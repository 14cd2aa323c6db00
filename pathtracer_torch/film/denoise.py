"""Edge-aware a-trous wavelet denoiser (counterpart of pathtracer/film/denoise.py).

The JAX package writes it in XLA, not as a Pallas kernel, so the port is
plain PyTorch: per level, 25 static edge-clamped image shifts with the
B3-spline taps h = [1, 4, 6, 4, 1] / 16 per axis, dilated 2^i, weighted
by the SVGF-style edge stops

  w = h(tap) * w_l * max(0, n_p . n_q)^sigma_n
             * exp(-|z_p - z_q|^2 / (sigma_z * step * 0.01)).

Albedo is demodulated first and re-applied after; sky pixels (depth =
inf) pass through. w_l is exp(-|dL| / (4 sdev + 1e-4)) with the 3x3
prefiltered standard deviation of `variance` when it is given (and the
variance carried through each level as sum(w^2 var) / (sum w)^2), else
the exposure-invariant relative luminance difference.
"""

from __future__ import annotations

import torch

from pathtracer_torch.utils.vmath import luminance

_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _shift2(img, dy: int, dx: int):
    """out[y, x] = img[clamp(y - dy), clamp(x - dx)] ([H, W, ...])."""
    if dy:
        h = img.shape[0]
        idx = (torch.arange(h, device=img.device) - dy).clamp(0, h - 1)
        img = img[idx]
    if dx:
        w = img.shape[1]
        idx = (torch.arange(w, device=img.device) - dx).clamp(0, w - 1)
        img = img[:, idx]
    return img


def atrous_denoise(radiance, normal, depth, albedo, iterations: int = 3,
                   sigma_l: float = 1.0, sigma_n: float = 32.0,
                   sigma_z: float = 1.0, variance=None):
    """Denoise linear radiance f32[H, W, 3]; same shape and dtype.

    normal f32[H, W, 3], depth f32[H, W] (inf = sky), albedo f32[H, W, 3];
    variance: optional f32[H, W] variance of the mean radiance's
    luminance.
    """
    sky = ~torch.isfinite(depth)
    z = torch.where(sky, 0.0, depth)
    z_span = torch.clamp(z.max() - z.min(), min=1e-6)
    z = z / z_span
    alb = torch.clamp(albedo, min=1e-3)
    irr = radiance / alb
    var = None
    if variance is not None:
        alb_l = torch.clamp(luminance(alb), min=1e-3)
        var = torch.clamp(variance, min=0.0) / (alb_l * alb_l)

    out = irr
    for i in range(iterations):
        step = 1 << i
        lum_c = luminance(out)
        acc = torch.zeros_like(out)
        wsum = torch.zeros(out.shape[:2], dtype=out.dtype, device=out.device)
        vacc = None
        if var is not None:
            gv = torch.zeros_like(var)
            for gy in (-1, 0, 1):
                for gx in (-1, 0, 1):
                    gw = (2.0 - abs(gy)) * (2.0 - abs(gx)) / 16.0
                    gv = gv + gw * _shift2(var, gy, gx)
            sdev = torch.sqrt(torch.clamp(gv, min=0.0))
            vacc = torch.zeros_like(var)
        for ky in range(-2, 3):
            for kx in range(-2, 3):
                h = _B3[ky + 2] * _B3[kx + 2]
                dy, dx = ky * step, kx * step
                n_q = _shift2(normal, dy, dx)
                z_q = _shift2(z, dy, dx)
                l_q = _shift2(lum_c, dy, dx)
                sky_q = _shift2(sky, dy, dx)
                w_n = torch.clamp((normal * n_q).sum(dim=-1),
                                  min=0.0) ** sigma_n
                w_z = torch.exp(-(z - z_q) ** 2 / (sigma_z * step * 0.01))
                if var is not None:
                    w_l = torch.exp(-torch.abs(lum_c - l_q)
                                    / (4.0 * sdev + 1e-4))
                else:
                    rel = (lum_c - l_q) / torch.clamp(
                        torch.maximum(lum_c, l_q), min=1e-3)
                    w_l = torch.exp(-rel * rel / sigma_l)
                w = h * w_n * w_z * w_l * (~sky_q)
                acc = acc + _shift2(out, dy, dx) * w[..., None]
                wsum = wsum + w
                if var is not None:
                    vacc = vacc + w * w * _shift2(var, dy, dx)
        wn = torch.clamp(wsum, min=1e-8)
        out = acc / wn[..., None]
        if var is not None:
            var = vacc / (wn * wn)
    result = out * alb
    return torch.where(sky[..., None], radiance, result)
