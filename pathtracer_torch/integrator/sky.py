"""Environment lighting, the "miss shader" (counterpart of pathtracer/integrator/sky.py).

Gradient (miss.rmiss:153-156, x sky_gain), black and equirect env-map
skies. The Hosek-Wilkie sky is not ported yet (ROADMAP.md Queue 1,
estimator variants); the config rejects it.
"""

from __future__ import annotations

import torch

from pathtracer_torch.scene.envlight import M_PI

_TOP = (0.6, 0.7, 0.9)
_BOT = (0.02, 0.02, 0.05)


def gradient_sky(d, gain: float = 0.2):
    """Simple vertical gradient (miss.rmiss:153-156) x gain."""
    t = torch.clamp(0.5 * (d[..., 1] + 1.0), 0.0, 1.0)
    top = torch.tensor(_TOP, dtype=torch.float32, device=d.device)
    bot = torch.tensor(_BOT, dtype=torch.float32, device=d.device)
    m = ((1.0 - t) ** 2)[..., None]
    return (top * (1.0 - m) + bot * m) * gain


def envmap_radiance(envmap, d, blocks=None):
    """Bilinear equirect lookup: envmap f32[H,W,3], d unit [..., 3].

    x wraps (floor-mod), y clips, as the JAX lookup. blocks: optional
    2x2-footprint rows f32[H,W,12] (Scene.envmap_blocks) - one 48-byte
    row gather instead of four taps, bit-identical filtering.
    """
    h, w = envmap.shape[0], envmap.shape[1]
    u = (torch.atan2(d[..., 2], d[..., 0]) / (2.0 * M_PI) + 0.5) * w - 0.5
    v = (torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0)) / M_PI) * h - 0.5
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    x1 = torch.remainder(x0 + 1, w)
    x0 = torch.remainder(x0, w)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    y0 = torch.clamp(y0, 0, h - 1)
    if blocks is not None:
        row = blocks[y0, x0]                       # [..., 12], one gather
        a = row[..., 0:3] * (1 - fx) + row[..., 3:6] * fx
        b = row[..., 6:9] * (1 - fx) + row[..., 9:12] * fx
        return a * (1 - fy) + b * fy
    a = envmap[y0, x0] * (1 - fx) + envmap[y0, x1] * fx
    b = envmap[y1, x0] * (1 - fx) + envmap[y1, x1] * fx
    return a * (1 - fy) + b * fy


def sky_radiance(cfg, d, envmap=None, envmap_blocks=None):
    """Dispatch on cfg.sky - the miss-shader entry point."""
    if cfg.sky == "black":
        return torch.zeros(d.shape[:-1] + (3,), dtype=torch.float32,
                           device=d.device)
    if cfg.sky == "gradient":
        return gradient_sky(d, cfg.sky_gain)
    if cfg.sky == "envmap":
        return envmap_radiance(envmap, d, blocks=envmap_blocks)
    raise ValueError(f"sky={cfg.sky!r} is not ported (ROADMAP.md Queue 1, "
                     "estimator variants)")
