"""Environment-map importance sampling (counterpart of pathtracer/scene/envlight.py).

Equirect HDR env maps, the light of BASELINE config 4. Standard 2D CDF
over the luminance-weighted texel solid angles:

  w[r,c]   = luminance(env[r,c]) * sin(theta_r)
  marginal = cdf over row sums, conditional = per-row cdf over columns
  p(omega) = select_prob / texel_solid_angle   (piecewise-constant pdf)

The CDF build is numpy (float64 inside) at scene-finalize time; sampling
and pdf lookups are torch on the render device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M_PI = np.pi


def build_env_distribution(envmap: np.ndarray):
    """CDFs + solid-angle pdf map for an equirect env map f32[H, W, 3].

    Returns (marginal_cdf f32[H], cond_cdf f32[H, W], pdf f32[H, W]).
    """
    env = np.asarray(envmap, np.float64)
    h, w = env.shape[:2]
    lum = 0.2126 * env[..., 0] + 0.7152 * env[..., 1] + 0.0722 * env[..., 2]
    theta = (np.arange(h) + 0.5) / h * M_PI
    weight = np.maximum(lum, 0.0) * np.sin(theta)[:, None]
    total = weight.sum()
    if total <= 0:
        weight = np.ones_like(weight)
        total = weight.sum()

    row_w = weight.sum(axis=1)
    marginal_cdf = np.cumsum(row_w) / total
    marginal_cdf[-1] = 1.0

    cond = np.cumsum(weight, axis=1)
    row_safe = np.where(row_w > 0, row_w, 1.0)[:, None]
    cond_cdf = cond / row_safe
    cond_cdf[:, -1] = 1.0

    select = weight / total                      # per-texel selection prob
    d_omega = (M_PI / h) * (2.0 * M_PI / w) * np.maximum(
        np.sin(theta)[:, None], 1e-8)
    pdf = select / d_omega                       # solid-angle pdf
    return (marginal_cdf.astype(np.float32), cond_cdf.astype(np.float32),
            pdf.astype(np.float32))


def _row_searchsorted(cdf2d, r, u):
    """Per-lane searchsorted(cdf2d[r], u, side='left') without the [N, W]
    row matrix.

    Gathering each lane's row would take N x W floats (4 GB at 1M lanes
    with a 1024-wide map); this lower-bound binary search takes
    ceil(log2 W) + 1 steps of one scalar gather per lane instead and
    returns the same indices.
    """
    w = cdf2d.shape[1]
    flat = cdf2d.reshape(-1)
    base = r * w
    lo = torch.zeros_like(r)
    hi = torch.full_like(r, w)
    # the insertion index lies in [0, w]: ceil(log2(w)) + 1 halvings
    for _ in range(int(math.ceil(math.log2(max(w, 2)))) + 1):
        open_ = lo < hi                      # converged lanes stay put
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        go_right = open_ & (flat[base + mid.clamp(max=w - 1)] < u)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(open_ & ~go_right, mid, hi)
    return lo


def sample_env(marginal_cdf, cond_cdf, u1, u2, u3, u4):
    """Sample directions from the env distribution.

    u1..u4: f32[N] uniforms (row, col, in-texel jitter x2).
    Returns (dir f32[N,3], row int64[N], col int64[N]).
    """
    h = marginal_cdf.shape[0]
    w = cond_cdf.shape[1]
    r = torch.searchsorted(marginal_cdf, u1.contiguous(),
                           right=False).clamp(0, h - 1)
    c = _row_searchsorted(cond_cdf, r, u2).clamp(0, w - 1)
    theta = (r.to(torch.float32) + u3) / h * M_PI
    phi = ((c.to(torch.float32) + u4) / w - 0.5) * (2.0 * M_PI)
    st = torch.sin(theta)
    d = torch.stack([st * torch.cos(phi), torch.cos(theta),
                     st * torch.sin(phi)], dim=-1)
    return d, r, c


def env_texel(h: int, w: int, d):
    """(row, col) int64 of the texel a direction d [..., 3] falls in."""
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 2], d[..., 0])
    r = (theta / M_PI * h).to(torch.int32).clamp(0, h - 1)
    c = ((phi / (2.0 * M_PI) + 0.5) * w).to(torch.int32).clamp(0, w - 1)
    return r.long(), c.long()


def env_pdf(pdf_map, d):
    """Solid-angle pdf of direction d [..., 3] under the env distribution."""
    r, c = env_texel(pdf_map.shape[0], pdf_map.shape[1], d)
    return pdf_map[r, c]
