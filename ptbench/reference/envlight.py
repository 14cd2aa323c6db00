"""Env-map importance sampling: a 2D CDF over luminance x sin(theta) of
the equirect texels, and its solid-angle pdf."""

from __future__ import annotations

import numpy as np
import torch

M_PI = np.pi


def distribution(envmap: np.ndarray):
    """(marginal cdf f32[H], conditional cdf f32[H, W], pdf f32[H, W])."""
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
    marginal = np.cumsum(row_w) / total
    marginal[-1] = 1.0
    cond = np.cumsum(weight, axis=1) / np.where(row_w > 0, row_w,
                                                1.0)[:, None]
    cond[:, -1] = 1.0
    d_omega = (M_PI / h) * (2.0 * M_PI / w) * np.maximum(
        np.sin(theta)[:, None], 1e-8)
    pdf = (weight / total) / d_omega
    return (marginal.astype(np.float32), cond.astype(np.float32),
            pdf.astype(np.float32))


def sample(marginal, cond, u):
    """Directions [N, 3] drawn with uniforms u [N, 4] (row, column, two
    in-texel jitters)."""
    h, w = cond.shape
    r = torch.searchsorted(marginal, u[:, 0].contiguous(),
                           right=False).clamp(0, h - 1)
    c = torch.searchsorted(cond[r], u[:, 1, None].contiguous(),
                           right=False)[:, 0].clamp(0, w - 1)
    theta = (r.to(u.dtype) + u[:, 2]) / h * M_PI
    phi = ((c.to(u.dtype) + u[:, 3]) / w - 0.5) * (2.0 * M_PI)
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), torch.cos(theta),
                        st * torch.sin(phi)], dim=-1)


def pdf_of(pdf_map, d):
    """Solid-angle pdf of directions d [N, 3]."""
    h, w = pdf_map.shape
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 2], d[..., 0])
    r = (theta / M_PI * h).to(torch.int32).clamp(0, h - 1)
    c = ((phi / (2.0 * M_PI) + 0.5) * w).to(torch.int32).clamp(0, w - 1)
    return pdf_map[r.long(), c.long()]
