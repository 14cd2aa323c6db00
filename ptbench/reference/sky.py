"""Radiance of rays that leave the scene: gradient, black, or an
equirect env map (bilinear, x wrapping, y clipped)."""

from __future__ import annotations

import torch

M_PI = 3.141592653589793
_TOP = (0.6, 0.7, 0.9)
_BOT = (0.02, 0.02, 0.05)


def gradient(d, gain: float):
    t = torch.clamp(0.5 * (d[..., 1] + 1.0), 0.0, 1.0)
    top = torch.tensor(_TOP, dtype=d.dtype, device=d.device)
    bot = torch.tensor(_BOT, dtype=d.dtype, device=d.device)
    m = ((1.0 - t) ** 2)[..., None]
    return (top * (1.0 - m) + bot * m) * gain


def envmap(env, d):
    h, w = env.shape[0], env.shape[1]
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
    a = env[y0, x0] * (1 - fx) + env[y0, x1] * fx
    b = env[y1, x0] * (1 - fx) + env[y1, x1] * fx
    return a * (1 - fy) + b * fy


def radiance(rc, d, env):
    """Sky radiance of directions d [N, 3] under config rc."""
    if rc["sky"] == "black":
        return torch.zeros_like(d)
    if rc["sky"] == "gradient":
        return gradient(d, rc["sky_gain"])
    if rc["sky"] == "envmap":
        return envmap(env, d)
    raise NotImplementedError(f"reference sky {rc['sky']!r}")
