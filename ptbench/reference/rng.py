"""Counter-based PCG4D random numbers keyed on (pixel, sample, depth, salt).

The estimator's random numbers, written from the PCG4D hash (Jarzynski
and Olano, "Hash Functions for GPU Rendering", JCGT 2020): u32 words in
int64 with explicit wrap-around; a draw is the top 24 bits x 2^-24.
"""

from __future__ import annotations

import torch

SALT_JITTER = 0
SALT_ALPHA = 1
SALT_DIELECTRIC = 2
SALT_LIGHT_SELECT = 3
SALT_LIGHT_UV = 4
SALT_BSDF_LOBE = 5
SALT_BSDF_UV = 6
SALT_RR = 7
SALT_ENV_SELECT = 8
SALT_ENV_UV = 9
SALT_TEX_FILTER = 10
SALT_ENV_RR = 11
SALTS_PER_DEPTH = 12
M32 = 0xFFFFFFFF


def _mul32(a, b):
    a_lo = a & 0xFFFF
    a_hi = a >> 16
    return (a_lo * b + (((a_hi * (b & 0xFFFF)) & 0xFFFF) << 16)) & M32


def pcg4d(v):
    v = (_mul32(v & M32, 1664525) + 1013904223) & M32
    x, y, z, w = v.unbind(-1)
    x = (x + _mul32(y, w)) & M32
    y = (y + _mul32(z, x)) & M32
    z = (z + _mul32(x, y)) & M32
    w = (w + _mul32(y, z)) & M32
    x, y, z, w = (a ^ (a >> 16) for a in (x, y, z, w))
    x = (x + _mul32(y, w)) & M32
    y = (y + _mul32(z, x)) & M32
    z = (z + _mul32(x, y)) & M32
    w = (w + _mul32(y, z)) & M32
    return torch.stack([x, y, z, w], dim=-1)


def uniform4(pixel, sample, depth: int, salt: int, seed: int, dtype):
    """Four U[0, 1) draws [N, 4] in `dtype` for int64 pixel/sample [N]."""
    ds = (int(depth) * SALTS_PER_DEPTH + salt) & M32
    key = torch.stack(torch.broadcast_tensors(
        pixel.long() & M32, sample.long() & M32,
        torch.tensor(ds, device=pixel.device),
        torch.tensor(int(seed) & M32, device=pixel.device)), dim=-1)
    bits = pcg4d(key)
    return ((bits >> 8).to(torch.float32) * (1.0 / (1 << 24))).to(dtype)
