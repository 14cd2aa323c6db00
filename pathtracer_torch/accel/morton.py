"""30-bit Morton codes (counterpart of pathtracer/accel/morton.py).

u32 words ride in int64; every intermediate of `expand_bits_10` stays
below 2^28, so no masking beyond the JAX constants is needed.
"""

from __future__ import annotations

import torch


def expand_bits_10(v):
    """Spread the low 10 bits of int64[...] so consecutive bits are 3 apart."""
    v = v.to(torch.int64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(x, y, z):
    """Interleave three 10-bit integer coordinates -> 30-bit Morton code."""
    return (expand_bits_10(x) << 2) | (expand_bits_10(y) << 1) \
        | expand_bits_10(z)


def morton_codes(points, lo=None, hi=None):
    """Morton codes of f32 points [..., 3] normalised into their AABB.

    lo/hi default to the batch min/max. Returns int64[...] (u32 values).
    """
    flat = points.reshape(-1, 3)
    if lo is None:
        lo = flat.amin(dim=0)
    if hi is None:
        hi = flat.amax(dim=0)
    extent = torch.clamp(hi - lo, min=1e-12)
    unit = torch.clamp((points - lo) / extent, 0.0, 1.0)
    q = torch.clamp((unit * 1024.0).to(torch.int64), max=1023)
    return morton3d(q[..., 0], q[..., 1], q[..., 2])
