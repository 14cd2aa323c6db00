"""Vector math over [..., 3] tensors (counterpart of pathtracer/utils/vmath.py).

Dot products are written out as ((a0*b0 + a1*b1) + a2*b2) so the sum
order is fixed on every device.
"""

from __future__ import annotations

import torch

EPS = 1e-5  # common.glsl:24


def dot(a, b):
    """Batched 3-vector dot product -> [...]."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def dotk(a, b):
    """Batched dot with kept dim -> [..., 1]."""
    return dot(a, b)[..., None]


def cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def length(a):
    return torch.sqrt(torch.clamp(dot(a, a), min=0.0))


def normalize(a, eps: float = 1e-20):
    return a * torch.rsqrt(torch.clamp(dotk(a, a), min=eps))


def reflect(i, n):
    """GLSL reflect: i - 2*dot(n,i)*n (incident points toward surface)."""
    return i - 2.0 * dotk(n, i) * n


def refract(i, n, eta):
    """GLSL refract. Returns (refracted_dir, tir_mask); zeros on TIR."""
    eta = eta[..., None]
    cosi = -dotk(i, n)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = (k < 0.0)[..., 0]
    refr = eta * i + (eta * cosi - torch.sqrt(torch.clamp(k, min=0.0))) * n
    refr = torch.where(tir[..., None], torch.zeros_like(refr), refr)
    return refr, tir


def luminance(rgb):
    """Rec.709 luminance (main.cpp:287 weights)."""
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def maxc(rgb):
    """Max colour component (raygen.rgen:287 RR probability)."""
    return rgb.amax(dim=-1)


def onb(n):
    """Branch-free orthonormal basis (T, B) for normal n (common.glsl:52-58)."""
    x, y, z = n.unbind(-1)
    cond = (x.abs() > y.abs())[..., None]
    zero = torch.zeros_like(x)
    t_a = torch.stack([z, zero, -x], dim=-1)
    t_b = torch.stack([zero, -z, y], dim=-1)
    t = normalize(torch.where(cond, t_a, t_b))
    b = cross(n, t)
    return t, b


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)
