"""3-vector helpers over [..., 3] tensors, sums in a fixed order."""

from __future__ import annotations

import torch

EPS = 1e-5


def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def dotk(a, b):
    return dot(a, b)[..., None]


def cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def normalize(a, eps: float = 1e-20):
    return a * torch.rsqrt(torch.clamp(dotk(a, a), min=eps))


def reflect(i, n):
    return i - 2.0 * dotk(n, i) * n


def refract(i, n, eta):
    eta = eta[..., None]
    cosi = -dotk(i, n)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = (k < 0.0)[..., 0]
    refr = eta * i + (eta * cosi - torch.sqrt(torch.clamp(k, min=0.0))) * n
    return torch.where(tir[..., None], torch.zeros_like(refr), refr), tir


def onb(n):
    """Branch-free orthonormal basis (T, B) around n."""
    x, y, z = n.unbind(-1)
    cond = (x.abs() > y.abs())[..., None]
    zero = torch.zeros_like(x)
    t = normalize(torch.where(cond, torch.stack([z, zero, -x], dim=-1),
                              torch.stack([zero, -z, y], dim=-1)))
    return t, cross(n, t)
