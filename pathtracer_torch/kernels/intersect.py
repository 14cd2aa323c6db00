"""Ray-triangle intersection and brute-force scene intersection.

Counterpart of pathtracer/kernels/intersect.py: Moller-Trumbore without
backface culling, the O(rays x tris) closest-hit oracle, and shadow-ray
visibility with the reference's backface skip (raygen.rgen:214-218).
The brute routes are also the production intersector for scenes of at
most 256 triangles (render.make_intersectors).

Hit convention: t f32[N] (t_max if miss), tri i32[N] (-1 miss), u, v
f32[N] barycentrics of corners 1 and 2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pathtracer_torch import tracing
from pathtracer_torch.utils import vmath

DET_EPS = 1e-12


class Hit(NamedTuple):
    t: torch.Tensor      # f32 [N]
    tri: torch.Tensor    # i32 [N], -1 = miss
    u: torch.Tensor      # f32 [N]
    v: torch.Tensor      # f32 [N]

    @property
    def valid(self):
        return self.tri >= 0


def ray_triangle(o, d, v0, v1, v2, t_min, t_max):
    """Moller-Trumbore for broadcastable batches -> (t, u, v, hit_mask)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = vmath.cross(d, e2)
    det = vmath.dot(e1, pvec)
    ok_det = det.abs() > DET_EPS
    inv_det = torch.where(ok_det, torch.reciprocal(det), 0.0)
    tvec = o - v0
    u = vmath.dot(tvec, pvec) * inv_det
    qvec = vmath.cross(tvec, e1)
    v = vmath.dot(d, qvec) * inv_det
    t = vmath.dot(e2, qvec) * inv_det
    hit = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min) & (t < t_max))
    t = torch.where(hit, t, torch.inf)
    return t, u, v, hit


def hint_test(tri_v0, tri_v1, tri_v2):
    """The brute route's hint re-test: hint_fn(tri, o, d, t_min, t_max,
    front_only=False) -> (t, u, v, ok), Moller-Trumbore of each ray
    against its own triangle; front_only adds occluded_brute's
    front-facing test."""
    def hint_fn(tri, o, d, t_min, t_max, front_only=False):
        i = tri.clamp(min=0).long()
        v0, v1, v2 = tri_v0[i], tri_v1[i], tri_v2[i]
        t, u, v, ok = ray_triangle(o, d, v0, v1, v2, t_min, t_max)
        if front_only:
            ok = ok & (vmath.dot(d, vmath.cross(v1 - v0, v2 - v0)) < 0.0)
        return t, u, v, ok
    return hint_fn


def _pad_tris(tri_v0, tri_v1, tri_v2, tri_chunk):
    pad = (-tri_v0.shape[0]) % tri_chunk
    if pad:
        padv = torch.full((pad, 3), torch.inf, dtype=tri_v0.dtype,
                          device=tri_v0.device)
        tri_v0, tri_v1, tri_v2 = (torch.cat([a, padv])
                                  for a in (tri_v0, tri_v1, tri_v2))
    return tri_v0, tri_v1, tri_v2


def intersect_brute(o, d, tri_v0, tri_v1, tri_v2, t_min, t_max,
                    tri_chunk: int = 256) -> Hit:
    """Closest hit of rays [N,3] against all triangles [T,3] (O(N*T))."""
    n = o.shape[0]
    t_max = tracing.device_tensor(t_max, o.device, torch.float32).expand(n)
    tv0, tv1, tv2 = _pad_tris(tri_v0, tri_v1, tri_v2, tri_chunk)
    best_t = t_max.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    best_u = torch.zeros(n, dtype=torch.float32, device=o.device)
    best_v = torch.zeros_like(best_u)
    rows = torch.arange(n, device=o.device)
    for c0 in range(0, tv0.shape[0], tri_chunk):
        t, u, v, hit = ray_triangle(
            o[:, None, :], d[:, None, :], tv0[None, c0:c0 + tri_chunk],
            tv1[None, c0:c0 + tri_chunk], tv2[None, c0:c0 + tri_chunk],
            t_min, t_max[:, None])
        tj, j = torch.min(torch.where(hit, t, torch.inf), dim=1)
        better = tj < best_t
        best_t = torch.where(better, tj, best_t)
        best_tri = torch.where(better, (c0 + j).to(torch.int32), best_tri)
        best_u = torch.where(better, u[rows, j], best_u)
        best_v = torch.where(better, v[rows, j], best_v)
    return Hit(t=best_t, tri=best_tri, u=best_u, v=best_v)


def occluded_brute(o, d, t_max, tri_v0, tri_v1, tri_v2,
                   tri_chunk: int = 256, want_blocker: bool = False):
    """Any front-facing hit with 0 < t < t_max per ray -> bool[N].

    want_blocker: also return i32[N], the lowest index of a blocking
    triangle (-1 where open) - the shadow-priming hint. On scenes of at
    most tri_chunk triangles this is the JAX package's choice exactly.
    """
    n = o.shape[0]
    t_max = tracing.device_tensor(t_max, o.device, torch.float32).expand(n)
    tv0, tv1, tv2 = _pad_tris(tri_v0, tri_v1, tri_v2, tri_chunk)
    blocked = torch.zeros(n, dtype=torch.bool, device=o.device)
    btri = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    for c0 in range(0, tv0.shape[0], tri_chunk):
        v0c = tv0[c0:c0 + tri_chunk]
        v1c = tv1[c0:c0 + tri_chunk]
        v2c = tv2[c0:c0 + tri_chunk]
        t, _, _, hit = ray_triangle(o[:, None, :], d[:, None, :],
                                    v0c[None], v1c[None], v2c[None],
                                    0.0, torch.inf)
        gn = vmath.cross(v1c - v0c, v2c - v0c)[None]
        front = vmath.dot(d[:, None, :], gn) < 0.0
        hit = hit & front & (t < t_max[:, None])
        any_hit = hit.any(dim=1)
        if want_blocker:
            first = torch.argmax(hit.to(torch.uint8), dim=1)   # first True
            btri = torch.where(any_hit & ~blocked,
                               (c0 + first).to(torch.int32), btri)
        blocked = blocked | any_hit
    return (blocked, btri) if want_blocker else blocked
