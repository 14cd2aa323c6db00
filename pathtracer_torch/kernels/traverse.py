"""K5 closest-hit and K6 any-hit traversal of the threaded LBVH
(counterpart of pathtracer/kernels/traverse.py).

The Bvh of accel/lbvh.py is threaded: a box hit on an internal node goes
to node + 1 (its first child in DFS preorder), a leaf or a miss goes to
miss_link, and -1 ends the walk. So a ray needs no stack.

  intersect_bvh(packed, o, d, t_min, t_max) -> Hit: nearest triangle with
      t_min < t < best_t (best_t starts at t_max, a scalar or per ray;
      strict `<`, so the first of equal-t triangles in DFS order wins);
      t = inf on a miss.
  occluded_bvh(packed, o, d, t_max) -> bool[N]: a front-facing triangle
      (dot(d, e1 x e2) < 0, raygen.rgen:214-218) with 0 < t < t_max; a
      ray stops at its first one.

`pack_bvh` lays a node out as one 32-byte row [lo.xyz, hi.xyz,
miss_link, tri_id] (the two links as int32 bits) and a triangle as one
row [v0, e1 = v1 - v0, e2 = v2 - v0]. The wrappers run the CUDA kernels
of csrc/traverse.cu on CUDA tensors (one thread a ray walking the tree)
and the plain versions on CPU tensors, never the reverse. The plain
versions step all live rays in lockstep, one node a step, with the same
per-ray sequence of operations as the kernels, which are built with
-fmad=false, so the two agree bit for bit. In the JAX package the
traversal is XLA code (`_intersect_chunk` :140, `_occluded_chunk` :206),
not Pallas; its ray chunking is a TPU mechanic and is dropped.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from pathtracer_torch import tracing
from pathtracer_torch.kernels import LAUNCHES, cuda_build
from pathtracer_torch.kernels.intersect import DET_EPS, Hit
from pathtracer_torch.scene.types import Bvh


class PackedBvh(NamedTuple):
    """Traversal layout: one row gather a node and one a leaf triangle."""

    nodes: torch.Tensor  # f32 [n_nodes, 8]: lo3, hi3, miss, tri (int32 bits)
    tris: torch.Tensor   # f32 [T, 9]: v0, e1, e2

    @property
    def links(self):
        """int32 [n_nodes, 2]: (miss_link, tri_id) of each node."""
        return self.nodes[:, 6:8].view(torch.int32)


def pack_bvh(bvh: Bvh, indices, positions) -> PackedBvh:
    """Pack a threaded Bvh and its mesh into the traversal layout."""
    links = torch.stack([bvh.miss_link, bvh.tri_id], dim=1) \
        .to(torch.int32).contiguous().view(torch.float32)
    nodes = torch.cat([bvh.aabb_min, bvh.aabb_max, links], dim=1)
    idx = indices.long()
    v0 = positions[idx[:, 0]]
    tris = torch.cat([v0, positions[idx[:, 1]] - v0,
                      positions[idx[:, 2]] - v0], dim=1)
    return PackedBvh(nodes=nodes.contiguous(), tris=tris.contiguous())


def _safe_inv(d):
    """1/d with zero components nudged off zero (keeps the slab NaN-free)."""
    tiny = 1e-20
    d_safe = torch.where(d.abs() < tiny, torch.where(d < 0, -tiny, tiny), d)
    return torch.reciprocal(d_safe)


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def _dot(ax, ay, az, bx, by, bz):
    return (ax * bx + ay * by) + az * bz


def _mt_packed(rows, o, d, t_min, t_max):
    """Moller-Trumbore against [N, 9] rows (v0, e1, e2) -> (t, u, v, hit,
    front): front is the occlusion test's dot(d, e1 x e2) < 0."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = rows.unbind(1)
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    px, py, pz = _cross(dx, dy, dz, e2x, e2y, e2z)
    det = _dot(e1x, e1y, e1z, px, py, pz)
    ok_det = det.abs() > DET_EPS
    inv_det = torch.where(ok_det, torch.reciprocal(det), 0.0)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = _dot(tx, ty, tz, px, py, pz) * inv_det
    qx, qy, qz = _cross(tx, ty, tz, e1x, e1y, e1z)
    v = _dot(dx, dy, dz, qx, qy, qz) * inv_det
    t = _dot(e2x, e2y, e2z, qx, qy, qz) * inv_det
    hit = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min) & (t < t_max))
    front = _dot(dx, dy, dz, *_cross(e1x, e1y, e1z, e2x, e2y, e2z)) < 0.0
    return t, u, v, hit, front


def _slab(nodes, ni, o, inv_d):
    """(t_near, t_far) of rays o/inv_d [m, 3] against node rows ni."""
    row = nodes[ni]
    t1 = (row[:, 0:3] - o) * inv_d
    t2 = (row[:, 3:6] - o) * inv_d
    lo = torch.minimum(t1, t2)
    hi = torch.maximum(t1, t2)
    t_near = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    t_far = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    return t_near, t_far


def _per_ray(x, n, device):
    return tracing.device_tensor(x, device, torch.float32).expand(
        n).contiguous()


def _count(counter, value):
    if counter is not None:
        counter += value


def hint_test(packed: PackedBvh):
    """The bvh route's hint re-test: hint_fn(tri, o, d, t_min, t_max,
    front_only=False) -> (t, u, v, ok), each ray against its own
    triangle row with the traversal's Moller-Trumbore (front_only: the
    occlusion walk's front-facing test)."""
    def hint_fn(tri, o, d, t_min, t_max, front_only=False):
        rows = packed.tris[tri.clamp(min=0).long()]
        t, u, v, ok, front = _mt_packed(rows, o, d, t_min, t_max)
        return t, u, v, (ok & front) if front_only else ok
    return hint_fn


def intersect_bvh_plain(packed: PackedBvh, o, d, t_min, t_max,
                        node_visits=None, leaf_tests=None) -> Hit:
    """Plain PyTorch K5: live rays in lockstep, one node a step.

    node_visits / leaf_tests: optional int64 0-d tensors, incremented by
    the (ray, node) steps and the (ray, leaf triangle) tests this call's
    data needs - the work a bound counts.
    """
    n = o.shape[0]
    dev = o.device
    links = packed.links
    inv_d = _safe_inv(d)
    best_t = _per_ray(t_max, n, dev).clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    idx = torch.arange(n, device=dev)
    while idx.numel():
        ni = node[idx]
        t_near, t_far = _slab(packed.nodes, ni, o[idx], inv_d[idx])
        bt = best_t[idx]
        box_hit = (t_near <= t_far) & (t_far >= t_min) & (t_near <= bt)
        miss = links[ni, 0].long()
        tri = links[ni, 1]
        leaf = box_hit & (tri >= 0)
        _count(node_visits, idx.numel())
        li = idx[leaf]
        if li.numel():
            _count(leaf_tests, li.numel())
            lt = tri[leaf]
            t, u, v, hit, _ = _mt_packed(packed.tris[lt.long()], o[li],
                                         d[li], t_min, bt[leaf])
            better = hit & (t < bt[leaf])
            wi = li[better]
            best_t[wi] = t[better]
            best_tri[wi] = lt[better]
            best_u[wi] = u[better]
            best_v[wi] = v[better]
        nxt = torch.where(box_hit & (tri < 0), ni + 1, miss)
        node[idx] = nxt
        idx = idx[nxt >= 0]
    best_t = torch.where(best_tri >= 0, best_t, torch.inf)
    return Hit(t=best_t, tri=best_tri, u=best_u, v=best_v)


def occluded_bvh_plain(packed: PackedBvh, o, d, t_max, node_visits=None,
                       leaf_tests=None):
    """Plain PyTorch K6 -> bool[N]; counters as intersect_bvh_plain."""
    n = o.shape[0]
    dev = o.device
    links = packed.links
    inv_d = _safe_inv(d)
    tm = _per_ray(t_max, n, dev)
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    idx = torch.arange(n, device=dev)
    while idx.numel():
        ni = node[idx]
        t_near, t_far = _slab(packed.nodes, ni, o[idx], inv_d[idx])
        ti = tm[idx]
        box_hit = (t_near <= t_far) & (t_far >= 0.0) & (t_near <= ti)
        miss = links[ni, 0].long()
        tri = links[ni, 1]
        leaf = box_hit & (tri >= 0)
        _count(node_visits, idx.numel())
        newly = torch.zeros_like(leaf)
        li = idx[leaf]
        if li.numel():
            _count(leaf_tests, li.numel())
            t, _, _, hit, front = _mt_packed(packed.tris[tri[leaf].long()],
                                             o[li], d[li], 0.0, torch.inf)
            newly[leaf] = hit & front & (t < ti[leaf])
        blocked[idx] = newly
        nxt = torch.where(box_hit & (tri < 0), ni + 1, miss)
        nxt = torch.where(newly, -1, nxt)           # early out
        node[idx] = nxt
        idx = idx[nxt >= 0]
    return blocked


_SIG = {
    "pt_bvh_closest": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    "pt_bvh_occluded": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
}


def _check_inputs(packed: PackedBvh, o, d, per_ray):
    dev = o.device
    n = o.shape[0]
    want = [("nodes", packed.nodes, (packed.nodes.shape[0], 8)),
            ("tris", packed.tris, (packed.tris.shape[0], 9)),
            ("o", o, (n, 3)), ("d", d, (n, 3)), ("t_max", per_ray, (n,))]
    for name, t, shape in want:
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"bvh traversal {name}: want contiguous float32 {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def intersect_bvh(packed: PackedBvh, o, d, t_min, t_max) -> Hit:
    """K5: closest hit (kernel on CUDA, plain version on CPU)."""
    if o.device.type == "cpu":
        return intersect_bvh_plain(packed, o, d, t_min, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"intersect_bvh: unsupported device {o.device}")
    n = o.shape[0]
    tm = _per_ray(t_max, n, o.device)
    _check_inputs(packed, o, d, tm)
    out_t = torch.empty(n, dtype=torch.float32, device=o.device)
    out_tri = torch.empty(n, dtype=torch.int32, device=o.device)
    out_u = torch.empty_like(out_t)
    out_v = torch.empty_like(out_t)
    if n:
        lib = cuda_build.load("traverse", _SIG)
        rc = lib.pt_bvh_closest(
            packed.nodes.data_ptr(), packed.tris.data_ptr(), o.data_ptr(),
            d.data_ptr(), n, float(t_min), tm.data_ptr(), out_t.data_ptr(),
            out_tri.data_ptr(), out_u.data_ptr(), out_v.data_ptr(),
            cuda_build.stream_ptr(o.device))
        cuda_build.check_launch(rc, "bvh_closest")
        LAUNCHES["bvh_closest"] += 1
    return Hit(t=out_t, tri=out_tri, u=out_u, v=out_v)


def occluded_bvh(packed: PackedBvh, o, d, t_max):
    """K6: bool[N] blocked (kernel on CUDA, plain version on CPU)."""
    if o.device.type == "cpu":
        return occluded_bvh_plain(packed, o, d, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"occluded_bvh: unsupported device {o.device}")
    n = o.shape[0]
    tm = _per_ray(t_max, n, o.device)
    _check_inputs(packed, o, d, tm)
    out = torch.empty(n, dtype=torch.bool, device=o.device)
    if n:
        lib = cuda_build.load("traverse", _SIG)
        rc = lib.pt_bvh_occluded(
            packed.nodes.data_ptr(), packed.tris.data_ptr(), o.data_ptr(),
            d.data_ptr(), n, tm.data_ptr(), out.data_ptr(),
            cuda_build.stream_ptr(o.device))
        cuda_build.check_launch(rc, "bvh_occluded")
        LAUNCHES["bvh_occluded"] += 1
    return out
