"""Cluster accel for packet traversal (counterpart of pathtracer/accel/cluster.py).

Only the production build is ported: `sahsplit` (native SBVH leaves,
Morton-ordered, cluster count padded to a multiple of 128 with empty
clusters) followed by `_finish_build`. Both default accels of the JAX
package are the same build (`build_scene_clusters` there), so the port
builds one and uses it for closest and occlusion calls alike.

Layouts are the JAX package's:
  aabb_lo/hi f32[C, 3]  clipped-union leaf boxes, pads at _PAD_POS
  blocks_t   f32[C, 16, K]  Baldwin-Weber rows n(3), d, r1(3), c1,
                            r2(3), c2, tri_id+1, pad(3)   (the sweeps)
  bw_rows    f32[T', 12]    the port's: each triangle's Baldwin-Weber
                            rows by id (T' = largest id + 1), read off
                            blocks_t once, so a hint re-test
                            (render.make_intersectors) does the sweeps'
                            arithmetic with one gather
  n_lanes    i32[C]         the port's: 1 + the last lane whose id row is
                            > 0 (0 for a pad cluster); the build packs a
                            cluster's triangles first, so the sweep
                            kernels test lanes < n_lanes only
  blocks_lm  f32[C, K, 16]  the port's: blocks_t lane-major, each lane's
                            16 rows contiguous (64 B), the sweep kernels'
                            staging layout
The three derived tables are built once with the accel (also for a JAX
accel carried in by accel_from_numpy) and move with it in `to`.
The JAX accel's Moller-Trumbore `blocks` [C, K, 12] feed only its
lockstep sweep, which the port does not have.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pathtracer_torch.accel import morton as morton_mod
from pathtracer_torch.utils import native

_PAD_POS = 1e30
CLUSTER_K = 128      # triangles per cluster (the sweep's lane count)
DUP_BUDGET = 1.5     # SBVH reference budget, x triangle count


@dataclasses.dataclass(frozen=True)
class ClusterAccel:
    """Flat two-level accel: C cluster AABBs + pre-baked triangle rows."""

    aabb_lo: torch.Tensor   # f32 [C, 3]
    aabb_hi: torch.Tensor   # f32 [C, 3]
    blocks_t: torch.Tensor  # f32 [C, 16, K]
    bw_rows: torch.Tensor   # f32 [T', 12]
    n_lanes: torch.Tensor   # i32 [C]
    blocks_lm: torch.Tensor  # f32 [C, K, 16]

    @property
    def n_clusters(self) -> int:
        return self.aabb_lo.shape[0]

    @property
    def tris_per_cluster(self) -> int:
        return self.blocks_t.shape[2]

    def to(self, device) -> "ClusterAccel":
        return ClusterAccel(*(getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)))


def accel_from_numpy(aabb_lo, aabb_hi, blocks_t, *,
                     device) -> ClusterAccel:
    """Carry a JAX ClusterAccel's arrays (as numpy) into the port."""
    t = [torch.from_numpy(np.array(a, np.float32)).to(device)
         for a in (aabb_lo, aabb_hi, blocks_t)]
    return ClusterAccel(*t, **derived_tables(t[2]))


def derived_tables(blocks_t):
    """bw_rows, n_lanes and blocks_lm of blocks_t [C, 16, K] (see the
    module docstring), as ClusterAccel keywords."""
    return dict(bw_rows=triangle_rows(blocks_t), **lane_tables(blocks_t))


def lane_tables(blocks_t):
    """The sweep kernels' tables of blocks_t [C, 16, K]: n_lanes i32[C]
    (1 + the last lane whose id row is > 0, 0 for a pad cluster) and
    blocks_lm f32[C, K, 16] (each lane's rows contiguous)."""
    k = blocks_t.shape[2]
    lane = torch.arange(1, k + 1, dtype=torch.int32, device=blocks_t.device)
    n_lanes = torch.where(blocks_t[:, 12, :] > 0, lane, 0).amax(dim=1)
    return dict(n_lanes=n_lanes.to(torch.int32).contiguous(),
                blocks_lm=blocks_t.transpose(1, 2).contiguous())


def triangle_rows(blocks_t):
    """Each triangle's Baldwin-Weber rows f32[T', 12] by id, read off its
    cluster slots (a triangle that spatial splits put in several clusters
    has the same rows in each); rows of ids in no cluster stay 0, which
    no ray hits."""
    c, rows, k = blocks_t.shape
    slots = blocks_t.transpose(1, 2).reshape(c * k, rows)
    ids = torch.round(slots[:, 12]).to(torch.int64) - 1
    real = ids >= 0
    n = int(ids.max()) + 1 if bool(real.any()) else 0
    out = torch.zeros((n, 12), dtype=torch.float32, device=blocks_t.device)
    out[ids[real]] = slots[real, :12]
    return out


def build_clusters(v0, v1, v2) -> ClusterAccel:
    """sahsplit cluster accel over triangles v0/v1/v2 f32[T, 3] (CPU)."""
    v0, v1, v2 = (torch.as_tensor(a, dtype=torch.float32).cpu()
                  for a in (v0, v1, v2))
    t = v0.shape[0]
    k = CLUSTER_K
    leaves, leaf_lo, leaf_hi = native.sah_split_build(
        v0.numpy(), v1.numpy(), v2.numpy(), k, dup_budget=DUP_BUDGET)
    # Morton-order the leaves by clipped-box centre (the JAX build does
    # the same for its fetch-group alignment; kept for identical ids)
    cen = torch.from_numpy((leaf_lo + leaf_hi) * 0.5)
    code = morton_mod.morton_codes(cen).numpy()
    lorder = np.argsort(code, kind="stable")
    leaves = [leaves[i] for i in lorder]
    leaf_lo, leaf_hi = leaf_lo[lorder], leaf_hi[lorder]
    # pad the cluster count to a 128 multiple with empty clusters
    c = -(-len(leaves) // 128) * 128
    order = np.full((c * k,), -1, np.int64)
    for i, leaf in enumerate(leaves):
        order[i * k: i * k + leaf.shape[0]] = leaf
    n_real = sum(leaf.shape[0] for leaf in leaves)
    sid = torch.from_numpy(order)
    gather = sid.clamp(min=0)
    real = (sid >= 0)[:, None]
    sv0 = torch.where(real, v0[gather], _PAD_POS)
    sv1 = torch.where(real, v1[gather], _PAD_POS)
    sv2 = torch.where(real, v2[gather], _PAD_POS)
    accel = _finish_build(sv0, sv1, sv2, sid, k, c * k - n_real, t)
    lo = np.full((c, 3), _PAD_POS, np.float32)
    hi = np.full((c, 3), _PAD_POS, np.float32)
    lo[: len(leaves)] = leaf_lo
    hi[: len(leaves)] = leaf_hi
    return dataclasses.replace(accel, aabb_lo=torch.from_numpy(lo),
                               aabb_hi=torch.from_numpy(hi))


def _cross_fma(a, b):
    """a x b with each component as fma(a_i, b_j, -(a_j * b_i)).

    The reference builds its tables with XLA on the host, which contracts
    `jnp.cross` exactly this way; near-parallel edges cancel, so the
    contracted and uncontracted forms differ far beyond an ulp there. The
    f32 x f32 product is exact in f64, so the f64 sum rounded once to f32
    is the fused result (up to a double rounding that needs an exact f32
    tie after the f64 rounding).
    """
    a64, b64 = a.double(), b.double()

    def comp(i, j):
        p = (a[:, j] * b[:, i]).double()
        return (a64[:, i] * b64[:, j] - p).float()

    return torch.stack([comp(1, 2), comp(2, 0), comp(0, 1)], dim=1)


def _finish_build(sv0, sv1, sv2, sid, k, pad, t) -> ClusterAccel:
    """Cluster AABBs + Baldwin-Weber rows over the ordered triangle arrays."""
    c = sv0.shape[0] // k
    lo = torch.minimum(torch.minimum(sv0, sv1), sv2).reshape(c, k, 3)
    hi = torch.maximum(torch.maximum(sv0, sv1), sv2).reshape(c, k, 3)
    if pad:
        valid = (sid >= 0).reshape(c, k, 1)
        lo = torch.where(valid, lo, torch.inf)
        hi = torch.where(valid, hi, -torch.inf)
    aabb_lo = lo.amin(dim=1)
    aabb_hi = hi.amax(dim=1)
    if pad:
        empty = (~valid).all(dim=1)[..., 0]
        aabb_lo = torch.where(empty[:, None], _PAD_POS, aabb_lo)
        aabb_hi = torch.where(empty[:, None], _PAD_POS, aabb_hi)

    # tri ids ride as float VALUES id + 1 (exact below 2^24)
    id_val = (sid + 1).to(torch.float32)[:, None]
    e1 = sv1 - sv0
    e2 = sv2 - sv0
    zeros = torch.zeros((sv0.shape[0], 1), dtype=torch.float32)

    def dot3(a, b):
        return ((a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1])
                + a[:, 2] * b[:, 2])[:, None]

    # Baldwin-Weber rows: n = e1 x e2, plane offset d, barycentric rows
    # r1 = (e2 x n)/|n|^2, r2 = (n x e1)/|n|^2 with offsets c1/c2.
    nrm = _cross_fma(e1, e2)
    dpl = dot3(nrm, sv0)
    det = dot3(nrm, nrm)
    inv_det = torch.where(det > 0, 1.0 / torch.where(det > 0, det, 1.0),
                          0.0)
    r1 = _cross_fma(e2, nrm) * inv_det
    c1 = -dot3(r1, sv0)
    r2 = _cross_fma(nrm, e1) * inv_det
    c2 = -dot3(r2, sv0)
    rows_bw = torch.cat([nrm, dpl, r1, c1, r2, c2, id_val, zeros, zeros,
                         zeros], dim=1)                     # [T, 16]
    bt = rows_bw.reshape(c, k, 16).transpose(1, 2).contiguous()
    return ClusterAccel(aabb_lo=aabb_lo, aabb_hi=aabb_hi, blocks_t=bt,
                        **derived_tables(bt))


def build_scene_clusters(scene):
    """Attach the sahsplit cluster accel (built on the host) to the scene."""
    tri = torch.arange(scene.n_tris, device=scene.device)
    v0, v1, v2 = scene.tri_vertices(tri)
    accel = build_clusters(v0, v1, v2)
    return scene.with_clusters(accel.to(scene.device))
