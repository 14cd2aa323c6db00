"""Cluster accel for packet traversal (counterpart of pathtracer/accel/cluster.py).

All six build methods of the JAX package run on the host:
`morton`, `median`, `sah`, `sahleaf`, `sahdeep` and `sahsplit` (the
default of build_scene_clusters: native SBVH leaves, Morton-ordered,
cluster count padded to a multiple of 128 with empty clusters), each
followed by `_finish_build`. build_scene_clusters attaches two accels,
`clusters` for occlusion calls and `clusters_fine` for closest-hit
calls (PT_COARSE_METHOD, PT_FINE_METHOD); by default both are one
sahsplit build.

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
import os

import numpy as np
import torch

from pathtracer_torch.accel import morton as morton_mod
from pathtracer_torch.utils import native

_PAD_POS = 1e30
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


def _choose_k(n_tris: int, max_clusters: int, min_k: int = 128) -> int:
    """Smallest power-of-two cluster size >= min_k with <= max_clusters."""
    k = min_k
    while (n_tris + k - 1) // k > max_clusters:
        k *= 2
    return k


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _fma(a, b, c):
    """fma(a, b, c) of f32 tensors: a * b is exact in f64, so the f64 sum
    rounded once to f32 is the fused result (up to a double rounding
    that needs an exact f32 tie after the f64 rounding)."""
    return (a.double() * b.double() + c.double()).float()


def _median_order(centroids, n_segments: int, axis_mode: str = "longest"):
    """Recursive median-split (k-d) ordering over equal-size segments
    (cluster.py:80-135): log2(n_segments) rounds, each sorting every
    segment along its split axis - the longest centroid extent, or
    (axis_mode "sa") the axis whose median cut gives the least summed
    child surface area. Pad centroids (1e30) sort to segment tails.

    The JAX package sorts on (segment id, coordinate) with a stable
    two-key lax.sort; segments are contiguous and equal-size, so a
    stable sort of each segment's row is the same permutation.
    """
    n = centroids.shape[0]
    levels = n_segments.bit_length() - 1
    order = torch.arange(n, dtype=torch.int64)

    def seg_sort(coord, order, nseg):
        idx = torch.sort(coord.reshape(nseg, -1), dim=1, stable=True).indices
        return torch.gather(order.reshape(nseg, -1), 1, idx).reshape(-1)

    def masked_extent(c, valid, rows):
        cs = c.reshape(rows, -1, 3)
        vs = valid.reshape(rows, -1, 1)
        lo = torch.where(vs, cs, torch.inf).amin(dim=1)
        hi = torch.where(vs, cs, -torch.inf).amax(dim=1)
        return torch.nan_to_num(hi - lo, neginf=0.0, posinf=0.0)

    def child_sa(ordered, nseg):
        """Summed child-box surface area per segment after a median cut;
        the JAX package's host XLA contracts the sum into two FMAs."""
        ca = centroids[ordered]
        e = masked_extent(ca, ca[:, 0] < 1e29, nseg * 2)
        sa = _fma(e[:, 0], e[:, 2], _fma(e[:, 0], e[:, 1],
                                         e[:, 1] * e[:, 2]))
        return sa.reshape(nseg, 2).sum(dim=1)

    for lvl in range(levels):
        nseg = 1 << lvl
        s = n // nseg
        c = centroids[order]
        valid = c[:, 0] < 1e29
        if axis_mode == "sa" and s >= 2:
            costs = [child_sa(seg_sort(torch.where(valid, c[:, a], torch.inf),
                                       order, nseg), nseg)
                     for a in range(3)]
            axis = torch.argmin(torch.stack(costs, dim=1), dim=1)
        else:
            axis = torch.argmax(masked_extent(c, valid, nseg), dim=1)
        ax_per = axis.repeat_interleave(s)
        coord = torch.gather(c, 1, ax_per[:, None])[:, 0]
        order = seg_sort(torch.where(valid, coord, torch.inf), order, nseg)
    return order


def _box_area(lo, hi):
    """Summed-face AABB surface-area proxy (numpy, broadcasting)."""
    e = np.maximum(hi - lo, 0.0)
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] \
        + e[..., 0] * e[..., 2]


def _binned_object_best(cen, lo_rows, hi_rows, n_bins):
    """Best binned-SAH object split over the 3 axes (cluster.py:154;
    native/pathtracer_native.cpp mirrors this cost model).

    cen/lo_rows/hi_rows: f32[n, 3] row centroids and row AABBs.
    Returns (cost, mask_left) or None (degenerate centroid box).
    """
    n = cen.shape[0]
    clo, chi = cen.min(axis=0), cen.max(axis=0)
    ext = chi - clo
    best = None
    for ax in range(3):
        if ext[ax] <= 0:
            continue
        b = np.minimum(((cen[:, ax] - clo[ax])
                        * (n_bins / ext[ax])).astype(np.int32),
                       n_bins - 1)
        cnt = np.bincount(b, minlength=n_bins)
        blo = np.full((n_bins, 3), np.inf, np.float32)
        bhi = np.full((n_bins, 3), -np.inf, np.float32)
        np.minimum.at(blo, b, lo_rows)
        np.maximum.at(bhi, b, hi_rows)
        plo = np.minimum.accumulate(blo, axis=0)
        phi = np.maximum.accumulate(bhi, axis=0)
        slo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
        shi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
        nl = np.cumsum(cnt)[:-1]
        nr = n - nl
        cost = (_box_area(plo[:-1], phi[:-1]) * nl
                + _box_area(slo[1:], shi[1:]) * nr)
        cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
        j = int(np.argmin(cost))
        if np.isfinite(cost[j]) and (best is None or cost[j] < best[0]):
            best = (float(cost[j]), b <= j)
    return best


def _sah_leaves(v0, v1, v2, k: int, n_bins: int = 16,
                deep_ratio: float = None):
    """Binned-SAH top-down leaf partition, numpy on the host
    (cluster.py:194): leaves of at most k triangles whose split follows
    the SAH minimum. deep_ratio (sahdeep): keep splitting below k while
    the children's areas sum to < deep_ratio x the parent's.

    Returns a list of int32 index arrays, one per leaf.
    """
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    cent = (v0 + v1 + v2) / 3.0
    tlo = np.minimum(np.minimum(v0, v1), v2)
    thi = np.maximum(np.maximum(v0, v1), v2)

    leaves = []
    stack = [np.arange(v0.shape[0], dtype=np.int32)]
    while stack:
        idx = stack.pop()
        n = idx.shape[0]
        small = n <= k
        if small and (deep_ratio is None or n < 32):
            leaves.append(idx)
            continue
        best = _binned_object_best(cent[idx], tlo[idx], thi[idx], n_bins)
        if best is None:
            if small:
                leaves.append(idx)
                continue
            stack.append(idx[: n // 2])      # degenerate: index halves
            stack.append(idx[n // 2:])
            continue
        _, left = best
        if small:
            # sub-k split: only where it shrinks summed leaf area
            li, ri = idx[left], idx[~left]
            pa = _box_area(tlo[idx].min(axis=0), thi[idx].max(axis=0))
            la = _box_area(tlo[li].min(axis=0), thi[li].max(axis=0))
            ra = _box_area(tlo[ri].min(axis=0), thi[ri].max(axis=0))
            if la + ra >= deep_ratio * pa:
                leaves.append(idx)
                continue
        stack.append(idx[left])
        stack.append(idx[~left])
    return leaves


def _sah_split_leaves(v0, v1, v2, k: int, n_bins: int = 16,
                      dup_budget: float = 1.5):
    """Binned-SAH leaves with spatial splits (SBVH-style), numpy on the
    host (cluster.py:257): the oracle of the native sahsplit build
    (utils/native.sah_split_build), run under PT_NATIVE_BUILD=0.

    At each node the binned object split competes with the best spatial
    split (uniform planes over the node box; a straddling triangle goes
    to both sides with its box clipped at the plane) by SAH cost, with
    duplication capped at dup_budget x T references. Returns (leaves of
    unique int32 ids, clipped-union leaf boxes lo/hi f32[L, 3]).
    """
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    t = v0.shape[0]
    tlo = np.minimum(np.minimum(v0, v1), v2)
    thi = np.maximum(np.maximum(v0, v1), v2)
    area = _box_area

    ref_tri = np.arange(t, dtype=np.int32)
    ref_lo = tlo.copy()
    ref_hi = thi.copy()
    budget = int(dup_budget * t)

    leaves = []
    stack = [np.arange(t, dtype=np.int64)]   # indices into ref arrays
    refs_total = t
    while stack:
        idx = stack.pop()
        n = idx.shape[0]
        if n <= k:
            leaves.append(idx)
            continue
        rlo, rhi = ref_lo[idx], ref_hi[idx]
        cen = (rlo + rhi) * 0.5
        nlo, nhi = rlo.min(axis=0), rhi.max(axis=0)
        obj = _binned_object_best(cen, rlo, rhi, n_bins)

        spa = None  # (cost, plane_x, axis)
        if refs_total < budget:
            nex = nhi - nlo
            for ax in range(3):
                if nex[ax] <= 0:
                    continue
                scale = n_bins / nex[ax]
                lob = np.clip(((rlo[:, ax] - nlo[ax]) * scale
                               ).astype(np.int32), 0, n_bins - 1)
                hib = np.clip(((rhi[:, ax] - nlo[ax]) * scale
                               ).astype(np.int32), 0, n_bins - 1)
                enter = np.bincount(lob, minlength=n_bins)
                exit_ = np.bincount(hib, minlength=n_bins)
                nl = np.cumsum(enter)[:-1]
                nr = n - np.cumsum(exit_)[:-1]
                blo = np.full((n_bins, 3), np.inf, np.float32)
                bhi = np.full((n_bins, 3), -np.inf, np.float32)
                for bb in range(n_bins):
                    inb = (lob <= bb) & (hib >= bb)
                    if not inb.any():
                        continue
                    lo_b = rlo[inb].copy()
                    hi_b = rhi[inb].copy()
                    lo_b[:, ax] = np.maximum(lo_b[:, ax],
                                             nlo[ax] + bb / scale)
                    hi_b[:, ax] = np.minimum(hi_b[:, ax],
                                             nlo[ax] + (bb + 1) / scale)
                    blo[bb] = np.minimum(blo[bb], lo_b.min(axis=0))
                    bhi[bb] = np.maximum(bhi[bb], hi_b.max(axis=0))
                plo = np.minimum.accumulate(blo, axis=0)
                phi = np.maximum.accumulate(bhi, axis=0)
                slo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
                shi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
                cost = (area(plo[:-1], phi[:-1]) * nl
                        + area(slo[1:], shi[1:]) * nr)
                cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
                j = int(np.argmin(cost))
                if np.isfinite(cost[j]) and (spa is None
                                             or cost[j] < spa[0]):
                    spa = (float(cost[j]), nlo[ax] + (j + 1) / scale, ax)

        if spa is not None and (obj is None or spa[0] < obj[0]):
            _, px, ax = spa
            go_l = ref_lo[idx, ax] < px
            go_r = ref_hi[idx, ax] > px
            on_plane = ~go_l & ~go_r            # degenerate: box == plane
            go_l |= on_plane
            both = go_l & go_r
            n_new = int(both.sum())
            commit = (go_l.sum() > 0 and go_r.sum() > 0
                      and refs_total + n_new <= budget)
            if commit:
                # straddlers: left keeps the ref clipped at px, right
                # gets a new clipped ref
                li = idx[go_l]
                new0 = ref_lo.shape[0]
                ref_tri = np.concatenate([ref_tri, ref_tri[idx[both]]])
                nl_ = ref_lo[idx[both]].copy()
                nl_[:, ax] = np.maximum(nl_[:, ax], px)
                nh_ = ref_hi[idx[both]].copy()
                ref_lo = np.concatenate([ref_lo, nl_])
                ref_hi = np.concatenate([ref_hi, nh_])
                ref_hi[idx[both], ax] = px       # clip left copies
                ri = np.concatenate([
                    idx[go_r & ~both],
                    np.arange(new0, new0 + n_new, dtype=np.int64)])
                refs_total += n_new
                stack.append(li)
                stack.append(ri)
                continue
            # budget blown or one-sided plane: fall back to object split

        if obj is None:
            stack.append(idx[: n // 2])
            stack.append(idx[n // 2:])
            continue
        left = obj[1]
        stack.append(idx[left])
        stack.append(idx[~left])

    # leaves hold ref indices: map to unique tri ids, with the clipped-box
    # union per leaf as the cluster box
    ids = [np.unique(ref_tri[leaf]).astype(np.int32) for leaf in leaves]
    leaf_lo = np.stack([ref_lo[leaf].min(axis=0) for leaf in leaves])
    leaf_hi = np.stack([ref_hi[leaf].max(axis=0) for leaf in leaves])
    return ids, leaf_lo, leaf_hi


METHODS = ("morton", "median", "sah", "sahleaf", "sahdeep", "sahsplit")


def build_clusters(v0, v1, v2, max_clusters: int = 512, min_k: int = 128,
                   method: str = "morton") -> ClusterAccel:
    """Cluster accel over triangles v0/v1/v2 f32[T, 3], built on the host
    (cluster.py:405-536).

    method: "morton" (Morton sort, fixed chunks of K), "median" / "sah"
    (recursive median splits on the longest axis / the least child
    area), "sahleaf" / "sahdeep" (binned-SAH leaves of at most min_k;
    sahdeep splits below min_k per PT_SAH_DEEP, default 0.8) or
    "sahsplit" (SAH leaves with spatial splits, duplication budget
    PT_SAH_DUP, default 1.5; native, or the numpy oracle under
    PT_NATIVE_BUILD=0). K is the smallest power of two >= min_k with at
    most max_clusters clusters for the fixed-size methods, min_k for the
    SAH ones, whose leaves are Morton-ordered by box centre and whose
    cluster count is padded to a multiple of 128 with empty clusters.
    """
    from pathtracer_torch import knobs

    if method not in METHODS:
        raise ValueError(f"build_clusters: method {method!r}, expected one "
                         f"of {', '.join(METHODS)}")
    v0, v1, v2 = (torch.as_tensor(a, dtype=torch.float32).cpu()
                  for a in (v0, v1, v2))
    t = v0.shape[0]
    if method in ("sahleaf", "sahdeep", "sahsplit"):
        return _build_sah(v0, v1, v2, min_k, method, knobs)

    k = _choose_k(t, max_clusters, min_k)
    # a tensor divisor: CUDA would multiply by a scalar's rounded reciprocal
    centroids = (v0 + v1 + v2) / torch.full_like(v0, 3.0)
    if method in ("median", "sah"):
        # pad first to (pow2 clusters) x k so segments stay equal-size
        c_pow2 = _next_pow2((t + k - 1) // k)
        pad_n = c_pow2 * k - t
        cent_p = torch.cat([centroids, torch.full((pad_n, 3), _PAD_POS)])
        order_p = _median_order(cent_p, c_pow2,
                                "sa" if method == "sah" else "longest")
        real = order_p < t
        sid = torch.where(real, order_p, -1)
        gather = torch.where(real, order_p, 0)
        sv0, sv1, sv2 = (torch.where(real[:, None], v[gather], _PAD_POS)
                         for v in (v0, v1, v2))
        return _finish_build(sv0, sv1, sv2, sid, k, pad_n, t)

    codes = morton_mod.morton_codes(centroids)
    order = torch.sort(codes, stable=True).indices
    pad = (-t) % k
    padv = torch.full((pad, 3), _PAD_POS)
    sv0, sv1, sv2 = (torch.cat([v[order], padv]) for v in (v0, v1, v2))
    sid = torch.cat([order, torch.full((pad,), -1, dtype=torch.int64)])
    return _finish_build(sv0, sv1, sv2, sid, k, pad, t)


def _build_sah(v0, v1, v2, k, method, knobs):
    """The SAH-leaf builds (sahleaf, sahdeep, sahsplit) at K = k."""
    a0, a1, a2 = v0.numpy(), v1.numpy(), v2.numpy()
    t = a0.shape[0]
    boxes = None
    if method == "sahsplit":
        dup = float(os.environ.get("PT_SAH_DUP") or DUP_BUDGET)
        if knobs.choice("PT_NATIVE_BUILD", "1", ("0", "1")) == "1":
            leaves, lo, hi = native.sah_split_build(a0, a1, a2, k,
                                                    dup_budget=dup)
        else:
            leaves, lo, hi = _sah_split_leaves(a0, a1, a2, k, dup_budget=dup)
        boxes = (lo, hi)
    else:
        deep = (float(os.environ.get("PT_SAH_DEEP") or 0.8)
                if method == "sahdeep" else None)
        leaves = _sah_leaves(a0, a1, a2, k, deep_ratio=deep)
    # Morton-order the leaves by box centre (the JAX build aligns spatial
    # siblings with its fetch groups this way; cluster.py:445-460)
    if boxes is not None:
        cen = (boxes[0] + boxes[1]) * 0.5
    else:
        cen = np.stack([
            (np.minimum(np.minimum(a0[leaf], a1[leaf]), a2[leaf]).min(0)
             + np.maximum(np.maximum(a0[leaf], a1[leaf]), a2[leaf]).max(0))
            * 0.5 for leaf in leaves])
    code = morton_mod.morton_codes(torch.from_numpy(cen)).numpy()
    lorder = np.argsort(code, kind="stable")
    leaves = [leaves[i] for i in lorder]
    # pad the cluster count to a 128 multiple with empty clusters
    c = -(-len(leaves) // 128) * 128
    order = np.full((c * k,), -1, np.int64)
    for i, leaf in enumerate(leaves):
        order[i * k: i * k + leaf.shape[0]] = leaf
    n_real = sum(leaf.shape[0] for leaf in leaves)   # > t for sahsplit
    sid = torch.from_numpy(order)
    gather = sid.clamp(min=0)
    real = (sid >= 0)[:, None]
    sv0, sv1, sv2 = (torch.where(real, v[gather], _PAD_POS)
                     for v in (v0, v1, v2))
    accel = _finish_build(sv0, sv1, sv2, sid, k, c * k - n_real, t)
    if boxes is None:
        return accel
    lo = np.full((c, 3), _PAD_POS, np.float32)
    hi = np.full((c, 3), _PAD_POS, np.float32)
    lo[: len(leaves)] = boxes[0][lorder]
    hi[: len(leaves)] = boxes[1][lorder]
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


def build_scene_clusters(scene, max_clusters: int = 2048,
                         method: str = "sahsplit"):
    """Attach the packet-traversal accels to the scene (cluster.py:594):
    `clusters` (occlusion calls) built with PT_COARSE_METHOD (default
    `method`) and `clusters_fine` (closest-hit calls) with
    PT_FINE_METHOD (default sahsplit); one accel serves both when the
    methods are equal. Built on the host, moved to the scene's device."""
    from pathtracer_torch import knobs

    fine = knobs.choice("PT_FINE_METHOD", "sahsplit", METHODS)
    coarse = knobs.choice("PT_COARSE_METHOD", method, METHODS)
    tri = torch.arange(scene.n_tris, device=scene.device)
    v0, v1, v2 = scene.tri_vertices(tri)
    accel = build_clusters(v0, v1, v2, max_clusters,
                           method=coarse).to(scene.device)
    if fine == coarse:
        return scene.with_clusters(accel, accel)
    return scene.with_clusters(accel, build_clusters(
        v0, v1, v2, max_clusters, method=fine).to(scene.device))
