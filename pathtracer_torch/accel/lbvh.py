"""LBVH builder: Morton sort + Karras radix tree + threaded layout
(counterpart of pathtracer/accel/lbvh.py).

1. 30-bit Morton codes over triangle centroids (accel/morton.py).
2. Stable sort of the codes.
3. Karras 2012 binary radix tree: every internal node's range and split
   come from fixed-trip doubling and binary searches, all nodes at once.
4. Node boxes as range min/max over the sorted leaf boxes (a sparse-table
   RMQ: every node covers a contiguous leaf range).
5. Threaded DFS layout: sorting nodes by (range start asc, size desc) is
   the DFS preorder; a node's miss link is the first DFS node whose range
   starts after its range ends (a searchsorted), so traversal needs no
   stack (kernels/traverse.py).

Every step is vectorised on the tensors' device. The build uses integer
ops, min/max and one centroid division only, so its `Bvh` equals the JAX
package's bit for bit, on either device. Codes are u32 words in int64;
torch has no clz, so `_clz32` is a branch-free 32-bit count by shifts of
16/8/4/2/1 (not log2, which rounds above 2^24).
"""

from __future__ import annotations

import torch

from pathtracer_torch.accel import morton as morton_mod
from pathtracer_torch.scene.types import Bvh, Scene

_M32 = 0xFFFFFFFF
_TRIPS = 32     # the JAX build's fixed trip count for every search


def _clz32(x):
    """Leading zeros of u32 words in int64[...] (clz(0) = 32)."""
    x = x & _M32
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        z = (x >> (32 - s)) == 0
        n = n + z * s
        x = torch.where(z, (x << s) & _M32, x)
    return n + (x == 0)


def _delta(codes, i, j, n):
    """Karras delta(i, j): common-prefix length of the augmented keys.

    codes: sorted u32 codes int64[n]. Out-of-range j -> -1. Equal codes
    fall back to the leaf index bits (concat(code, index)): 32 + clz(i ^ j).
    """
    j_ok = (j >= 0) & (j < n)
    jc = j.clamp(0, n - 1)
    x = codes[i] ^ codes[jc]
    d = torch.where(x == 0, 32 + _clz32(i ^ jc), _clz32(x))
    return torch.where(j_ok, d, -1)


def _radix_tree_ranges(codes, n):
    """Ranges and splits of the n-1 internal nodes (Karras 2012, fig. 4).

    Returns (first, last, split) int64[n-1]: node i covers sorted leaves
    [first, last] and splits into [first, split], [split+1, last].
    """
    i = torch.arange(n - 1, dtype=torch.int64, device=codes.device)
    d = torch.sign(_delta(codes, i, i + 1, n) - _delta(codes, i, i - 1, n))
    delta_min = _delta(codes, i, i - d, n)

    # upper bound on the range length by doubling
    lmax = torch.full_like(i, 2)
    for _ in range(_TRIPS):
        grow = _delta(codes, i, i + lmax * d, n) > delta_min
        lmax = torch.where(grow, lmax * 2, lmax)

    # binary search of the exact length
    length = torch.zeros_like(i)
    t = lmax // 2
    for _ in range(_TRIPS):
        cand = length + t
        ok = (t > 0) & (_delta(codes, i, i + cand * d, n) > delta_min)
        length = torch.where(ok, cand, length)
        t = t // 2
    j = i + length * d

    # split: largest s with delta(i, i + s*d) > delta_node, replicating
    # `do { t = ceil(t/2) } while (t > 1)` with a mask
    delta_node = _delta(codes, i, j, n)
    s = torch.zeros_like(i)
    t = (length + 1) // 2
    cont = torch.ones_like(i, dtype=torch.bool)
    for _ in range(_TRIPS):
        cand = s + t
        ok = cont & (_delta(codes, i, i + cand * d, n) > delta_node)
        s = torch.where(ok, cand, s)
        cont = cont & (t > 1)
        t = (t + 1) // 2
    gamma = i + s * d + d.clamp(max=0)
    return torch.minimum(i, j), torch.maximum(i, j), gamma


def _range_aabb(leaf_lo, leaf_hi, first, last):
    """Boxes of contiguous leaf ranges by a sparse-table RMQ.

    leaf_lo/hi f32[n, 3] sorted leaf boxes; first/last int64[m].
    Returns (lo, hi) f32[m, 3].
    """
    n = leaf_lo.shape[0]
    levels_lo = [leaf_lo]
    levels_hi = [leaf_hi]
    span = 1
    ar = torch.arange(n, device=leaf_lo.device)
    while span * 2 <= n:
        shift = torch.clamp(ar + span, max=n - 1)
        levels_lo.append(torch.minimum(levels_lo[-1], levels_lo[-1][shift]))
        levels_hi.append(torch.maximum(levels_hi[-1], levels_hi[-1][shift]))
        span *= 2
    tab_lo = torch.stack(levels_lo)     # [L, n, 3]
    tab_hi = torch.stack(levels_hi)
    k = (31 - _clz32(last - first + 1)).clamp(0, len(levels_lo) - 1)
    right = last - (1 << k) + 1
    lo = torch.minimum(tab_lo[k, first], tab_lo[k, right])
    hi = torch.maximum(tab_hi[k, first], tab_hi[k, right])
    return lo, hi


def build_lbvh(v0, v1, v2) -> Bvh:
    """Threaded LBVH over triangles (v0, v1, v2: f32[T, 3]) on their
    device: 2T-1 nodes in DFS preorder, root at 0."""
    n = v0.shape[0]
    dev = v0.device
    i32 = torch.int32
    if n == 1:
        # degenerate single-leaf tree
        return Bvh(aabb_min=torch.minimum(torch.minimum(v0, v1), v2),
                   aabb_max=torch.maximum(torch.maximum(v0, v1), v2),
                   hit_link=torch.full((1,), -1, dtype=i32, device=dev),
                   miss_link=torch.full((1,), -1, dtype=i32, device=dev),
                   tri_id=torch.zeros((1,), dtype=i32, device=dev))

    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its rounded reciprocal, which moves some centroids by an ulp
    three = torch.full_like(v0, 3.0)
    codes = morton_mod.morton_codes((v0 + v1 + v2) / three)
    order = torch.argsort(codes, stable=True)
    codes = codes[order]
    leaf_lo = torch.minimum(torch.minimum(v0, v1), v2)[order]
    leaf_hi = torch.maximum(torch.maximum(v0, v1), v2)[order]

    first, last, _ = _radix_tree_ranges(codes, n)
    int_lo, int_hi = _range_aabb(leaf_lo, leaf_hi, first, last)

    # threaded DFS layout over all 2n-1 nodes: internal ranges
    # [first, last] (size >= 2), leaves [i, i]
    leaf_ids = torch.arange(n, dtype=torch.int64, device=dev)
    all_first = torch.cat([first, leaf_ids])
    all_last = torch.cat([last, leaf_ids])
    all_lo = torch.cat([int_lo, leaf_lo])
    all_hi = torch.cat([int_hi, leaf_hi])
    all_tri = torch.cat([torch.full((n - 1,), -1, dtype=torch.int64,
                                    device=dev), order])

    # DFS preorder == sort by (start asc, size desc): two stable sorts
    size = all_last - all_first + 1
    o1 = torch.argsort(-size, stable=True)
    o2 = torch.argsort(all_first[o1], stable=True)
    dfs = o1[o2]
    d_first = all_first[dfs].contiguous()
    d_last = all_last[dfs]

    # miss link: the first DFS node whose range starts at d_last + 1 (the
    # DFS successor outside the subtree); -1 where the subtree ends the
    # array
    n_nodes = 2 * n - 1
    succ = torch.searchsorted(d_first, (d_last + 1).contiguous(),
                              side="left")
    miss = torch.where(d_last + 1 >= n, -1, succ)
    miss = torch.where(miss >= n_nodes, -1, miss)

    d_tri = all_tri[dfs]
    nxt = torch.arange(1, n_nodes + 1, dtype=torch.int64, device=dev)
    hit = torch.where(d_tri >= 0, miss, torch.where(nxt >= n_nodes, -1, nxt))
    return Bvh(aabb_min=all_lo[dfs], aabb_max=all_hi[dfs],
               hit_link=hit.to(i32), miss_link=miss.to(i32),
               tri_id=d_tri.to(i32))


def build_scene_bvh(scene: Scene) -> Scene:
    """Attach an LBVH over the scene's triangles, built on its device."""
    v0, v1, v2 = scene.tri_vertices(
        torch.arange(scene.n_tris, device=scene.device))
    return scene.with_bvh(build_lbvh(v0, v1, v2))
