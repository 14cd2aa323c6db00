"""K1 tile cull and K4 block-gated cull (counterpart of pathtracer/kernels/pallas_cull.py).

`tile_cull` returns tile_tnear f32[n_tiles, C]: for each tile of
`tile_rays` consecutive rays and each cluster AABB, the minimum over the
tile's rays of the clamped entry distance max(tn, 0), over rays that
pass (tn <= tf) & (tf >= t_min) & (tn <= t_max); +inf where none does.

It reads PT_CULL_SKIP and PT_CULL_BLK on every call, as the JAX package
does (pallas_cull.py:163-174). Unset (the default), it runs K1. With
PT_CULL_SKIP=1 the clusters are padded to a multiple of 128 with far
boxes and, where Cp % blk == 0 and Cp // blk >= 2 (blk = PT_CULL_BLK,
default 128; pallas_cull.py:197), it runs K4: each (tile, block of blk
clusters) first tests the block's union box, and a block that no ray of
the tile enters is written +inf without its per-cluster slab tests.
Otherwise it runs K1. K4 equals K1 bit for bit (a child box lies inside
its union box, and sub/mul/min/max round monotonically). K4's kernel
also drops the rays that fail the root box (the union of every box) and
tests a kept block's clusters against the rays that pass its union box
only (`skip_ray_sets_plain`; the argument is in csrc/cull.cu). Its
union boxes are derived once per box table and blk (`union_table`).

For CPU tensors each kernel runs its plain version (`tile_cull_plain`,
`tile_cull_skip_plain`); for CUDA tensors it launches csrc/cull.cu or
raises. Kernel and plain version agree bit for bit (sub, mul, min and
max only).
"""

from __future__ import annotations

import ctypes
import os
import weakref

import torch

from pathtracer_torch.kernels import LAUNCHES, cuda_build

CULL_BLOCK = 256          # clusters per plain-cull block (bounds transients)
_PAIR_BUDGET = 1 << 22    # tiles x rays x clusters per plain-cull block
LANES = 128               # K4 pads the cluster count to a multiple of this
_FAR = 1e30               # far pad box (pallas_cull.py:183-189)
_SKIP_MAX_RAYS = 256      # K4's kernel: one thread a ray in a 256-thread CTA
_SKIP_MAX_SHMEM = 227 * 1024   # shared memory a CTA can have on an H100


def tile_cull_plain(aabb_lo, aabb_hi, o, inv_d, t_max, *, t_min, n_tiles,
                    tile_rays):
    """Plain PyTorch K1 (blocked over tiles and clusters)."""
    c = aabb_lo.shape[0]
    ot = o.reshape(n_tiles, tile_rays, 1, 3)
    it = inv_d.reshape(n_tiles, tile_rays, 1, 3)
    tmx = t_max.reshape(n_tiles, tile_rays, 1)
    out = torch.empty((n_tiles, c), dtype=torch.float32, device=o.device)
    tb = max(1, _PAIR_BUDGET // (tile_rays * CULL_BLOCK))
    for a in range(0, n_tiles, tb):
        for c0 in range(0, c, CULL_BLOCK):
            hit, t_near = _slab_hit(aabb_lo[c0:c0 + CULL_BLOCK],
                                    aabb_hi[c0:c0 + CULL_BLOCK],
                                    ot[a:a + tb], it[a:a + tb],
                                    tmx[a:a + tb], t_min)   # [tb, R, B]
            entry = torch.where(hit, torch.clamp(t_near, min=0.0),
                                torch.inf)
            out[a:a + tb, c0:c0 + CULL_BLOCK] = entry.amin(dim=1)
    return out


def gated(n_clusters: int, blk: int) -> bool:
    """Does K4 apply at this cluster count? (pallas_cull.py:197)"""
    cp = n_clusters + (-n_clusters) % LANES
    return cp % blk == 0 and cp // blk >= 2


def union_boxes(aabb_lo, aabb_hi, blk):
    """Union box of each block of blk clusters -> (lo, hi) f32[NB, 3].

    The clusters are first padded to a multiple of LANES with far boxes,
    as _tile_cull_impl pads them; a block holding pads reaches 1e30.
    """
    c = aabb_lo.shape[0]
    pad = (-c) % LANES
    if pad:
        far = aabb_lo.new_full((pad, 3), _FAR)
        aabb_lo = torch.cat([aabb_lo, far])
        aabb_hi = torch.cat([aabb_hi, far])
    nb = aabb_lo.shape[0] // blk
    return (aabb_lo.reshape(nb, blk, 3).amin(dim=1).contiguous(),
            aabb_hi.reshape(nb, blk, 3).amax(dim=1).contiguous())


# tables derived from tensors (K4's union boxes): (tag, ids) -> (weak
# refs, version counters, table)
_DERIVED = {}
_DERIVED_KEPT = 8


def derived(tensors, tag, make):
    """make() once per tag and tuple of tensors: the result is kept while
    every tensor is alive and unmodified (the same objects, with
    unchanged version counters), so a table derived from an accel's
    tensors is not rebuilt on each call that hands them over."""
    key = (tag,) + tuple(id(t) for t in tensors)
    versions = tuple(t._version for t in tensors)
    got = _DERIVED.get(key)
    if got is not None and got[1] == versions and all(
            ref() is t for ref, t in zip(got[0], tensors)):
        return got[2]
    value = make()
    _DERIVED.pop(key, None)
    while len(_DERIVED) >= _DERIVED_KEPT:
        _DERIVED.pop(next(iter(_DERIVED)))
    _DERIVED[key] = (tuple(weakref.ref(t) for t in tensors), versions, value)
    return value


def n_blocks(n_clusters: int, blk: int) -> int:
    """K4's block count NB: the clusters padded to a multiple of LANES,
    in blocks of blk."""
    return (n_clusters + (-n_clusters) % LANES) // blk


def union_table(aabb_lo, aabb_hi, blk):
    """K4's box table f32[NB + 1, 6] on the boxes' device: row b < NB is
    block b's union box (lo, hi) from union_boxes, row NB the root box
    (their union: every cluster and far pad lies in it).

    Derived once per box table and blk (`derived`), so the main path,
    which hands K4 its accel's aabb tensors on every call, runs no
    reductions per call.
    """
    def make():
        ulo, uhi = union_boxes(aabb_lo, aabb_hi, blk)
        root = torch.cat([ulo.amin(dim=0), uhi.amax(dim=0)])
        return torch.cat([torch.cat([ulo, uhi], dim=1),
                          root[None]]).contiguous()

    return derived((aabb_lo, aabb_hi), ("union", blk), make)


def _slab_hit(lo, hi, o, inv_d, t_max, t_min):
    """K1's slab test and accept test: (hit, tn); lo/hi broadcast against
    o/inv_d (..., 3) and t_max."""
    t1 = (lo - o) * inv_d
    t2 = (hi - o) * inv_d
    t_near = torch.minimum(t1, t2).amax(dim=-1)
    t_far = torch.maximum(t1, t2).amin(dim=-1)
    return (t_near <= t_far) & (t_far >= t_min) & (t_near <= t_max), t_near


def sc_mask_plain(aabb_lo, aabb_hi, o, inv_d, t_max, *, t_min, n_tiles,
                  tile_rays, blk):
    """Per-(tile, block) any-hit of the block's union box -> i32[tiles, NB].

    The counterpart of _sc_mask (pallas_cull.py:110): the same union
    boxes, slab arithmetic and accept test (NB real columns, no lane pad).
    """
    ulo, uhi = union_boxes(aabb_lo, aabb_hi, blk)
    ot = o.reshape(n_tiles, tile_rays, 1, 3)
    it = inv_d.reshape(n_tiles, tile_rays, 1, 3)
    tmx = t_max.reshape(n_tiles, tile_rays, 1)
    hit, _ = _slab_hit(ulo, uhi, ot, it, tmx, t_min)     # [tiles, R, NB]
    return hit.any(dim=1).to(torch.int32)


def skip_ray_sets_plain(aabb_lo, aabb_hi, o, inv_d, t_max, *, t_min,
                        n_tiles, tile_rays, blk):
    """The rays K4's kernel tests -> (live bool[tiles, R], passes
    bool[tiles, NB, R]).

    live: the rays that pass the root box, the union of every union box
    (row NB of union_table); the kernel drops the others before the gate.
    passes[t, b]: the live rays of tile t that pass block b's union box;
    block b is kept where any does, and the kernel tests its clusters
    against these rays only. Both drops are exact (a ray that fails a
    box fails every box inside it; csrc/cull.cu), so the rays outside
    these sets change neither tile_cull_skip_plain nor sc_mask_plain.
    """
    ulo, uhi = union_boxes(aabb_lo, aabb_hi, blk)
    live, _ = _slab_hit(ulo.amin(dim=0), uhi.amax(dim=0), o, inv_d, t_max,
                        t_min)                            # [n]
    live = live.reshape(n_tiles, tile_rays)
    hit, _ = _slab_hit(ulo, uhi, o.reshape(n_tiles, tile_rays, 1, 3),
                       inv_d.reshape(n_tiles, tile_rays, 1, 3),
                       t_max.reshape(n_tiles, tile_rays, 1), t_min)
    return live, hit.transpose(1, 2) & live[:, None, :]


def tile_cull_skip_plain(aabb_lo, aabb_hi, o, inv_d, t_max, *, t_min,
                         n_tiles, tile_rays, blk, pair_tests=None,
                         kernel_tests=None):
    """Plain PyTorch K4: sc_mask_plain, then K1's arithmetic on the kept
    (tile, block) pairs and +inf on the gated ones.

    pair_tests: optional int64 0-d tensor, incremented by the (ray, box)
    slab tests this call's data needs - the work a bound counts: the
    unparked rays (origin below 1e29) against the root box, the live
    ones among them (skip_ray_sets_plain) against the NB union boxes,
    and each kept block's passing unparked rays against its real
    clusters (pads excluded).
    kernel_tests: optional int64 0-d tensor, incremented by the tests the
    kernel runs: every ray against the root box, the live rays against
    the NB union boxes, and each kept block's passing rays against its
    clusters below C.
    """
    c = aabb_lo.shape[0]
    mask = sc_mask_plain(aabb_lo, aabb_hi, o, inv_d, t_max, t_min=t_min,
                         n_tiles=n_tiles, tile_rays=tile_rays, blk=blk)
    out = torch.full((n_tiles, c), torch.inf, dtype=torch.float32,
                     device=o.device)
    if pair_tests is not None or kernel_tests is not None:
        live, passes = skip_ray_sets_plain(
            aabb_lo, aabb_hi, o, inv_d, t_max, t_min=t_min, n_tiles=n_tiles,
            tile_rays=tile_rays, blk=blk)
        nb = mask.shape[1]
        pad = (-c) % LANES
        real = torch.cat([aabb_lo[:, 0] < 1e29, live.new_zeros(pad)])
        real_blk = real.reshape(nb, blk).sum(dim=1)               # [NB]
        below_c = torch.arange(c + pad, device=o.device) < c
        c_blk = below_c.reshape(nb, blk).sum(dim=1)
        unparked = (o[:, 0] < 1e29).reshape(n_tiles, tile_rays)
        if pair_tests is not None:
            pair_tests += (unparked.sum() + (unparked & live).sum() * nb
                           + ((passes & unparked[:, None, :]).sum(dim=2)
                              * real_blk).sum())
        if kernel_tests is not None:
            kernel_tests += (live.numel() + live.sum() * nb
                             + (passes.sum(dim=2) * c_blk).sum())
    ot = o.reshape(n_tiles, tile_rays, 1, 3)
    it = inv_d.reshape(n_tiles, tile_rays, 1, 3)
    tmx = t_max.reshape(n_tiles, tile_rays, 1)
    tb = max(1, _PAIR_BUDGET // (tile_rays * blk))
    for b in range(mask.shape[1]):
        c0, c1 = b * blk, min((b + 1) * blk, c)
        kept = torch.nonzero(mask[:, b]).flatten()
        for a in range(0, kept.numel() if c0 < c1 else 0, tb):
            tiles = kept[a:a + tb]
            hit, t_near = _slab_hit(aabb_lo[c0:c1], aabb_hi[c0:c1],
                                    ot[tiles], it[tiles], tmx[tiles], t_min)
            entry = torch.where(hit, torch.clamp(t_near, min=0.0),
                                torch.inf)
            out[tiles, c0:c1] = entry.amin(dim=1)
    return out


_SIG = {"pt_tile_cull": [ctypes.c_void_p] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p],
    "pt_tile_cull_skip": [ctypes.c_void_p] * 6 + [
    ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3,
    "pt_tile_cull_skip_info": [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4}


def _check(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def tile_cull(aabb_lo, aabb_hi, o, inv_d, t_max, *, t_min, n_tiles,
              tile_rays):
    """tile_tnear f32[n_tiles, C]: K4 where PT_CULL_SKIP=1 gates, else K1
    (kernel on CUDA, plain on CPU)."""
    blk = int(os.environ.get("PT_CULL_BLK", "128"))
    if os.environ.get("PT_CULL_SKIP", "0") != "0" \
            and gated(aabb_lo.shape[0], blk):
        return tile_cull_skip(aabb_lo, aabb_hi, o, inv_d, t_max, t_min=t_min,
                              n_tiles=n_tiles, tile_rays=tile_rays, blk=blk)
    if o.device.type == "cpu":
        return tile_cull_plain(aabb_lo, aabb_hi, o, inv_d, t_max,
                               t_min=t_min, n_tiles=n_tiles,
                               tile_rays=tile_rays)
    out = _checked_out(aabb_lo, aabb_hi, o, inv_d, t_max, n_tiles,
                       tile_rays)
    c = aabb_lo.shape[0]
    if n_tiles == 0 or c == 0:
        return out
    lib = cuda_build.load("cull", _SIG)
    rc = lib.pt_tile_cull(
        aabb_lo.data_ptr(), aabb_hi.data_ptr(), o.data_ptr(),
        inv_d.data_ptr(), t_max.data_ptr(), float(t_min), n_tiles, c,
        tile_rays, out.data_ptr(), cuda_build.stream_ptr(o.device))
    cuda_build.check_launch(rc, "tile_cull")
    LAUNCHES["tile_cull"] += 1
    return out


def _checked_out(aabb_lo, aabb_hi, o, inv_d, t_max, n_tiles, tile_rays):
    """Check a CUDA call's arguments; allocate its f32[n_tiles, C] output."""
    if o.device.type != "cuda":
        raise ValueError(f"tile_cull: unsupported device {o.device}")
    dev = o.device
    c = aabb_lo.shape[0]
    n = n_tiles * tile_rays
    f32 = torch.float32
    _check("aabb_lo", aabb_lo, (c, 3), f32, dev)
    _check("aabb_hi", aabb_hi, (c, 3), f32, dev)
    _check("o", o, (n, 3), f32, dev)
    _check("inv_d", inv_d, (n, 3), f32, dev)
    _check("t_max", t_max, (n,), f32, dev)
    return torch.empty((n_tiles, c), dtype=f32, device=dev)


def _skip_shmem(tile_rays, nb):
    """Shared memory of one K4 CTA (csrc/cull.cu skip_shmem_bytes)."""
    return 32 * tile_rays + 4 * nb * (-(-tile_rays // 32) + 2) + 4 * 8


def tile_cull_skip(aabb_lo, aabb_hi, o, inv_d, t_max, *, t_min, n_tiles,
                   tile_rays, blk, mask_out=None):
    """K4: tile_tnear f32[n_tiles, C] (kernel on CUDA, plain on CPU).

    Needs gated(C, blk). mask_out: optional i32[n_tiles, NB] on o's
    device that receives the per-(tile, block) flags. On the card a tile
    holds at most 256 rays, and NB x ceil(R / 32) pass words
    must fit a CTA's shared memory; beyond either it raises.
    """
    c = aabb_lo.shape[0]
    if not gated(c, blk):
        raise ValueError(f"tile_cull_skip: {c} clusters do "
                         f"not make >= 2 whole blocks of {blk}")
    if o.device.type == "cpu":
        if mask_out is not None:
            mask_out.copy_(sc_mask_plain(aabb_lo, aabb_hi, o, inv_d, t_max,
                                         t_min=t_min, n_tiles=n_tiles,
                                         tile_rays=tile_rays, blk=blk))
        return tile_cull_skip_plain(aabb_lo, aabb_hi, o, inv_d, t_max,
                                    t_min=t_min, n_tiles=n_tiles,
                                    tile_rays=tile_rays, blk=blk)
    out = _checked_out(aabb_lo, aabb_hi, o, inv_d, t_max, n_tiles,
                       tile_rays)
    nb = n_blocks(c, blk)
    if mask_out is not None:
        _check("mask_out", mask_out, (n_tiles, nb), torch.int32, o.device)
    if tile_rays > _SKIP_MAX_RAYS:
        raise ValueError(f"tile_cull_skip: {tile_rays} rays a tile; the "
                         f"kernel takes at most {_SKIP_MAX_RAYS}")
    if _skip_shmem(tile_rays, nb) > _SKIP_MAX_SHMEM:
        raise ValueError(f"tile_cull_skip: {nb} blocks of {blk} clusters "
                         "need more shared memory than a CTA has; use a "
                         "larger PT_CULL_BLK")
    if n_tiles == 0:
        return out
    table = union_table(aabb_lo, aabb_hi, blk)
    lib = cuda_build.load("cull", _SIG)
    rc = lib.pt_tile_cull_skip(
        aabb_lo.data_ptr(), aabb_hi.data_ptr(), table.data_ptr(),
        o.data_ptr(), inv_d.data_ptr(), t_max.data_ptr(), float(t_min),
        n_tiles, c, tile_rays, blk, nb, out.data_ptr(),
        None if mask_out is None else mask_out.data_ptr(),
        cuda_build.stream_ptr(o.device))
    cuda_build.check_launch(rc, "tile_cull_skip")
    LAUNCHES["tile_cull_skip"] += 1
    return out


def kernel_info(tile_rays=64, nb=22):
    """Registers and local (spill) bytes a thread, threads a CTA, resident
    CTAs and the occupancy (resident warps / 64) an SM of K4 for
    tile_rays rays a tile and nb union boxes, from the CUDA runtime
    (needs a card; the build's ptxas report is
    cuda_build.build_logs["cull"])."""
    lib = cuda_build.load("cull", _SIG)
    vals = [ctypes.c_int(0) for _ in range(4)]
    rc = lib.pt_tile_cull_skip_info(tile_rays, nb,
                                    *(ctypes.byref(v) for v in vals))
    cuda_build.check_launch(rc, "tile_cull_skip kernel_info")
    regs, local, blocks, threads = (v.value for v in vals)
    return dict(registers=regs, local_bytes=local, threads=threads,
                blocks_per_sm=blocks, occupancy=blocks * threads / 32 / 64)

