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
its union box, and sub/mul/min/max round monotonically).

For CPU tensors each kernel runs its plain version (`tile_cull_plain`,
`tile_cull_skip_plain`); for CUDA tensors it launches csrc/cull.cu or
raises. Kernel and plain version agree bit for bit (sub, mul, min and
max only).
"""

from __future__ import annotations

import ctypes
import os

import torch

from pathtracer_torch.kernels import LAUNCHES, cuda_build

CULL_BLOCK = 256          # clusters per plain-cull block (bounds transients)
_PAIR_BUDGET = 1 << 22    # tiles x rays x clusters per plain-cull block
LANES = 128               # K4 pads the cluster count to a multiple of this
_FAR = 1e30               # far pad box (pallas_cull.py:183-189)


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


def tile_cull_skip_plain(aabb_lo, aabb_hi, o, inv_d, t_max, *, t_min,
                         n_tiles, tile_rays, blk, pair_tests=None):
    """Plain PyTorch K4: sc_mask_plain, then K1's arithmetic on the kept
    (tile, block) pairs and +inf on the gated ones.

    pair_tests: optional int64 0-d tensor, incremented by the (ray, box)
    slab tests K4 needs: per tile its unparked rays times (NB union boxes
    + the real clusters of its kept blocks).
    """
    c = aabb_lo.shape[0]
    mask = sc_mask_plain(aabb_lo, aabb_hi, o, inv_d, t_max, t_min=t_min,
                         n_tiles=n_tiles, tile_rays=tile_rays, blk=blk)
    out = torch.full((n_tiles, c), torch.inf, dtype=torch.float32,
                     device=o.device)
    if pair_tests is not None:
        real = (aabb_lo[:, 0] < 1e29).to(torch.int64)
        real = torch.cat([real, real.new_zeros((-c) % LANES)])
        real_blk = real.reshape(-1, blk).sum(dim=1)              # [NB]
        live = (o[:, 0] < 1e29).reshape(n_tiles, tile_rays).sum(dim=1)
        kept_real = (mask.to(torch.int64) * real_blk).sum(dim=1)  # [tiles]
        pair_tests += (live * (mask.shape[1] + kept_real)).sum()
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
    "pt_tile_cull_skip": [ctypes.c_void_p] * 7 + [
    ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3}


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


def tile_cull_skip(aabb_lo, aabb_hi, o, inv_d, t_max, *, t_min, n_tiles,
                   tile_rays, blk, mask_out=None):
    """K4: tile_tnear f32[n_tiles, C] (kernel on CUDA, plain on CPU).

    Needs gated(C, blk). mask_out: optional i32[n_tiles, NB] on o's
    device that receives the per-(tile, block) flags.
    """
    if not gated(aabb_lo.shape[0], blk):
        raise ValueError(f"tile_cull_skip: {aabb_lo.shape[0]} clusters do "
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
    c = aabb_lo.shape[0]
    ub_lo, ub_hi = union_boxes(aabb_lo, aabb_hi, blk)
    nb = ub_lo.shape[0]
    if mask_out is not None:
        _check("mask_out", mask_out, (n_tiles, nb), torch.int32, o.device)
    if n_tiles == 0:
        return out
    lib = cuda_build.load("cull", _SIG)
    rc = lib.pt_tile_cull_skip(
        aabb_lo.data_ptr(), aabb_hi.data_ptr(), ub_lo.data_ptr(),
        ub_hi.data_ptr(), o.data_ptr(), inv_d.data_ptr(), t_max.data_ptr(),
        float(t_min), n_tiles, c, tile_rays, blk, nb, out.data_ptr(),
        None if mask_out is None else mask_out.data_ptr(),
        cuda_build.stream_ptr(o.device))
    cuda_build.check_launch(rc, "tile_cull_skip")
    LAUNCHES["tile_cull_skip"] += 1
    return out
