"""K1 tile cull (counterpart of pathtracer/kernels/pallas_cull.py).

`tile_cull` returns tile_tnear f32[n_tiles, C]: for each tile of
`tile_rays` consecutive rays and each cluster AABB, the minimum over the
tile's rays of the clamped entry distance max(tn, 0), over rays that
pass (tn <= tf) & (tf >= t_min) & (tn <= t_max); +inf where none does.

For CPU tensors it runs `tile_cull_plain`; for CUDA tensors it launches
the kernel in csrc/cull.cu or raises. The two agree bit for bit (sub,
mul, min and max only).
"""

from __future__ import annotations

import ctypes

import torch

from pathtracer_torch.kernels import LAUNCHES, cuda_build

CULL_BLOCK = 256          # clusters per plain-cull block (bounds transients)
_PAIR_BUDGET = 1 << 22    # tiles x rays x clusters per plain-cull block


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
            lo = aabb_lo[c0:c0 + CULL_BLOCK]
            hi = aabb_hi[c0:c0 + CULL_BLOCK]
            t1 = (lo - ot[a:a + tb]) * it[a:a + tb]     # [tb, R, B, 3]
            t2 = (hi - ot[a:a + tb]) * it[a:a + tb]
            t_near = torch.minimum(t1, t2).amax(dim=-1)
            t_far = torch.maximum(t1, t2).amin(dim=-1)
            hit = ((t_near <= t_far) & (t_far >= t_min)
                   & (t_near <= tmx[a:a + tb]))
            entry = torch.where(hit, torch.clamp(t_near, min=0.0),
                                torch.inf)
            out[a:a + tb, c0:c0 + CULL_BLOCK] = entry.amin(dim=1)
    return out


_SIG = {"pt_tile_cull": [ctypes.c_void_p] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p]}


def _check(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def tile_cull(aabb_lo, aabb_hi, o, inv_d, t_max, *, t_min, n_tiles,
              tile_rays):
    """K1: tile_tnear f32[n_tiles, C] (kernel on CUDA, plain on CPU)."""
    if o.device.type == "cpu":
        return tile_cull_plain(aabb_lo, aabb_hi, o, inv_d, t_max,
                               t_min=t_min, n_tiles=n_tiles,
                               tile_rays=tile_rays)
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
    out = torch.empty((n_tiles, c), dtype=f32, device=dev)
    if n_tiles == 0 or c == 0:
        return out
    lib = cuda_build.load("cull", _SIG)
    rc = lib.pt_tile_cull(
        aabb_lo.data_ptr(), aabb_hi.data_ptr(), o.data_ptr(),
        inv_d.data_ptr(), t_max.data_ptr(), float(t_min), n_tiles, c,
        tile_rays, out.data_ptr(), cuda_build.stream_ptr(dev))
    cuda_build.check_launch(rc, "tile_cull")
    LAUNCHES["tile_cull"] += 1
    return out
