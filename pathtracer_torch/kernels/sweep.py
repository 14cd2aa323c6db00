"""K2 closest sweep and K3 occlusion sweep (counterpart of pathtracer/kernels/pallas_sweep.py).

Both walk each tile's near-to-far cluster schedule st/si [tiles, Cs]
and test the tile's rays against the clusters' Baldwin-Weber rows
blocks_t [C, 16, K] (accel/cluster.py):

  sweep_closest(st, si, rays[tiles, 6, R], t_cap, blocks_t, t_min)
      -> (t, tri, u, v) [tiles, R]: nearest hit with t_min < t < best_t,
         best_t seeded from the scene-exit cap t_cap; a tile stops when
         st[j] >= max(best_t) over its rays.
  sweep_occluded(st, si, rays, t_max_rays, blocks_t) -> blocked i32:
      any front-facing hit with 0 < t < t_max; a tile stops when every
      ray is blocked or the schedule reaches +inf.

For CPU tensors the wrappers run the plain versions; for CUDA tensors
they launch csrc/sweep.cu or raise. The plain versions run all tiles in
lockstep, one schedule column at a time, with each tile masked once its
own stop rule fires - the same per-ray update sequence as the kernel, so
the two agree hit for hit (the kernel is built with -fmad=false).
"""

from __future__ import annotations

import ctypes

import torch

from pathtracer_torch.kernels import LAUNCHES, cuda_build
from pathtracer_torch.kernels.intersect import DET_EPS

_PAIR_BUDGET = 1 << 22      # tiles x rays x lanes per plain-sweep block
_STOP_CHECK = 8             # columns between host checks of "any tile live"


def _bw_lane(blk, o, d, t_min, best_t):
    """Dense Baldwin-Weber test: blk f32[tb, 16, K], o/d 3-tuples of [tb, R, 1].

    Returns (t, u, v, denom) each [tb, R, K]; t = +inf where no valid
    hit with t_min < t < best_t (best_t [tb, R, 1] or a scalar).
    """
    ox, oy, oz = o
    dx, dy, dz = d
    row = [blk[:, i, None, :] for i in range(12)]           # [tb, 1, K]
    nx, ny, nz, dpl, r1x, r1y, r1z, c1, r2x, r2y, r2z, c2 = row
    denom = dx * nx + dy * ny + dz * nz
    ok_det = denom.abs() > DET_EPS
    inv = torch.where(ok_det, torch.reciprocal(denom), 0.0)
    t = (dpl - (ox * nx + oy * ny + oz * nz)) * inv
    hx = ox + t * dx
    hy = oy + t * dy
    hz = oz + t * dz
    u = r1x * hx + r1y * hy + r1z * hz + c1
    v = r2x * hx + r2y * hy + r2z * hz + c2
    ok = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > t_min) & (t < best_t))
    return torch.where(ok, t, torch.inf), u, v, denom


def _tile_block(tile_rays, k):
    return max(1, _PAIR_BUDGET // (tile_rays * k))


def sweep_closest_plain(st, si, rays, t_cap, blocks_t, t_min):
    """Plain PyTorch K2 (lockstep over tiles, blocked to bound memory)."""
    tiles, cs = st.shape
    r = rays.shape[2]
    k = blocks_t.shape[2]
    dev = st.device
    out_t = t_cap.clone()
    out_tri = torch.full((tiles, r), -1, dtype=torch.int32, device=dev)
    out_u = torch.zeros((tiles, r), dtype=torch.float32, device=dev)
    out_v = torch.zeros_like(out_u)
    tb = _tile_block(r, k)
    for a in range(0, tiles, tb):
        b = min(tiles, a + tb)
        o = tuple(rays[a:b, i, :, None] for i in range(3))
        d = tuple(rays[a:b, i, :, None] for i in range(3, 6))
        best_t = out_t[a:b]
        best_tri = out_tri[a:b]
        best_u = out_u[a:b]
        best_v = out_v[a:b]
        live = torch.ones(b - a, dtype=torch.bool, device=dev)
        for j in range(cs):
            live = live & (st[a:b, j] < best_t.amax(dim=1))
            if j % _STOP_CHECK == 0 and not bool(live.any()):
                break
            blk = blocks_t[si[a:b, j].long()]                 # [tb, 16, K]
            t, u, v, _ = _bw_lane(blk, o, d, t_min, best_t[:, :, None])
            tid = torch.round(blk[:, 12, :]).to(torch.int32) - 1   # [tb, K]
            tj, jj = torch.min(t, dim=2)                      # first minimum
            uj = torch.gather(u, 2, jj[..., None])[..., 0]
            vj = torch.gather(v, 2, jj[..., None])[..., 0]
            idj = torch.gather(tid, 1, jj)
            better = (live[:, None] & (tj < best_t) & torch.isfinite(tj)
                      & (idj >= 0))
            best_t.copy_(torch.where(better, tj, best_t))
            best_tri.copy_(torch.where(better, idj, best_tri))
            best_u.copy_(torch.where(better, uj, best_u))
            best_v.copy_(torch.where(better, vj, best_v))
    return out_t, out_tri, out_u, out_v


def sweep_occluded_plain(st, si, rays, t_max_rays, blocks_t):
    """Plain PyTorch K3 (lockstep over tiles, blocked to bound memory)."""
    tiles, cs = st.shape
    r = rays.shape[2]
    k = blocks_t.shape[2]
    dev = st.device
    out = torch.zeros((tiles, r), dtype=torch.bool, device=dev)
    tb = _tile_block(r, k)
    for a in range(0, tiles, tb):
        b = min(tiles, a + tb)
        o = tuple(rays[a:b, i, :, None] for i in range(3))
        d = tuple(rays[a:b, i, :, None] for i in range(3, 6))
        tm = t_max_rays[a:b, :, None]
        blocked = out[a:b]
        live = torch.ones(b - a, dtype=torch.bool, device=dev)
        for j in range(cs):
            live = live & (st[a:b, j] < torch.inf) \
                & (~blocked).any(dim=1)
            if j % _STOP_CHECK == 0 and not bool(live.any()):
                break
            blk = blocks_t[si[a:b, j].long()]
            t, _, _, denom = _bw_lane(blk, o, d, 0.0, torch.inf)
            hit = torch.isfinite(t) & (denom < 0.0) & (t < tm)
            blocked |= hit.any(dim=2) & live[:, None]
    return out.to(torch.int32)


_SIG = {
    "pt_sweep_closest": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    "pt_sweep_occluded": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
}


def _check_inputs(st, si, rays, per_ray, blocks_t):
    dev = st.device
    tiles, cs = st.shape
    r = rays.shape[2] if rays.dim() == 3 else -1
    c, rows, k = blocks_t.shape
    want = [("st", st, (tiles, cs), torch.float32),
            ("si", si, (tiles, cs), torch.int32),
            ("rays", rays, (tiles, 6, r), torch.float32),
            ("per-ray bound", per_ray, (tiles, r), torch.float32),
            ("blocks_t", blocks_t, (c, 16, k), torch.float32)]
    for name, t, shape, dtype in want:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"sweep {name}: want contiguous {dtype} {shape} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if r % 32 or not 0 < r <= 1024:
        raise ValueError(f"sweep: tile_rays {r} must be a multiple of 32 "
                         "in [32, 1024] (one thread per ray)")
    return tiles, cs, r, k


def sweep_closest(st, si, rays, t_cap, blocks_t, t_min):
    """K2: (t, tri, u, v) [tiles, R] (kernel on CUDA, plain on CPU)."""
    if st.device.type == "cpu":
        return sweep_closest_plain(st, si, rays, t_cap, blocks_t, t_min)
    if st.device.type != "cuda":
        raise ValueError(f"sweep_closest: unsupported device {st.device}")
    tiles, cs, r, k = _check_inputs(st, si, rays, t_cap, blocks_t)
    dev = st.device
    out_t = torch.empty((tiles, r), dtype=torch.float32, device=dev)
    out_tri = torch.empty((tiles, r), dtype=torch.int32, device=dev)
    out_u = torch.empty_like(out_t)
    out_v = torch.empty_like(out_t)
    if tiles == 0:
        return out_t, out_tri, out_u, out_v
    lib = cuda_build.load("sweep", _SIG)
    rc = lib.pt_sweep_closest(
        st.data_ptr(), si.data_ptr(), tiles, cs, rays.data_ptr(),
        t_cap.data_ptr(), blocks_t.data_ptr(), k, r, float(t_min),
        out_t.data_ptr(), out_tri.data_ptr(), out_u.data_ptr(),
        out_v.data_ptr(), cuda_build.stream_ptr(dev))
    cuda_build.check_launch(rc, "sweep_closest")
    LAUNCHES["sweep_closest"] += 1
    return out_t, out_tri, out_u, out_v


def sweep_occluded(st, si, rays, t_max_rays, blocks_t):
    """K3: blocked i32[tiles, R] (kernel on CUDA, plain on CPU)."""
    if st.device.type == "cpu":
        return sweep_occluded_plain(st, si, rays, t_max_rays, blocks_t)
    if st.device.type != "cuda":
        raise ValueError(f"sweep_occluded: unsupported device {st.device}")
    tiles, cs, r, k = _check_inputs(st, si, rays, t_max_rays, blocks_t)
    dev = st.device
    out = torch.empty((tiles, r), dtype=torch.int32, device=dev)
    if tiles == 0:
        return out
    lib = cuda_build.load("sweep", _SIG)
    rc = lib.pt_sweep_occluded(
        st.data_ptr(), si.data_ptr(), tiles, cs, rays.data_ptr(),
        t_max_rays.data_ptr(), blocks_t.data_ptr(), k, r, out.data_ptr(),
        cuda_build.stream_ptr(dev))
    cuda_build.check_launch(rc, "sweep_occluded")
    LAUNCHES["sweep_occluded"] += 1
    return out
