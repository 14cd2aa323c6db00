"""K2 closest sweep and K3/K3b occlusion sweeps (counterpart of pathtracer/kernels/pallas_sweep.py).

Both walk each tile's near-to-far cluster schedule st/si [tiles, Cs]
and test the tile's rays against the clusters' Baldwin-Weber rows
blocks_t [C, 16, K] (accel/cluster.py):

  sweep_closest(st, si, rays[tiles, 6, R], t_cap, accel, t_min)
      -> (t, tri, u, v) [tiles, R]: nearest hit with t_min < t < best_t,
         best_t seeded from the scene-exit cap t_cap; a tile stops when
         st[j] >= max(best_t) over its rays.
  sweep_occluded(st, si, rays, t_max_rays, accel) -> blocked i32:
      any front-facing hit with 0 < t < t_max; a tile stops when every
      ray is blocked or settled (t_max <= 0: it can never be blocked) or
      the schedule reaches +inf.
  sweep_occluded(..., want_blocker=True) -> (blocked, btri i32) (K3b):
      btri is -1 where open, else the triangle of the blocking lane with
      the smallest t (lowest lane on a tie) in the first schedule column
      where the ray became blocked.

On the card K2 runs in two launches (csrc/sweep.cu): pass A walks each
tile up to RESUME_COLUMNS columns and lists the tiles still walking
there; pass B, beside pass A's last CTAs, finishes those on clusters of
RESUME_CTAS CTAs, that many columns a round - the same hits bit for bit.

t_min must be >= 0 (the kernels reject lanes on the sign of t before
the reciprocal). The wrappers take the ClusterAccel: for CPU tensors
they run the plain versions on its blocks_t; for CUDA tensors they
launch csrc/sweep.cu on its lane tables n_lanes and blocks_lm (built
once with the accel, accel/cluster.py) or raise. The plain versions
take blocks_t, as the JAX functions do, and run all
tiles in lockstep, one schedule column at a time, with each tile masked
once its own stop rule fires - the same per-ray update sequence as the
kernels, so the two agree hit for hit (the kernels are built with
-fmad=false).
"""

from __future__ import annotations

import ctypes

import torch

from pathtracer_torch.kernels import LAUNCHES, cuda_build
from pathtracer_torch.kernels.intersect import DET_EPS

_PAIR_BUDGET = 1 << 22      # tiles x rays x lanes per plain-sweep block
_STOP_CHECK = 8             # columns between host checks of "any tile live"
_WARP = 32                  # rays a warp of the kernels tests together
TILE_WIDTHS = (32, 64, 128, 256)   # rays a tile the kernels take
_BLOCK_THREADS = 256        # threads a block at R >= 64 (kMaxThreads)
# K2's two passes (csrc/sweep.cu): pass A walks each tile up to
# RESUME_COLUMNS columns, pass B finishes the walks still going there on
# clusters of RESUME_CTAS CTAs (the kernel's kResumeCtas), RESUME_CTAS
# columns a round
RESUME_COLUMNS = 48
RESUME_CTAS = 4


def parts(tile_rays: int) -> int:
    """Threads a ray, over interleaved lanes (sweep_column.cuh parts()):
    4 at 32 and 64 rays a tile, 2 at 128, 1 at 256."""
    return min(4, _BLOCK_THREADS // tile_rays)


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


def bw_hit(rows, o, d, t_min, t_max, front_only=False):
    """One Baldwin-Weber test per ray against its own triangle rows
    [N, 12], with the sweeps' arithmetic -> (t, u, v, ok) [N]; t_max is
    a scalar or per ray. front_only: also require a front-facing hit
    (denom < 0), the occlusion sweeps' policy."""
    if isinstance(t_max, torch.Tensor):
        t_max = t_max.reshape(-1, 1, 1)
    blk = rows[:, :, None]
    t, u, v, denom = _bw_lane(
        blk, tuple(o[:, i, None, None] for i in range(3)),
        tuple(d[:, i, None, None] for i in range(3)), t_min, t_max)
    t, u, v = t[:, 0, 0], u[:, 0, 0], v[:, 0, 0]
    ok = torch.isfinite(t)
    if front_only:
        ok = ok & (denom[:, 0, 0] < 0.0)
    return t, u, v, ok


def _tile_block(tile_rays, k):
    return max(1, _PAIR_BUDGET // (tile_rays * k))


def _count_column(live, can_hit, blk, kernel_tests, tile_columns, a, b,
                  hit=None):
    """Add one column of tiles a:b to tile_columns (the tiles that visit
    it) and kernel_tests (the lane tests the kernels run there, see
    sweep_closest_plain). can_hit [tb, R]: rays whose thread enters the
    lane loop; hit [tb, R, K] (K3): lanes that block, where a thread
    stops."""
    if tile_columns is not None:
        tile_columns[a:b] += live
    if kernel_tests is None:
        return
    tb, r = can_hit.shape
    k = blk.shape[2]
    lane = torch.arange(1, k + 1, device=blk.device)
    n_lanes = torch.where(blk[:, 12, :] > 0, lane, 0).amax(dim=1)   # [tb]
    p = parts(r)
    q = torch.arange(p, device=blk.device)
    # thread (ray, part q) tests lanes q, q + p, ... < n_lanes
    its = ((n_lanes[:, None] - q + p - 1) // p).clamp(min=0)
    its = its[:, None, :].expand(tb, r, p)                     # [tb, R, p]
    if hit is not None:                 # up to and with its first hit
        hq = torch.nn.functional.pad(hit, (0, -k % p))
        hq = hq.reshape(tb, r, -1, p)                           # lane i*p+q
        first = torch.argmax(hq.to(torch.uint8), dim=2) + 1
        its = torch.where(hq.any(dim=2), first, its)
    its = its * (live[:, None] & can_hit)[..., None]
    # a warp holds one part of _WARP rays and runs as long as its longest
    warp = its.reshape(tb, r // _WARP, _WARP, p).amax(dim=2)
    kernel_tests += warp.sum() * _WARP


def sweep_closest_plain(st, si, rays, t_cap, blocks_t, t_min,
                        pair_tests=None, kernel_tests=None,
                        tile_columns=None):
    """Plain PyTorch K2 (lockstep over tiles, blocked to bound memory).

    pair_tests: optional int64 0-d tensor, incremented by the (ray,
    triangle) tests this call's data needs - the work a bound counts: in
    each column the stop rule lets a tile visit, every ray whose best t
    still lies beyond the column's entry, against each real triangle of
    the cluster (pad lanes excluded).
    kernel_tests: optional int64 0-d tensor, incremented by the lane
    tests the kernel runs: a warp holds one of a ray's parts(R) threads
    for _WARP rays, each thread tests every parts(R)-th lane below the
    cluster's n_lanes if its ray has best t > t_min, and the warp
    iterates as long as its longest thread (x _WARP lane slots).
    tile_columns: optional int64 [tiles] tensor, incremented by the
    columns each tile visits (its sequential walk; their sum x R x K
    counts a kernel that tests every lane of every visited column).
    """
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
            _count_column(live, best_t > t_min, blk, kernel_tests,
                          tile_columns, a, b)
            if pair_tests is not None:
                need = live[:, None] & (st[a:b, j, None] < best_t)
                pair_tests += (need.sum(1)
                               * (blk[:, 12, :] > 0.5).sum(1)).sum()
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


def sweep_occluded_plain(st, si, rays, t_max_rays, blocks_t,
                         want_blocker=False, pair_tests=None,
                         kernel_tests=None, tile_columns=None):
    """Plain PyTorch K3 / K3b (lockstep over tiles, blocked to bound
    memory). A tile walks while it holds an open ray - not blocked, with
    t_max > 0 (a ray with t_max <= 0 can never be blocked) - and the
    schedule is finite. pair_tests as in sweep_closest_plain, for the
    open rays: K3 needs a cluster's real triangles up to the first
    blocking one, K3b all of them (its rule takes the nearest).
    kernel_tests and tile_columns as in sweep_closest_plain, with the
    open rays' threads in the lane loop; a K3 thread stops at its first
    blocking lane."""
    tiles, cs = st.shape
    r = rays.shape[2]
    k = blocks_t.shape[2]
    dev = st.device
    out = torch.zeros((tiles, r), dtype=torch.bool, device=dev)
    out_btri = torch.full((tiles, r), -1, dtype=torch.int32, device=dev)
    tb = _tile_block(r, k)
    for a in range(0, tiles, tb):
        b = min(tiles, a + tb)
        o = tuple(rays[a:b, i, :, None] for i in range(3))
        d = tuple(rays[a:b, i, :, None] for i in range(3, 6))
        tm = t_max_rays[a:b, :, None]
        can_block = tm[..., 0] > 0.0
        blocked = out[a:b]
        btri = out_btri[a:b]
        live = torch.ones(b - a, dtype=torch.bool, device=dev)
        for j in range(cs):
            open_ = ~blocked & can_block
            live = live & (st[a:b, j] < torch.inf) & open_.any(dim=1)
            if j % _STOP_CHECK == 0 and not bool(live.any()):
                break
            blk = blocks_t[si[a:b, j].long()]
            t, _, _, denom = _bw_lane(blk, o, d, 0.0, torch.inf)
            hit = torch.isfinite(t) & (denom < 0.0) & (t < tm)
            _count_column(live, open_, blk, kernel_tests, tile_columns, a, b,
                          None if want_blocker else hit)
            newly = hit.any(dim=2) & live[:, None]
            if pair_tests is not None:
                real = blk[:, 12, :] > 0.5                    # [tb, K]
                n_real = real.sum(1, keepdim=True)
                per = n_real.expand(-1, r)
                if not want_blocker:   # up to the first blocking lane
                    first = torch.argmax(hit.to(torch.uint8), dim=2)
                    per = torch.where(hit.any(dim=2), torch.gather(
                        torch.cumsum(real, 1), 1, first), per)
                need = live[:, None] & open_
                pair_tests += (need * per).sum()
            if want_blocker:
                # first minimum of t over the hit lanes: lowest lane on ties
                _, jj = torch.min(torch.where(hit, t, torch.inf), dim=2)
                tid = torch.round(blk[:, 12, :]).to(torch.int32) - 1
                btri.copy_(torch.where(newly & ~blocked,
                                       torch.gather(tid, 1, jj), btri))
            blocked |= newly
    out = out.to(torch.int32)
    return (out, out_btri) if want_blocker else out


_SIG = {
    "pt_sweep_closest": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p],
    "pt_sweep_occluded": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    "pt_sweep_occluded_blocker": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p],
    "pt_sweep_info": [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
}
_KINDS = ("sweep_closest", "sweep_occluded", "sweep_occluded_blocker",
          "sweep_resume")


def _check_inputs(st, si, rays, per_ray, accel):
    """Validate a CUDA launch's inputs -> (tiles, cs, r, k)."""
    dev = st.device
    tiles, cs = st.shape
    r = rays.shape[2] if rays.dim() == 3 else -1
    c, k, _ = accel.blocks_lm.shape
    want = [("st", st, (tiles, cs), torch.float32),
            ("si", si, (tiles, cs), torch.int32),
            ("rays", rays, (tiles, 6, r), torch.float32),
            ("per-ray bound", per_ray, (tiles, r), torch.float32),
            ("n_lanes", accel.n_lanes, (c,), torch.int32),
            ("blocks_lm", accel.blocks_lm, (c, k, 16), torch.float32)]
    for name, t, shape, dtype in want:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"sweep {name}: want contiguous {dtype} {shape} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if r not in TILE_WIDTHS:
        raise ValueError(f"sweep: tile_rays {r} must be one of "
                         f"{', '.join(map(str, TILE_WIDTHS))} (blocks of at "
                         "most 256 threads: four a ray up to 64 rays, two "
                         "at 128, one at 256)")
    return tiles, cs, r, k


def sweep_closest(st, si, rays, t_cap, accel, t_min):
    """K2: (t, tri, u, v) [tiles, R] (kernel on CUDA, plain on CPU)."""
    if not t_min >= 0.0:
        raise ValueError(f"sweep_closest: t_min {t_min} must be >= 0 (the "
                         "kernel rejects lanes on the sign of t)")
    if st.device.type == "cpu":
        return sweep_closest_plain(st, si, rays, t_cap, accel.blocks_t,
                                   t_min)
    if st.device.type != "cuda":
        raise ValueError(f"sweep_closest: unsupported device {st.device}")
    return _closest_cuda(st, si, rays, t_cap, accel, t_min,
                         RESUME_COLUMNS)[0]


def _closest_cuda(st, si, rays, t_cap, accel, t_min, columns):
    """K2's two launches -> ((t, tri, u, v), resume): resume
    i32[tiles + 3], csrc/sweep.cu's list: the count of tiles pass B
    resumed, two counters, then tile + 1 of each in the order pass A
    listed them (None when no walk can pass `columns`: pass A alone)."""
    tiles, cs, r, k = _check_inputs(st, si, rays, t_cap, accel)
    dev = st.device
    out_t = torch.empty((tiles, r), dtype=torch.float32, device=dev)
    out_tri = torch.empty((tiles, r), dtype=torch.int32, device=dev)
    out_u = torch.empty_like(out_t)
    out_v = torch.empty_like(out_t)
    if tiles == 0:
        return (out_t, out_tri, out_u, out_v), None
    resume = (torch.empty(tiles + 3, dtype=torch.int32, device=dev)
              if columns < cs else None)
    lib = cuda_build.load("sweep", _SIG)
    rc = lib.pt_sweep_closest(
        st.data_ptr(), si.data_ptr(), tiles, cs, rays.data_ptr(),
        t_cap.data_ptr(), accel.blocks_lm.data_ptr(),
        accel.n_lanes.data_ptr(), k, r, float(t_min), columns,
        0 if resume is None else resume.data_ptr(), out_t.data_ptr(),
        out_tri.data_ptr(), out_u.data_ptr(), out_v.data_ptr(),
        cuda_build.stream_ptr(dev))
    cuda_build.check_launch(rc, "sweep_closest")
    LAUNCHES["sweep_closest"] += 1
    return (out_t, out_tri, out_u, out_v), resume


def sweep_closest_resumed(st, si, rays, t_cap, accel, t_min,
                          columns=RESUME_COLUMNS):
    """K2 on CUDA tensors with pass B's engagement -> (t, tri, u, v,
    resumed): resumed i64, the sorted tiles pass B finished (a host
    sync). columns sets pass A's budget for a measurement; sweep_closest
    runs RESUME_COLUMNS."""
    out, resume = _closest_cuda(st, si, rays, t_cap, accel, t_min, columns)
    if resume is None:
        return out + (torch.zeros(0, dtype=torch.int64, device=st.device),)
    n = int(resume[0])
    return out + (torch.sort(resume[3:3 + n].long() - 1).values,)


def sweep_occluded(st, si, rays, t_max_rays, accel, want_blocker=False):
    """K3: blocked i32[tiles, R]; K3b (want_blocker): (blocked, btri).

    The CUDA kernels for CUDA tensors, the plain version for CPU ones.
    """
    if st.device.type == "cpu":
        return sweep_occluded_plain(st, si, rays, t_max_rays,
                                    accel.blocks_t, want_blocker)
    if st.device.type != "cuda":
        raise ValueError(f"sweep_occluded: unsupported device {st.device}")
    tiles, cs, r, k = _check_inputs(st, si, rays, t_max_rays, accel)
    dev = st.device
    out = torch.empty((tiles, r), dtype=torch.int32, device=dev)
    btri = torch.empty_like(out) if want_blocker else None
    if tiles == 0:
        return (out, btri) if want_blocker else out
    lib = cuda_build.load("sweep", _SIG)
    args = (st.data_ptr(), si.data_ptr(), tiles, cs, rays.data_ptr(),
            t_max_rays.data_ptr(), accel.blocks_lm.data_ptr(),
            accel.n_lanes.data_ptr(), k, r, out.data_ptr())
    if want_blocker:
        rc = lib.pt_sweep_occluded_blocker(*args, btri.data_ptr(),
                                           cuda_build.stream_ptr(dev))
        cuda_build.check_launch(rc, "sweep_occluded_blocker")
        LAUNCHES["sweep_occluded_blocker"] += 1
        return out, btri
    rc = lib.pt_sweep_occluded(*args, cuda_build.stream_ptr(dev))
    cuda_build.check_launch(rc, "sweep_occluded")
    LAUNCHES["sweep_occluded"] += 1
    return out


def kernel_info(name, tile_rays=64, k=128):
    """Registers and local (spill) bytes a thread, threads a block,
    resident blocks and the occupancy (resident warps / 64) an SM of
    sweep kernel `name` for tile_rays rays a tile and K lanes, from the
    CUDA runtime (needs a card; the build's ptxas report is
    cuda_build.build_logs["sweep"]). "sweep_resume" is K2's pass B, on
    clusters of RESUME_CTAS CTAs; its `clusters`, the most its grid takes."""
    lib = cuda_build.load("sweep", _SIG)
    vals = [ctypes.c_int(0) for _ in range(5)]
    rc = lib.pt_sweep_info(_KINDS.index(name), tile_rays, k,
                           *(ctypes.byref(v) for v in vals))
    cuda_build.check_launch(rc, f"kernel_info({name})")
    regs, local, blocks, threads, groups = (v.value for v in vals)
    info = dict(registers=regs, local_bytes=local, threads=threads,
                blocks_per_sm=blocks, occupancy=blocks * threads / 32 / 64)
    if name == "sweep_resume":
        info["clusters"] = groups
    return info
