"""K2's roofline: the work a closest-hit sweep chunk needs, against peaks.

A chunk is K2's inputs as the packet layer hands them over: a schedule
(st, si) [tiles, C], rays [tiles, 6, R], per-ray caps t_cap [tiles, R],
the accel and t_min. What it needs, whatever implements it:

  tests   for each live ray, every real triangle of every cluster whose
          box the ray enters (slab test over [t_min, t_end]) no later
          than its final hit t_end (the hit K2 returns, else its cap);
  FLOPs   32 a test: the Baldwin-Weber test as its plain expression
          (denominator 5, reciprocal 1, t 7, hit point 6, u 6, v 6,
          u + v 1), an FMA counted as its two operations;
  bytes   each ray read once (6 floats and its cap) and its answer
          written once (t, triangle, u, v), the schedule entries of the
          clusters some ray of the tile needs (8 bytes each), and the
          rows of each needed cluster's real triangles once (64 bytes a
          triangle).

The least time is the larger of FLOPs / peak FLOP/s and bytes / peak
bytes/s; the share is that over the time K2 takes on the chunk.
"""

from __future__ import annotations

import torch

FLOPS_PER_TEST = 32
RAY_BYTES = 7 * 4 + 4 * 4
SCHED_BYTES = 8
TRI_BYTES = 16 * 4
RAY_BLOCK = 8192


def real_triangles(blocks_lm):
    """Real triangles of each cluster [C] (lanes whose id row is > 0)."""
    return (blocks_lm[:, :, 12] > 0.5).sum(dim=1)


def chunk_work(st, si, rays, t_cap, aabb_lo, aabb_hi, n_real, t_end,
               t_min):
    """(FLOPs, bytes) chunk `rays` needs, t_end [tiles, R] each ray's
    final hit distance."""
    tiles, _, r = rays.shape
    o = rays[:, 0:3, :].transpose(1, 2).reshape(-1, 3)
    d = rays[:, 3:6, :].transpose(1, 2).reshape(-1, 3)
    t_end = t_end.reshape(-1)
    live = (o[:, 0] < 1e29) & (t_end > t_min)
    tests = torch.zeros((), dtype=torch.float64, device=o.device)
    need_any = torch.zeros(aabb_lo.shape[0], dtype=torch.bool,
                           device=o.device)
    sched = torch.zeros((), dtype=torch.float64, device=o.device)
    inv = torch.where(d.abs() > 1e-20, 1.0 / d, torch.copysign(
        torch.full_like(d, 1e20), d))
    for a in range(0, o.shape[0], RAY_BLOCK):
        b = min(o.shape[0], a + RAY_BLOCK)
        t1 = (aabb_lo[None] - o[a:b, None]) * inv[a:b, None]
        t2 = (aabb_hi[None] - o[a:b, None]) * inv[a:b, None]
        t_near = torch.clamp(torch.minimum(t1, t2).amax(dim=2), min=t_min)
        t_far = torch.maximum(t1, t2).amin(dim=2)
        need = (t_near <= t_far) & (t_near <= t_end[a:b, None]) \
            & live[a:b, None]
        tests += (need.double() @ n_real.double()).sum()
        need_any |= need.any(dim=0)
        # whole tiles only: RAY_BLOCK is a multiple of every tile width
        sched += need.reshape(-1, r, need.shape[1]).any(dim=1).sum()
    flops = float(tests) * FLOPS_PER_TEST
    nbytes = (float(live.sum()) * RAY_BYTES + float(sched) * SCHED_BYTES
              + float(n_real[need_any].sum()) * TRI_BYTES)
    return flops, nbytes


def replay(chunks, sweep_closest, reps: int = 3):
    """Time each captured chunk through K2 (CUDA events, after one warm
    launch) and count its work -> dict(flops, bytes, seconds, chunks)."""
    from ptbench.roofline import peaks

    flops = nbytes = seconds = bound = 0.0
    for st, si, rays, t_cap, accel, t_min in chunks:
        t, tri, _, _ = sweep_closest(st, si, rays, t_cap, accel, t_min)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            sweep_closest(st, si, rays, t_cap, accel, t_min)
        end.record()
        torch.cuda.synchronize()
        sec = start.elapsed_time(end) / 1e3 / reps
        t_end = torch.where(tri >= 0, t, t_cap)
        f, b = chunk_work(st, si, rays, t_cap, accel.aabb_lo, accel.aabb_hi,
                          real_triangles(accel.blocks_lm), t_end, t_min)
        flops += f
        nbytes += b
        seconds += sec
        bound += max(f / peaks.FP32_FLOPS, b / peaks.HBM_BYTES)
    return dict(flops=flops, bytes=nbytes, seconds=seconds, bound_s=bound,
                chunks=len(chunks))
