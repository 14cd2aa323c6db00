"""Auditable packet metrics for the bench output (counterpart of pathtracer/bench/pair_metrics.py).

Computed on the benched scene's real bounce-1 batch (cosine-scattered
from true primary hits), from exact schedule and stop data:

  tile_visited_cols_mean  columns a tile's sweep visits (schedule entries
                          in front of its slowest ray's stop)
  ray_needed_cols_mean    columns each ray needs by itself
  packet_waste            visited / needed: the overshoot of sweeping a
                          tile's rays together

and the cost model they imply at the card's own rate:

  sweep_pairs_g           (ray, triangle) pairs the visited columns hold
                          (cols x PT_TILE_RAYS x K)
  sweep_us_per_iter       K2's cost of one column a tile on this card,
                          measured live on K2 itself (bench/sweep_attrib
                          .us_per_col: sweep_closest on P3's synthetic
                          schedule at cpi 1, dt / dcols) when the scene
                          is on a card; None on the CPU
  sweep_model_ms          visited columns x that cost: what K2 should take
                          for the batch (None on the CPU)
  sweep_gpairs_per_s      the pair rate the model implies (None on the CPU)

K2 takes one cluster a column, so cpi is 1. The counts are data
products of the schedule and the stop rule: K1 is bit-exact against
its plain version, so a card and the CPU count the same on one batch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pathtracer_torch.bench import sweep_attrib
from pathtracer_torch.integrator import camera as cam_mod
from pathtracer_torch.kernels import packet
from pathtracer_torch.sampling import rng as rng_mod
from pathtracer_torch.utils import vmath

_NEED_BLOCK = 512      # tiles a block of the needed-columns count


def bounce1_batch(scene, cfg, camera, max_rays: int = 1 << 21):
    """The bounce-1 batch (o2, d2) f32[n, 3] of the first min(W*H,
    max_rays) pixels (whole tiles), sample 0: rays leaving each primary
    hit in a cosine-weighted direction; misses are parked."""
    accel = scene.clusters
    dev = scene.device
    w, h = cfg.width, cfg.height
    tile_rays = packet.tile_rays_knob()
    n = min(w * h, max_rays) // tile_rays * tile_rays
    cs = camera.state(device=dev) if hasattr(camera, "state") else camera
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    samp = torch.zeros(n, dtype=torch.int64, device=dev)
    o, d = cam_mod.generate_primary_rays(cs, w, h, cfg.fov_deg, pix, samp,
                                         0)
    o = o.contiguous()            # the camera's origin, broadcast
    hit = packet.intersect_clusters(accel, o, d, 1e-3, 1e20,
                                    sort_rays=False)
    live = torch.isfinite(hit.t)
    tri = torch.clamp(hit.tri, min=0)
    v0, v1, v2 = scene.tri_vertices(tri)
    gn = vmath.normalize(vmath.cross(v1 - v0, v2 - v0))
    gn = torch.where((gn * d).sum(dim=-1, keepdim=True) > 0, -gn, gn)
    p = o + hit.t[:, None] * d
    u1, u2 = rng_mod.uniform2(pix, samp, 7, 0, 0)
    t_, b_ = vmath.onb(gn)
    r = torch.sqrt(u1)
    phi = 2 * math.pi * u2
    local = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                         torch.sqrt(torch.clamp(1 - u1, min=0.0))], dim=-1)
    d2 = vmath.normalize(local[:, 0:1] * t_ + local[:, 1:2] * b_
                         + local[:, 2:3] * gn)
    o2 = torch.where(live[:, None], p + gn * 1e-3,
                     torch.full_like(p, 1e30))
    d2 = torch.where(live[:, None], d2,
                     torch.tensor([[0.0, 0.0, 1.0]], device=dev))
    return o2, d2


def schedule_and_stops(accel, o2, d2):
    """The batch (o2, d2) [n, 3] (n a multiple of PT_TILE_RAYS) as the closest
    call orders it: coherence sort (2 direction bits), K1 cull, per-tile
    schedule -> (st f32[tiles, C], best f32[tiles, R]: each ray's stop,
    its hit or the scene exit, live bool[tiles, R]: rays not parked)."""
    tile_rays = packet.tile_rays_knob()
    n = o2.shape[0]
    n_tiles = n // tile_rays
    t_max = torch.full((n,), 1e20, dtype=torch.float32, device=o2.device)
    _, o_s, d_s, t_max = packet._coherence_sort(accel, o2, d2, t_max, 2)
    _, st, _, _ = packet._chunk_schedule(accel, o_s, d_s, t_max, 1e-3,
                                         tile_rays, "ray", 1)
    hit = packet.intersect_clusters(accel, o_s, d_s, 1e-3, 1e20,
                                    sort_rays=False)
    cap = packet._scene_exit(accel, o_s, d_s, t_max)
    best = torch.minimum(torch.where(torch.isfinite(hit.t), hit.t,
                                     torch.inf), cap)
    live = (o_s[:, 0] < 1e29).reshape(n_tiles, tile_rays)
    return st, best.reshape(n_tiles, tile_rays), live


def count_columns(st, best, live):
    """Per tile the columns it visits (schedule entries in front of its
    slowest live ray's stop) and per ray the columns it needs (entries in
    front of its own stop): numpy (vis i64[tiles], need i64[tiles, R],
    tile_live bool[tiles], live bool[tiles, R]), 0 where not live."""
    n_tiles = st.shape[0]
    tile_live = live.any(dim=1)
    slowest = torch.where(live, best, 0.0).amax(dim=1, keepdim=True)
    vis = (st < slowest).sum(dim=1)
    need = torch.cat([
        (st[a:a + _NEED_BLOCK, None, :]
         < best[a:a + _NEED_BLOCK, :, None]).sum(dim=2)
        for a in range(0, n_tiles, _NEED_BLOCK)]) if n_tiles else \
        torch.zeros_like(best, dtype=torch.int64)
    vis = torch.where(tile_live, vis, 0)
    need = torch.where(live, need, 0)
    return tuple(x.cpu().numpy() for x in (vis, need, tile_live, live))


def schedule_stats(accel, o2, d2):
    """count_columns on the batch (o2, d2) as the closest call orders it."""
    return count_columns(*schedule_and_stops(accel, o2, d2))


def pair_metrics(vis, need, tile_live, live, k, us_per_col=None):
    """The JSON-ready dict from schedule_stats' arrays; the model fields
    are None without a measured us_per_col."""
    vis = vis[tile_live]
    need = need[live]
    if vis.size == 0 or need.size == 0:
        return {"error": "no live rays in bounce-1 batch"}
    tile_rays = packet.tile_rays_knob()
    visited_mean = float(vis.mean())
    needed_mean = float(need.mean())
    # per-ray columns the packet actually pays, amortized over live rays
    per_ray_paid = float(vis.sum()) * tile_rays / max(1, need.size)
    waste = per_ray_paid / max(1e-9, needed_mean)
    cpi = 1                        # K2 tests one cluster a column
    iters = float(np.ceil(vis / cpi).sum())
    pairs = float(vis.sum()) * tile_rays * k
    model_ms = gpairs = None
    if us_per_col is not None:
        model_ms = round(iters * us_per_col * 1e-3, 1)
        gpairs = round(pairs / (iters * us_per_col * 1e-6) / 1e9, 1)
    return {
        "rays_probed": int(need.size),
        "tile_visited_cols_mean": round(visited_mean, 1),
        "ray_needed_cols_mean": round(needed_mean, 1),
        "packet_waste": round(waste, 2),
        "sweep_pairs_g": round(pairs / 1e9, 2),
        "sweep_model_ms": model_ms,
        "sweep_gpairs_per_s": gpairs,
        "sweep_us_per_iter": us_per_col,
        "cpi": cpi,
        "tris_per_cluster": int(k),
    }


def bounce1_pair_metrics(scene, cfg, camera, max_rays: int = 1 << 21):
    """Exact visited/needed column stats on the real bounce-1 batch and,
    on a card, the cost model at the rate K2 runs there and then
    (sweep_attrib.us_per_col)."""
    o2, d2 = bounce1_batch(scene, cfg, camera, max_rays)
    stats = schedule_stats(scene.clusters, o2, d2)
    rate = None
    if scene.device.type == "cuda":
        rate = sweep_attrib.us_per_col(scene.device)
    return pair_metrics(*stats, scene.clusters.tris_per_cluster, rate)
