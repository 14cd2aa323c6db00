"""Packet (tile) traversal over the cluster accel (counterpart of pathtracer/kernels/packet.py).

Per traversal call:
1. coherence key (direction bins major, origin Morton minor; parked
   lanes last) and one stable sort of the whole wavefront - primary rays
   skip it, they arrive in swizzled 8x8 pixel-block order;
2. pad to whole tiles with parked rays, then chunks of CHUNK_TILES tiles;
   chunks whose lanes are all parked are skipped (one host sync per call
   reads every chunk's flag);
3. per live chunk: K1 tile cull -> per-tile schedule sort (near to far)
   -> K2 closest sweep or K3 occlusion sweep, with best_t seeded from
   the per-ray scene-exit cap;
4. unsort by scattering through the inverse permutation.

backend "pallas" runs the kernels of cull.py / sweep.py (CUDA kernels
for CUDA tensors, their plain versions on the CPU); backend "xla" runs
the plain lockstep sweep of the JAX package (packet.py:680-827), which
tests CLUSTERS_PER_ITER columns per iteration with Moller-Trumbore on the
[C, K, 12] blocks.
"""

from __future__ import annotations

import torch

from pathtracer_torch.accel import morton as morton_mod
from pathtracer_torch.kernels import cull, sweep
from pathtracer_torch.kernels.intersect import DET_EPS, Hit
from pathtracer_torch.utils import vmath

TILE_RAYS = 64            # rays per tile (packet width)
CHUNK_TILES = 2048        # tiles per launch = the dead-chunk skip granule
CLUSTERS_PER_ITER = 2     # lockstep ("xla") sweep columns per iteration

# Pad lanes are PARKED rays: origin at _PARK, unit direction, t_max 0.
_PARK = 1e30
_PAD_VALUES = (_PARK, 1.0, 0.0)


def _safe_inv(d):
    tiny = 1e-20
    d_safe = torch.where(d.abs() < tiny,
                         torch.where(d < 0, -tiny, tiny), d)
    return torch.reciprocal(d_safe)


def _scene_box(accel):
    finite = (accel.aabb_lo[:, 0] < 1e29)[:, None]
    lo = torch.where(finite, accel.aabb_lo, torch.inf).amin(dim=0)
    hi = torch.where(finite, accel.aabb_hi, -torch.inf).amax(dim=0)
    return lo, hi


def _coherence_key(accel, o, d, dir_bits: int):
    """u32 key (in int64): direction bin major, origin Morton minor."""
    lo, hi = _scene_box(accel)
    if dir_bits <= 1:
        dbin = ((d[:, 0] > 0).to(torch.int64)
                + 2 * (d[:, 1] > 0).to(torch.int64)
                + 4 * (d[:, 2] > 0).to(torch.int64))
    else:
        levels = float(torch.tensor((1 << dir_bits) - 1e-3,
                                    dtype=torch.float32))
        q = torch.clamp((d * 0.5 + 0.5) * levels, 0,
                        (1 << dir_bits) - 1).to(torch.int64)
        dbin = ((q[:, 0] << (2 * dir_bits)) | (q[:, 1] << dir_bits)
                | q[:, 2])
    db = 3 * dir_bits
    m = morton_mod.morton_codes(o, lo=lo, hi=hi)      # 30-bit
    key = (dbin << (32 - db)) | (m >> (db - 2))
    return torch.where(o[:, 0] >= 1e29, 0xFFFFFFFF, key)


def _scene_exit(accel, o, d, t_max):
    """Per-ray exit distance from the scene box (caps best_t)."""
    lo, hi = _scene_box(accel)
    inv_d = _safe_inv(d)
    t1 = (lo - o) * inv_d
    t2 = (hi - o) * inv_d
    t_far = torch.maximum(t1, t2).amin(dim=-1)
    return torch.minimum(torch.clamp(t_far * 1.0001 + 1e-3, min=0.0), t_max)


def _sorted_schedule(tile_tnear, cpi):
    """Sort each tile's clusters near to far, padded to a cpi multiple.

    Returns (st f32, si i32) [tiles, C']; unvisited entries are +inf with
    id 0 (a harmless re-test of cluster 0).
    """
    tiles, c = tile_tnear.shape
    pad = (-c) % cpi
    if pad:
        tile_tnear = torch.cat(
            [tile_tnear, torch.full((tiles, pad), torch.inf,
                                    device=tile_tnear.device)], dim=1)
    st, si = torch.sort(tile_tnear, dim=1, stable=True)
    si = torch.where(torch.isfinite(st), si, 0).to(torch.int32)
    return st.contiguous(), si.contiguous()


def _pad_rays(rays, n, multiple):
    pad = (-n) % multiple
    if pad:
        rays = tuple(
            torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]),
                                     _PAD_VALUES[i], dtype=a.dtype,
                                     device=a.device)])
            for i, a in enumerate(rays))
    return rays, n + pad


def chunk_live(o, chunk_rays):
    """Per chunk of `chunk_rays` lanes: is ANY lane not parked? (one sync)"""
    live = o[:, 0] < 1e29
    pad = (-live.shape[0]) % chunk_rays
    if pad:
        live = torch.cat([live, live.new_zeros(pad)])
    return live.reshape(-1, chunk_rays).any(dim=1).tolist()


def _chunk_map(fn, rays, n, tile_rays, chunk_rays, dead):
    """Apply fn to each live chunk of whole tiles; dead(m) fills the rest."""
    rays, total = _pad_rays(rays, n, tile_rays)
    outs = []
    for ci, live in enumerate(chunk_live(rays[0], chunk_rays)):
        part = tuple(a[ci * chunk_rays:(ci + 1) * chunk_rays] for a in rays)
        outs.append(fn(part) if live else dead(part[0].shape[0]))
    return tuple(torch.cat(x)[:n] for x in zip(*outs))


def _per_ray(t_max, o):
    return torch.as_tensor(t_max, dtype=torch.float32,
                           device=o.device).expand(o.shape[0]).contiguous()


def _coherence_sort(accel, o, d, t_max, dir_bits):
    order = torch.sort(_coherence_key(accel, o, d, dir_bits),
                       stable=True).indices
    return order, o[order], d[order], t_max[order]


def _unsort(order, x):
    out = torch.empty_like(x)
    out[order] = x
    return out


def _tile_rays6(o, d, n_tiles, tile_rays):
    """[n, 3] origins and directions -> rays f32[tiles, 6, R]."""
    return torch.cat([o.reshape(n_tiles, tile_rays, 3),
                      d.reshape(n_tiles, tile_rays, 3)],
                     dim=2).transpose(1, 2).contiguous()


# --- the lockstep ("xla") sweep, packet.py:521-599 and 680-827 -----------

def _fetch_blocks(accel, cids):
    """Gather + flatten CPI cluster blocks per tile: [tiles, CPI*K, 12]."""
    blk = accel.blocks[cids.long()]
    s = blk.shape
    return blk.reshape(s[0], s[1] * s[2], s[3])


def _mt_test(block, o, d):
    """Moller-Trumbore of [tiles, R] rays against [tiles, Kc] block rows."""
    v0 = block[:, None, :, 0:3]
    e1 = block[:, None, :, 3:6]
    e2 = block[:, None, :, 6:9]
    ob = o[:, :, None, :]
    db = d[:, :, None, :]
    pvec = vmath.cross(db, e2)
    det = vmath.dot(e1, pvec)
    ok_det = det.abs() > DET_EPS
    inv_det = torch.where(ok_det, torch.reciprocal(det), 0.0)
    tvec = ob - v0
    u = vmath.dot(tvec, pvec) * inv_det
    qvec = vmath.cross(tvec, e1)
    v = vmath.dot(db, qvec) * inv_det
    t = vmath.dot(e2, qvec) * inv_det
    ok = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, ok, e1, e2, db


def _mt_closest(block, o, d, t_min, t_max):
    t, u, v, ok, *_ = _mt_test(block, o, d)
    ok = ok & (t > t_min) & (t < t_max[:, :, None])
    t = torch.where(ok, t, torch.inf)
    tid = torch.round(block[:, :, 9]).to(torch.int32) - 1    # [tiles, Kc]
    tj, j = torch.min(t, dim=-1)
    uj = torch.gather(u, 2, j[..., None])[..., 0]
    vj = torch.gather(v, 2, j[..., None])[..., 0]
    idj = torch.gather(tid, 1, j)
    idj = torch.where(torch.isfinite(tj), idj, -1)
    return tj, uj, vj, idj


def _mt_any_front(block, o, d, t_max):
    t, _, _, ok, e1, e2, db = _mt_test(block, o, d)
    front = vmath.dot(db, vmath.cross(e1, e2)) < 0.0
    ok = ok & (t > 0.0) & (t < t_max[:, :, None]) & front
    return ok.any(dim=-1)


def _lockstep_closest(accel, st, si, ot, dt, t_cap, t_min, cpi):
    n_cols = st.shape[1]
    best_t = t_cap.clone()
    best_tri = torch.full_like(t_cap, -1, dtype=torch.int32)
    best_u = torch.zeros_like(t_cap)
    best_v = torch.zeros_like(t_cap)
    j = 0
    while j < n_cols and bool((st[:, j] < best_t.amax(dim=1)).any()):
        block = _fetch_blocks(accel, si[:, j:j + cpi])
        t, u, v, tri = _mt_closest(block, ot, dt, t_min, best_t)
        better = (t < best_t) & (tri >= 0)
        best_t = torch.where(better, t, best_t)
        best_tri = torch.where(better, tri, best_tri)
        best_u = torch.where(better, u, best_u)
        best_v = torch.where(better, v, best_v)
        j += cpi
    return best_t, best_tri, best_u, best_v


def _lockstep_occluded(accel, st, si, ot, dt, tm, cpi):
    n_cols = st.shape[1]
    blocked = torch.zeros_like(tm, dtype=torch.bool)
    j = 0
    while j < n_cols:
        live = (st[:, j] < torch.inf) & (~blocked).any(dim=1)
        if not bool(live.any()):
            break
        block = _fetch_blocks(accel, si[:, j:j + cpi])
        newly = _mt_any_front(block, ot, dt, tm)
        blocked = blocked | (newly & live[:, None])
        j += cpi
    return blocked


# --- per-chunk bodies ----------------------------------------------------

def _closest_chunk(accel, o, d, t_max, t_min, tile_rays, cpi, backend):
    n = o.shape[0]
    n_tiles = n // tile_rays
    inv_d = _safe_inv(d)
    cull_fn = cull.tile_cull if backend == "pallas" else cull.tile_cull_plain
    tile_tnear = cull_fn(accel.aabb_lo, accel.aabb_hi, o, inv_d, t_max,
                         t_min=t_min, n_tiles=n_tiles, tile_rays=tile_rays)
    t_cap = _scene_exit(accel, o, d, t_max).reshape(n_tiles, tile_rays)
    if backend == "pallas":
        st, si = _sorted_schedule(tile_tnear, 1)
        t, tri, u, v = sweep.sweep_closest(
            st, si, _tile_rays6(o, d, n_tiles, tile_rays),
            t_cap.contiguous(), accel.blocks_t, t_min)
    else:
        st, si = _sorted_schedule(tile_tnear, cpi)
        t, tri, u, v = _lockstep_closest(
            accel, st, si, o.reshape(n_tiles, tile_rays, 3),
            d.reshape(n_tiles, tile_rays, 3), t_cap, t_min, cpi)
    t = torch.where(tri >= 0, t, torch.inf)
    return t.reshape(n), tri.reshape(n), u.reshape(n), v.reshape(n)


def _occluded_chunk(accel, o, d, t_max, tile_rays, cpi, backend):
    n = o.shape[0]
    n_tiles = n // tile_rays
    inv_d = _safe_inv(d)
    cull_fn = cull.tile_cull if backend == "pallas" else cull.tile_cull_plain
    tile_tnear = cull_fn(accel.aabb_lo, accel.aabb_hi, o, inv_d, t_max,
                         t_min=0.0, n_tiles=n_tiles, tile_rays=tile_rays)
    tm = t_max.reshape(n_tiles, tile_rays)
    if backend == "pallas":
        st, si = _sorted_schedule(tile_tnear, 1)
        blocked = sweep.sweep_occluded(
            st, si, _tile_rays6(o, d, n_tiles, tile_rays), tm.contiguous(),
            accel.blocks_t) > 0
    else:
        st, si = _sorted_schedule(tile_tnear, cpi)
        blocked = _lockstep_occluded(
            accel, st, si, o.reshape(n_tiles, tile_rays, 3),
            d.reshape(n_tiles, tile_rays, 3), tm, cpi)
    return (blocked.reshape(n),)


def intersect_clusters(accel, o, d, t_min, t_max, sort_rays: bool = True,
                       tile_rays: int = None, cpi: int = None,
                       chunk_rays: int = None, backend: str = "xla",
                       dir_bits: int = 3) -> Hit:
    """Closest hit of rays o/d [N,3] via packet traversal.

    t_max may be a scalar or per-ray [N]. dir_bits: direction bits per
    axis of the coherence key (3 for closest calls).
    """
    tile_rays = tile_rays or TILE_RAYS
    cpi = cpi or CLUSTERS_PER_ITER
    chunk_rays = chunk_rays or CHUNK_TILES * tile_rays
    n = o.shape[0]
    t_max = _per_ray(t_max, o)
    order = None
    if sort_rays:
        order, o, d, t_max = _coherence_sort(accel, o, d, t_max, dir_bits)

    def dead(m):
        z = torch.zeros(m, dtype=torch.float32, device=o.device)
        return (z + torch.inf, torch.full((m,), -1, dtype=torch.int32,
                                          device=o.device), z, z)

    t, tri, u, v = _chunk_map(
        lambda r: _closest_chunk(accel, *r, t_min, tile_rays, cpi, backend),
        (o, d, t_max), n, tile_rays, chunk_rays, dead)
    if order is not None:
        t, tri, u, v = (_unsort(order, x) for x in (t, tri, u, v))
    return Hit(t=t, tri=tri, u=u, v=v)


def occluded_clusters(accel, o, d, t_max, sort_rays: bool = True,
                      tile_rays: int = None, cpi: int = None,
                      chunk_rays: int = None, backend: str = "xla",
                      dir_bits: int = 2):
    """Any-hit (front-facing) visibility via packet traversal -> bool[N]."""
    tile_rays = tile_rays or TILE_RAYS
    cpi = cpi or CLUSTERS_PER_ITER
    chunk_rays = chunk_rays or CHUNK_TILES * tile_rays
    n = o.shape[0]
    t_max = _per_ray(t_max, o)
    order = None
    if sort_rays:
        order, o, d, t_max = _coherence_sort(accel, o, d, t_max, dir_bits)

    def dead(m):
        return (torch.zeros(m, dtype=torch.bool, device=o.device),)

    (blocked,) = _chunk_map(
        lambda r: _occluded_chunk(accel, *r, tile_rays, cpi, backend),
        (o, d, t_max), n, tile_rays, chunk_rays, dead)
    if order is not None:
        blocked = _unsort(order, blocked)
    return blocked
