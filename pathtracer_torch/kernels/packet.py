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

Step 3's kernels are the wrappers of cull.py / sweep.py: the CUDA
kernels for CUDA tensors, their plain versions for CPU tensors.
occluded_clusters(..., want_blocker=True) also returns a
blocker-triangle hint per ray (K3b).
"""

from __future__ import annotations

import torch

from pathtracer_torch.accel import morton as morton_mod
from pathtracer_torch.kernels import cull, sweep
from pathtracer_torch.kernels.intersect import Hit

TILE_RAYS = 64            # rays per tile (packet width)
CHUNK_TILES = 2048        # tiles per launch = the dead-chunk skip granule

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


def _sorted_schedule(tile_tnear):
    """Sort each tile's clusters near to far.

    Returns (st f32, si i32) [tiles, C]; unvisited entries are +inf with
    id 0 (a harmless re-test of cluster 0).
    """
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


# --- per-chunk bodies ----------------------------------------------------

def _chunk_schedule(accel, o, d, t_max, t_min, tile_rays):
    """K1 cull + per-tile schedule sort of one chunk -> (n_tiles, st, si)."""
    n_tiles = o.shape[0] // tile_rays
    tile_tnear = cull.tile_cull(accel.aabb_lo, accel.aabb_hi, o,
                                _safe_inv(d), t_max, t_min=t_min,
                                n_tiles=n_tiles, tile_rays=tile_rays)
    return (n_tiles,) + _sorted_schedule(tile_tnear)


def _closest_chunk(accel, o, d, t_max, t_min, tile_rays):
    n = o.shape[0]
    n_tiles, st, si = _chunk_schedule(accel, o, d, t_max, t_min, tile_rays)
    t_cap = _scene_exit(accel, o, d, t_max).reshape(n_tiles, tile_rays)
    t, tri, u, v = sweep.sweep_closest(
        st, si, _tile_rays6(o, d, n_tiles, tile_rays), t_cap.contiguous(),
        accel, t_min)
    t = torch.where(tri >= 0, t, torch.inf)
    return t.reshape(n), tri.reshape(n), u.reshape(n), v.reshape(n)


def _occluded_chunk(accel, o, d, t_max, tile_rays, want_blocker):
    n = o.shape[0]
    n_tiles, st, si = _chunk_schedule(accel, o, d, t_max, 0.0, tile_rays)
    out = sweep.sweep_occluded(
        st, si, _tile_rays6(o, d, n_tiles, tile_rays),
        t_max.reshape(n_tiles, tile_rays).contiguous(), accel,
        want_blocker=want_blocker)
    if want_blocker:
        return (out[0] > 0).reshape(n), out[1].reshape(n)
    return ((out > 0).reshape(n),)


def intersect_clusters(accel, o, d, t_min, t_max, sort_rays: bool = True,
                       tile_rays: int = None, chunk_rays: int = None,
                       dir_bits: int = 3) -> Hit:
    """Closest hit of rays o/d [N,3] via packet traversal.

    t_max may be a scalar or per-ray [N]. dir_bits: direction bits per
    axis of the coherence key (3 for closest calls).
    """
    tile_rays = tile_rays or TILE_RAYS
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
        lambda r: _closest_chunk(accel, *r, t_min, tile_rays),
        (o, d, t_max), n, tile_rays, chunk_rays, dead)
    if order is not None:
        t, tri, u, v = (_unsort(order, x) for x in (t, tri, u, v))
    return Hit(t=t, tri=tri, u=u, v=v)


def occluded_clusters(accel, o, d, t_max, sort_rays: bool = True,
                      tile_rays: int = None, chunk_rays: int = None,
                      dir_bits: int = 2, want_blocker: bool = False):
    """Any-hit (front-facing) visibility via packet traversal -> bool[N].

    want_blocker: return (blocked, btri i32[N]) with a blocking
    triangle's id per ray (-1 open, and -1 in skipped dead chunks).
    """
    tile_rays = tile_rays or TILE_RAYS
    chunk_rays = chunk_rays or CHUNK_TILES * tile_rays
    n = o.shape[0]
    t_max = _per_ray(t_max, o)
    order = None
    if sort_rays:
        order, o, d, t_max = _coherence_sort(accel, o, d, t_max, dir_bits)

    def dead(m):
        blocked = torch.zeros(m, dtype=torch.bool, device=o.device)
        if want_blocker:
            return blocked, torch.full((m,), -1, dtype=torch.int32,
                                       device=o.device)
        return (blocked,)

    out = _chunk_map(
        lambda r: _occluded_chunk(accel, *r, tile_rays, want_blocker),
        (o, d, t_max), n, tile_rays, chunk_rays, dead)
    if order is not None:
        out = tuple(_unsort(order, x) for x in out)
    return out if want_blocker else out[0]
