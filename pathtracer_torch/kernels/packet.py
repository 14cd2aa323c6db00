"""Packet (tile) traversal over the cluster accel (counterpart of pathtracer/kernels/packet.py).

Per traversal call:
1. one stable sort of the whole wavefront by the dirmajor coherence key
   (direction bins major, origin Morton minor; parked lanes last);
   primary rays skip it, they arrive in swizzled 8x8 pixel-block order;
2. pad to whole tiles of PT_TILE_RAYS rays (32, 64, 128 or 256) with
   parked rays, then chunks of PT_CHUNK_TILES tiles; chunks whose lanes
   are all parked are skipped (one host sync per call reads every
   chunk's flag);
3. per live chunk: the tile cull (K1, or K4 under PT_CULL_SKIP=1) ->
   per-tile schedule sort near to far -> K2 closest sweep or K3
   occlusion sweep, one cluster a column, with best_t seeded from the
   per-ray scene-exit cap;
4. unsort by scattering through the inverse permutation.

Step 3's kernels are the wrappers of cull.py / sweep.py: the CUDA
kernels for CUDA tensors, their plain versions for CPU tensors.
occluded_clusters(..., want_blocker=True) also returns a
blocker-triangle hint per ray (K3b). The knobs are read per call
(knobs.py lists every PT_* knob of the JAX package and its state).
"""

from __future__ import annotations

import torch

from pathtracer_torch import knobs, tracing
from pathtracer_torch.accel import morton as morton_mod
from pathtracer_torch.kernels import cull, sweep
from pathtracer_torch.kernels.intersect import Hit

TILE_RAYS = 64            # rays per tile (packet width), PT_TILE_RAYS
CHUNK_TILES = 2048        # tiles per launch = the dead-chunk skip granule


def tile_rays_knob() -> int:
    """PT_TILE_RAYS (default 64): the widths the sweep kernels take."""
    return knobs.integer("PT_TILE_RAYS", TILE_RAYS, sweep.TILE_WIDTHS)


def chunk_tiles_knob() -> int:
    """PT_CHUNK_TILES (default 2048)."""
    n = knobs.integer("PT_CHUNK_TILES", CHUNK_TILES)
    if n < 1:
        raise ValueError(f"PT_CHUNK_TILES={n}: expected >= 1")
    return n


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


def _coherence_key(accel, o, d, dir_bits: int = None):
    """u32 dirmajor coherence key per ray (in int64; packet.py:214-271):
    the direction bin major, origin Morton minor.

    dir_bits: direction bits per axis (None: PT_DIR_BITS, default 2).
    Parked lanes (origin >= 1e29) get 0xFFFFFFFF and sort last.
    """
    if dir_bits is None:
        dir_bits = knobs.integer("PT_DIR_BITS", 2)
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
    with tracing.span("pt.schedule", tiles=tile_tnear.shape[0],
                      clusters=tile_tnear.shape[1]):
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
    flags = live.reshape(-1, chunk_rays).any(dim=1)
    with tracing.host_sync("chunk_live"):
        return flags.tolist()


def _chunk_map(fn, rays, n, tile_rays, chunk_rays, dead):
    """Apply fn to each live chunk of whole tiles; dead(m) fills the rest."""
    rays, total = _pad_rays(rays, n, tile_rays)
    outs = []
    for ci, live in enumerate(chunk_live(rays[0], chunk_rays)):
        part = tuple(a[ci * chunk_rays:(ci + 1) * chunk_rays] for a in rays)
        if live:
            with tracing.span("pt.chunk"):
                outs.append(fn(part))
        else:
            outs.append(dead(part[0].shape[0]))
    return tuple(torch.cat(x)[:n] for x in zip(*outs))


def _per_ray(t_max, o):
    return tracing.device_tensor(t_max, o.device, torch.float32).expand(
        o.shape[0]).contiguous()


def _coherence_sort(accel, o, d, t_max, dir_bits):
    with tracing.span("pt.sort"):
        order = torch.sort(_coherence_key(accel, o, d, dir_bits),
                           stable=True).indices
        return order, o[order], d[order], t_max[order]


def _unsort(order, xs):
    """Each tensor of xs scattered back through the sort's order."""
    with tracing.span("pt.sort"):
        outs = tuple(torch.empty_like(x) for x in xs)
        for out, x in zip(outs, xs):
            out[order] = x
        return outs


def _tile_rays6(o, d, n_tiles, tile_rays):
    """[n, 3] origins and directions -> rays f32[tiles, 6, R]."""
    return torch.cat([o.reshape(n_tiles, tile_rays, 3),
                      d.reshape(n_tiles, tile_rays, 3)],
                     dim=2).transpose(1, 2).contiguous()


# --- per-chunk bodies ----------------------------------------------------

def _chunk_schedule(accel, o, d, t_max, t_min, tile_rays):
    """Tile cull (K1, or K4 under PT_CULL_SKIP=1) and the per-tile
    schedule sort of one chunk -> (n_tiles, st, si)."""
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


def _traverse(accel, o, d, t_max, sort_rays, tile_rays, chunk_rays,
              dir_bits, body, dead):
    """Sort the whole wavefront (with sort_rays), run body on each live
    chunk, and unsort (packet.py:871-963)."""
    order = None
    if sort_rays:
        order, o, d, t_max = _coherence_sort(accel, o, d, t_max, dir_bits)
    out = _chunk_map(body, (o, d, t_max), o.shape[0], tile_rays,
                     chunk_rays, dead)
    if order is not None:
        out = _unsort(order, out)
    return out


def _call_shape(tile_rays, chunk_rays):
    """Resolve a call's tile width and chunk (the JAX defaults: PT_TILE_RAYS,
    PT_CHUNK_TILES x PT_TILE_RAYS rays)."""
    knob_rays = tile_rays_knob()
    tile_rays = tile_rays or knob_rays
    if tile_rays not in sweep.TILE_WIDTHS:
        raise ValueError(f"tile_rays {tile_rays}: expected one of "
                         f"{', '.join(map(str, sweep.TILE_WIDTHS))}, the "
                         "widths the sweep kernels take")
    return tile_rays, chunk_rays or chunk_tiles_knob() * knob_rays


def intersect_clusters(accel, o, d, t_min, t_max, sort_rays: bool = True,
                       tile_rays: int = None, chunk_rays: int = None,
                       dir_bits: int = None) -> Hit:
    """Closest hit of rays o/d [N,3] via packet traversal.

    t_max may be a scalar or per-ray [N]. dir_bits: direction bits per
    axis of the coherence key (None: PT_CLOSEST_DB, default 3).
    """
    tile_rays, chunk_rays = _call_shape(tile_rays, chunk_rays)
    if dir_bits is None:
        dir_bits = knobs.integer("PT_CLOSEST_DB", 3)
    dev = o.device

    def dead(m):
        z = torch.zeros(m, dtype=torch.float32, device=dev)
        return (z + torch.inf, torch.full((m,), -1, dtype=torch.int32,
                                          device=dev), z, z)

    with tracing.span("pt.traverse.closest"):
        t, tri, u, v = _traverse(
            accel, o, d, _per_ray(t_max, o), sort_rays, tile_rays,
            chunk_rays, dir_bits,
            lambda r: _closest_chunk(accel, *r, t_min, tile_rays), dead)
    return Hit(t=t, tri=tri, u=u, v=v)


def occluded_clusters(accel, o, d, t_max, sort_rays: bool = True,
                      tile_rays: int = None, chunk_rays: int = None,
                      dir_bits: int = None, want_blocker: bool = False):
    """Any-hit (front-facing) visibility via packet traversal -> bool[N].

    dir_bits: None reads PT_OCCL_DB (default 2). want_blocker: return
    (blocked, btri i32[N]) with a blocking triangle's id per ray (-1
    open, and -1 in skipped dead chunks).
    """
    tile_rays, chunk_rays = _call_shape(tile_rays, chunk_rays)
    if dir_bits is None:
        dir_bits = knobs.integer("PT_OCCL_DB", 2)
    dev = o.device

    def dead(m):
        blocked = torch.zeros(m, dtype=torch.bool, device=dev)
        if want_blocker:
            return blocked, torch.full((m,), -1, dtype=torch.int32,
                                       device=dev)
        return (blocked,)

    with tracing.span("pt.traverse.occluded"):
        out = _traverse(
            accel, o, d, _per_ray(t_max, o), sort_rays, tile_rays,
            chunk_rays, dir_bits,
            lambda r: _occluded_chunk(accel, *r, tile_rays, want_blocker),
            dead)
    return out if want_blocker else out[0]
