"""Packet (tile) traversal over the cluster accel (counterpart of pathtracer/kernels/packet.py).

Per traversal call:
1. coherence key and one stable sort of the rays - over the whole
   wavefront, or (PT_SORT_SCOPE=chunk, or a wavefront of one chunk) per
   chunk; primary rays skip it, they arrive in swizzled 8x8 pixel-block
   order. Keys (PT_KEY_SCHEME, PT_KEY_SCHEME_OCCL for occlusion calls):
   dirmajor (direction bins major, origin Morton minor), mixed (the two
   bit streams interleaved) or firstcluster (the ray's nearest cluster
   major: K8, cull.first_cluster); parked lanes last;
2. pad to whole tiles of PT_TILE_RAYS rays (32, 64, 128 or 256) with
   parked rays,
   then chunks of PT_CHUNK_TILES tiles; chunks whose lanes are all
   parked are skipped (one host sync per call reads every chunk's flag);
3. per live chunk: the tile cull (cull="ray": K1, or K4 under
   PT_CULL_SKIP=1; cull="frustum": K7) -> with a fetch group g > 1
   (PT_FETCH_GROUP, or the caller's group) the group-min over g
   consecutive clusters -> per-tile schedule sort near to far (or the
   packed u32 sort under PT_SCHED_PACK=1) -> K2 closest sweep or K3
   occlusion sweep, on g x K-lane grouped clusters when g > 1, with
   best_t seeded from the per-ray scene-exit cap;
4. unsort by scattering through the inverse permutation.

Step 3's kernels are the wrappers of cull.py / sweep.py: the CUDA
kernels for CUDA tensors, their plain versions for CPU tensors.
occluded_clusters(..., want_blocker=True) also returns a
blocker-triangle hint per ray (K3b). The knobs are read per call
(knobs.py lists every PT_* knob of the JAX package and its state).
"""

from __future__ import annotations

import dataclasses

import torch

from pathtracer_torch import knobs, tracing
from pathtracer_torch.accel import cluster as cluster_mod
from pathtracer_torch.accel import morton as morton_mod
from pathtracer_torch.kernels import cull, sweep
from pathtracer_torch.kernels.intersect import Hit

TILE_RAYS = 64            # rays per tile (packet width), PT_TILE_RAYS
CHUNK_TILES = 2048        # tiles per launch = the dead-chunk skip granule
SCHED_PACK_MAX = 1 << 12  # clusters the packed schedule's 12 id bits hold


def tile_rays_knob() -> int:
    """PT_TILE_RAYS (default 64): the widths the sweep kernels take."""
    return knobs.integer("PT_TILE_RAYS", TILE_RAYS, sweep.TILE_WIDTHS)


def chunk_tiles_knob() -> int:
    """PT_CHUNK_TILES (default 2048)."""
    n = knobs.integer("PT_CHUNK_TILES", CHUNK_TILES)
    if n < 1:
        raise ValueError(f"PT_CHUNK_TILES={n}: expected >= 1")
    return n


def _fetch_group(group=None) -> int:
    """Clusters a sweep column takes: the caller's group, else
    PT_FETCH_GROUP (default 1)."""
    g = int(group) if group is not None else knobs.integer(
        "PT_FETCH_GROUP", 1)
    if g < 1:
        raise ValueError(f"fetch group {g}: expected >= 1")
    return g


def _grouped_accel(accel, g: int):
    """The sweep tables of accel's clusters in aligned groups of g
    (packet.py:96-118): blocks_t [ceil(C/g), 16, g*K], cluster C padded
    to a multiple of g with zero blocks (normal 0 and id row 0: never a
    hit, lane count 0), with its lane tables; derived once per blocks_t
    tensor and g (cull.derived)."""
    def make():
        bt = accel.blocks_t
        c, rows, k = bt.shape
        pad = (-c) % g
        if pad:
            bt = torch.cat([bt, bt.new_zeros((pad, rows, k))])
        c2 = bt.shape[0] // g
        btg = (bt.reshape(c2, g, rows, k).transpose(1, 2)
               .reshape(c2, rows, g * k).contiguous())
        return dataclasses.replace(
            accel, aabb_lo=accel.aabb_lo[:0], aabb_hi=accel.aabb_hi[:0],
            blocks_t=btg, **cluster_mod.lane_tables(btg))

    return cull.derived((accel.blocks_t,), ("group", g), make)


def _group_blocks(accel, tile_tnear, g: int):
    """Group-major sweep operands (packet.py:96): (tile_tnear's min over
    each group f32[tiles, ceil(C/g)], the grouped accel); inf-padded
    tnear columns are never scheduled."""
    c = tile_tnear.shape[1]
    pad = (-c) % g
    if pad:
        tile_tnear = torch.cat([tile_tnear, tile_tnear.new_full(
            (tile_tnear.shape[0], pad), torch.inf)], dim=1)
    ttg = tile_tnear.reshape(tile_tnear.shape[0], -1, g).amin(dim=2)
    return ttg.contiguous(), _grouped_accel(accel, g)


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


KEY_SCHEMES = ("dirmajor", "mixed", "firstcluster")


def _mixed_key(m, m_bits: int, d, dir_bits: int):
    """6D-interleaved coherence key (PT_KEY_SCHEME=mixed, packet.py:132):
    the direction bits (axis-interleaved, MSB first) merged evenly
    through the origin-Morton bits from the MSB down (a Bresenham merge
    of the two bit streams); the top 32 bits of the merged stream."""
    db3 = 3 * dir_bits
    levels = float(torch.tensor((1 << dir_bits) - 1e-3,
                                dtype=torch.float32))
    q = torch.clamp((d * 0.5 + 0.5) * levels, 0,
                    (1 << dir_bits) - 1).to(torch.int64)
    md = torch.zeros_like(q[:, 0])
    for i in range(dir_bits - 1, -1, -1):          # MSB first
        for ax in range(3):
            md = (md << 1) | ((q[:, ax] >> i) & 1)
    total = m_bits + db3
    key = torch.zeros_like(m)
    mi = di = 0                                    # bits consumed
    for pos in range(min(total, 32)):
        # emit a direction bit when its stream is behind its share
        if di * total <= pos * db3 and di < db3:
            bit = (md >> (db3 - 1 - di)) & 1
            di += 1
        else:
            bit = (m >> (m_bits - 1 - mi)) & 1
            mi += 1
        key = (key << 1) | bit
    return key


def _first_cluster(accel, o, d):
    """Per-ray nearest cluster id i32[N] and clamped entry f32[N] (K8)."""
    return cull.first_cluster(accel.aabb_lo, accel.aabb_hi, o.contiguous(),
                              _safe_inv(d).contiguous())


def _coherence_key(accel, o, d, dir_bits: int = None, scheme: str = None):
    """u32 coherence key per ray (in int64; packet.py:214-271).

    dir_bits: direction bits per axis (None: PT_DIR_BITS, default 2).
    scheme (None: PT_KEY_SCHEME, default dirmajor): "dirmajor" =
    direction bin major, origin Morton minor; "mixed" = _mixed_key (at
    dir_bits >= 2; dirmajor below); "firstcluster" = the ray's nearest
    cluster (K8) major, then the direction bin, then origin Morton.
    Parked lanes (origin >= 1e29) get 0xFFFFFFFF and sort last.
    """
    if dir_bits is None:
        dir_bits = knobs.integer("PT_DIR_BITS", 2)
    scheme = scheme or knobs.choice("PT_KEY_SCHEME", "dirmajor",
                                    KEY_SCHEMES)
    if scheme not in KEY_SCHEMES:
        raise ValueError(f"key scheme {scheme!r}: expected one of "
                         f"{', '.join(KEY_SCHEMES)}")
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
    if scheme == "mixed" and dir_bits >= 2:
        key = _mixed_key(m, 30, d, dir_bits)
    elif scheme == "firstcluster":
        fc, _ = _first_cluster(accel, o, d)
        cb = max(1, int(accel.aabb_lo.shape[0] - 1).bit_length())
        rest = max(0, 32 - cb - db)
        key = ((fc.to(torch.int64) << (32 - cb)) | (dbin << rest)
               | (m >> (30 - rest if rest < 30 else 0)))
    else:
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
    id 0 (a harmless re-test of cluster 0). PT_SCHED_PACK=1 (at most
    SCHED_PACK_MAX clusters) sorts packed u32 keys instead.
    """
    if knobs.choice("PT_SCHED_PACK", "0", ("0", "1")) == "1" \
            and tile_tnear.shape[1] <= SCHED_PACK_MAX:
        return _packed_schedule_sort(tile_tnear)
    st, si = torch.sort(tile_tnear, dim=1, stable=True)
    si = torch.where(torch.isfinite(st), si, 0).to(torch.int32)
    return st.contiguous(), si.contiguous()


def _packed_schedule_sort(tile_tnear):
    """One-key schedule sort (packet.py:489-518): key = (20-bit floor
    quantization of the entry << 12) | cluster id. The dequantized entry,
    one quantum lower, stays a lower bound of the true entry, so the
    closest sweep's stop rule stays conservative."""
    tiles, c = tile_tnear.shape
    fin = torch.isfinite(tile_tnear)
    mag = torch.where(fin, tile_tnear, 0.0)
    scale = torch.clamp(mag.max(), min=1e-20)
    maxq = (1 << 20) - 2
    maxq_f = tracing.device_tensor(float(maxq), tile_tnear.device,
                                    torch.float32)
    q = torch.clamp((mag * (maxq_f / scale)).to(torch.int64), max=maxq)
    cid = torch.arange(c, dtype=torch.int64, device=tile_tnear.device)
    key = torch.where(fin, (q << 12) | cid[None, :], 0xFFFFFFFF)
    key = torch.sort(key, dim=1).values
    valid = key != 0xFFFFFFFF
    qs = torch.clamp((key >> 12).to(torch.float32) - 1.0, min=0.0)
    st = torch.where(valid, qs * (scale / maxq_f), torch.inf)
    si = torch.where(valid, key & 0xFFF, 0).to(torch.int32)
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


def _coherence_sort(accel, o, d, t_max, dir_bits, scheme=None):
    with tracing.span("pt.sort"):
        order = torch.sort(_coherence_key(accel, o, d, dir_bits, scheme),
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


CULLS = ("ray", "frustum")


# --- per-chunk bodies ----------------------------------------------------

def _chunk_schedule(accel, o, d, t_max, t_min, tile_rays, cull_kind, group):
    """Tile cull (K1/K4, or K7 for cull="frustum"), the fetch group's
    group-min and the per-tile schedule sort of one chunk -> (n_tiles,
    st, si, the accel the sweep walks)."""
    n_tiles = o.shape[0] // tile_rays
    fn = cull.frustum_cull if cull_kind == "frustum" else cull.tile_cull
    tile_tnear = fn(accel.aabb_lo, accel.aabb_hi, o, _safe_inv(d), t_max,
                    t_min=t_min, n_tiles=n_tiles, tile_rays=tile_rays)
    sweep_accel = accel
    g = _fetch_group(group)
    if g > 1:
        tile_tnear, sweep_accel = _group_blocks(accel, tile_tnear, g)
    return (n_tiles,) + _sorted_schedule(tile_tnear) + (sweep_accel,)


def _closest_chunk(accel, o, d, t_max, t_min, tile_rays, cull_kind, group):
    n = o.shape[0]
    n_tiles, st, si, sweep_accel = _chunk_schedule(
        accel, o, d, t_max, t_min, tile_rays, cull_kind, group)
    t_cap = _scene_exit(accel, o, d, t_max).reshape(n_tiles, tile_rays)
    t, tri, u, v = sweep.sweep_closest(
        st, si, _tile_rays6(o, d, n_tiles, tile_rays), t_cap.contiguous(),
        sweep_accel, t_min)
    t = torch.where(tri >= 0, t, torch.inf)
    return t.reshape(n), tri.reshape(n), u.reshape(n), v.reshape(n)


def _occluded_chunk(accel, o, d, t_max, tile_rays, want_blocker, cull_kind,
                    group):
    n = o.shape[0]
    n_tiles, st, si, sweep_accel = _chunk_schedule(
        accel, o, d, t_max, 0.0, tile_rays, cull_kind, group)
    out = sweep.sweep_occluded(
        st, si, _tile_rays6(o, d, n_tiles, tile_rays),
        t_max.reshape(n_tiles, tile_rays).contiguous(), sweep_accel,
        want_blocker=want_blocker)
    if want_blocker:
        return (out[0] > 0).reshape(n), out[1].reshape(n)
    return ((out > 0).reshape(n),)


def _traverse(accel, o, d, t_max, sort_rays, tile_rays, chunk_rays,
              dir_bits, scheme, body, dead):
    """Sort (over the wavefront, or per chunk under PT_SORT_SCOPE=chunk
    when the wavefront spans chunks), run body on each live chunk, and
    unsort (packet.py:871-963). The two scopes sort the same rays
    together when the wavefront is one chunk."""
    n = o.shape[0]
    per_chunk = (sort_rays and n > chunk_rays and knobs.choice(
        "PT_SORT_SCOPE", "global", ("global", "chunk")) == "chunk")
    order = None
    if sort_rays and not per_chunk:
        order, o, d, t_max = _coherence_sort(accel, o, d, t_max, dir_bits,
                                             scheme)
    fn = body
    if per_chunk:
        def fn(rays):
            part_order, *sorted_rays = _coherence_sort(accel, *rays,
                                                       dir_bits, scheme)
            return _unsort(part_order, body(sorted_rays))
    out = _chunk_map(fn, (o, d, t_max), n, tile_rays, chunk_rays, dead)
    if order is not None:
        out = _unsort(order, out)
    return out


def _call_shape(tile_rays, chunk_rays, cull_kind):
    """Resolve a call's tile width and chunk (the JAX defaults: PT_TILE_RAYS,
    PT_CHUNK_TILES x PT_TILE_RAYS rays) and check the cull."""
    if cull_kind not in CULLS:
        raise ValueError(f"cull {cull_kind!r}: expected one of "
                         f"{', '.join(CULLS)}")
    knob_rays = tile_rays_knob()
    tile_rays = tile_rays or knob_rays
    if tile_rays not in sweep.TILE_WIDTHS:
        raise ValueError(f"tile_rays {tile_rays}: expected one of "
                         f"{', '.join(map(str, sweep.TILE_WIDTHS))}, the "
                         "widths the sweep kernels take")
    return tile_rays, chunk_rays or chunk_tiles_knob() * knob_rays


def intersect_clusters(accel, o, d, t_min, t_max, sort_rays: bool = True,
                       tile_rays: int = None, chunk_rays: int = None,
                       dir_bits: int = None, cull: str = "ray",
                       group: int = None) -> Hit:
    """Closest hit of rays o/d [N,3] via packet traversal.

    t_max may be a scalar or per-ray [N]. dir_bits: direction bits per
    axis of the coherence key (None: PT_CLOSEST_DB, default 3). cull:
    "ray" (K1, or K4 under PT_CULL_SKIP=1) or "frustum" (K7). group:
    clusters a sweep column takes (None: PT_FETCH_GROUP, default 1).
    """
    tile_rays, chunk_rays = _call_shape(tile_rays, chunk_rays, cull)
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
            chunk_rays, dir_bits, None,
            lambda r: _closest_chunk(accel, *r, t_min, tile_rays, cull,
                                     group),
            dead)
    return Hit(t=t, tri=tri, u=u, v=v)


def occluded_clusters(accel, o, d, t_max, sort_rays: bool = True,
                      tile_rays: int = None, chunk_rays: int = None,
                      dir_bits: int = None, want_blocker: bool = False,
                      cull: str = "ray", group: int = None):
    """Any-hit (front-facing) visibility via packet traversal -> bool[N].

    dir_bits: None reads PT_OCCL_DB (default 2); the key scheme is
    PT_KEY_SCHEME_OCCL (default dirmajor). cull and group as in
    intersect_clusters. want_blocker: return (blocked, btri i32[N]) with
    a blocking triangle's id per ray (-1 open, and -1 in skipped dead
    chunks).
    """
    tile_rays, chunk_rays = _call_shape(tile_rays, chunk_rays, cull)
    if dir_bits is None:
        dir_bits = knobs.integer("PT_OCCL_DB", 2)
    scheme = knobs.choice("PT_KEY_SCHEME_OCCL", "dirmajor", KEY_SCHEMES)
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
            chunk_rays, dir_bits, scheme,
            lambda r: _occluded_chunk(accel, *r, tile_rays, want_blocker,
                                      cull, group),
            dead)
    return out if want_blocker else out[0]
