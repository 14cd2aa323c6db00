"""pathtracer_torch CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device. The
file imports neither jax nor the JAX package, so on a machine with a
card it also runs without them:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from pathtracer_torch import kernels
from pathtracer_torch.accel.cluster import _finish_build, build_clusters
from pathtracer_torch.kernels import cull, packet, sweep
from pathtracer_torch.kernels.intersect import ray_triangle

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc "
                    "and run only on the card")
    return torch.device("cuda")


def _soup(t, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    return [torch.from_numpy(x) for x in (v0, v1, v2)]


def _rays(n, seed, dev, park_tail=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if park_tail:
        o[-park_tail:] = 1e30
        d[-park_tail:] = 1.0
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


@pytest.mark.parametrize("n_tris,n_tiles,t_max", [(3000, 40, 3.0),
                                                  (300, 3, 1e20)])
def test_kernels_match_plain_bit_for_bit(dev, n_tris, n_tiles, t_max):
    accel = build_clusters(*_soup(n_tris, n_tris),
                           method="sahsplit").to(dev)
    o, d = _rays(64 * n_tiles, n_tiles, dev, park_tail=70)
    tm = torch.full((o.shape[0],), t_max, device=dev)
    inv = packet._safe_inv(d)
    kw = dict(t_min=1e-3, n_tiles=n_tiles, tile_rays=64)
    before = dict(kernels.LAUNCHES)
    tn = cull.tile_cull(accel.aabb_lo, accel.aabb_hi, o, inv, tm, **kw)
    assert torch.equal(tn, cull.tile_cull_plain(accel.aabb_lo,
                                                accel.aabb_hi, o, inv, tm,
                                                **kw))
    st, si = packet._sorted_schedule(tn)
    rays6 = packet._tile_rays6(o, d, n_tiles, 64)
    cap = packet._scene_exit(accel, o, d, tm).reshape(n_tiles, 64) \
        .contiguous()
    got = sweep.sweep_closest(st, si, rays6, cap, accel, 1e-3)
    ref = sweep.sweep_closest_plain(st, si, rays6, cap, accel.blocks_t,
                                    1e-3)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert bool((got[1] >= 0).any())
    tm2 = tm.reshape(n_tiles, 64).contiguous()
    occ = sweep.sweep_occluded(st, si, rays6, tm2, accel)
    assert torch.equal(occ, sweep.sweep_occluded_plain(st, si, rays6, tm2,
                                                       accel.blocks_t))
    assert all(kernels.LAUNCHES[k] == before[k] + 1
               for k in ("tile_cull", "sweep_closest", "sweep_occluded"))
    assert kernels.LAUNCHES["sweep_occluded_blocker"] == \
        before["sweep_occluded_blocker"]


def test_packet_traversal_on_cuda_matches_cpu(dev):
    accel = build_clusters(*_soup(2000, 5), method="sahsplit")
    o, d = _rays(5000, 6, "cpu")
    tm = torch.full((5000,), 2.0)
    for sort in (True, False):
        hc = packet.intersect_clusters(accel, o, d, 1e-3, 1e20,
                                       sort_rays=sort)
        hg = packet.intersect_clusters(accel.to(dev), o.to(dev), d.to(dev),
                                       1e-3, 1e20, sort_rays=sort)
        assert torch.equal(hg.tri.cpu(), hc.tri)
        oc = packet.occluded_clusters(accel, o, d, tm, sort_rays=sort)
        og = packet.occluded_clusters(accel.to(dev), o.to(dev), d.to(dev),
                                      tm.to(dev), sort_rays=sort)
        assert torch.equal(og.cpu(), oc)


def test_wrappers_check_their_inputs(dev):
    accel = build_clusters(*_soup(300, 1), method="sahsplit").to(dev)
    o, d = _rays(64, 2, dev)
    tm = torch.full((64,), 2.0, device=dev)
    kw = dict(t_min=0.0, n_tiles=1, tile_rays=64)
    with pytest.raises(ValueError):
        cull.tile_cull(accel.aabb_lo, accel.aabb_hi, o.double(),
                       packet._safe_inv(d), tm, **kw)
    with pytest.raises(ValueError):
        cull.tile_cull(accel.aabb_lo, accel.aabb_hi, o.t().contiguous().t(),
                       packet._safe_inv(d), tm, **kw)
    tn = cull.tile_cull(accel.aabb_lo, accel.aabb_hi, o,
                        packet._safe_inv(d), tm, **kw)
    st, si = packet._sorted_schedule(tn)
    rays6 = packet._tile_rays6(o, d, 1, 64)
    with pytest.raises(ValueError):
        sweep.sweep_closest(st, si.long(), rays6, tm.reshape(1, 64), accel,
                            1e-3)
    with pytest.raises(ValueError):
        sweep.sweep_occluded(st, si, rays6[:, :, :32].contiguous(),
                             tm.reshape(1, 64)[:, :32].contiguous(),
                             accel.to("cpu"))


def test_cornell_render_on_cuda_matches_cpu(dev):
    from pathtracer_torch.config import RenderConfig
    from pathtracer_torch.integrator.camera import Camera
    from pathtracer_torch.render import Renderer
    from pathtracer_torch.scene.procedural import cornell_box

    cfg = RenderConfig(width=32, height=32, spp=2, max_depth=4,
                       spp_batch=True)
    imgs = []
    for device in ("cpu", dev):
        c = Camera(position=(0.5, 0.5, 2.2))
        c.look_at((0.5, 0.5, 0.0))
        r = Renderer(cornell_box(materials_suite=True).finalize(
            device="cpu"), cfg, c,
                     device=device)
        imgs.append(r.run(1).accum.cpu().numpy())
    diff = np.abs(imgs[0] - imgs[1]).max(-1)
    assert (diff > 0.01).mean() <= 0.02
    assert abs(imgs[0].mean() - imgs[1].mean()) <= 1e-3 * imgs[0].mean()


def test_blocker_kernel_matches_plain_bit_for_bit(dev):
    """K3b: blocked and btri bit-equal to the plain version, blocked equal
    to K3's, and every hint a front-facing blocker with 0 < t < t_max
    under Moller-Trumbore - or, on a triangle edge where the two tests
    round apart, under the sweep's own Baldwin-Weber test."""
    v = _soup(3000, 8)
    accel = build_clusters(*v, method="sahsplit").to(dev)
    n_tiles = 40
    o, d = _rays(64 * n_tiles, 9, dev, park_tail=70)
    tm = torch.full((o.shape[0],), 1.5, device=dev)
    tn = cull.tile_cull(accel.aabb_lo, accel.aabb_hi, o, packet._safe_inv(d),
                        tm, t_min=0.0, n_tiles=n_tiles, tile_rays=64)
    st, si = packet._sorted_schedule(tn)
    rays6 = packet._tile_rays6(o, d, n_tiles, 64)
    tm2 = tm.reshape(n_tiles, 64).contiguous()
    before = kernels.LAUNCHES["sweep_occluded_blocker"]
    blk, btri = sweep.sweep_occluded(st, si, rays6, tm2, accel,
                                     want_blocker=True)
    assert kernels.LAUNCHES["sweep_occluded_blocker"] == before + 1
    pblk, pbtri = sweep.sweep_occluded_plain(st, si, rays6, tm2,
                                             accel.blocks_t,
                                             want_blocker=True)
    assert torch.equal(blk, pblk) and torch.equal(btri, pbtri)
    assert torch.equal(blk, sweep.sweep_occluded(st, si, rays6, tm2, accel))
    assert torch.equal(btri >= 0, blk > 0) and bool((blk > 0).any())
    hinted = (btri >= 0).reshape(-1)
    ids = btri.reshape(-1)[hinted].long().cpu()
    v0, v1, v2 = (x[ids] for x in v)
    oc, dc = o[hinted].cpu(), d[hinted].cpu()
    t, _, _, ok = ray_triangle(oc, dc, v0, v1, v2, 0.0, 1.5)
    ok = ok & ((dc * torch.cross(v1 - v0, v2 - v0, dim=1)).sum(1) < 0.0)
    edge = ~ok
    ok[edge] = sweep.bw_hit(accel.bw_rows.cpu()[ids[edge]], oc[edge],
                            dc[edge], 0.0, 1.5, front_only=True)[3]
    assert bool(ok.all())


def test_primed_render_on_cuda_matches_unprimed(dev):
    """Priming on the card: the same image and the same ray count, and
    the bounce-0 shadow batch went through K3b."""
    import dataclasses

    from pathtracer_torch.accel.cluster import build_scene_clusters
    from pathtracer_torch.config import RenderConfig
    from pathtracer_torch.integrator.camera import Camera
    from pathtracer_torch.render import Renderer
    from pathtracer_torch.scene.build import MaterialDesc
    from pathtracer_torch.scene.procedural import cornell_box, icosphere

    b = cornell_box()
    sv, sf = icosphere(0.25, (0.5, 0.35, 0.2), 3)
    b.add_mesh(sv, sf, b.add_material(MaterialDesc(albedo=(0.7, 0.6, 0.2),
                                                   roughness=0.4)))
    scene = build_scene_clusters(b.finalize(device="cpu"))
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=3,
                       spp_batch=True)
    out = []
    for c in (cfg, dataclasses.replace(cfg, primary_priming=True)):
        cam = Camera(position=(0.5, 0.5, 2.2))
        cam.look_at((0.5, 0.5, 0.0))
        r = Renderer(scene, c, cam, device=dev)
        kernels.reset_launch_counts()
        r.run(2)
        out.append((r.film.accum.cpu(), int(r.last_rays),
                    kernels.LAUNCHES["sweep_occluded_blocker"]))
    (base, rays_b, k3b_b), (primed, rays_p, k3b_p) = out
    torch.testing.assert_close(primed, base, rtol=1e-5, atol=1e-6)
    assert rays_p == rays_b
    assert k3b_b == 0 and k3b_p > 0


@pytest.mark.parametrize("blk", [128, 256])
def test_skip_cull_kernel_matches_plain_and_k1(dev, blk, monkeypatch):
    """K4: the block-gated cull equals its plain version and K1 bit for
    bit, its mask equals sc_mask_plain, and tile_cull launches it (and
    not K1) under PT_CULL_SKIP=1."""
    # 500 boxes on islands 25 apart (a 256 block spans ~2 islands), 12
    # of them far pads: padded to 512 clusters
    rng = np.random.default_rng(11)
    ctr = rng.uniform(-1, 1, (500, 3)) + (np.arange(500) // 100)[:, None] \
        * 25.0
    half = rng.uniform(0.05, 0.4, (500, 3))
    lo = torch.from_numpy(ctr - half).float().to(dev)
    hi = torch.from_numpy(ctr + half).float().to(dev)
    lo[-12:] = hi[-12:] = 1e30
    assert cull.gated(500, blk)
    n_tiles = 50
    o, d = _rays(64 * n_tiles, 12, dev, park_tail=70)
    tm = torch.full((o.shape[0],), 40.0, device=dev)
    inv = packet._safe_inv(d)
    kw = dict(t_min=1e-3, n_tiles=n_tiles, tile_rays=64)
    nb = cull.union_boxes(lo, hi, blk)[0].shape[0]
    mask = torch.full((n_tiles, nb), -1, dtype=torch.int32, device=dev)
    before = dict(kernels.LAUNCHES)
    got = cull.tile_cull_skip(lo, hi, o, inv, tm, blk=blk, mask_out=mask,
                              **kw)
    assert kernels.LAUNCHES["tile_cull_skip"] == before["tile_cull_skip"] + 1
    ref = cull.tile_cull_skip_plain(lo, hi, o, inv, tm, blk=blk, **kw)
    k1 = cull.tile_cull_plain(lo, hi, o, inv, tm, **kw)
    assert torch.equal(got, ref) and torch.equal(got, k1)
    assert torch.equal(mask, cull.sc_mask_plain(lo, hi, o, inv, tm, blk=blk,
                                                **kw))
    assert 0 < int(mask.sum()) < mask.numel()
    assert bool(torch.isfinite(got).any())
    monkeypatch.setenv("PT_CULL_SKIP", "1")
    monkeypatch.setenv("PT_CULL_BLK", str(blk))
    before = dict(kernels.LAUNCHES)
    assert torch.equal(cull.tile_cull(lo, hi, o, inv, tm, **kw), k1)
    assert kernels.LAUNCHES["tile_cull_skip"] == before["tile_cull_skip"] + 1
    assert kernels.LAUNCHES["tile_cull"] == before["tile_cull"]


# --- K4's ray rule: the adversarial chunk ------------------------------------

# (pads, t_min, t_max): "none" 512 real boxes; "accel" 500 real and 12
# accel pad boxes at 1e30 (C = 512); "far" 488 real and 12 accel pads (C
# = 500), to which K4 adds 12 far pads (the last block holds both kinds)
CULL_TRAPS = [(pads, t_min, t_max) for pads in ("none", "accel", "far")
              for t_min in (0.0, 1e-3) for t_max in (40.0, float("inf"))]


def cull_trap_case(pads, t_max, dev="cpu"):
    """An adversarial K4 chunk: (lo, hi, o, inv_d, t_max) with seven
    64-ray tiles.

    Boxes on islands 25 apart (a block of 128 spans ~1.3 islands), pads
    as `pads` says. Tiles: 0 live rays from island 0; 1 live rays with a
    parked tail (origin 1e30, d = 1: 12 packet pads with t_max 0, then 12
    rays parked by the integrator with the case's t_max); 2 parked rays
    only (t_max 0 and the case's); 3 half live, half parked with three
    equal negative 1/d components (the case's t_max); 4 those corner rays
    only; 5 live rays leaving the scene (they miss the root box); 6 live
    rays inside island 3.
    """
    rng = np.random.default_rng(17)
    c = 500 if pads == "far" else 512
    ctr = rng.uniform(-1, 1, (c, 3)) + (np.arange(c) // 100)[:, None] * 25.0
    half = rng.uniform(0.05, 0.4, (c, 3))
    lo, hi = ctr - half, ctr + half
    if pads != "none":
        lo[-12:] = hi[-12:] = 1e30
    n = 7 * 64
    o = rng.uniform(-2, 2, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.full(n, t_max)
    parked = np.zeros(n, bool)
    parked[64 + 40:3 * 64] = True                  # tiles 1 (tail) and 2
    tm[64 + 40:64 + 52] = 0.0                      # packet pads
    tm[2 * 64:2 * 64 + 32] = 0.0
    o[parked], d[parked] = 1e30, 1.0
    corner = np.zeros(n, bool)
    corner[3 * 64 + 32:5 * 64] = True              # tile 3's half, tile 4
    o[corner], d[corner] = 1e30, -0.57735027
    o[5 * 64:6 * 64] = (0.0, -100.0, 0.0)          # tile 5 leaves the scene
    d[5 * 64:6 * 64] = np.abs(d[5 * 64:6 * 64]) * (0.1, -1.0, 0.1)
    o[6 * 64:] += 75.0                             # tile 6 at island 3
    f = [torch.from_numpy(np.asarray(x, np.float32)).to(dev)
         for x in (lo, hi, o, d, tm)]
    return f[0], f[1], f[2], packet._safe_inv(f[3]), f[4]


@pytest.mark.parametrize("blk", [128, 256])
@pytest.mark.parametrize("trap", CULL_TRAPS)
def test_skip_cull_kernel_on_adversarial_chunk(dev, trap, blk):
    """K4 on cull_trap_case: bit-exact against its plain version and K1,
    its mask equal to sc_mask_plain, for every pad layout, t_min and
    t_max."""
    pads, t_min, t_max = trap
    lo, hi, o, inv, tm = cull_trap_case(pads, t_max, dev)
    kw = dict(t_min=t_min, n_tiles=7, tile_rays=64)
    mask = torch.full((7, cull.n_blocks(lo.shape[0], blk)), -1,
                      dtype=torch.int32, device=dev)
    got = cull.tile_cull_skip(lo, hi, o, inv, tm, blk=blk, mask_out=mask,
                              **kw)
    assert torch.equal(got, cull.tile_cull_skip_plain(lo, hi, o, inv, tm,
                                                      blk=blk, **kw))
    assert torch.equal(got, cull.tile_cull_plain(lo, hi, o, inv, tm, **kw))
    assert torch.equal(mask, cull.sc_mask_plain(lo, hi, o, inv, tm,
                                                blk=blk, **kw))


# --- the sweeps' branches ----------------------------------------------------

def _right(x0, y0, z):
    """Right triangle (x0, y0)-(x0+1, y0)-(x0, y0+1) at height z, normal
    +z: its Baldwin-Weber rows are exact, u = x - x0 and v = y - y0."""
    return [(x0, y0, z), (x0 + 1.0, y0, z), (x0, y0 + 1.0, z)]


BRANCH_IDS = dict(tie=(1, 2), cross=(3, 4))   # equal triangles, by id
BRANCH_LANES = (1, 86, 127, 128)                # real lanes of clusters 0-3
BRANCH_RAYS = {                # tile 0's first rays: origin, direction, t_max
    "tie_edge": ((0.25, 0.75, 5.0), (0, 0, -1), 12.0),   # u + v = 1
    "cross_tie": ((2.25, 0.5, 5.0), (0, 0, -1), 12.0),
    "on_plane_down": ((0.3, 0.3, 0.0), (0, 0, -1), 12.0),
    "on_plane_up": ((0.3, 0.3, 0.0), (0, 0, 1), 12.0),
    "t_max_at_hit": ((0.0, 0.5, 5.0), (0, 0, -1), 5.0),  # u = 0, t = 5
    "vertex": ((1.0, 0.0, 5.0), (0, 0, -1), 12.0),       # u = 1, v = 0
    "cross_edge": ((2.5, 0.5, 5.0), (0, 0, -1), 12.0),   # u + v = 1
    "u_zero": ((0.0, 0.25, 5.0), (0, 0, -1), 12.0),
}


def branch_case(dev="cpu"):
    """An accel and four 64-ray tiles that reach every branch of the
    sweep kernels: clusters with 1, 86, 127 and 128 real lanes and 124
    pad clusters; equal triangles on lanes 10 and 11 of cluster 1 (ids
    1, 2) and on lane 5 of cluster 2 and lane 7 of cluster 3 (ids 3, 4);
    rays onto those triangles' edges and vertices (u + v = 1, u = 0),
    rays starting on a triangle's plane, a ray whose t_max equals its hit
    t; parked rays (tile 1), rays with t_max 0 and -1 (tile 2) and
    back-facing rays (tile 3).

    Returns (accel, o, d, t_max [256]); tile 0's first rays are
    BRANCH_RAYS, in order."""
    rng = np.random.default_rng(31)
    k = 128
    big = [(-10.0, -10.0, -4.0), (20.0, -10.0, -4.0), (-10.0, 20.0, -4.0)]
    tris = [big, _right(0.0, 0.0, 0.0), _right(0.0, 0.0, 0.0),
            _right(2.0, 0.0, -1.0), _right(2.0, 0.0, -1.0)]
    # fillers below the special triangles and away from x in [2, 3];
    # clusters 2 and 3 keep theirs off y in [0, 1] too, so the first
    # blocking cluster of a ray onto a special triangle is that one's
    p0 = np.concatenate([rng.uniform([-2, -2, -3], [1.5, 4, -1.5], (86, 3)),
                         rng.uniform([-2, 1.6, -3], [1.5, 4, -1.5],
                                     (127 + 128, 3))])
    n_fill = len(p0)
    fill = np.stack([p0, p0 + rng.uniform(-0.4, 0.4, (n_fill, 3)),
                     p0 + rng.uniform(-0.4, 0.4, (n_fill, 3))], 1)
    tris = np.concatenate([np.array(tris), fill]).astype(np.float32)
    fill_ids = iter(range(5, len(tris)))
    lanes = [[0], [next(fill_ids) for _ in range(86)],
             [next(fill_ids) for _ in range(127)],
             [next(fill_ids) for _ in range(128)]]
    lanes[1][10:12] = BRANCH_IDS["tie"]
    lanes[2][5] = BRANCH_IDS["cross"][0]
    lanes[3][7] = BRANCH_IDS["cross"][1]
    c = 128
    sid = np.full((c * k,), -1, np.int64)
    for i, ids in enumerate(lanes):
        sid[i * k: i * k + len(ids)] = ids
    real = sid >= 0
    sv = [np.where(real[:, None], tris[np.maximum(sid, 0), i], 1e30)
          .astype(np.float32) for i in range(3)]
    accel = _finish_build(*(torch.from_numpy(x) for x in sv),
                          torch.from_numpy(sid), k, int((~real).sum()),
                          len(tris)).to(dev)
    n = 256
    o = rng.uniform([-2, -2, 4], [4, 4, 6], (n, 3))
    d = rng.normal([0, 0, -1], 0.3, (n, 3))
    o[192:, 2] = -6.0                         # tile 3 looks up from below:
    d[192:, 2] = np.abs(d[192:, 2])           # back faces
    t_max = rng.uniform(1.0, 12.0, n)
    for i, (oi, di, ti) in enumerate(BRANCH_RAYS.values()):
        o[i], d[i], t_max[i] = oi, di, ti
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[64:84], d[64:84], t_max[64:84] = 1e30, 1.0, 0.0   # parked
    t_max[128:158] = 0.0
    t_max[158:168] = -1.0
    return (accel,) + tuple(torch.from_numpy(x.astype(np.float32)).to(dev)
                            for x in (o, d, t_max))


def branch_sweep_args(accel, o, d, t_max, t_min):
    """(closest args, occlusion args) of branch_case's four tiles for the
    plain sweeps, with K1's schedules at t_min and 0 (the wrappers take
    the accel in place of blocks_t)."""
    n_tiles = o.shape[0] // 64
    rays6 = packet._tile_rays6(o, d, n_tiles, 64)
    out = []
    for tmin in (t_min, 0.0):
        tn = cull.tile_cull(accel.aabb_lo, accel.aabb_hi, o,
                            packet._safe_inv(d), t_max, t_min=tmin,
                            n_tiles=n_tiles, tile_rays=64)
        out.append(packet._sorted_schedule(tn) + (rays6,))
    cap = packet._scene_exit(accel, o, d, t_max).reshape(n_tiles, 64)
    return (out[0] + (cap.contiguous(), accel.blocks_t, t_min),
            out[1] + (t_max.reshape(n_tiles, 64).contiguous(),
                      accel.blocks_t))


@pytest.mark.parametrize("t_min", [0.0, 1e-3])
def test_sweep_kernels_match_plain_on_every_branch(dev, t_min):
    """K2 (t/tri/u/v), K3 and K3b (blocked/btri) bit-exact against their
    plain versions on branch_case; a negative t_min raises."""
    accel, o, d, tm = branch_case(dev)
    assert sorted(accel.n_lanes.tolist())[-4:] == list(BRANCH_LANES)
    closest, occl = branch_sweep_args(accel, o, d, tm, t_min)
    ref = sweep.sweep_closest_plain(*closest)
    got = sweep.sweep_closest(*closest[:4], accel, t_min)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert bool((ref[1] >= 0).any())
    for want_blocker in (False, True):
        ref = sweep.sweep_occluded_plain(*occl, want_blocker=want_blocker)
        got = sweep.sweep_occluded(*occl[:4], accel,
                                   want_blocker=want_blocker)
        for a, b in zip(got if want_blocker else (got,),
                        ref if want_blocker else (ref,)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="t_min"):
        sweep.sweep_closest(*closest[:4], accel, -1e-3)


def test_sweep_kernel_occupancy_is_reported(dev):
    for name in ("sweep_closest", "sweep_occluded", "sweep_occluded_blocker"):
        info = sweep.kernel_info(name)
        assert info["registers"] > 0 and info["blocks_per_sm"] > 0
        assert 0.0 < info["occupancy"] <= 1.0
    info = cull.kernel_info()
    assert info["registers"] > 0 and info["blocks_per_sm"] > 0
    assert info["threads"] == 256 and info["local_bytes"] == 0


def test_skip_cull_kernel_on_unaligned_rows(dev):
    """K4 on 375 boxes (C % 4 != 0: the output rows are not 16-byte
    aligned, so the gated blocks take the scalar +inf stores; 384 padded
    clusters make 3 blocks of 128)."""
    lo, hi, o, inv, tm = cull_trap_case("none", 40.0, dev)
    lo, hi = lo[:375].contiguous(), hi[:375].contiguous()
    kw = dict(t_min=1e-3, n_tiles=7, tile_rays=64)
    mask = torch.empty((7, 3), dtype=torch.int32, device=dev)
    got = cull.tile_cull_skip(lo, hi, o, inv, tm, blk=128, mask_out=mask,
                              **kw)
    assert torch.equal(got, cull.tile_cull_plain(lo, hi, o, inv, tm, **kw))
    assert torch.equal(mask, cull.sc_mask_plain(lo, hi, o, inv, tm, blk=128,
                                                **kw))
    assert 0 < int(mask.sum()) < mask.numel()


def test_skip_cull_kernel_derives_union_boxes_once(dev, monkeypatch):
    """The CUDA route builds K4's union boxes once per box table and blk
    (union_table), not on every call."""
    lo, hi, o, inv, tm = cull_trap_case("far", 40.0, dev)
    calls = []
    real = cull.union_boxes

    def counted(*a):
        calls.append(a[2])
        return real(*a)

    monkeypatch.setattr(cull, "union_boxes", counted)
    kw = dict(t_min=0.0, n_tiles=7, tile_rays=64, blk=128)
    first = cull.tile_cull_skip(lo, hi, o, inv, tm, **kw)
    for _ in range(3):
        assert torch.equal(cull.tile_cull_skip(lo, hi, o, inv, tm, **kw),
                           first)
    assert calls == [128]


def test_skip_cull_kernel_limits_raise(dev):
    """K4 has two limits on the card, and each raises: tiles of more
    than 256 rays, and NB pass words beyond a CTA's shared memory."""
    lo = torch.zeros((8192, 3), device=dev)
    o = torch.zeros((512, 3), device=dev)
    kw = dict(t_min=0.0, n_tiles=1, tile_rays=512, blk=128)
    with pytest.raises(ValueError, match="at most 256"):
        cull.tile_cull_skip(lo, lo, o, o, o[:, 0].contiguous(), **kw)
    kw.update(tile_rays=256, n_tiles=2, blk=1)
    with pytest.raises(ValueError, match="shared memory"):
        cull.tile_cull_skip(lo, lo, o, o, o[:, 0].contiguous(), **kw)


def _bvh_case(n_tris, seed, dev, n_rays=4000):
    """A packed LBVH over a soup and rays: half from random origins, half
    aimed at points of random triangles, the last 64 parked (origin
    1e30) as the integrator parks dead lanes."""
    from pathtracer_torch.accel import lbvh
    from pathtracer_torch.kernels import traverse

    v0, v1, v2 = _soup(n_tris, seed)
    t = n_tris
    verts = torch.stack([v0, v1, v2], 1).reshape(-1, 3)
    idx = torch.arange(3 * t, dtype=torch.int32).reshape(t, 3)
    packed = traverse.pack_bvh(lbvh.build_lbvh(v0, v1, v2), idx, verts)
    o, d = _rays(n_rays, seed + 1, "cpu", park_tail=64)
    rng = np.random.default_rng(seed + 2)
    m = n_rays // 2
    k = torch.from_numpy(rng.integers(0, t, m))
    b = torch.from_numpy(rng.dirichlet((1.0, 1.0, 1.0), m)
                         .astype(np.float32))
    p = b[:, :1] * v0[k] + b[:, 1:2] * v1[k] + b[:, 2:] * v2[k]
    d[m:-64] = torch.nn.functional.normalize(p - o[m:], dim=1)[:-64]
    tm = torch.from_numpy(rng.uniform(0.2, 3.0, n_rays).astype(np.float32))
    return (traverse.PackedBvh(packed.nodes.to(dev), packed.tris.to(dev)),
            o.to(dev), d.to(dev), tm.to(dev))


@pytest.mark.parametrize("n_tris,seed", [(1, 3), (2, 4), (3000, 5),
                                         (20000, 6)])
def test_bvh_kernels_match_plain_bit_for_bit(dev, n_tris, seed):
    """K5 and K6 against their plain versions on the card: hit ids, t, u
    and v bit for bit (scalar and per-ray t_max), blocked flags equal."""
    from pathtracer_torch.kernels import traverse

    packed, o, d, tm = _bvh_case(n_tris, seed, dev)
    before = dict(kernels.LAUNCHES)
    for t_max in (1e20, tm):
        got = traverse.intersect_bvh(packed, o, d, 1e-3, t_max)
        ref = traverse.intersect_bvh_plain(packed, o, d, 1e-3, t_max)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert bool((got.tri >= 0).any())
    occ = traverse.occluded_bvh(packed, o, d, tm)
    assert occ.dtype == torch.bool
    assert torch.equal(occ, traverse.occluded_bvh_plain(packed, o, d, tm))
    assert kernels.LAUNCHES["bvh_closest"] == before["bvh_closest"] + 2
    assert kernels.LAUNCHES["bvh_occluded"] == before["bvh_occluded"] + 1


def test_bvh_wrappers_check_their_inputs(dev):
    from pathtracer_torch.kernels import traverse

    packed, o, d, tm = _bvh_case(300, 7, dev, n_rays=256)
    with pytest.raises(ValueError):
        traverse.intersect_bvh(packed, o.double(), d, 1e-3, 1e20)
    with pytest.raises(ValueError):
        traverse.occluded_bvh(packed, o.t().contiguous().t(), d, tm)
    with pytest.raises(ValueError):
        traverse.occluded_bvh(traverse.PackedBvh(packed.nodes.cpu(),
                                                 packed.tris), o, d, tm)


def test_lbvh_build_on_cuda_matches_cpu(dev):
    from pathtracer_torch.accel import lbvh

    v0, v1, v2 = _soup(80000, 8)
    cpu = lbvh.build_lbvh(v0, v1, v2)
    gpu = lbvh.build_lbvh(v0.to(dev), v1.to(dev), v2.to(dev))
    for f in ("aabb_min", "aabb_max", "hit_link", "miss_link", "tri_id"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f


def test_sobol_on_cuda_matches_cpu(dev):
    from pathtracer_torch.sampling import rng

    g = np.random.default_rng(9)
    pix = torch.from_numpy(g.integers(0, 1 << 22, 1 << 16))
    samp = torch.from_numpy(g.integers(0, 1 << 32, 1 << 16))
    for depth, salt in ((0, rng.SALT_JITTER), (4, rng.SALT_BSDF_UV)):
        cpu = rng.uniform4(pix, samp, depth, salt, 5, sampler="sobol")
        gpu = rng.uniform4(pix.to(dev), samp.to(dev), depth, salt, 5,
                           sampler="sobol")
        assert torch.equal(gpu.cpu(), cpu)


def test_bvh_render_on_cuda_matches_cpu(dev):
    """The bvh route with sobol and the Hosek sky on the card against the
    CPU; primed equal to unprimed on the card."""
    from pathtracer_torch.config import RenderConfig
    from pathtracer_torch.integrator.camera import Camera
    from pathtracer_torch.render import Renderer
    from pathtracer_torch.scene.procedural import cornell_box

    kw = dict(width=32, height=32, spp=2, max_depth=4, spp_batch=True,
              intersector="bvh", sampler="sobol")
    films = {}
    for device, primed in (("cpu", False), (dev, False), (dev, True)):
        c = Camera(position=(0.5, 0.5, 2.2))
        c.look_at((0.5, 0.5, 0.0))
        r = Renderer(cornell_box(materials_suite=True).finalize(
            device="cpu"), RenderConfig(primary_priming=primed, **kw), c,
            device=device)
        films[(str(device), primed)] = (r.run(2).accum.cpu().numpy(),
                                        int(r.last_rays))
    cpu, _ = films[("cpu", False)]
    gpu, rays = films[(str(dev), False)]
    diff = np.abs(cpu - gpu).max(-1)
    assert (diff > 0.01).mean() <= 0.02
    assert abs(cpu.mean() - gpu.mean()) <= 1e-3 * cpu.mean()
    primed, rays_p = films[(str(dev), True)]
    assert rays_p == rays
    np.testing.assert_allclose(primed, gpu, rtol=1e-5, atol=1e-6)


def _gate(img, ref):
    """The robust image gate of benchmarks/run_configs.py:127-131."""
    d = img - ref
    ad = np.abs(d).max(-1)
    inl = ad <= np.percentile(ad, 98.0)
    rmse = float(np.sqrt(np.mean(d[inl] ** 2)))
    mean_rel = abs(float(img.mean()) - float(ref.mean())) / max(
        abs(float(ref.mean())), 1e-6)
    assert rmse <= 5e-3 and (ad > 0.01).mean() <= 0.02 \
        and mean_rel <= 1e-3, (rmse, (ad > 0.01).mean(), mean_rel)


def _one_rank_group(backend, tmp_path):
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    return dist


def test_gloo_all_reduce_on_cuda_tensors(dev, tmp_path):
    """The reductions the sharded path makes, on CUDA tensors through
    gloo (the backend of several ranks on one card): SUM of f32 and
    int64, MAX of int32."""
    dist = _one_rank_group("gloo", tmp_path)
    try:
        f = torch.arange(6, dtype=torch.float32, device=dev)
        n = torch.tensor([5], dtype=torch.int64, device=dev)
        h = torch.tensor([-1, 7], dtype=torch.int32, device=dev)
        dist.all_reduce(f)
        dist.all_reduce(n)
        dist.all_reduce(h, op=dist.ReduceOp.MAX)
        assert f.tolist() == list(range(6)) and n.tolist() == [5]
        assert h.tolist() == [-1, 7] and h.dtype == torch.int32
    finally:
        dist.destroy_process_group()


def test_sharded_render_nccl_world1_matches_single_device(dev, tmp_path):
    """Renderer(mesh=...) over NCCL at world size 1 on a textured
    sponza_like at 64x64, 4 spp, depth 6, cluster route: the film passes
    the gate against the single-device render, the ray counts are equal,
    and K1-K3 launched."""
    from pathtracer_torch.accel.cluster import build_scene_clusters
    from pathtracer_torch.config import RenderConfig
    from pathtracer_torch.integrator.camera import Camera
    from pathtracer_torch.parallel import sharding
    from pathtracer_torch.render import Renderer
    from pathtracer_torch.scene.procedural import sponza_like

    scene = build_scene_clusters(sponza_like(20_000, textured=True)
                                 .finalize(device="cpu"))
    cfg = RenderConfig(width=64, height=64, spp=4, max_depth=6,
                       spp_batch=True)
    dist = _one_rank_group("nccl", tmp_path)
    try:
        out = {}
        for name, mesh in (("single", None), ("mesh", sharding.make_mesh())):
            cam = Camera(position=(3.0, 4.5, 6.0))
            cam.look_at((14.0, 3.0, 6.0))
            kernels.reset_launch_counts()
            r = Renderer(scene, cfg, cam, device=dev, mesh=mesh)
            rays = []
            for _ in range(2):
                r.step()
                rays.append(int(r.last_rays))
            out[name] = (r.film.accum.cpu().numpy(), rays,
                         dict(kernels.LAUNCHES))
        assert out["mesh"][1] == out["single"][1]
        _gate(out["mesh"][0], out["single"][0])
        assert all(out["mesh"][2][k] > 0 for k in
                   ("tile_cull", "sweep_closest", "sweep_occluded"))
    finally:
        dist.destroy_process_group()


def _sponza_glb(tmp_path, tris=20_000):
    from pathtracer_torch.scene.export import export_glb
    from pathtracer_torch.scene.procedural import sponza_like

    path = str(tmp_path / "sponza.glb")
    export_glb(sponza_like(tris, textured=True), path)
    return path


def test_glb_roundtrip_renders_on_cuda_like_the_build(dev, tmp_path):
    """A textured sponza_like exported to .glb and loaded back renders on
    the card (64x64, 4 spp, depth 6, cluster route) with the ray counts
    and, within the gate, the film of the in-memory build; K1-K3
    launched."""
    from pathtracer_torch.accel.cluster import build_scene_clusters
    from pathtracer_torch.config import RenderConfig
    from pathtracer_torch.integrator.camera import Camera
    from pathtracer_torch.render import Renderer
    from pathtracer_torch.scene.gltf import load_gltf
    from pathtracer_torch.scene.procedural import sponza_like

    cfg = RenderConfig(width=64, height=64, spp=4, max_depth=6,
                       spp_batch=True)
    out = {}
    for name, builder in (("build", sponza_like(20_000, textured=True)),
                          ("glb", load_gltf(_sponza_glb(tmp_path)))):
        scene = build_scene_clusters(builder.finalize(device="cpu"))
        cam = Camera(position=(3.0, 4.5, 6.0))
        cam.look_at((14.0, 3.0, 6.0))
        kernels.reset_launch_counts()
        r = Renderer(scene, cfg, cam, device=dev)
        rays = []
        for _ in range(2):
            r.step()
            rays.append(int(r.last_rays))
        out[name] = (r.film.accum.cpu().numpy(), rays,
                     dict(kernels.LAUNCHES))
    assert out["glb"][1] == out["build"][1]
    _gate(out["glb"][0], out["build"][0])
    assert all(out["glb"][2][k] > 0 for k in
               ("tile_cull", "sweep_closest", "sweep_occluded"))


def test_image_decoders_on_card_machine_match_committed_pil_arrays(dev):
    """The native PNG/JPEG decoders, built on a machine with a card and
    without PIL: every committed fixture to RGBA and RGB equal to the
    committed PIL arrays, the 1024x1024 4:2:0 bench JPEGs to the sha256 of
    PIL's decode (chip_smoke.py's images phase checks the same)."""
    import json
    import os

    import image_codecs as ic

    from pathtracer_torch.utils import native

    files, ref = ic.load_fixtures()
    for name, raw in files.items():
        for k, ch in enumerate((4, 3)):
            np.testing.assert_array_equal(native.image_decode(raw, name, ch),
                                          ref[name][k], err_msg=name)
    with open(os.path.join(ic.DATA_DIR, "bench_sha256.json")) as f:
        digests = json.load(f)
    for key, want in digests.items():
        name = key.split(":")[0]
        with open(os.path.join(ic.DATA_DIR, name), "rb") as f:
            assert ic.digest(native.image_rgb(f.read(), name)) == want, name


def test_jpeg_textured_glb_renders_like_the_decoded_arrays(dev, tmp_path):
    """A .glb whose textures are JPEG and 16-bit PNG bytes, rendered on
    the card (64x64, 4 spp, depth 4, cluster route): film and ray counts
    bit for bit those of the same scene built from the committed PIL
    arrays directly; K1-K3 launched."""
    import image_codecs as ic

    from pathtracer_torch.accel.cluster import build_scene_clusters
    from pathtracer_torch.config import RenderConfig
    from pathtracer_torch.integrator.camera import Camera
    from pathtracer_torch.render import Renderer
    from pathtracer_torch.scene.gltf import load_gltf

    files, ref = ic.load_fixtures()
    path = str(tmp_path / "images.glb")
    ic.write_textured_glb(path, files)
    loaded = load_gltf(path)
    with ic.decoded_by_pil(files, ref):
        direct = load_gltf(path)
    cfg = RenderConfig(width=64, height=64, spp=4, max_depth=4,
                       spp_batch=True)
    out = {}
    for name, builder in (("glb", loaded), ("direct", direct)):
        scene = build_scene_clusters(builder.finalize(device="cpu"))
        cam = Camera(position=(3.0, 4.5, 6.0))
        cam.look_at((14.0, 3.0, 6.0))
        kernels.reset_launch_counts()
        r = Renderer(scene, cfg, cam, device=dev)
        r.step()
        out[name] = (r.film.accum.cpu().numpy(), int(r.last_rays),
                     dict(kernels.LAUNCHES))
    assert out["glb"][0].tobytes() == out["direct"][0].tobytes()
    assert out["glb"][1] == out["direct"][1]
    assert all(out["glb"][2][k] > 0 for k in
               ("tile_cull", "sweep_closest", "sweep_occluded"))


@pytest.mark.parametrize("m,n_s", [(4096, 4), (777, 32)])
def test_film_sample_sum_on_cuda_is_the_cpus(dev, m, n_s):
    """render.sample_sum on the card, for sample-major lanes and for
    lanes in a random order (as cfg.wavefront_sort returns them): the
    same bits on every run, and those of index_add_ on the CPU."""
    from pathtracer_torch.render import sample_sum

    g = torch.Generator().manual_seed(m)
    v = torch.randn(n_s * m, 3, generator=g) * 100
    rows = torch.arange(m).repeat(n_s)
    perm = torch.randperm(n_s * m, generator=g)
    for vals, rws in ((v, None), (v[perm], rows[perm])):
        idx = rows if rws is None else rws
        want = torch.zeros(m, 3).index_add_(0, idx, vals)
        order = None if rws is None else torch.argsort(rws.to(dev),
                                                       stable=True)
        runs = [sample_sum(vals.to(dev), order, m, n_s).cpu()
                for _ in range(3)]
        for got in runs:
            assert torch.equal(got, want)


def test_app_composes_glb_and_obj_on_cuda(dev, tmp_path, capsys):
    """app.main with --scene a.glb@... --scene b.obj (a map_Kd PNG from
    the port's encoder) and an LDR PNG env map on --device cuda."""
    import json

    from pathtracer_torch import app
    from pathtracer_torch.utils import native

    rng = np.random.default_rng(0)
    with open(tmp_path / "wood.png", "wb") as f:
        f.write(native.png_encode(rng.integers(0, 256, (8, 8, 3),
                                               dtype=np.uint8)))
    with open(tmp_path / "sky.png", "wb") as f:
        f.write(native.png_encode(rng.integers(0, 256, (16, 32, 3),
                                               dtype=np.uint8)))
    with open(tmp_path / "b.mtl", "w") as f:
        f.write("newmtl wood\nKd 1 1 1\nmap_Kd wood.png\n")
    with open(tmp_path / "b.obj", "w") as f:
        f.write("mtllib b.mtl\nv -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\n"
                "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nusemtl wood\n"
                "f 1/1 2/2 3/3 4/4\n")
    out = str(tmp_path / "c.png")
    rc = app.main(["--scene", _sponza_glb(tmp_path) + "@0,-1,-6,0.5,30",
                   "--scene", str(tmp_path / "b.obj"), "--sky", "envmap",
                   "--envmap", str(tmp_path / "sky.png"), "--width", "64",
                   "--height", "64", "--spp", "2", "--frames", "2",
                   "--device", "cuda", "--out", out])
    assert rc == 0 and open(out, "rb").read(4) == b"\x89PNG"
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert [r["frame"] for r in lines] == [1, 2]
    assert all(r["device"].startswith("cuda") and r["mean_radiance"] > 0
               and r["mrays_per_sec"] > 0 for r in lines)


# --- P1-P3 probe kernels (csrc/probes.cu) ---------------------------------

def chain_case(dtype, seed=0):
    """[64, 1024] inputs: the probe's range, and two rows of the kinds
    that round specially (+-0, f32 and bf16 subnormals, the smallest
    normals, x equal to y), all in [-1, 1], where the chain stays finite
    (its domain: fminf and torch.minimum differ on NaN)."""
    from pathtracer_torch.bench.bf16_probe import probe_inputs

    x, y = probe_inputs("cpu", 64, seed)
    tiny = torch.finfo(torch.bfloat16).tiny
    row = torch.tensor([0.0, -0.0, tiny, -tiny, tiny / 8, -tiny / 64,
                        1e-40, 1e-45, 1.0, -1.0, 0.5, -0.5])
    x[0, :12] = row
    y[0, :12] = row.flip(0)
    y[1, :12] = row
    x[1, :12] = row
    return x.to(dtype), y.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("steps", [1, 2, 9, 4096])
def test_chain_kernel_matches_plain(dev, dtype, steps):
    from pathtracer_torch.kernels import probes

    x, y = chain_case(dtype)
    x, y = x.to(dev), y.to(dev)
    name = "chain_f32" if dtype == torch.float32 else "chain_bf16"
    before = kernels.LAUNCHES[name]
    got = probes.chain(x, y, steps)
    assert kernels.LAUNCHES[name] == before + 1
    ref = probes.chain_plain(x, y, steps)
    assert got.dtype == dtype
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       ref.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32))


def cond_case(kind, dev):
    from pathtracer_torch.bench.cond_probe import probe_input

    if kind == "probe":
        return probe_input(dev)
    rng = np.random.default_rng(7)
    x = rng.integers(0, 3, (1, 64, 512)).astype(np.float32)  # many ties
    if kind == "steps":
        x = x * 7.0 - 150.0 * np.arange(64)[None, :, None]
        x[0, 1::2] += 1e4
        x[0, 3::4] -= 1e4 - 150.0
    return torch.from_numpy(x.astype(np.float32)).to(dev)


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("kind", ["probe", "ties", "steps"])
@pytest.mark.parametrize("n_iter", [1, 256])
def test_cond_walk_kernel_matches_plain(dev, gate, kind, n_iter):
    from pathtracer_torch.kernels import probes

    x = cond_case(kind, dev)
    got = probes.cond_walk(x, n_iter, gate, grid=4)
    ref = probes.cond_walk_plain(x, n_iter, gate)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def exact_schedule(tiles, n_cols, cpi, c, dev):
    """sweep_attrib.schedule cut to its n_cols * cpi entries: the kernel's
    n_cols is then the walk's own (below, at or above the ring's stages),
    where sweep_attrib's padding to lcm(cpi, 128) entries makes it >= 128."""
    from pathtracer_torch.bench import sweep_attrib

    st, si = sweep_attrib.schedule(tiles, n_cols, cpi, c, dev)
    cs = n_cols * cpi
    return st[:, :cs].contiguous(), si[:, :cs].contiguous()


def attrib_stop_case(tiles, n_cols, cpi, stop_col, inf_col, c, dev,
                     seed=5):
    """P3's inputs where the stop rule fires mid-walk: (st, si, rays,
    blocks_lm) of n_cols columns. Cluster 0 is a wall every ray hits
    (each lane the plane z = 5 with u = v = 0.25; rays leave z <= 1
    with dz > 0, so t <= 6 |d| / dz < 1e3) and starts every column 0;
    the other clusters are probe_inputs' random rows. Even tiles: entries
    0 before column stop_col, 1e3 from it, so the variants that test
    lanes stop at stop_col by K2's rule (every ray's best t < 1e3) and
    the others walk on. Odd tiles: +inf from column inf_col, where every
    variant stops."""
    from pathtracer_torch.bench import sweep_attrib

    lm, _ = sweep_attrib.probe_inputs(tiles, c, "cpu", seed=seed)
    lm[0] = 0.0
    lm[0, :, 2] = 1.0     # n = (0, 0, 1)
    lm[0, :, 3] = 5.0     # d
    lm[0, :, 7] = 0.25    # c1: u
    lm[0, :, 11] = 0.25   # c2: v
    lm[0, :, 12] = 1.0    # id row
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.0, 1.0, (tiles, 3, sweep_attrib.R))
    d = rng.normal(size=(tiles, 3, sweep_attrib.R))
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = torch.from_numpy(np.concatenate([o, d], axis=1).astype(
        np.float32))
    st, si = exact_schedule(tiles, n_cols, cpi, c, "cpu")
    si[:, 0] = 0
    st[0::2, stop_col * cpi:] = 1e3
    st[1::2, inf_col * cpi:] = torch.inf
    return st.to(dev), si.to(dev), rays.to(dev), lm.to(dev)


def _attrib_same(got, ref, variant):
    if variant != "full":
        assert bool(torch.isinf(got).all()) and bool(torch.isinf(ref).all())
        return
    assert torch.equal(torch.isfinite(got), torch.isfinite(ref))
    assert bool(torch.isfinite(ref).any())
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("variant", ["empty", "nodma", "noalu", "dma1",
                                     "full"])
@pytest.mark.parametrize("cpi", range(1, 14))
@pytest.mark.parametrize("n_cols", range(1, 6))
def test_sweep_attrib_kernel_matches_plain(dev, variant, cpi, n_cols):
    """Every cpi of 1-13 (rings of 3 stages to cpi 9, 2 from 10) at 1-5
    columns, below, at and above the ring's stages: on the schedule cut
    to its columns and on sweep_attrib's padded one, where the walk stops
    at the first +inf entry (sweep_attrib's 2,048 clusters: dma1 then
    copies up to 1,014 of them)."""
    from pathtracer_torch.bench import sweep_attrib
    from pathtracer_torch.kernels import probes

    tiles, c = 16, sweep_attrib.CLUSTERS
    lm, rays = sweep_attrib.probe_inputs(tiles, c, dev)
    for st, si in (exact_schedule(tiles, n_cols, cpi, c, dev),
                   sweep_attrib.schedule(tiles, n_cols, cpi, c, dev)):
        before = kernels.LAUNCHES["sweep_attrib"]
        got = probes.sweep_attrib(st, si, rays, lm, cpi, variant)
        assert kernels.LAUNCHES["sweep_attrib"] == before + 1
        ref = probes.sweep_attrib_plain(st, si, rays, lm.transpose(1, 2),
                                        cpi, variant)
        _attrib_same(got, ref, variant)


@pytest.mark.parametrize("variant", ["empty", "nodma", "noalu", "dma1",
                                     "full"])
@pytest.mark.parametrize("cpi,n_cols,stop_col,inf_col",
                         [(1, 7, 3, 5), (1, 2, 1, 1), (2, 6, 4, 2),
                          (9, 5, 2, 3), (12, 4, 2, 3), (13, 3, 1, 2)])
def test_sweep_attrib_kernel_stops_mid_walk(dev, variant, cpi, n_cols,
                                            stop_col, inf_col):
    """attrib_stop_case: K2's rule stops the lane-testing variants at
    stop_col on even tiles, a +inf entry every variant at inf_col on odd
    ones, with copies of later columns in flight; full's column count
    (its output less its t) is the plain version's."""
    from pathtracer_torch.kernels import probes

    st, si, rays, lm = attrib_stop_case(16, n_cols, cpi, stop_col, inf_col,
                                        64, dev)
    got = probes.sweep_attrib(st, si, rays, lm, cpi, variant)
    ref = probes.sweep_attrib_plain(st, si, rays, lm.transpose(1, 2), cpi,
                                    variant)
    _attrib_same(got, ref, variant)


@pytest.mark.parametrize("variant", ["empty", "nodma", "noalu", "dma1",
                                     "full"])
@pytest.mark.parametrize("cpi", [1, 9, 10, 13])
def test_sweep_attrib_kernel_at_32_rays(dev, variant, cpi):
    """32-ray tiles (128 threads a block) at 1-5 columns."""
    from pathtracer_torch.bench import sweep_attrib
    from pathtracer_torch.kernels import probes

    tiles, c = 8, 512
    lm, rays = sweep_attrib.probe_inputs(tiles, c, dev)
    rays = rays[:, :, :32].contiguous()
    for n_cols in range(1, 6):
        st, si = exact_schedule(tiles, n_cols, cpi, c, dev)
        got = probes.sweep_attrib(st, si, rays, lm, cpi, variant)
        ref = probes.sweep_attrib_plain(st, si, rays, lm.transpose(1, 2),
                                        cpi, variant)
        _attrib_same(got, ref, variant)


def test_attrib_ring_layout_and_occupancy(dev):
    """The kernel's shared memory is attrib_shmem's for every cpi of
    1-13 at the stages attrib_stages picks; at cpi 1 the ring leaves
    shared memory for at least as many blocks an SM as registers allow
    a 256-thread block of K2 (48 registers: 5)."""
    from pathtracer_torch.kernels import probes

    lib = probes._lib()
    for r in (32, 64):
        for cpi in range(1, 14):
            s = probes.attrib_stages(r, 128, cpi)
            assert lib.pt_attrib_shmem(r, 128, cpi, s) \
                == probes.attrib_shmem(r, 128, cpi, s) <= probes.SHMEM_LIMIT
    for v in probes.VARIANTS:
        info = probes.kernel_info(v, 64, 128, 1)
        assert info["stages"] == 3 and info["local_bytes"] == 0
        assert info["blocks_per_sm"] >= 5, info


def test_probe_wrappers_check_their_inputs(dev):
    from pathtracer_torch.bench import sweep_attrib
    from pathtracer_torch.kernels import probes

    lm, rays = sweep_attrib.probe_inputs(2, 64, dev)
    st, si = sweep_attrib.schedule(2, 1, 14, 64, dev)
    with pytest.raises(ValueError, match="shared memory"):
        probes.sweep_attrib(st, si, rays, lm, 14, "full")
    st, si = sweep_attrib.schedule(2, 1, 1, 64, dev)
    with pytest.raises(ValueError, match="dma1"):
        probes.sweep_attrib(st, si, rays, lm, 1, "dma1")
    with pytest.raises(ValueError, match="int32"):
        probes.sweep_attrib(st, si.long(), rays, lm, 1, "full")
    x = torch.zeros((1, 64, 511), device=dev)
    with pytest.raises(ValueError, match="cond_walk"):
        probes.cond_walk(x)
    with pytest.raises(ValueError, match="even"):
        probes.chain(torch.zeros(3, dtype=torch.bfloat16, device=dev),
                     torch.zeros(3, dtype=torch.bfloat16, device=dev))


# --- the packet layer's knobs ---------------------------------------------

@pytest.mark.parametrize("env", [
    {"PT_TILE_RAYS": "32", "PT_CHUNK_TILES": "4"},
    {"PT_TILE_RAYS": "128"},
    {"PT_TILE_RAYS": "256", "PT_CHUNK_TILES": "2"},
])
def test_packet_knobs_card_equals_cpu(dev, env, monkeypatch):
    """The packet layer under the knobs on the card (K1, K2, K3) finds
    what its CPU route (the plain versions) finds, hit for hit."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    accel = build_clusters(*_soup(2000, 13), method="sahsplit")
    o, d = _rays(1000, 14, torch.device("cpu"), park_tail=50)
    tm = torch.full((1000,), 2.0)
    out = {}
    for where in ("cpu", dev):
        a = accel.to(where)
        hit = packet.intersect_clusters(a, o.to(where), d.to(where), 1e-3,
                                        1e20)
        blocked = packet.occluded_clusters(a, o.to(where), d.to(where),
                                           tm.to(where))
        out[str(where)] = [x.cpu() for x in (hit.t, hit.tri, hit.u, hit.v,
                                             blocked)]
    for x, y in zip(out["cpu"], out[str(dev)]):
        assert torch.equal(x, y)


# --- 128- and 256-ray tiles -----------------------------------------------

@pytest.mark.parametrize("tile_rays", [128, 256])
@pytest.mark.parametrize("n_tris,n_tiles,t_max", [(3000, 12, 3.0),
                                                  (300, 2, 1e20)])
def test_wide_tile_kernels_match_plain(dev, tile_rays, n_tris, n_tiles,
                                       t_max):
    """K1, K2, K3 and K3b at 128 and 256 rays a tile (two threads a ray
    and one): bit for bit their plain versions, one launch each, and
    the same hits as the 64-ray kernels give the same rays."""
    accel = build_clusters(*_soup(n_tris, n_tris),
                           method="sahsplit").to(dev)
    n = tile_rays * n_tiles
    o, d = _rays(n, n_tiles, dev, park_tail=70)
    tm = torch.full((n,), t_max, device=dev)
    inv = packet._safe_inv(d)
    kw = dict(t_min=1e-3, n_tiles=n_tiles, tile_rays=tile_rays)
    before = dict(kernels.LAUNCHES)
    tn = cull.tile_cull(accel.aabb_lo, accel.aabb_hi, o, inv, tm, **kw)
    assert torch.equal(tn, cull.tile_cull_plain(accel.aabb_lo,
                                                accel.aabb_hi, o, inv, tm,
                                                **kw))
    st, si = packet._sorted_schedule(tn)
    rays6 = packet._tile_rays6(o, d, n_tiles, tile_rays)
    cap = packet._scene_exit(accel, o, d, tm).reshape(
        n_tiles, tile_rays).contiguous()
    got = sweep.sweep_closest(st, si, rays6, cap, accel, 1e-3)
    ref = sweep.sweep_closest_plain(st, si, rays6, cap, accel.blocks_t,
                                    1e-3)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert bool((got[1] >= 0).any())
    tm2 = tm.reshape(n_tiles, tile_rays).contiguous()
    occ = sweep.sweep_occluded(st, si, rays6, tm2, accel)
    assert torch.equal(occ, sweep.sweep_occluded_plain(st, si, rays6, tm2,
                                                       accel.blocks_t))
    blk = sweep.sweep_occluded(st, si, rays6, tm2, accel, want_blocker=True)
    ref_b = sweep.sweep_occluded_plain(st, si, rays6, tm2, accel.blocks_t,
                                       want_blocker=True)
    for a, b in zip(blk, ref_b):
        assert torch.equal(a, b)
    assert torch.equal(blk[0], occ)
    assert all(kernels.LAUNCHES[k] == before[k] + 1
               for k in ("tile_cull", "sweep_closest", "sweep_occluded",
                         "sweep_occluded_blocker"))
    # the 64-ray kernels on the same rays find the same hits at the same t
    m = n // 64
    tn64 = cull.tile_cull(accel.aabb_lo, accel.aabb_hi, o, inv, tm,
                          t_min=1e-3, n_tiles=m, tile_rays=64)
    st64, si64 = packet._sorted_schedule(tn64)
    t64, tri64, _, _ = sweep.sweep_closest(
        st64, si64, packet._tile_rays6(o, d, m, 64),
        cap.reshape(m, 64).contiguous(), accel, 1e-3)
    same = (tri64.reshape(-1) >= 0) == (got[1].reshape(-1) >= 0)
    assert bool(same.all())
    hit = got[1].reshape(-1) >= 0
    assert torch.equal(t64.reshape(-1)[hit], got[0].reshape(-1)[hit])


@pytest.mark.parametrize("tile_rays", [128, 256])
def test_wide_tile_kernel_info(dev, tile_rays):
    """The wide-tile sweeps keep 256-thread blocks and spill nothing."""
    for name in ("sweep_closest", "sweep_occluded", "sweep_occluded_blocker"):
        info = sweep.kernel_info(name, tile_rays)
        assert info["threads"] == 256 and info["local_bytes"] == 0
        assert info["registers"] > 0 and info["blocks_per_sm"] > 0


@pytest.mark.parametrize("tile_rays", [128, 256])
@pytest.mark.parametrize("blk", [128, 256])
def test_skip_cull_kernel_on_wide_tiles(dev, tile_rays, blk):
    """K4 on cull_trap_case's first 384 rays as 3 tiles of 128, or its
    first 256 as one tile: bit for bit its plain version and K1."""
    lo, hi, o, inv, tm = cull_trap_case("accel", 40.0, dev)
    n_tiles = 448 // tile_rays
    n = n_tiles * tile_rays
    o, inv, tm = o[:n], inv[:n], tm[:n]
    kw = dict(t_min=1e-3, n_tiles=n_tiles, tile_rays=tile_rays)
    mask = torch.empty((n_tiles, cull.n_blocks(lo.shape[0], blk)),
                       dtype=torch.int32, device=dev)
    got = cull.tile_cull_skip(lo, hi, o, inv, tm, blk=blk, mask_out=mask,
                              **kw)
    assert torch.equal(got, cull.tile_cull_skip_plain(lo, hi, o, inv, tm,
                                                      blk=blk, **kw))
    assert torch.equal(got, cull.tile_cull_plain(lo, hi, o, inv, tm, **kw))
    assert torch.equal(mask, cull.sc_mask_plain(lo, hi, o, inv, tm,
                                                blk=blk, **kw))


def test_sweep_refuses_other_widths(dev):
    accel = build_clusters(*_soup(300, 1), method="sahsplit").to(dev)
    o, d = _rays(96 * 2, 2, dev)
    rays6 = packet._tile_rays6(o, d, 2, 96)
    st = torch.zeros((2, 1), device=dev)
    si = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="128, 256"):
        sweep.sweep_closest(st, si, rays6, torch.ones((2, 96), device=dev),
                            accel, 1e-3)


# --- P2 at the probe's grid ----------------------------------------------

@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("kind", ["probe", "ties", "steps"])
def test_cond_walk_at_the_probe_grid_matches_plain(dev, gate, kind):
    """P2 at the probe's 64 grid steps of a 2-CTA cluster and 256
    iterations: bit for bit the plain version, one launch."""
    from pathtracer_torch.kernels import probes

    x = cond_case(kind, dev)
    name = "cond_walk_gated" if gate else "cond_walk"
    before = kernels.LAUNCHES[name]
    got = probes.cond_walk(x, 256, gate, grid=64)
    assert kernels.LAUNCHES[name] == before + 1
    ref = probes.cond_walk_plain(x, 256, gate)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
