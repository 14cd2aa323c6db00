"""K4, the block-gated tile cull, against the JAX package and against K1.

The JAX side runs its Pallas cull in interpret mode under PT_CULL_SKIP=1
(`tile_cull(..., interpret=True)`), as tests/test_pallas_cull.py does.
K4's plain version must equal it bit for bit and equal the port's K1
plain version; `sc_mask_plain` must equal `_sc_mask` on the real NB
columns. Inputs are the island soup of tests/test_pallas_cull.py (a
spread-out scene and a short t_max, so many blocks really gate).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer.accel.cluster import build_clusters as jbuild_clusters
from pathtracer.kernels import packet as jpacket
from pathtracer.kernels import pallas_cull as jcull
from pathtracer_torch import render as trender
from pathtracer_torch.accel.cluster import build_scene_clusters
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.integrator.camera import Camera
from pathtracer_torch.kernels import LAUNCHES, cull
from pathtracer_torch.scene import procedural
from tests.test_torch_cuda import CULL_TRAPS, cull_trap_case


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads keep this file's CPU render from
    oversubscribing the cores when test files run side by side."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _soup(t, seed, islands=0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    if islands:
        off = (np.arange(t)[:, None] // (t // islands)).astype(
            np.float32) * 25.0
        v0, v1, v2 = v0 + off, v1 + off, v2 + off
    return v0, v1, v2


def _rays(n, seed, park_tail=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if park_tail:
        o[-park_tail:] = jpacket._PARK
        d[-park_tail:] = np.array([0.0, 0.0, 1.0], np.float32)
    return o, d


def _case(n_tris, max_clusters, min_k, n_rays, t_max, seed, islands=10):
    v0, v1, v2 = _soup(n_tris, seed, islands)
    accel = jbuild_clusters(jnp.asarray(v0), jnp.asarray(v1),
                            jnp.asarray(v2), max_clusters=max_clusters,
                            min_k=min_k)
    o, d = _rays(n_rays, seed + 1, park_tail=n_rays // 8)
    tm = np.full((n_rays,), t_max, np.float32)
    tm[-(n_rays // 8):] = 0.0
    inv = np.asarray(jpacket._safe_inv(jnp.asarray(d)))
    return (np.asarray(accel.aabb_lo), np.asarray(accel.aabb_hi), o, inv,
            tm)


def _jax_cull(lo, hi, o, inv, tm, n_tiles, blk, monkeypatch, skip="1"):
    monkeypatch.setenv("PT_CULL_SKIP", skip)
    monkeypatch.setenv("PT_CULL_BLK", str(blk))
    return np.asarray(jcull.tile_cull(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(o), jnp.asarray(inv),
        jnp.asarray(tm), t_min=1e-3, n_tiles=n_tiles, tile_rays=64,
        interpret=True))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# (tris, max_clusters, min_k, rays, t_max, seed, blk): C = 512 (4 blocks of
# 128, 2 of 256), and C = 375 (not a lane multiple: padded to 384, 3 blocks
# of 128; 384 % 256 != 0, so blk 256 takes K1 in both packages)
CASES = [(4096, 512, 4, 256, 40.0, 11, 128),
         (4096, 512, 4, 256, 40.0, 11, 256),
         (3000, 512, 4, 192, 1e20, 31, 128),
         (3000, 512, 4, 192, 1e20, 31, 256)]


@pytest.mark.parametrize("case", CASES)
def test_skip_plain_matches_jax_and_k1(case, monkeypatch):
    *shape, blk = case
    lo, hi, o, inv, tm = _case(*shape)
    n_tiles = o.shape[0] // 64
    kw = dict(t_min=1e-3, n_tiles=n_tiles, tile_rays=64)
    ref = _jax_cull(lo, hi, o, inv, tm, n_tiles, blk, monkeypatch)
    tlo, thi, to, tinv, ttm = _t(lo, hi, o, inv, tm)
    k1 = cull.tile_cull_plain(tlo, thi, to, tinv, ttm, **kw).numpy()
    np.testing.assert_array_equal(k1, ref)
    if not cull.gated(lo.shape[0], blk):
        assert lo.shape[0] == 375 and blk == 256
        return
    pairs = torch.zeros((), dtype=torch.int64)
    k4 = cull.tile_cull_skip_plain(tlo, thi, to, tinv, ttm, blk=blk,
                                   pair_tests=pairs, **kw).numpy()
    np.testing.assert_array_equal(k4, ref)
    np.testing.assert_array_equal(k4, k1)
    # the gate really skips here, and the count is below K1's pairs
    mask = cull.sc_mask_plain(tlo, thi, to, tinv, ttm, blk=blk, **kw)
    assert 0 < int(mask.sum()) < mask.numel()
    live = int((to[:, 0] < 1e29).sum())
    real = int((tlo[:, 0] < 1e29).sum())
    assert 0 < int(pairs) < live * (mask.shape[1] + real)


@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[2]])
def test_sc_mask_matches_jax(case):
    *shape, blk = case
    lo, hi, o, inv, tm = _case(*shape)
    n_tiles = o.shape[0] // 64
    c = lo.shape[0]
    pad = (-c) % jcull.LANES
    far = np.full((pad, 3), 1e30, np.float32)
    ab = jnp.concatenate([jnp.asarray(np.concatenate([lo, far])).T,
                          jnp.asarray(np.concatenate([hi, far])).T])
    ref = np.asarray(jcull._sc_mask(ab, jnp.asarray(o), jnp.asarray(inv),
                                    jnp.asarray(tm), 1e-3, n_tiles, 64,
                                    blk))
    got = cull.sc_mask_plain(*_t(lo, hi, o, inv, tm), t_min=1e-3,
                             n_tiles=n_tiles, tile_rays=64, blk=blk).numpy()
    nb = (c + pad) // blk
    assert got.shape == (n_tiles, nb) and got.dtype == np.int32
    np.testing.assert_array_equal(got, ref[:, :nb])
    assert (ref[:, nb:] == 0).all()


@pytest.mark.parametrize("blk,tris,c", [(128, 1500, 94), (256, 3000, 375),
                                        (256, 4096, 512)])
def test_tile_cull_routes_like_jax(blk, tris, c, monkeypatch):
    """PT_CULL_SKIP=1 takes K4 exactly where the JAX rule gates
    (Cp % blk == 0 and Cp // blk >= 2), else K1, and both equal JAX."""
    lo, hi, o, inv, tm = _case(tris, c if c < 128 else 512, 4, 128, 30.0,
                               41)
    assert lo.shape[0] == c
    ref = _jax_cull(lo, hi, o, inv, tm, 2, blk, monkeypatch)
    calls = []
    real_skip = cull.tile_cull_skip_plain

    def counted(*a, **kw):
        calls.append(kw["blk"])
        return real_skip(*a, **kw)

    monkeypatch.setattr(cull, "tile_cull_skip_plain", counted)
    got = cull.tile_cull(*_t(lo, hi, o, inv, tm), t_min=1e-3, n_tiles=2,
                         tile_rays=64).numpy()
    np.testing.assert_array_equal(got, ref)
    assert calls == ([blk] if cull.gated(c, blk) else [])
    assert cull.gated(c, blk) == (c == 512)
    monkeypatch.setenv("PT_CULL_SKIP", "0")
    calls.clear()
    np.testing.assert_array_equal(
        cull.tile_cull(*_t(lo, hi, o, inv, tm), t_min=1e-3, n_tiles=2,
                       tile_rays=64).numpy(), ref)
    assert calls == []


def test_skip_wrapper_rejects_ungated_counts():
    lo = torch.zeros((128, 3))
    with pytest.raises(ValueError, match="2 whole blocks"):
        cull.tile_cull_skip(lo, lo, torch.zeros((64, 3)),
                            torch.ones((64, 3)), torch.ones(64), t_min=0.0,
                            n_tiles=1, tile_rays=64, blk=128)


def test_render_with_skip_equals_k1_render(monkeypatch):
    """A 32x32 sponza_like frame (>= 2 blocks of 128 clusters) renders the
    same film and ray count with PT_CULL_SKIP=1 as without, and the skip
    path ran (counted on its plain route; LAUNCHES counts CUDA launches
    only, so it stays 0 here)."""
    scene = build_scene_clusters(procedural.sponza_like(
        target_tris=40_000).finalize(device="cpu"))
    assert scene.clusters.n_clusters >= 256
    cam = Camera(position=(3.0, 4.5, 6.0))
    cam.look_at((14.0, 3.0, 6.0))
    cfg = RenderConfig(width=32, height=32, spp=1, max_depth=2)
    state = cam.state(device="cpu")
    base, rays = trender.render_frame_with_stats(scene, cfg, state, 0)
    calls = []
    real_skip = cull.tile_cull_skip_plain

    def counted(*a, **kw):
        calls.append(kw["blk"])
        return real_skip(*a, **kw)

    monkeypatch.setattr(cull, "tile_cull_skip_plain", counted)
    monkeypatch.setenv("PT_CULL_SKIP", "1")
    before = dict(LAUNCHES)
    gated_img, rays_g = trender.render_frame_with_stats(scene, cfg, state, 0)
    assert calls and set(calls) == {128}
    assert LAUNCHES == before
    assert int(rays_g) == int(rays)
    assert torch.equal(gated_img, base)


def _np_slab(lo, hi, o, inv, tm, t_min):
    """K1's slab and accept test in numpy float32 (the same roundings)."""
    with np.errstate(over="ignore"):     # parked rays: 1e30 * 1e20 -> inf
        t1 = (lo - o) * inv
        t2 = (hi - o) * inv
    tn = np.minimum(t1, t2).max(-1)
    tf = np.maximum(t1, t2).min(-1)
    return (tn <= tf) & (tf >= t_min) & (tn <= tm)


def test_skip_pair_count_on_packet_chunk():
    """pair_tests counts the slab tests the data needs, tile by tile, on
    a chunk the packet layer pads: unparked rays against the root box,
    the live ones against the NB union boxes, and each kept block's
    passing unparked rays against its real clusters; kernel_tests the
    tests the kernel runs (every ray against the root box, the live rays
    against the union boxes, the passing rays against all C clusters)."""
    lo, hi, o, inv, tm = _case(4096, 512, 4, 256, 40.0, 11)
    tlo, thi, to, tinv, ttm = _t(lo, hi, o, inv, tm)
    pairs = torch.zeros((), dtype=torch.int64)
    tests = torch.zeros((), dtype=torch.int64)
    cull.tile_cull_skip_plain(tlo, thi, to, tinv, ttm, t_min=1e-3,
                              n_tiles=4, tile_rays=64, blk=128,
                              pair_tests=pairs, kernel_tests=tests)
    ulo = lo.reshape(4, 128, 3).min(1)
    uhi = hi.reshape(4, 128, 3).max(1)
    live = _np_slab(ulo.min(0), uhi.max(0), o, inv, tm, 1e-3)   # [256]
    passes = _np_slab(ulo[None], uhi[None], o[:, None], inv[:, None],
                      tm[:, None], 1e-3) & live[:, None]          # [256, 4]
    unparked = o[:, 0] < 1e29
    real = (lo[:, 0] < 1e29).reshape(4, 128).sum(1)
    want = (unparked.sum() + (unparked & live).sum() * 4
            + ((passes & unparked[:, None]).sum(0) * real).sum())
    assert 0 < live.sum() < 256 and 0 < passes.sum() < live.sum() * 4
    assert int(pairs) == int(want)
    assert int(tests) == 256 + live.sum() * 4 + passes.sum() * 128


@pytest.mark.parametrize("blk", [128, 256])
@pytest.mark.parametrize("pads", ["none", "far"])
def test_union_table_equals_union_boxes(pads, blk):
    """K4's box table holds union_boxes' boxes bit for bit and their
    union, with and without far pads, and is derived once per box table
    and blk (again after an in-place change)."""
    lo, hi = cull_trap_case(pads, 40.0)[:2]
    nb = cull.n_blocks(lo.shape[0], blk)
    table = cull.union_table(lo, hi, blk)
    ulo, uhi = cull.union_boxes(lo, hi, blk)

    def bits(x):
        return x.contiguous().view(torch.int32)

    assert table.shape == (nb + 1, 6) and ulo.shape == (nb, 3)
    assert torch.equal(bits(table[:nb, :3]), bits(ulo))
    assert torch.equal(bits(table[:nb, 3:]), bits(uhi))
    assert torch.equal(bits(table[nb]), bits(torch.cat([ulo.amin(0),
                                                        uhi.amax(0)])))
    assert bool((table[nb, 3:] == 1e30).all()) == (pads == "far")
    assert cull.union_table(lo, hi, blk) is table
    assert cull.union_table(lo, hi, 64) is not table
    lo[0] -= 1.0
    moved = cull.union_table(lo, hi, blk)
    assert moved is not table
    assert torch.equal(moved[:nb, :3], cull.union_boxes(lo, hi, blk)[0])


@pytest.mark.parametrize("trap", CULL_TRAPS)
def test_skip_ray_rule_is_exact_on_adversarial_chunk(trap):
    """The rays K4's kernel drops (skip_ray_sets_plain: those outside the
    root box, and per kept block those outside its union box) change
    neither tile_cull_skip_plain nor sc_mask_plain: a NaN t_max fails
    every accept test, so the dropped rays are removed that way. The
    traps stay in: parked rays meet pad boxes at t = 0 when t_min is 0,
    and parked rays with three equal negative 1/d components meet every
    real box when t_max is infinite."""
    pads, t_min, t_max = trap
    lo, hi, o, inv, tm = cull_trap_case(pads, t_max)
    kw = dict(t_min=t_min, n_tiles=7, tile_rays=64)
    nan = torch.tensor(float("nan"))
    k1 = cull.tile_cull_plain(lo, hi, o, inv, tm, **kw)
    parked = (o[:, 0] >= 1e29).reshape(7, 64)
    corner = parked & (inv[:, 0] < 0).reshape(7, 64)
    assert bool((inv[corner.reshape(-1)] == inv[corner.reshape(-1)][0, 0])
                .all()) and float(inv[corner.reshape(-1)][0, 0]) < 0
    padded = pads != "none"
    real = lo[:, 0] < 1e29
    for blk in (128, 256):
        base = cull.tile_cull_skip_plain(lo, hi, o, inv, tm, blk=blk, **kw)
        mask = cull.sc_mask_plain(lo, hi, o, inv, tm, blk=blk, **kw)
        assert torch.equal(base, k1)
        live, passes = cull.skip_ray_sets_plain(lo, hi, o, inv, tm, blk=blk,
                                                **kw)
        tm_live = torch.where(live.reshape(-1), tm, nan)
        assert torch.equal(cull.tile_cull_skip_plain(
            lo, hi, o, inv, tm_live, blk=blk, **kw), base)
        assert torch.equal(cull.sc_mask_plain(
            lo, hi, o, inv, tm_live, blk=blk, **kw), mask)
        assert torch.equal(passes.any(dim=2).to(torch.int32), mask)
        for b in range(mask.shape[1]):
            cols = slice(b * blk, min((b + 1) * blk, lo.shape[0]))
            tm_b = torch.where(passes[:, b].reshape(-1), tm, nan)
            assert torch.equal(cull.tile_cull_plain(
                lo[cols], hi[cols], o, inv, tm_b, **kw), base[:, cols])
        # what is kept and what is dropped
        assert not bool(live[5].any())                 # leaving the scene
        pad_ok = t_min == 0.0 and padded
        assert torch.equal(live[parked & ~corner],
                           torch.full_like(live[parked & ~corner], pad_ok))
        assert bool(live[corner].all()) == (padded or t_max == np.inf)
        assert bool(mask[2, -1]) == pad_ok and not bool(mask[2, :-1].any())
        assert torch.equal(base[2][~real] == 0.0,
                           torch.full_like(base[2][~real] == 0.0, pad_ok))
        hits = torch.isfinite(base[4][real])
        assert torch.equal(hits, torch.full_like(hits, t_max == np.inf))
        assert bool((base[4][real][hits] > 1e29).all())
