"""Packet traversal at 128- and 256-ray tiles, port vs the JAX package.

The JAX package takes any tile width (`intersect_clusters(tile_rays=)`,
`PT_TILE_RAYS`); the port's sweep kernels take 32, 64, 128 and 256 (one
256-thread block a tile: four threads a ray up to 64 rays, two at 128,
one at 256). On the CPU the port runs the plain versions, which take any
width, so these hold the port's packet layer at 128 and 256 to:

- the JAX functions called with the same `tile_rays=` on the same accel
  (the JAX build carried into the port) and the brute-force oracle
  (every triangle, no accel): the same triangle for every ray, t within
  the 64-wide parity tests' bar (rtol 1e-4, atol 1e-5: XLA contracts
  FMAs on the host, the port keeps separate roundings) - or, for at
  most 0.5% of rays, another triangle at the same t within that bar
  (sponza_like's coplanar ties and near-ties, which the two roundings
  can resolve apart, as they do at 64 rays a tile) - the same
  occlusion, and blocker hints that block;
- the JAX Pallas sweeps in interpret mode at the same width, on the same
  schedule: K2's triangles, K3's occlusion and K3b's hints;

on the test soups (sorted and unsorted rays, ragged counts, several
chunks with a parked one) and on a small textured sponza_like. The
widths' knob, the plain sweeps' kernel-test count at two threads a ray
and one, and the refusal of other widths are checked too.

    python -m pytest tests/test_torch_tile_widths.py -q -p no:randomly
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer.accel.cluster import build_clusters as jbuild
from pathtracer.kernels import packet as jpacket
from pathtracer.kernels.intersect import intersect_brute, occluded_brute
from pathtracer.scene import procedural as jproc
from pathtracer_torch.accel.cluster import accel_from_numpy, build_clusters
from pathtracer_torch.kernels import cull, packet, sweep

WIDE = (128, 256)
T_RTOL, T_ATOL = 1e-4, 1e-5      # the 64-wide parity tests' bar


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _soup(t, seed=0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    return v0, v1, v2


def _rays(n, seed=1, lo=-2.0, hi=2.0, park=None):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if park is not None:
        o[park] = 1e30
        d[park] = 1.0
    return o, d


def _carry(ja):
    return accel_from_numpy(*(np.asarray(getattr(ja, f)) for f in
                              ("aabb_lo", "aabb_hi", "blocks_t")),
                            device="cpu")


def _T(a):
    return torch.from_numpy(np.array(a))


def _compare(ja, ta, v, o, d, tile_rays, t_max=2.0, **kw):
    """Port vs JAX (same tile_rays and kwargs) vs brute: hits, t,
    occlusion and blocker hints."""
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    jv = [jnp.asarray(x) for x in v]
    ref = intersect_brute(jo, jd, *jv, 1e-3, 1e20)
    jh = jpacket.intersect_clusters(ja, jo, jd, 1e-3, 1e20,
                                    tile_rays=tile_rays, **kw)
    th = packet.intersect_clusters(ta, _T(o), _T(d), 1e-3, 1e20,
                                   tile_rays=tile_rays, **kw)
    # JAX's triangle and the oracle's, or another one at the same t
    # within the bar: sponza_like's coplanar overlapping triangles make
    # ties and near-ties, which XLA's FMAs and the port's separate
    # roundings can resolve apart (at 64 rays a tile as at 128 and 256)
    for other_hit in (jh, ref):
        other = th.tri.numpy() != np.asarray(other_hit.tri)
        assert (np.asarray(other_hit.tri)[other] >= 0).all()
        assert (th.tri.numpy()[other] >= 0).all()
        np.testing.assert_allclose(th.t.numpy()[other],
                                   np.asarray(other_hit.t)[other],
                                   rtol=T_RTOL, atol=T_ATOL)
        assert other.sum() <= 0.005 * len(o)
    hit = np.asarray(jh.tri) >= 0
    assert hit.sum() > 0
    np.testing.assert_allclose(th.t.numpy()[hit], np.asarray(jh.t)[hit],
                               rtol=T_RTOL, atol=T_ATOL)
    tm = np.full(len(o), t_max, np.float32)
    ob = np.asarray(occluded_brute(jo, jd, jnp.asarray(tm), *jv))
    jb, jbt = jpacket.occluded_clusters(ja, jo, jd, jnp.asarray(tm),
                                        tile_rays=tile_rays,
                                        want_blocker=True, **kw)
    tb, tbt = packet.occluded_clusters(ta, _T(o), _T(d), _T(tm),
                                       tile_rays=tile_rays,
                                       want_blocker=True, **kw)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tb.numpy(), ob)
    assert 0 < ob.sum() < len(o)
    # hints: JAX's XLA route names a blocker by its own Moller-Trumbore
    # rule, the sweeps by K3b's (test_wide_sweeps_match_pallas_interpret
    # holds those to the Pallas kernel); here every hint must block
    np.testing.assert_array_equal(tbt.numpy() >= 0, tb.numpy())
    assert (np.asarray(jbt) >= 0).sum() == tb.numpy().sum()
    sel = tbt >= 0
    rows = ta.bw_rows[tbt[sel].long()]
    _, _, _, ok = sweep.bw_hit(rows, _T(o)[sel], _T(d)[sel], 0.0,
                               _T(tm)[sel], front_only=True)
    assert bool(ok.all())
    blocked = packet.occluded_clusters(ta, _T(o), _T(d), _T(tm),
                                       tile_rays=tile_rays, **kw)
    np.testing.assert_array_equal(blocked.numpy(), ob)


@pytest.mark.parametrize("tile_rays", WIDE)
@pytest.mark.parametrize("sort_rays", [True, False])
def test_soup_matches_jax_and_brute(tile_rays, sort_rays):
    """300 triangles, 700 rays (ragged: not whole tiles), the JAX morton
    accel carried into the port."""
    v = _soup(300)
    ja = jbuild(*(jnp.asarray(x) for x in v), max_clusters=16)
    o, d = _rays(700)
    _compare(ja, _carry(ja), v, o, d, tile_rays, sort_rays=sort_rays)


@pytest.mark.parametrize("tile_rays", WIDE)
@pytest.mark.parametrize("seed,max_c", [(2, 16), (5, 4)])
def test_wide_sweeps_match_pallas_interpret(tile_rays, seed, max_c):
    """K2, K3 and K3b's plain versions at 128 and 256 rays a tile against
    the JAX Pallas sweeps in interpret mode on the same schedule: the
    same triangles (t within 1e-5: XLA contracts FMAs on the host), the
    same occlusion, the same blocker hints bit for bit."""
    from pathtracer.kernels import pallas_sweep

    v = _soup(300, seed)
    ja = jbuild(*(jnp.asarray(x) for x in v), max_clusters=max_c)
    ta = _carry(ja)
    n_tiles = 3
    o, d = (_T(x) for x in _rays(n_tiles * tile_rays, seed=seed + 1))
    tm = torch.full((o.shape[0],), 2.0)
    tn = cull.tile_cull_plain(ta.aabb_lo, ta.aabb_hi, o, packet._safe_inv(d),
                              tm, t_min=1e-3, n_tiles=n_tiles,
                              tile_rays=tile_rays)
    st, si = packet._sorted_schedule(tn)
    rays6 = packet._tile_rays6(o, d, n_tiles, tile_rays)
    tm2 = tm.reshape(n_tiles, tile_rays)
    cap = packet._scene_exit(ta, o, d, tm).reshape(n_tiles, tile_rays)
    j = [jnp.asarray(x.numpy()) for x in (st, si, rays6)]
    jbt = jnp.asarray(np.asarray(ja.blocks_t))
    ref = pallas_sweep.sweep_closest(*j, jnp.asarray(cap.numpy()), jbt, 1e-3,
                                     interpret=True)
    got = sweep.sweep_closest(st, si, rays6, cap, ta, 1e-3)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    hit = np.asarray(ref[1]) >= 0
    assert hit.sum() > 10
    np.testing.assert_allclose(got[0].numpy()[hit], np.asarray(ref[0])[hit],
                               rtol=1e-5)
    ref_o = np.asarray(pallas_sweep.sweep_occluded(
        *j, jnp.asarray(tm2.numpy()), jbt, interpret=True))
    np.testing.assert_array_equal(
        sweep.sweep_occluded(st, si, rays6, tm2, ta).numpy(), ref_o)
    ref_b = pallas_sweep.sweep_occluded(*j, jnp.asarray(tm2.numpy()), jbt,
                                        interpret=True, want_blocker=True)
    got_b = sweep.sweep_occluded(st, si, rays6, tm2, ta, want_blocker=True)
    for x, y in zip(got_b, ref_b):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert 0 < ref_o.sum() < ref_o.size


@pytest.mark.parametrize("tile_rays", WIDE)
def test_chunks_with_a_parked_one_match_jax(tile_rays):
    """Chunks of two tiles, the second all parked (skipped), the port's
    own sahsplit build against the JAX traversal of the same tables."""
    v = _soup(500, seed=3)
    ta = build_clusters(*(_T(x) for x in v), method="sahsplit")
    n = 5 * tile_rays + 37
    park = np.zeros(n, bool)
    park[2 * tile_rays:4 * tile_rays] = True
    o, d = _rays(n, seed=4, park=park)
    ja = jbuild(*(jnp.asarray(x) for x in v), max_clusters=16)
    ja = dataclasses.replace(ja, **{f: jnp.asarray(getattr(ta, f).numpy())
                                    for f in ("aabb_lo", "aabb_hi",
                                              "blocks_t")})
    _compare(ja, ta, v, o, d, tile_rays, sort_rays=False,
             chunk_rays=2 * tile_rays)
    assert packet.chunk_live(_T(o), 2 * tile_rays)[1] is False


@pytest.fixture(scope="module")
def sponza():
    """A small textured sponza_like: (JAX accel, carried accel, vertices)
    and rays from inside the hall."""
    b = jproc.sponza_like(target_tris=3000, textured=True)
    s = b.finalize()
    pos, idx = np.asarray(s.positions), np.asarray(s.indices)
    v = [pos[idx[:, k]] for k in range(3)]
    ja = jbuild(*(jnp.asarray(x) for x in v), max_clusters=64)
    lo = np.min([x.min(0) for x in v], 0)
    hi = np.max([x.max(0) for x in v], 0)
    rng = np.random.default_rng(5)
    n = 1500
    o = (lo + (hi - lo) * rng.uniform(0.1, 0.9, (n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return ja, _carry(ja), v, o, d


@pytest.mark.parametrize("tile_rays", WIDE)
def test_sponza_like_matches_jax_and_brute(sponza, tile_rays):
    ja, ta, v, o, d = sponza
    _compare(ja, ta, v, o, d, tile_rays, t_max=3.0)


@pytest.mark.parametrize("tile_rays", WIDE)
def test_knob_takes_wide_tiles(tile_rays, monkeypatch):
    """PT_TILE_RAYS=128/256 is the width of a call that names none, and
    its chunk is PT_CHUNK_TILES x PT_TILE_RAYS rays."""
    monkeypatch.setenv("PT_TILE_RAYS", str(tile_rays))
    monkeypatch.setenv("PT_CHUNK_TILES", "2")
    assert packet.tile_rays_knob() == tile_rays
    assert packet._call_shape(None, None) == (tile_rays, 2 * tile_rays)
    v = _soup(200, seed=6)
    ta = build_clusters(*(_T(x) for x in v), method="sahsplit")
    o, d = _rays(3 * tile_rays + 5, seed=7)
    by_knob = packet.intersect_clusters(ta, _T(o), _T(d), 1e-3, 1e20)
    monkeypatch.delenv("PT_TILE_RAYS")
    named = packet.intersect_clusters(ta, _T(o), _T(d), 1e-3, 1e20,
                                      tile_rays=tile_rays,
                                      chunk_rays=2 * tile_rays)
    for a, b in zip(by_knob, named):
        assert torch.equal(a, b)


@pytest.mark.parametrize("env,kw", [({"PT_TILE_RAYS": "96"}, {}),
                                    ({"PT_TILE_RAYS": "512"}, {}),
                                    ({}, {"tile_rays": 48})])
def test_other_widths_raise_naming_the_widths(env, kw, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    v = _soup(50, seed=8)
    ta = build_clusters(*(_T(x) for x in v), method="sahsplit")
    o, d = _rays(64, seed=9)
    with pytest.raises(ValueError, match="32, 64, 128, 256"):
        packet.intersect_clusters(ta, _T(o), _T(d), 1e-3, 1e20, **kw)
    with pytest.raises(ValueError, match="32, 64, 128, 256"):
        packet.occluded_clusters(ta, _T(o), _T(d), torch.full((64,), 1.0),
                                 **kw)


@pytest.mark.parametrize("tile_rays", [64, 128, 256])
def test_kernel_test_count_follows_the_threads_a_ray(tile_rays):
    """sweep_closest_plain's kernel_tests at parts(R) threads a ray (4,
    2, 1): per visited column and warp of 32 rays of one part, the
    longest thread's lanes x 32, recounted here from the walk."""
    assert sweep.parts(tile_rays) == {64: 4, 128: 2, 256: 1}[tile_rays]
    v = _soup(400, seed=10)
    ta = build_clusters(*(_T(x) for x in v), method="sahsplit")
    n_tiles = 3
    # origins inside the soup's box: every ray's scene-exit cap > t_min
    o, d = (_T(x) for x in _rays(n_tiles * tile_rays, seed=11, lo=-0.5,
                                 hi=0.5))
    tm = torch.full((o.shape[0],), 1e20)
    tn = cull.tile_cull_plain(ta.aabb_lo, ta.aabb_hi, o, packet._safe_inv(d),
                              tm, t_min=1e-3, n_tiles=n_tiles,
                              tile_rays=tile_rays)
    st, si = packet._sorted_schedule(tn)
    rays6 = packet._tile_rays6(o, d, n_tiles, tile_rays)
    cap = packet._scene_exit(ta, o, d, tm).reshape(n_tiles, tile_rays)
    tests = torch.zeros((), dtype=torch.int64)
    cols = torch.zeros(n_tiles, dtype=torch.int64)
    sweep.sweep_closest_plain(st, si, rays6, cap, ta.blocks_t, 1e-3,
                              kernel_tests=tests, tile_columns=cols)
    # every ray has best t > t_min here, so in each visited column a
    # thread of part q tests lanes q, q + p, ... below n_lanes: each of
    # part q's R / 32 warps runs ceil((n_lanes - q) / p) lane slots of 32
    p = sweep.parts(tile_rays)
    n_lanes = ta.n_lanes.long()
    want = 0
    for t in range(n_tiles):
        for j in range(int(cols[t])):
            n = int(n_lanes[si[t, j]])
            want += sum(-(-(n - q) // p) for q in range(p)) * tile_rays
    assert int(tests) == want and want > 0
