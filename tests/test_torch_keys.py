"""Coherence keys, K7/K8's plain versions, schedules, fetch groups and the
wavefront order, port vs the JAX package, bit for bit.

- `_mixed_key` and `_coherence_key` under every scheme (dirmajor, mixed,
  firstcluster) at 1-3 direction bits, and the knobs that choose them
  (PT_KEY_SCHEME, PT_DIR_BITS);
- `_first_cluster` (K8's plain version `cull.first_cluster_plain`): ids
  and entries over 375 clusters (two blocks of 256, a tie rule across
  them), rays inside boxes (entry 0 in many clusters: lowest id wins),
  parked rays (id 0, +inf) and pad boxes;
- `_frustum_cull` (K7's plain version `cull.frustum_cull_plain`) at tile
  widths 32, 64, 128 and 256, with parked rays and per-ray t_max;
- `_packed_schedule_sort` (PT_SCHED_PACK), `_group_blocks` (fetch
  groups 2-4 with a ragged last group) and `integrator/path.
  _wavefront_order`.

    python -m pytest tests/test_torch_keys.py -q -p no:randomly
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pathtracer.accel.cluster import build_clusters as jbuild
from pathtracer.integrator import path as jpath
from pathtracer.kernels import packet as jpacket
from pathtracer.scene import procedural as jproc
from pathtracer_torch.accel.cluster import accel_from_numpy
from pathtracer_torch.accel import morton as tmorton
from pathtracer_torch.integrator import path as tpath
from pathtracer_torch.kernels import cull
from pathtracer_torch.kernels import packet as tpacket
from pathtracer_torch.scene import procedural as tproc


def _soup(t, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    return v0, v1, v2


def _rays(n, seed, park=0, spread=2.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if park:
        o[-park:] = 1e30
        d[-park:] = 1.0
    return o, d


def _accels(t=3000, seed=4, method="morton", **kw):
    """(JAX accel, the port's carried accel) over one soup."""
    ja = jbuild(*(jnp.asarray(x) for x in _soup(t, seed)), method=method,
                **kw)
    ta = accel_from_numpy(*(np.asarray(getattr(ja, f)) for f in
                            ("aabb_lo", "aabb_hi", "blocks_t")),
                          device="cpu")
    return ja, ta


@pytest.fixture(scope="module")
def morton375():
    """3000 triangles in 375 clusters of 8 (K8 walks two 256-blocks)."""
    return _accels(3000, 4, "morton", max_clusters=512, min_k=8)


@pytest.fixture(scope="module")
def padded():
    """A sahsplit accel: 128 clusters, most of them pad boxes at 1e30."""
    return _accels(900, 5, "sahsplit", max_clusters=64, min_k=128)


@pytest.mark.parametrize("dir_bits", [2, 3, 4])
def test_mixed_key_bit_exact(dir_bits):
    o, d = _rays(4000, 7)
    m = np.random.default_rng(8).integers(0, 1 << 30, 4000, dtype=np.uint32)
    ref = np.asarray(jpacket._mixed_key(jnp.asarray(m), 30, jnp.asarray(d),
                                        dir_bits))
    got = tpacket._mixed_key(torch.from_numpy(m.astype(np.int64)), 30,
                             torch.from_numpy(d), dir_bits)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("scheme", ["dirmajor", "mixed", "firstcluster"])
@pytest.mark.parametrize("dir_bits", [1, 2, 3])
def test_coherence_key_schemes_bit_exact(morton375, scheme, dir_bits):
    ja, ta = morton375
    o, d = _rays(3000, 9, park=100)
    ref = np.asarray(jpacket._coherence_key(ja, jnp.asarray(o),
                                            jnp.asarray(d), dir_bits,
                                            scheme=scheme))
    got = tpacket._coherence_key(ta, torch.from_numpy(o),
                                 torch.from_numpy(d), dir_bits,
                                 scheme=scheme).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    assert (got[-100:] == 0xFFFFFFFF).all()


def test_key_knobs_choose_scheme_and_bits(morton375, monkeypatch):
    """PT_KEY_SCHEME and PT_DIR_BITS are read where the JAX package reads
    them (a call without scheme / dir_bits); a bad scheme raises."""
    ja, ta = morton375
    o, d = _rays(1000, 10)
    monkeypatch.setenv("PT_KEY_SCHEME", "mixed")
    monkeypatch.setenv("PT_DIR_BITS", "3")
    ref = np.asarray(jpacket._coherence_key(ja, jnp.asarray(o),
                                            jnp.asarray(d)))
    got = tpacket._coherence_key(ta, torch.from_numpy(o),
                                 torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    assert not np.array_equal(got, tpacket._coherence_key(
        ta, torch.from_numpy(o), torch.from_numpy(d), 3,
        scheme="dirmajor").numpy())
    monkeypatch.setenv("PT_KEY_SCHEME", "morton")
    with pytest.raises(ValueError, match="PT_KEY_SCHEME"):
        tpacket._coherence_key(ta, torch.from_numpy(o), torch.from_numpy(d))


@pytest.mark.parametrize("which", ["morton375", "padded"])
def test_first_cluster_bit_exact(which, request):
    """ids and entries; rays start inside the soup (many ties at entry 0)
    and the last 70 are parked."""
    ja, ta = request.getfixturevalue(which)
    o, d = _rays(2000, 11, park=70, spread=1.0)
    rid, rt = jpacket._first_cluster(ja, jnp.asarray(o), jnp.asarray(d))
    tid, tt = tpacket._first_cluster(ta, torch.from_numpy(o),
                                     torch.from_numpy(d))
    np.testing.assert_array_equal(tid.numpy(), np.asarray(rid))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(rt))
    assert tid.dtype == torch.int32
    assert (tid[-70:] == 0).all() and torch.isinf(tt[-70:]).all()
    zero = tt[:-70] == 0.0
    assert int(zero.sum()) > 100          # ties at entry 0 were exercised
    # the plain version is blocked over rays: a block edge changes nothing
    saved = cull.FIRST_RAY_BLOCK
    try:
        cull.FIRST_RAY_BLOCK = 333
        bid, bt = tpacket._first_cluster(ta, torch.from_numpy(o),
                                         torch.from_numpy(d))
    finally:
        cull.FIRST_RAY_BLOCK = saved
    assert torch.equal(bid, tid) and torch.equal(bt, tt)


@pytest.mark.parametrize("tile_rays", [32, 64, 128, 256])
@pytest.mark.parametrize("which", ["morton375", "padded"])
def test_frustum_cull_bit_exact(which, tile_rays, request):
    ja, ta = request.getfixturevalue(which)
    n_tiles = 12
    n = n_tiles * tile_rays
    o, d = _rays(n, 12, park=tile_rays + 5)
    tm = np.random.default_rng(13).uniform(0.5, 4.0, n).astype(np.float32)
    tm[: tile_rays] = 1e20
    ref = np.asarray(jpacket._frustum_cull(
        ja, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(tm), n_tiles,
        tile_rays))
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    got = cull.frustum_cull(ta.aabb_lo, ta.aabb_hi, to,
                            tpacket._safe_inv(td), torch.from_numpy(tm),
                            t_min=1e-3, n_tiles=n_tiles, tile_rays=tile_rays)
    np.testing.assert_array_equal(got.numpy(), ref)
    fin = np.isfinite(ref)
    assert 0 < fin.sum() < fin.size
    # conservative: every cluster K1 finds for a tile, K7 finds too
    k1 = cull.tile_cull_plain(ta.aabb_lo, ta.aabb_hi, to,
                              tpacket._safe_inv(td), torch.from_numpy(tm),
                              t_min=1e-3, n_tiles=n_tiles,
                              tile_rays=tile_rays)
    assert bool((torch.isfinite(got) | ~torch.isfinite(k1)).all())


def test_packed_schedule_sort_bit_exact(morton375):
    ja, ta = morton375
    o, d = _rays(64 * 6, 14, park=40)
    tn = cull.tile_cull_plain(ta.aabb_lo, ta.aabb_hi, torch.from_numpy(o),
                              tpacket._safe_inv(torch.from_numpy(d)),
                              torch.full((384,), 1e20), t_min=1e-3,
                              n_tiles=6, tile_rays=64)
    rst, rsi = jpacket._packed_schedule_sort(jnp.asarray(tn.numpy()))
    st, si = tpacket._packed_schedule_sort(tn)
    np.testing.assert_array_equal(st.numpy(), np.asarray(rst))
    np.testing.assert_array_equal(si.numpy(), np.asarray(rsi))
    assert si.dtype == torch.int32


def test_sched_pack_knob(morton375, monkeypatch):
    """PT_SCHED_PACK=1 routes _sorted_schedule to the packed sort, with
    the finite membership of the two-key sort."""
    _, ta = morton375
    tn = torch.from_numpy(np.random.default_rng(15).uniform(
        0, 5, (4, ta.n_clusters)).astype(np.float32))
    tn[tn > 3.0] = torch.inf
    st0, si0 = tpacket._sorted_schedule(tn)
    monkeypatch.setenv("PT_SCHED_PACK", "1")
    st1, si1 = tpacket._sorted_schedule(tn)
    assert torch.equal((st1, si1)[1], tpacket._packed_schedule_sort(tn)[1])
    for r in range(4):
        assert set(si0[r][torch.isfinite(st0[r])].tolist()) == \
            set(si1[r][torch.isfinite(st1[r])].tolist())


@pytest.mark.parametrize("g", [2, 3, 4])
def test_group_blocks_bit_exact(morton375, g):
    """375 clusters: a ragged last group for g = 2 and 4 (zero blocks,
    lane count 0), none for g = 3."""
    ja, ta = morton375
    tn = np.random.default_rng(16).uniform(0, 5, (5, 375)).astype(np.float32)
    tn[tn > 4.0] = np.inf
    rttg, rbtg = jpacket._group_blocks(ja, jnp.asarray(tn), g)
    ttg, grouped = tpacket._group_blocks(ta, torch.from_numpy(tn), g)
    np.testing.assert_array_equal(ttg.numpy(), np.asarray(rttg))
    np.testing.assert_array_equal(grouped.blocks_t.numpy(), np.asarray(rbtg))
    assert grouped.blocks_lm.shape == (-(-375 // g), 8 * g, 16)
    if 375 % g:
        assert int(grouped.n_lanes[-1]) == 8 * (375 % g)
    # derived once per blocks_t and g
    assert tpacket._group_blocks(ta, torch.from_numpy(tn), g)[1] is grouped


def test_wavefront_order_bit_exact():
    """path._wavefront_order on the same scene in each package: dead lanes
    last, stable."""
    js = jproc.sponza_like(2000, textured=False).finalize()
    ts = tproc.sponza_like(2000, textured=False).finalize(device="cpu")
    lo, hi = ts.positions.amin(0).numpy(), ts.positions.amax(0).numpy()
    rng = np.random.default_rng(17)
    o = rng.uniform(lo, hi, (5000, 3)).astype(np.float32)
    d = rng.normal(size=(5000, 3)).astype(np.float32)
    o[:300] = o[0]                     # equal keys: stability decides
    d[:300] = d[0]
    active = rng.uniform(size=5000) < 0.7
    ref = np.asarray(jpath._wavefront_order(js, jnp.asarray(o),
                                            jnp.asarray(d),
                                            jnp.asarray(active)))
    got = tpath._wavefront_order(ts, torch.from_numpy(o),
                                 torch.from_numpy(d),
                                 torch.from_numpy(active))
    np.testing.assert_array_equal(got.numpy(), ref)
    n_live = int(active.sum())
    assert active[got.numpy()[:n_live]].all()
    m = tmorton.morton_codes(torch.from_numpy(o), lo=ts.positions.amin(0),
                             hi=ts.positions.amax(0))
    assert int(m.max()) < (1 << 30)
