"""Traversal kernels K1-K3 and packet traversal of pathtracer_torch vs the JAX package.

CPU: each kernel's plain PyTorch version against the JAX Pallas kernel
run in interpret mode on identical inputs (K1 bit-exact, K2 tri-exact
with t/u/v within a few roundings of their summed terms, K3 exact), and
the port's
packet traversal against the JAX brute-force oracle
(tri / blocked exact, t within rtol 1e-4). The CUDA kernels themselves
are held to their plain versions in tests/test_torch_cuda.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer.accel.cluster import build_clusters as jbuild
from pathtracer.kernels import packet as jpacket
from pathtracer.kernels import pallas_cull, pallas_sweep
from pathtracer.kernels.intersect import intersect_brute, occluded_brute
from pathtracer_torch.accel.cluster import accel_from_numpy
from pathtracer_torch.accel.cluster import build_clusters
from pathtracer_torch.kernels import cull, packet, sweep
from pathtracer_torch.kernels import intersect as tisect


def tbuild(v0, v1, v2):
    """The port's production build (sahsplit: K = 128, the cluster count
    padded to a multiple of 128)."""
    return build_clusters(v0, v1, v2, method="sahsplit")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads keep this file's lockstep sweeps from
    oversubscribing the cores when test files run side by side."""
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


def _rays(n, seed=1, park_tail=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if park_tail:
        o[-park_tail:] = 1e30
        d[-park_tail:] = 1.0
    return o, d


def _carry(ja):
    return accel_from_numpy(*(np.asarray(getattr(ja, f)) for f in
                              ("aabb_lo", "aabb_hi", "blocks_t")),
                            device="cpu")


def _T(a):
    return torch.from_numpy(np.array(a))


# --- K1 tile cull ---------------------------------------------------------

@pytest.mark.parametrize("t,min_k,max_c,t_min", [(500, 8, 100, 1e-3),
                                                 (90, 8, 16, 0.0),
                                                 (2000, 4, 700, 1e-3)])
def test_cull_plain_matches_pallas_interpret(t, min_k, max_c, t_min):
    v0, v1, v2 = _soup(t, seed=t)
    ja = jbuild(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
                max_clusters=max_c, min_k=min_k)
    n = 256
    o, d = _rays(n, seed=2, park_tail=40)
    t_max = np.full(n, 50.0, np.float32)
    t_max[-40:] = 0.0
    inv = np.asarray(jpacket._safe_inv(jnp.asarray(d)))
    n_tiles = n // 64
    ref = np.asarray(pallas_cull.tile_cull(
        ja.aabb_lo, ja.aabb_hi, jnp.asarray(o), jnp.asarray(inv),
        jnp.asarray(t_max), t_min=t_min, n_tiles=n_tiles, tile_rays=64,
        interpret=True))
    got = cull.tile_cull(_T(ja.aabb_lo), _T(ja.aabb_hi), _T(o), _T(inv),
                         _T(t_max), t_min=t_min, n_tiles=n_tiles,
                         tile_rays=64).numpy()
    if t != 2000:
        assert ja.aabb_lo.shape[0] % 128 != 0   # C not a lane multiple
    np.testing.assert_array_equal(got, ref)
    assert np.isfinite(got).any() and np.isinf(got).any()


def test_safe_inv_matches_jax():
    d = np.float32([[0.0, -0.0, 1e-25], [-1e-25, 2.0, -3.0]])
    np.testing.assert_array_equal(
        packet._safe_inv(_T(d)).numpy(),
        np.asarray(jpacket._safe_inv(jnp.asarray(d))))


# --- K2 / K3 sweeps -------------------------------------------------------

def _sweep_inputs(n_tris=300, n_rays=512, max_c=16, seed=0, method="morton"):
    v0, v1, v2 = _soup(n_tris, seed=seed)
    ja = jbuild(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
                max_clusters=max_c, method=method)
    o, d = _rays(n_rays, seed=seed + 1, park_tail=10)
    n_tiles = n_rays // 64
    t_max = np.full(n_rays, 2.0, np.float32)
    t_max[-10:] = 0.0
    tn = jpacket._tile_cull(ja, jnp.asarray(o), jnp.asarray(d), 1e-3,
                            jnp.asarray(t_max), n_tiles, 64)
    st, si = jpacket._sorted_schedule(tn, 1)
    rays6 = np.swapaxes(np.concatenate(
        [o.reshape(n_tiles, 64, 3), d.reshape(n_tiles, 64, 3)], 2), 1, 2)
    t_cap = np.asarray(jpacket._scene_exit(
        ja, jnp.asarray(o), jnp.asarray(d), jnp.float32(1e20))) \
        .reshape(n_tiles, 64)
    return ja, (np.asarray(st), np.asarray(si), np.ascontiguousarray(rays6),
                t_cap, np.asarray(ja.blocks_t)), t_max.reshape(n_tiles, 64)


@pytest.mark.parametrize("seed,max_c", [(0, 16), (5, 4)])
def test_sweep_closest_plain_matches_pallas_interpret(seed, max_c):
    ja, (st, si, rays6, t_cap, bt), _ = _sweep_inputs(seed=seed,
                                                      max_c=max_c)
    ref = pallas_sweep.sweep_closest(
        jnp.asarray(st), jnp.asarray(si), jnp.asarray(rays6),
        jnp.asarray(t_cap), jnp.asarray(bt), 1e-3, interpret=True)
    got = sweep.sweep_closest(_T(st), _T(si), _T(rays6), _T(t_cap),
                              _carry(ja), 1e-3)
    rt, rtri, ru, rv = (np.asarray(x) for x in ref)
    gt, gtri, gu, gv = (x.numpy() for x in got)
    np.testing.assert_array_equal(gtri, rtri)
    hit = rtri >= 0
    assert hit.sum() > 20
    # XLA contracts a*b+c into FMAs when it runs the interpret-mode
    # kernel on the host; the port must not (it is held bit for bit to
    # the -fmad=false CUDA kernel). So t, u, v agree to a few roundings of
    # the terms each one sums: |diff| <= 32 * 2^-24 * sum(|term|).
    rows = {int(r[12]) - 1: r.astype(np.float64)
            for r in bt.transpose(0, 2, 1).reshape(-1, 16) if r[12] > 0}
    o = rays6[:, 0:3].transpose(0, 2, 1)[hit].astype(np.float64)
    d = rays6[:, 3:6].transpose(0, 2, 1)[hit].astype(np.float64)
    for k, tri in enumerate(rtri[hit]):
        r = rows[int(tri)]
        t = float(rt[hit][k])
        h = o[k] + t * d[k]
        no = np.abs(r[0:3] * o[k]).sum()
        scale_t = (abs(r[3]) + no) * abs(t) / max(
            abs(r[3] - (r[0:3] * o[k]).sum()), 1e-30) + abs(t)
        scale_u = np.abs(r[4:7] * h).sum() + abs(r[7])
        scale_v = np.abs(r[8:11] * h).sum() + abs(r[11])
        for got_x, ref_x, s in ((gt, rt, scale_t), (gu, ru, scale_u),
                                (gv, rv, scale_v)):
            assert abs(float(got_x[hit][k]) - float(ref_x[hit][k])) \
                <= 32 * 2.0 ** -24 * s
    np.testing.assert_allclose(gt[hit], rt[hit], rtol=1e-5)


@pytest.mark.parametrize("seed,max_c", [(0, 16), (5, 4)])
def test_sweep_occluded_plain_matches_pallas_interpret(seed, max_c):
    ja, (st, si, rays6, _, bt), tm = _sweep_inputs(seed=seed, max_c=max_c)
    ref = np.asarray(pallas_sweep.sweep_occluded(
        jnp.asarray(st), jnp.asarray(si), jnp.asarray(rays6),
        jnp.asarray(tm), jnp.asarray(bt), interpret=True))
    got = sweep.sweep_occluded(_T(st), _T(si), _T(rays6), _T(tm),
                               _carry(ja))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.sum() < ref.size


@pytest.mark.parametrize("kind", ["closest", "occluded", "blocker"])
def test_plain_sweeps_count_needed_pair_tests(kind):
    """pair_tests counts what the data needs, checked on one cluster of
    100 triangles (28 pad lanes) and one tile with 10 parked rays: K2
    counts the rays whose cap lies beyond the cluster's entry, K3 each
    open ray's triangles up to its first blocking lane, K3b the whole
    cluster for every open ray - never the pad lanes, the pad clusters
    (parked rays, at 1e30 like the pads' boxes, enter those at t = 0)
    or the parked rays."""
    rng = np.random.default_rng(21)
    v0 = rng.uniform(-0.5, 0.5, (100, 3)).astype(np.float32)
    v = [v0, v0 + rng.uniform(-0.3, 0.3, (100, 3)).astype(np.float32),
         v0 + rng.uniform(-0.3, 0.3, (100, 3)).astype(np.float32)]
    accel = tbuild(*(_T(x) for x in v))
    real = torch.nonzero(accel.aabb_lo[:, 0] < 1e29)[:, 0]
    assert real.numel() == 1 and accel.n_clusters == 128
    o, d = (_T(x) for x in _rays(64, seed=22, park_tail=10))
    tm = torch.full((64,), 2.0)
    tm[-10:] = 0.0
    tn = cull.tile_cull(accel.aabb_lo, accel.aabb_hi, o, packet._safe_inv(d),
                        tm, t_min=0.0, n_tiles=1, tile_rays=64)
    st, si = packet._sorted_schedule(tn)
    col = int(torch.nonzero(si[0] == real[0])[0, 0])
    assert torch.isfinite(st[0, col])
    assert int(torch.isfinite(st).sum()) == 128   # the 127 pads at t = 0
    rays6 = packet._tile_rays6(o, d, 1, 64)
    count = torch.zeros((), dtype=torch.int64)
    lanes = accel.blocks_t[real[0]]                    # [16, K]
    ids = torch.round(lanes[12]).long() - 1
    assert int((ids >= 0).sum()) == 100 and bool((ids[100:] < 0).all())
    if kind == "closest":
        cap = packet._scene_exit(accel, o, d, tm).reshape(1, 64)
        sweep.sweep_closest_plain(st, si, rays6, cap.contiguous(),
                                  accel.blocks_t, 0.0, pair_tests=count)
        want = int((cap[0] > st[0, col]).sum()) * 100
    else:
        sweep.sweep_occluded_plain(st, si, rays6, tm.reshape(1, 64),
                                   accel.blocks_t,
                                   want_blocker=kind == "blocker",
                                   pair_tests=count)
        want = 0
        for r in range(54):                 # the 10 parked rays need none
            n = 100
            if kind == "occluded":
                for lane in range(100):
                    ok = sweep.bw_hit(accel.bw_rows[ids[lane:lane + 1]],
                                      o[r:r + 1], d[r:r + 1], 0.0, 2.0,
                                      front_only=True)[3]
                    if bool(ok[0]):
                        n = lane + 1
                        break
            want += n
        assert kind == "blocker" or want < 5400   # some rays blocked
    assert int(count) == want > 0


# --- packet traversal end to end -----------------------------------------

_SOUP = _soup(300)
_RAYS = _rays(700)


def _oracle(v, o, d, t_max=2.0):
    hr = intersect_brute(*(jnp.asarray(x) for x in (o, d, *v)), 1e-3, 1e20)
    tm = jnp.full(len(o), t_max, jnp.float32)
    obr = occluded_brute(jnp.asarray(o), jnp.asarray(d), tm,
                         *(jnp.asarray(x) for x in v))
    return hr, np.asarray(obr)


@pytest.mark.parametrize("accel_src", ["jax_morton", "port_sahsplit"])
def test_packet_traversal_matches_bruteforce(accel_src):
    v = _SOUP
    o, d = _RAYS
    if accel_src == "jax_morton":
        accel = _carry(jbuild(*(jnp.asarray(x) for x in v), max_clusters=16))
    else:
        accel = tbuild(*(_T(x) for x in v))
    hr, obr = _oracle(v, o, d)
    hp = packet.intersect_clusters(accel, _T(o), _T(d), 1e-3, 1e20)
    np.testing.assert_array_equal(hp.tri.numpy(), np.asarray(hr.tri))
    both = np.asarray(hr.tri) >= 0
    assert both.sum() > 0
    np.testing.assert_allclose(hp.t.numpy()[both], np.asarray(hr.t)[both],
                               rtol=1e-4, atol=1e-5)
    op = packet.occluded_clusters(accel, _T(o), _T(d),
                                  torch.full((len(o),), 2.0))
    np.testing.assert_array_equal(op.numpy(), obr)


def test_packet_ragged_and_tiny():
    v = _soup(33, seed=7)
    accel = _carry(jbuild(*(jnp.asarray(x) for x in v), max_clusters=4))
    for n in (1, 130, 257):
        o, d = _rays(n, seed=n)
        hr, obr = _oracle(v, o, d)
        hp = packet.intersect_clusters(accel, _T(o), _T(d), 1e-3, 1e20)
        np.testing.assert_array_equal(hp.tri.numpy(), np.asarray(hr.tri))
        op = packet.occluded_clusters(accel, _T(o), _T(d),
                                      torch.full((n,), 2.0))
        np.testing.assert_array_equal(op.numpy(), obr)


def test_packet_small_chunks_and_dead_chunks():
    """Several chunks, one of them all parked (skipped), unsorted primary."""
    v = _SOUP
    o, d = _rays(640, seed=9)
    o[128:320] = 1e30                 # chunk 1 (128 rays) fully parked
    accel = _carry(jbuild(*(jnp.asarray(x) for x in v), max_clusters=16))
    hr, obr = _oracle(v, o, d)
    for sort in (True, False):
        hp = packet.intersect_clusters(accel, _T(o), _T(d), 1e-3, 1e20,
                                       sort_rays=sort, chunk_rays=128)
        np.testing.assert_array_equal(hp.tri.numpy(), np.asarray(hr.tri))
        op = packet.occluded_clusters(accel, _T(o), _T(d),
                                      torch.full((640,), 2.0),
                                      sort_rays=sort, chunk_rays=128)
        np.testing.assert_array_equal(op.numpy(), obr)
    assert packet.chunk_live(_T(o), 128) == [True, False, True, True, True]


def test_packet_schedule_longer_than_128_columns():
    """Corridor of ~125 ring clusters ahead of a far wall (the JAX
    test_pallas_cpi_not_dividing_128_keeps_tail scene): every ray walks
    the whole schedule before the wall."""
    rng = np.random.default_rng(11)
    v0l, v1l, v2l = [], [], []
    for i in range(128):
        n = 128
        if i == 127:
            v0l.append([[float(i), -2.0, -2.0]])
            v1l.append([[float(i), 4.0, -2.0]])
            v2l.append([[float(i), -2.0, 4.0]])
            n -= 1
        ang = rng.uniform(0, 2 * np.pi, n)
        rad = rng.uniform(0.25, 0.5, n)
        cy, cz = rad * np.cos(ang), rad * np.sin(ang)
        x = np.full(n, float(i)) + rng.uniform(-0.1, 0.1, n)
        a = np.stack([x, cy, cz], 1)
        v0l.append(a)
        v1l.append(a + rng.uniform(0.01, 0.1, (n, 3)) * [0, 1, 0])
        v2l.append(a + rng.uniform(0.01, 0.1, (n, 3)) * [0, 0, 1])
    v = [np.concatenate(x).astype(np.float32) for x in (v0l, v1l, v2l)]
    o = np.zeros((64, 3), np.float32)
    o[:, 0] = -2.0
    o[:, 1:] = rng.uniform(-0.05, 0.05, (64, 2))
    d = np.tile(np.float32([1.0, 0.0, 0.0]), (64, 1))
    ja = jbuild(*(jnp.asarray(x) for x in v), max_clusters=128,
                method="median")
    accel = _carry(ja)
    hr = intersect_brute(*(jnp.asarray(x) for x in (o, d, *v)), 1e-3, 1e20)
    assert (np.asarray(hr.tri) >= 0).all()
    n_tiles = 1
    tn = cull.tile_cull(accel.aabb_lo, accel.aabb_hi, _T(o),
                        packet._safe_inv(_T(d)), torch.full((64,), 1e20),
                        t_min=1e-3, n_tiles=n_tiles, tile_rays=64)
    assert int(torch.isfinite(tn).sum()) > 120
    hp = packet.intersect_clusters(accel, _T(o), _T(d), 1e-3, 1e20)
    np.testing.assert_array_equal(hp.tri.numpy(), np.asarray(hr.tri))


def test_brute_force_matches_jax():
    v = _SOUP
    o, d = _RAYS
    hr, obr = _oracle(v, o, d)
    hb = tisect.intersect_brute(_T(o), _T(d), *(_T(x) for x in v), 1e-3,
                                1e20)
    np.testing.assert_array_equal(hb.tri.numpy(), np.asarray(hr.tri))
    hit = np.asarray(hr.tri) >= 0
    np.testing.assert_allclose(hb.t.numpy()[hit], np.asarray(hr.t)[hit],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(hb.u.numpy()[hit], np.asarray(hr.u)[hit],
                               rtol=1e-4, atol=1e-5)
    ob = tisect.occluded_brute(_T(o), _T(d), torch.full((len(o),), 2.0),
                               *(_T(x) for x in v))
    np.testing.assert_array_equal(ob.numpy(), obr)


def test_wrappers_never_fall_back_off_cpu():
    """A non-CPU, non-CUDA tensor raises instead of taking the plain route."""
    o = torch.zeros((64, 3), device="meta")
    lo = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cull.tile_cull(lo, lo, o, o, torch.zeros(64, device="meta"),
                       t_min=0.0, n_tiles=1, tile_rays=64)
    st = torch.zeros((1, 4), device="meta")
    accel = tbuild(*(_T(x) for x in _soup(33, seed=7))).to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sweep.sweep_closest(st, st.int(), torch.zeros((1, 6, 64),
                                                      device="meta"),
                            torch.zeros((1, 64), device="meta"), accel, 1e-3)
    with pytest.raises(ValueError, match="unsupported device"):
        sweep.sweep_occluded(st, st.int(), torch.zeros((1, 6, 64),
                                                       device="meta"),
                             torch.zeros((1, 64), device="meta"), accel)


# --- lane tables, the settled-ray stop rule, the kernels' branches ---------

@pytest.mark.parametrize("method", ["sahsplit", "morton", "median"])
def test_jax_build_packs_pads_after_real_lanes(method):
    """In every cluster of the JAX build the real lanes come first and the
    pads after them, with a zero normal (no hit): testing lanes below
    n_lanes only is exact."""
    v = _soup(700, seed=41)
    ja = jbuild(*(jnp.asarray(x) for x in v), max_clusters=16,
                min_k=32 if method != "sahsplit" else 128, method=method)
    acc = _carry(ja)
    bt = np.asarray(ja.blocks_t)
    real = bt[:, 12, :] > 0
    lane = np.arange(bt.shape[2])
    n = acc.n_lanes.numpy()
    np.testing.assert_array_equal(real, lane[None, :] < n[:, None])
    assert (n > 0).any() and (n < bt.shape[2]).any()
    np.testing.assert_array_equal(
        bt[:, 0:3][np.broadcast_to(~real[:, None], bt[:, 0:3].shape)], 0.0)


def _old_occluded_walk(st, si, rays, t_max_rays, blocks_t, want_blocker):
    """The occlusion sweep's plain loop before rays with t_max <= 0 were
    settled: a tile walks while any of its rays is unblocked. -> (blocked,
    btri, columns each tile visits)."""
    tiles, cs = st.shape
    o = tuple(rays[:, i, :, None] for i in range(3))
    d = tuple(rays[:, i, :, None] for i in range(3, 6))
    tm = t_max_rays[:, :, None]
    blocked = torch.zeros(t_max_rays.shape, dtype=torch.bool)
    btri = torch.full(t_max_rays.shape, -1, dtype=torch.int32)
    live = torch.ones(tiles, dtype=torch.bool)
    cols = torch.zeros(tiles, dtype=torch.int64)
    for j in range(cs):
        live = live & (st[:, j] < torch.inf) & (~blocked).any(dim=1)
        if not bool(live.any()):
            break
        cols += live
        blk = blocks_t[si[:, j].long()]
        t, _, _, denom = sweep._bw_lane(blk, o, d, 0.0, torch.inf)
        hit = torch.isfinite(t) & (denom < 0.0) & (t < tm)
        newly = hit.any(dim=2) & live[:, None]
        if want_blocker:
            _, jj = torch.min(torch.where(hit, t, torch.inf), dim=2)
            tid = torch.round(blk[:, 12, :]).to(torch.int32) - 1
            btri = torch.where(newly & ~blocked, torch.gather(tid, 1, jj),
                               btri)
        blocked |= newly
    return blocked.to(torch.int32), btri, cols


@functools.lru_cache(maxsize=None)
def _settled_soup(seed):
    """Port-built soup, 4 tiles: parked rays, rays with t_max 0 and < 0
    mixed into tiles with open ones, and one tile of parked rays only."""
    accel = tbuild(*(_T(x) for x in _soup(900, seed=seed)))
    o, d = _rays(256, seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    tm = rng.uniform(0.2, 2.5, 256).astype(np.float32)
    pick = rng.permutation(192)
    o[pick[:30]] = 1e30
    d[pick[:30]] = 1.0
    tm[pick[:30]] = 0.0
    tm[pick[30:60]] = 0.0
    tm[pick[60:75]] = -1.0
    o[192:], d[192:], tm[192:] = 1e30, 1.0, 0.0
    o, d, tm = _T(o), _T(d), _T(tm)
    tn = cull.tile_cull(accel.aabb_lo, accel.aabb_hi, o, packet._safe_inv(d),
                        tm, t_min=0.0, n_tiles=4, tile_rays=64)
    st, si = packet._sorted_schedule(tn)
    return (st, si, packet._tile_rays6(o, d, 4, 64),
            tm.reshape(4, 64).contiguous(), accel.blocks_t)


@pytest.mark.parametrize("seed", [3, 8])
@pytest.mark.parametrize("want_blocker", [False, True])
def test_occluded_settled_stop_rule_matches_old_rule(seed, want_blocker):
    """Settling rays with t_max <= 0 changes no output of the plain K3 /
    K3b against the earlier loop, kept here as the reference."""
    args = _settled_soup(seed)
    old_blk, old_btri, _ = _old_occluded_walk(*args, want_blocker)
    got = sweep.sweep_occluded_plain(*args, want_blocker=want_blocker)
    blk, btri = got if want_blocker else (got, None)
    assert torch.equal(blk, old_blk)
    assert 0 < int(blk.sum()) < blk.numel()
    if want_blocker:
        assert torch.equal(btri, old_btri)
    assert not bool(blk[args[3] <= 0.0].any())


@pytest.mark.parametrize("seed", [3, 8])
def test_occluded_settled_stop_rule_visits_no_more_columns(seed):
    """The new rule visits no more columns than the old one, tile by tile
    (fewer here: parked rays put every pad cluster in their tiles'
    schedules); K3's threads stop at their first blocking lane, so it
    runs no more lane tests than K3b on the same walk."""
    args = _settled_soup(seed)
    _, _, old_cols = _old_occluded_walk(*args, False)
    tests = {}
    for want_blocker in (False, True):
        count = torch.zeros((), dtype=torch.int64)
        tile_cols = torch.zeros(args[0].shape[0], dtype=torch.int64)
        sweep.sweep_occluded_plain(*args, want_blocker=want_blocker,
                                   kernel_tests=count,
                                   tile_columns=tile_cols)
        assert (tile_cols <= old_cols).all()
        assert int(tile_cols.sum()) < int(old_cols.sum())
        tests[want_blocker] = int(count)
    assert 0 < tests[False] <= tests[True] \
        <= int(tile_cols.sum()) * 64 * args[4].shape[2]


def test_occluded_kernel_tests_stop_at_first_hit():
    """One cluster: lane 0 a 16-unit triangle facing the rays, lanes
    1-127 off to the side. A warp holds one of a ray's four threads (lanes
    q, q + 4, ...) for 32 rays and runs as long as its longest thread: K3
    stops the lane-0 threads at their hit, so the first warp group (all
    32 rays hit) runs 1 + 3 x 32 iterations, the second (one ray misses)
    4 x 32; K3b scans every lane."""
    k = 128
    rows = np.zeros((16, k), np.float32)
    x0 = np.float32([0.0] + [100.0] * (k - 1))
    rows[2] = 256.0                     # n = e1 x e2 = (0, 0, 16^2)
    rows[4], rows[7] = 1 / 16, -x0 / 16       # u = (x - x0) / 16
    rows[9] = 1 / 16                    # v = y / 16
    rows[12] = np.arange(1, k + 1)
    o = np.zeros((64, 3), np.float32)
    o[:, 0] = np.linspace(0.5, 2.0, 64)
    o[:, 1] = 0.5
    o[:, 2] = 5.0
    o[40, 0] = -3.0                     # misses every lane
    d = np.tile(np.float32([0.0, 0.0, -1.0]), (64, 1))
    args = (torch.zeros((1, 1)), torch.zeros((1, 1), dtype=torch.int32),
            packet._tile_rays6(_T(o), _T(d), 1, 64),
            torch.full((1, 64), 10.0), _T(rows[None]))
    tests = []
    for want_blocker in (False, True):
        count = torch.zeros((), dtype=torch.int64)
        out = sweep.sweep_occluded_plain(*args, want_blocker=want_blocker,
                                         kernel_tests=count)
        blocked = out[0] if want_blocker else out
        assert blocked[0].tolist() == [int(i != 40) for i in range(64)]
        tests.append(int(count))
    assert tests == [(1 + 3 * 32) * 32 + 4 * 32 * 32, 2 * 4 * 32 * 32]


def test_walk_counts_of_the_closest_sweep():
    """K2's walk: the kernel's lane tests lie between the needed ones and
    the dense count (every lane of every visited column)."""
    _, (st, si, rays6, t_cap, bt), _ = _sweep_inputs(seed=0, max_c=16)
    tests = torch.zeros((), dtype=torch.int64)
    needed = torch.zeros((), dtype=torch.int64)
    tile_cols = torch.zeros(st.shape[0], dtype=torch.int64)
    args = (_T(st), _T(si), _T(rays6), _T(t_cap), _T(bt), 1e-3)
    sweep.sweep_closest_plain(*args, pair_tests=needed, kernel_tests=tests,
                              tile_columns=tile_cols)
    cols = int(tile_cols.sum())
    assert 0 < int(needed) <= int(tests) <= cols * 64 * bt.shape[2]


def test_closest_sweep_rejects_negative_t_min():
    ja, (st, si, rays6, t_cap, _), _ = _sweep_inputs(seed=0, max_c=16)
    with pytest.raises(ValueError, match="t_min"):
        sweep.sweep_closest(_T(st), _T(si), _T(rays6), _T(t_cap),
                            _carry(ja), -1e-3)


@pytest.mark.parametrize("t_min", [0.0, 1e-3])
def test_branch_case_reaches_every_branch(t_min):
    """tests/test_torch_cuda.py holds the kernels to the plain versions on
    branch_case; here the plain versions show that it reaches each branch:
    ties resolve to the lower lane and the earlier column, edge and
    vertex hits with u + v = 1 and u = 0 count, a ray starting on a plane
    does not hit it, t = t_max does not block, and parked rays schedule
    pad clusters."""
    from tests.test_torch_cuda import (BRANCH_IDS, BRANCH_LANES, BRANCH_RAYS,
                                       branch_case, branch_sweep_args)

    accel, o, d, tm = branch_case()
    assert sorted(accel.n_lanes.tolist()) == [0] * 124 + list(BRANCH_LANES)
    closest, occl = branch_sweep_args(accel, o, d, tm, t_min)
    t, tri, u, v = (x[0] for x in sweep.sweep_closest_plain(*closest))
    ray = {name: i for i, name in enumerate(BRANCH_RAYS)}
    tie, cross = BRANCH_IDS["tie"], BRANCH_IDS["cross"]
    sched = closest[1][0].tolist()
    first_cross = cross[0] if sched.index(2) < sched.index(3) else cross[1]
    assert (int(tri[ray["tie_edge"]]), float(t[ray["tie_edge"]])) \
        == (tie[0], 5.0)
    assert float(u[ray["tie_edge"]] + v[ray["tie_edge"]]) == 1.0
    assert int(tri[ray["cross_tie"]]) == first_cross
    assert int(tri[ray["cross_edge"]]) == first_cross
    assert float(u[ray["cross_edge"]] + v[ray["cross_edge"]]) == 1.0
    assert int(tri[ray["on_plane_down"]]) not in tie
    assert int(tri[ray["on_plane_up"]]) == -1
    assert int(tri[ray["t_max_at_hit"]]) == -1
    assert (int(tri[ray["vertex"]]), float(u[ray["vertex"]])) == (tie[0], 1.0)
    assert (int(tri[ray["u_zero"]]), float(u[ray["u_zero"]])) == (tie[0], 0.0)
    blocked, btri = sweep.sweep_occluded_plain(*occl, want_blocker=True)
    assert int(btri[0, ray["tie_edge"]]) == tie[0]
    assert int(btri[0, ray["cross_tie"]]) == first_cross
    assert int(blocked[0, ray["t_max_at_hit"]]) == 0
    assert not bool(blocked[2][tm[128:192] <= 0.0].any())
    st1, si1 = occl[0][1], occl[1][1]
    assert bool((accel.n_lanes[si1[torch.isfinite(st1)].long()] == 0).any())


@pytest.mark.parametrize("t_min", [0.0, 1e-3])
@pytest.mark.parametrize("tile_rays", sweep.TILE_WIDTHS)
def test_long_walk_case_reaches_pass_b(tile_rays, t_min):
    """tests/test_torch_cuda.py holds K2's two passes to the plain version
    on long_walk_case; here the plain walk shows that the chunk reaches
    pass B: tiles stop short of the budget, at it, and past it at every
    residue of a round, and the full walk's rows take the hits the
    stale-seed cases are made of (the farther hit refused, the nearer
    taken, the earlier of two equal ones, the hit below t_min refused),
    and no walled tile takes the nearer hit behind its stop."""
    from tests.test_torch_cuda import (LONG_ROWS, RESUME_COLUMNS,
                                       RESUME_CTAS, long_walk_case,
                                       long_walks)

    assert (sweep.RESUME_COLUMNS, sweep.RESUME_CTAS) == (RESUME_COLUMNS,
                                                         RESUME_CTAS)
    walks = long_walks()
    st, si, rays6, cap, accel, ids = long_walk_case(tile_rays, walks, t_min)
    cols = torch.zeros(st.shape[0], dtype=torch.int64)
    _, tri, _, _ = sweep.sweep_closest_plain(st, si, rays6, cap,
                                             accel.blocks_t, t_min,
                                             tile_columns=cols)
    n_cols = accel.aabb_lo.shape[0]
    assert cols.tolist() == [n_cols if w is None else w for w in walks]
    past = [int(c) - RESUME_COLUMNS for c in cols if c > RESUME_COLUMNS]
    assert len(past) == 2 * RESUME_CTAS + 1
    assert {p % RESUME_CTAS for p in past} == set(range(RESUME_CTAS))
    assert max(past) > 4 * RESUME_CTAS
    full = len(walks) - 1
    rows = tri[full].reshape(tile_rays // 4, 4)
    assert bool((rows[LONG_ROWS["farther"]] == ids["farther"][full][0]).all())
    assert bool((rows[LONG_ROWS["nearer"]] == ids["nearer"][full][1]).all())
    assert bool((rows[LONG_ROWS["tie"]] == ids["tie"][full][0]).all())
    assert bool((rows[LONG_ROWS["early"]] == ids["early"][full]).all())
    low = rows[LONG_ROWS["below_t_min"]]
    assert bool((low == (ids["below_t_min"][full] if t_min == 0.0
                         else -1)).all())
    assert bool((rows[len(LONG_ROWS):] == -1).all())
    for i, wall in ids["wall"].items():
        rows = tri[i].reshape(tile_rays // 4, 4)
        assert bool((rows[LONG_ROWS["past_stop"]:] == wall).all())


def _split_walk(st, si, rays6, cap, blocks_t, t_min, columns, ctas):
    """csrc/sweep.cu's two passes over one tile at a time: the sequential
    walk up to `columns` columns, then rounds of `ctas` columns, each
    column's candidate taken with the round's starting best t as its
    seed and merged in column order under the stop rule."""
    tiles, cs = st.shape
    out = [cap.clone(), torch.full(cap.shape, -1, dtype=torch.int32),
           torch.zeros_like(cap), torch.zeros_like(cap)]
    for i in range(tiles):
        o = tuple(rays6[i:i + 1, a, :, None] for a in range(3))
        d = tuple(rays6[i:i + 1, a, :, None] for a in range(3, 6))
        best = [x[i] for x in out]

        def cand(j, seed):
            blk = blocks_t[si[i, j].long()][None]
            t, u, v, _ = sweep._bw_lane(blk, o, d, t_min, seed[None, :, None])
            tid = torch.round(blk[0, 12]).to(torch.int32) - 1
            tj, jj = torch.min(t[0], dim=1)
            return (tj, tid[jj], u[0].gather(1, jj[:, None])[:, 0],
                    v[0].gather(1, jj[:, None])[:, 0])

        def take(c):
            ok = (c[0] < best[0]) & (c[1] >= 0)
            for b, x in zip(best, c):
                b.copy_(torch.where(ok, x, b))

        def goes_on(j):
            return j < cs and bool(st[i, j] < best[0].max())

        j = 0
        while goes_on(j) and j < columns:
            take(cand(j, best[0]))
            j += 1
        while goes_on(j):
            seed = best[0].clone()
            for c in [cand(q, seed) for q in range(j, min(j + ctas, cs))]:
                if not goes_on(j):
                    break
                take(c)
                j += 1
    return tuple(out)


@pytest.mark.parametrize("columns,ctas", [(64, 2), (64, 4), (9, 4)])
@pytest.mark.parametrize("tile_rays", [32, 256])
def test_split_walk_equals_the_sequential_walk(tile_rays, columns, ctas):
    """The argument of csrc/sweep.cu's header, run: the two passes'
    rounds with stale seeds give sweep_closest_plain's (t, tri, u, v)
    bit for bit on long_walk_case, with the budget where the chunk is
    laid out and far before it."""
    from tests.test_torch_cuda import long_walk_case, long_walks

    st, si, rays6, cap, accel, _ = long_walk_case(
        tile_rays, long_walks(64, ctas), 1e-3, columns=64, ctas=ctas)
    args = (st, si, rays6, cap, accel.blocks_t, 1e-3)
    ref = sweep.sweep_closest_plain(*args)
    got = _split_walk(*args, columns, ctas)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
