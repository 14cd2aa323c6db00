"""Blocker hints and verified priming of pathtracer_torch against the JAX package.

- occluded_brute(want_blocker=True): blocked and the blocker id (the
  lowest-index blocking triangle) exactly equal to JAX's;
- the plain K3b sweep and occluded_clusters(want_blocker=True): blocked
  equal to K3 / the brute oracle, -1 exactly where open, and every hint
  re-verifies;
- priming is exact: primed against unprimed renders (per-sample and
  spp-batched, across Renderer frames, with env NEE) give the same image
  (rtol 1e-5, atol 1e-6) and the same ray count - the JAX package's own
  exactness tests (tests/test_render.py:151-230);
- a live primed env-NEE render of the port against the JAX package's:
  the robust image gate, ray counts within 1e-3, and the per-pixel
  primary-hit hints equal on >= 98% of pixels (winner flips at
  silhouettes account for the rest).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer.accel.cluster import build_scene_clusters as jbuild
from pathtracer.config import RenderConfig as JRenderConfig
from pathtracer.integrator.camera import Camera as JCamera
from pathtracer.kernels.intersect import occluded_brute as joccluded
from pathtracer.render import render_frame_with_stats as jrender
from pathtracer.scene import procedural as jproc
from pathtracer.scene.build import MaterialDesc as JMaterial
from pathtracer_torch import render as trender
from pathtracer_torch.accel.cluster import build_clusters
from pathtracer_torch.accel.cluster import build_scene_clusters as tbuild
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.integrator.camera import Camera
from pathtracer_torch.kernels import cull, packet, sweep
from pathtracer_torch.kernels import intersect as tisect
from pathtracer_torch.scene import procedural as tproc
from pathtracer_torch.scene.build import MaterialDesc
from pathtracer_torch.utils import vmath

BOX_CAM = ((0.5, 0.5, 2.2), (0.5, 0.5, 0.0))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """This module's renders are small: two intra-op threads keep them
    from oversubscribing the cores when test files run side by side."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _cam(cls):
    c = cls(position=BOX_CAM[0])
    c.look_at(BOX_CAM[1])
    return c


def _soup(t, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    return v0, v1, v2


def _rays(n, seed, park=()):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for a, b in park:
        o[a:b] = 1e30
        d[a:b] = 1.0
    return o, d


def _T(a):
    return torch.from_numpy(np.array(a))


def _assert_hints_verify(btri, blocked, o, d, t_max, v, bw_rows=None):
    """-1 exactly where open; each hint is a front-facing triangle with
    0 < t < t_max (Moller-Trumbore, or on a triangle edge the sweeps'
    Baldwin-Weber test, where the two may round apart)."""
    assert torch.equal(btri >= 0, blocked)
    sel = btri >= 0
    ids = btri[sel].long()
    v0, v1, v2 = (_T(x)[ids] for x in v)
    os_, ds = o[sel], d[sel]
    _, _, _, ok = tisect.ray_triangle(os_, ds, v0, v1, v2, 0.0, t_max[sel])
    ok = ok & (vmath.dot(ds, vmath.cross(v1 - v0, v2 - v0)) < 0.0)
    if bw_rows is not None and not bool(ok.all()):
        edge = ~ok
        ok[edge] = sweep.bw_hit(bw_rows[ids[edge]], os_[edge], ds[edge],
                                0.0, t_max[sel][edge], front_only=True)[3]
    assert bool(ok.all())
    return int(sel.sum())


# --- blocker hints ----------------------------------------------------------

@pytest.mark.parametrize("n_tris", [200, 300])
def test_occluded_brute_blocker_matches_jax(n_tris):
    v = _soup(n_tris, n_tris)
    o, d = _rays(900, 1, park=((0, 20),))
    tm = np.full(900, 1.5, np.float32)
    jb, jt = joccluded(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                       *(jnp.asarray(x) for x in v), want_blocker=True)
    tb, tt = tisect.occluded_brute(_T(o), _T(d), _T(tm), *(_T(x) for x in v),
                                   want_blocker=True)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert 0 < int(tb.sum()) < 880
    assert torch.equal(tb, tisect.occluded_brute(_T(o), _T(d), _T(tm),
                                                 *(_T(x) for x in v)))


def test_sweep_occluded_plain_blocker():
    v = _soup(600, 3)
    accel = build_clusters(*v, method="sahsplit")
    n_tiles = 8
    o, d = _rays(64 * n_tiles, 4, park=((450, 512),))
    o, d = _T(o), _T(d)
    tm = torch.full((64 * n_tiles,), 1.5)
    tn = cull.tile_cull_plain(accel.aabb_lo, accel.aabb_hi, o,
                              packet._safe_inv(d), tm, t_min=0.0,
                              n_tiles=n_tiles, tile_rays=64)
    st, si = packet._sorted_schedule(tn)
    args = (st, si, packet._tile_rays6(o, d, n_tiles, 64),
            tm.reshape(n_tiles, 64).contiguous(), accel.blocks_t)
    blocked, btri = sweep.sweep_occluded_plain(*args, want_blocker=True)
    assert torch.equal(blocked, sweep.sweep_occluded_plain(*args))
    hints = _assert_hints_verify(
        btri.reshape(-1), blocked.reshape(-1) > 0, o, d, tm, v,
        accel.bw_rows)
    assert 0 < hints < 450


def test_occluded_clusters_blocker():
    """Sorted and unsorted, with a skipped all-parked chunk: blocked
    equals the brute oracle and every hint verifies."""
    v = _soup(700, 5)
    accel = build_clusters(*v, method="sahsplit")
    o, d = _rays(640, 6, park=((128, 320),))
    tm = np.full(640, 1.5, np.float32)
    ref = np.asarray(joccluded(jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(tm), *(jnp.asarray(x) for x in v)))
    for sort in (True, False):
        blocked, btri = packet.occluded_clusters(
            accel, _T(o), _T(d), _T(tm), sort_rays=sort, chunk_rays=128,
            want_blocker=True)
        np.testing.assert_array_equal(blocked.numpy(), ref)
        assert (btri[128:320] == -1).all()
        _assert_hints_verify(btri, blocked, _T(o), _T(d), _T(tm), v,
                             accel.bw_rows)


@pytest.mark.parametrize("intersector", ["brute", "cluster"])
def test_route_hints_verify_with_route_test(intersector):
    """Each route's blocker hints pass that route's own hint test
    (front_only) on the same segment, with no edge exception: shadow
    hints are verified in the arithmetic the traversal decides with."""
    from pathtracer_torch.scene.build import SceneBuilder

    n_tris = 250 if intersector == "brute" else 700
    v = _soup(n_tris, 12)
    b = SceneBuilder()
    b.add_mesh(np.concatenate(v), np.arange(3 * n_tris).reshape(3, -1).T, 0)
    scene = b.finalize(device="cpu")
    if intersector == "cluster":
        scene = tbuild(scene)
    cfg = RenderConfig(intersector=intersector)
    _, occluded_fn, hint_fn = trender.make_intersectors(scene, cfg)
    o, d = (_T(x) for x in _rays(2000, 13))
    tm = torch.full((2000,), 1.5)
    blocked, btri = occluded_fn(o, d, tm, want_blocker=True)
    assert torch.equal(btri >= 0, blocked) and int(blocked.sum()) > 50
    sel = btri >= 0
    ok = hint_fn(btri[sel], o[sel], d[sel], 0.0, tm[sel], front_only=True)[3]
    assert bool(ok.all())
    # a back-facing hit is not a blocker: reversed rays reject it
    back = hint_fn(btri[sel], o[sel], -d[sel], -torch.inf, torch.inf,
                   front_only=True)[3]
    assert not bool(back.any())


# --- priming is exact -----------------------------------------------------

def _box_scene(builder_mod, material, envmap=False, device=None):
    b = builder_mod.cornell_box()
    sv, sf = builder_mod.icosphere(0.25, (0.5, 0.35, 0.2), 3)
    b.add_mesh(sv, sf, b.add_material(material(albedo=(0.7, 0.6, 0.2),
                                               roughness=0.4)))
    if envmap:   # enclosed box: env shadow rays mostly blocked
        env = np.ones((8, 16, 3), np.float32)
        env[2, 3] = 50.0
        b.set_envmap(env)
    return b.finalize() if device is None else b.finalize(device=device)


_SCENES = {}


def _port_scene(envmap):
    if envmap not in _SCENES:
        _SCENES[envmap] = tbuild(_box_scene(tproc, MaterialDesc, envmap,
                                            "cpu"))
        assert _SCENES[envmap].n_tris > 256
    return _SCENES[envmap]


@pytest.mark.parametrize("envmap,spp_batch", [(False, False), (False, True),
                                              (True, False), (True, True)])
def test_priming_exact(envmap, spp_batch):
    scene = _port_scene(envmap)
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=3,
                       spp_batch=spp_batch,
                       **(dict(sky="envmap", env_importance_sampling=True)
                          if envmap else {}))
    cam = _cam(Camera).state(device="cpu")
    base, rays_b = trender.render_frame_with_stats(scene, cfg, cam, 0)
    primed, rays_p, hints = trender.render_frame_with_stats(
        scene, dataclasses.replace(cfg, primary_priming=True), cam, 0,
        return_prime=True)
    torch.testing.assert_close(primed, base, rtol=1e-5, atol=1e-6)
    assert int(rays_p) == int(rays_b)
    assert hints.shape == (256, 3) and hints.dtype == torch.int32
    assert bool((hints[:, 0] >= 0).any())
    assert bool((hints[:, 2] >= 0).any()) == envmap


def test_priming_cross_frame_exact():
    """Hints chained across Renderer frames (and kept across a camera
    move) change nothing."""
    scene = _port_scene(False)
    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=3)
    rb = trender.Renderer(scene, cfg, _cam(Camera), device="cpu")
    rp = trender.Renderer(scene, dataclasses.replace(
        cfg, primary_priming=True), _cam(Camera), device="cpu")
    for _ in range(2):   # frame 1's sample is primed by frame 0's hints
        fb, fp = rb.step(), rp.step()
        assert int(rb.last_rays) == int(rp.last_rays)
    torch.testing.assert_close(fp.accum, fb.accum, rtol=1e-5, atol=1e-6)
    assert int(rp._prime[:, 0].max()) >= 0     # primary hits recorded
    assert int(rp._prime[:, 1].max()) >= 0     # shadow blockers found
    hints = rp._prime.clone()
    for r in (rb, rp):
        r.camera.look_at((0.45, 0.5, 0.0))
    fb, fp = rb.step(), rp.step()
    assert fp.frame == 1 and rp._prime is not None
    torch.testing.assert_close(fp.accum, fb.accum, rtol=1e-5, atol=1e-6)
    assert not torch.equal(rp._prime, hints)


@pytest.mark.parametrize("intersector", ["brute", "cluster"])
def test_primed_tie_keeps_traversal_order(intersector):
    """Rays on the shared diagonal of a quad hit both coplanar triangles
    at the same t; hinted with the triangle the traversal does not pick,
    the primed trace still reports the traversal's own choice."""
    from pathtracer_torch.integrator import path as tpath
    from pathtracer_torch.scene.build import SceneBuilder

    b = SceneBuilder()
    b.add_mesh(np.float32([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]]),
               np.int64([[0, 1, 2], [0, 2, 3]]), 0)
    far = np.random.default_rng(0).uniform(5, 9, (300, 3)).astype(np.float32)
    b.add_mesh(np.concatenate([far, far + [0.01, 0, 0], far + [0, 0.01, 0]]),
               np.arange(900).reshape(3, 300).T, 0)
    scene = b.finalize(device="cpu")
    if intersector == "cluster":
        scene = tbuild(scene)
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=1, sky="black",
                       intersector=intersector)
    xy = np.repeat(np.float32([0.25, 0.5, 0.75, 0.375]), 16)
    o = torch.from_numpy(np.stack([xy, xy, np.ones(64, np.float32)], 1))
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(64, 1)
    pix = torch.arange(64, dtype=torch.int32)
    samp = torch.zeros(64, dtype=torch.int64)
    fns = trender.make_intersectors(scene, cfg)
    base = fns[0](o, d, cfg.t_min, cfg.t_max, primary=True)
    assert (base.t == 1.0).all() and (base.tri >= 0).all()
    other = torch.where(base.tri == 0, 1, 0).to(torch.int32)
    prime = torch.stack([other, -torch.ones_like(other),
                         -torch.ones_like(other)], 1)
    _, _, _, out, _ = tpath.trace_paths(scene, cfg, o, d, pix, samp, fns[0],
                                        fns[1], prime=prime, hint_fn=fns[2])
    assert torch.equal(out[:, 0], base.tri)


# --- live comparison with the JAX package -----------------------------------

@pytest.fixture(scope="module")
def live_env():
    """One primed JAX render (env NEE, per-sample path) and the port's."""
    kw = dict(width=16, height=16, spp=2, max_depth=3, sky="envmap",
              env_importance_sampling=True, primary_priming=True)
    js = jbuild(_box_scene(jproc, JMaterial, envmap=True))
    jimg, jrays, jprime = jrender(js, JRenderConfig(**kw),
                                  _cam(JCamera).state(), 0,
                                  return_prime=True)
    timg, trays, tprime = trender.render_frame_with_stats(
        _port_scene(True), RenderConfig(**kw),
        _cam(Camera).state(device="cpu"), 0, return_prime=True)
    return (np.asarray(jimg), float(jrays), np.asarray(jprime),
            timg.numpy(), int(trays), tprime.numpy())


def test_live_env_priming_matches_jax(live_env):
    jimg, jrays, _, timg, trays, _ = live_env
    d = timg - jimg
    ad = np.abs(d).max(-1)
    inl = ad <= np.percentile(ad, 98.0)
    assert np.sqrt(np.mean(d[inl] ** 2)) <= 5e-3
    assert (ad > 0.01).mean() <= 0.02
    assert abs(timg.mean() - jimg.mean()) <= 1e-3 * jimg.mean()
    assert abs(trays - jrays) <= 1e-3 * jrays


def test_live_primary_hints_match_jax(live_env):
    _, _, jprime, _, _, tprime = live_env
    assert (tprime[:, 0] >= 0).mean() > 0.3    # the rest sees the sky
    assert (tprime[:, 0] == jprime[:, 0]).mean() >= 0.98
    for col in (1, 2):     # blocker columns: both sides found blockers
        assert (tprime[:, col] >= 0).any() and (jprime[:, col] >= 0).any()
