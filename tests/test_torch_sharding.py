"""Sharded rendering (parallel/sharding.py), port vs one device and the JAX package.

Port counterparts of tests/test_sharding.py:35-355 (its two
__graft_entry__ cases aside). The mesh holds every rank in this process
(rank None), so a test sums shard_contribution over every (tile, sample)
coordinate as the all_reduce would; tests/test_torch_sharding_gloo.py
runs the same reduction over real gloo ranks. Within the port the
tolerance is the JAX tests' own (rtol 1e-4, atol 1e-5; the priming and
motion-preview films 1e-5 / 1e-6); against JAX render_frame_sharded the
robust image gate of benchmarks/run_configs.py (nearest-hit winners flip
at silhouettes between the packages).

    python -m pytest tests/test_torch_sharding.py -q -p no:randomly
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pathtracer.accel.cluster import build_scene_clusters as jbuild
from pathtracer.config import RenderConfig as JRenderConfig
from pathtracer.integrator.camera import Camera as JCamera
from pathtracer.parallel import sharding as jsharding
from pathtracer.scene import procedural as jproc
from pathtracer.scene.build import MaterialDesc as JMaterial
from pathtracer_torch import render as trender
from pathtracer_torch.accel.lbvh import build_scene_bvh
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.parallel import sharding
from pathtracer_torch.render import Renderer
from pathtracer_torch.scene import procedural as tproc
from tests.test_torch_render import _assert_gate
from tests.test_torch_sharding_gloo import box_camera, box_scene

TOL = dict(rtol=1e-4, atol=1e-5)
EXACT_FILM = dict(rtol=1e-5, atol=1e-6)
BASE = dict(width=16, height=16, spp=2, max_depth=3)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _mesh(tile, sample):
    return sharding.make_mesh(tile, sample, world_size=tile * sample)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(kw or TOL))


@pytest.fixture(scope="module")
def routes():
    """{route: (scene, cfg)}: the bvh route on the Cornell box (as
    test_sharding.py's `setup`), the cluster route on the box with a
    1280-triangle sphere (its `cluster_setup`)."""
    bvh = build_scene_bvh(tproc.cornell_box().finalize(device="cpu"))
    return {"bvh": (bvh, RenderConfig(**BASE, intersector="bvh")),
            "cluster": (box_scene(), RenderConfig(**BASE))}


def _sharded(scene, cfg, mesh, frame=0, **kw):
    return sharding.render_frame_sharded(
        scene, cfg, box_camera().state(device="cpu"), frame, mesh, **kw)


def _single(scene, cfg, frame=0):
    return trender.render_frame_with_stats(
        scene, cfg, box_camera().state(device="cpu"), frame)


# n ranks, explicit (tile, sample) or None for the default factorization
MESH_CASES = [(1, None), (2, None), (4, None), (8, None), (8, (8, 1)),
              (8, (2, 4)), (4, (1, 4))]


@pytest.mark.parametrize("n,shape", MESH_CASES)
def test_mesh_factorization_matches_jax(n, shape):
    kw = dict(zip(("tile", "sample"), shape)) if shape else {}
    jm = jsharding.make_mesh(jax.devices()[:n], **kw)
    devices = np.asarray(jm.devices)
    for r in range(n):
        m = sharding.make_mesh(**kw, world_size=n, rank=r)
        assert m.shape == (jm.shape["tile"], jm.shape["sample"])
        pos = tuple(int(i) for i in np.argwhere(devices ==
                                                jax.devices()[r])[0])
        assert m.coords() == pos == divmod(r, m.sample)
    local = sharding.make_mesh(**kw, world_size=n)
    assert local.rank is None and local.shape == m.shape
    with pytest.raises(ValueError, match="name the rank"):
        local.coords()


def test_mesh_rejects_bad_shapes_and_missing_group():
    with pytest.raises(AssertionError):
        jsharding.make_mesh(jax.devices()[:8], tile=3, sample=2)
    with pytest.raises(ValueError, match="does not cover"):
        sharding.make_mesh(3, 2, world_size=8)
    with pytest.raises(ValueError, match="rank 8 outside"):
        sharding.make_mesh(4, 2, world_size=8, rank=8)
    with pytest.raises(ValueError, match="init_process_group"):
        sharding.make_mesh()            # no process group here
    scene, cfg = box_scene(), RenderConfig(**BASE)
    with pytest.raises(ValueError, match="not divisible by sample"):
        _sharded(scene, dataclasses.replace(cfg, spp=3), _mesh(4, 2))
    with pytest.raises(ValueError, match="not divisible by tile"):
        _sharded(scene, dataclasses.replace(cfg, width=12, height=12),
                 _mesh(5, 1))


def test_swizzled_pixel_ids_need_a_device():
    with pytest.raises(TypeError):
        trender._swizzled_pixel_ids(16, 16)
    ids = trender._swizzled_pixel_ids(16, 16, "cpu")
    assert ids.device.type == "cpu" and ids[:9].tolist() == [
        0, 1, 2, 3, 4, 5, 6, 7, 16]


@pytest.mark.parametrize("route", ["bvh", "cluster"])
def test_sharded_matches_single_device(routes, route):
    """The layout does not change the estimate: RNG counters key on
    (pixel, global sample)."""
    scene, cfg = routes[route]
    img, rays, _, _ = _sharded(scene, cfg, _mesh(4, 2))
    ref, ref_rays = _single(scene, cfg)
    assert float(ref.mean()) > 0.0
    _close(img, ref)
    assert int(rays) == int(ref_rays)


def test_shard_contributions_partition_the_frame(routes):
    """Each shard writes its own tile's lane slice only (zeros and -1
    hints elsewhere), and the contributions add up to the frame."""
    scene, cfg = routes["cluster"]
    cam = box_camera().state(device="cpu")
    prime = torch.full((256, 3), -1, dtype=torch.int32)
    parts = []
    for t in range(4):
        for s in range(2):
            c = sharding.shard_contribution(scene, cfg, cam, 0, (4, 2),
                                            (t, s), prime=prime)
            outside = torch.ones(256, dtype=torch.bool)
            outside[t * 64:(t + 1) * 64] = False
            assert not c.batched and int(c.rays) > 0
            assert not bool(c.radiance[outside].any())
            assert bool((c.prime[outside] == -1).all())
            assert bool((c.prime[~outside, 0] >= 0).any())
            parts.append(c)
    img, rays, _, _ = sharding.finish(sharding.combine(parts), cfg,
                                      trender._base_pixels(16, 16, "cpu"))
    ref, ref_rays = _single(scene, cfg)
    _close(img, ref)
    assert int(rays) == int(ref_rays) == sum(int(c.rays) for c in parts)


def test_sharded_matches_jax_render_frame_sharded():
    """The slice as a whole against JAX render_frame_sharded on the same
    (4, 2) mesh, 32x32, cluster route, the same scene from each package."""
    js = jbuild(_jax_box_scene())
    kw = dict(width=32, height=32, spp=2, max_depth=3)
    jcam = JCamera(position=(0.5, 0.5, 2.2))
    jcam.look_at((0.5, 0.5, 0.0))
    jimg = np.asarray(jsharding.render_frame_sharded(
        js, JRenderConfig(**kw), jcam.state(), 0,
        jsharding.make_mesh(jax.devices()[:8], tile=4, sample=2)))
    img, _, _, _ = _sharded(box_scene(), RenderConfig(**kw), _mesh(4, 2))
    assert img.shape == jimg.shape and bool(torch.isfinite(img).all())
    _assert_gate(img.numpy(), jimg)


def _jax_box_scene():
    b = jproc.cornell_box()
    sv, sf = jproc.icosphere(0.25, (0.5, 0.35, 0.2), 3)
    b.add_mesh(sv, sf, b.add_material(JMaterial(albedo=(0.7, 0.6, 0.2),
                                                roughness=0.4)))
    return b.finalize()


def test_sharded_layouts_agree(routes):
    scene, cfg = routes["bvh"]
    a = _sharded(scene, cfg, _mesh(8, 1))[0]
    b = _sharded(scene, cfg, _mesh(4, 2))[0]
    _close(a, b)


def test_sharded_swizzle_fallback_resolution(routes):
    """12x12 is no multiple of the 8x8 block: lanes stay row-major."""
    scene, cfg = routes["bvh"]
    cfg12 = dataclasses.replace(cfg, width=12, height=12)
    assert trender._swizzled_pixel_ids(12, 12, "cpu") is None
    _close(_sharded(scene, cfg12, _mesh(4, 2))[0], _single(scene, cfg12)[0])


def test_sharded_spp_batch_matches_loop(routes):
    """spp 4 over sample 2: each shard traces its 2 samples as one
    wavefront with cfg.spp_batch; same estimate as the loop."""
    scene, cfg = routes["bvh"]
    cfg4 = dataclasses.replace(cfg, spp=4)
    loop = _sharded(scene, cfg4, _mesh(4, 2))[0]
    batched = _sharded(scene, dataclasses.replace(cfg4, spp_batch=True),
                       _mesh(4, 2))[0]
    _close(batched, loop)
    _close(batched, _single(scene, cfg4)[0])


def _renderer(cfg, mesh=None, scene=None, **kw):
    return Renderer(scene or box_scene(), cfg, box_camera(), device="cpu",
                    mesh=mesh, **kw)


def test_sharded_priming_exact():
    """Priming through Renderer(mesh=...): frame 2 is primed by frame 1's
    hints; the film and ray counts equal the unprimed ones, and primary
    hits and shadow blockers are recorded."""
    cfg = RenderConfig(**BASE)
    rb = _renderer(cfg, _mesh(4, 2))
    rp = _renderer(dataclasses.replace(cfg, primary_priming=True),
                   _mesh(4, 2))
    for _ in range(2):
        rb.step(), rp.step()
        assert int(rb.last_rays) == int(rp.last_rays)
    _close(rp.film.accum, rb.film.accum, **EXACT_FILM)
    assert int(rp._prime[:, 0].max()) >= 0
    assert int(rp._prime[:, 1].max()) >= 0


def test_sharded_gbuffer_matches_single_device():
    """Loop branch: every G-buffer field is a sum over the samples, /spp
    after the reduction; it matches one device's, and so does the
    denoised display."""
    cfg = RenderConfig(**BASE, denoise=True)
    rs, r1 = _renderer(cfg, _mesh(4, 2)), _renderer(cfg)
    rs.step(), r1.step()
    for k in ("normal", "depth", "albedo", "m1", "m2"):
        a, b = rs._gbuf[k], r1._gbuf[k]
        assert a.shape == b.shape, k
        _close(a, b, err_msg=k, **TOL)
    _close(rs.display(), r1.display())


def test_sharded_gbuffer_frame_batch_local_spp_one():
    """Batched branch at local_spp 1 (spp 2 over sample 2, frame_batch
    2): the features come through undivided, from sample shard 0 (each
    row from its lowest sample, as on one device), and the moments are
    sums over every sample."""
    cfg = RenderConfig(**BASE, denoise=True, spp_batch=True, frame_batch=2)
    rs, r1 = _renderer(cfg, _mesh(4, 2)), _renderer(cfg)
    rs.step(), r1.step()
    assert rs.film.frame == r1.film.frame == 2
    for k in ("normal", "depth", "albedo", "m1", "m2"):
        _close(rs._gbuf[k], r1._gbuf[k], err_msg=k, **TOL)
    depth = rs._gbuf["depth"]
    hit = torch.isfinite(depth)
    assert bool(hit.any()) and bool((~hit).any())
    _close(rs._gbuf["normal"][hit].norm(dim=-1), torch.ones(
        int(hit.sum())), rtol=1e-4, atol=0.0)
    _close(rs._gbuf["albedo"][~hit], torch.ones(int((~hit).sum()), 3),
           rtol=1e-6, atol=0.0)
    _close(rs.film.accum, r1.film.accum)


def test_sharded_frame_batch_matches_progressive():
    """One 2-frame step on a (2, 2) mesh equals two sharded steps and one
    2-frame step on one device."""
    cfg_b = RenderConfig(**BASE, spp_batch=True)
    cfg_f = dataclasses.replace(cfg_b, frame_batch=2)
    r1, r2 = _renderer(cfg_b, _mesh(2, 2)), _renderer(cfg_f, _mesh(2, 2))
    r1.step(), r1.step()
    r2.step()
    assert r1.film.frame == r2.film.frame == 2
    _close(r2.film.accum, r1.film.accum)
    r3 = _renderer(cfg_f)
    r3.step()
    _close(r2.film.accum, r3.film.accum)
    assert int(r2.last_rays) == int(r3.last_rays)


def test_sharded_auto_frame_batch_matches_single_steps():
    """auto_frame_batch 3 on a (2, 2) mesh: the step after construction folds
    one frame, the next three; the film equals four single sharded steps,
    and a camera move drops back to a one-frame step."""
    cfg = RenderConfig(**BASE)
    ra = _renderer(cfg, _mesh(2, 2), auto_frame_batch=3)
    ra.step()
    assert ra.film.frame == 1
    ra.step()
    assert ra.film.frame == 4
    rb = _renderer(cfg, _mesh(2, 2))
    for _ in range(4):
        rb.step()
    _close(ra.film.accum, rb.film.accum)
    ra.camera.moved = True
    ra.step()
    assert ra.film.frame == 1


def test_sharded_env_nee_frame_batch():
    """Env NEE (its per-(cell, sample) table sized spp x frames) with a
    2-frame batched step on a (2, 2) mesh equals two sharded steps and one 2-frame
    step on one device."""
    b = tproc.cornell_box(materials_suite=True)
    env = np.zeros((32, 64, 3), np.float32)
    env[:16] = (0.4, 0.5, 0.8)
    env[20:24, 30:34] = 50.0
    b.set_envmap(env)
    from pathtracer_torch.accel.cluster import build_scene_clusters

    scene = build_scene_clusters(b.finalize(device="cpu"))
    cfg = RenderConfig(**BASE, sky="envmap", env_importance_sampling=True,
                       spp_batch=True)
    cfg_f = dataclasses.replace(cfg, frame_batch=2)
    rb = _renderer(cfg_f, _mesh(2, 2), scene)
    rp = _renderer(cfg, _mesh(2, 2), scene)
    rb.step()
    rp.step(), rp.step()
    assert rb.film.frame == rp.film.frame == 2
    _close(rb.film.accum, rp.film.accum)
    r1 = _renderer(cfg_f, scene=scene)
    r1.step()
    _close(rb.film.accum, r1.film.accum)


def test_sharded_motion_preview():
    """The moving-camera step is a single-device preview (film untouched);
    the first static step resumes sharded accumulation exactly as a
    renderer without a preview after the same move."""
    cfg = RenderConfig(**BASE)
    r = _renderer(cfg, _mesh(4, 2), motion_preview=2)
    r.camera.process_mouse(10.0, 0.0)
    assert r.step().frame == 0 and r._preview is not None
    assert r.display().shape == (16, 16, 3)
    assert r.step().frame == 1 and r._preview is None
    r2 = _renderer(cfg, _mesh(4, 2))
    r2.camera.process_mouse(10.0, 0.0)
    r2.step()
    _close(r.film.accum, r2.film.accum, **EXACT_FILM)


def test_sharded_thin_lens_matches_single_device():
    """The lens draw keys on (pixel, sample) like every other stream."""
    scene = box_scene()
    cfg = RenderConfig(**BASE, aperture=0.3, focus_dist=2.0)
    _close(_sharded(scene, cfg, _mesh(4, 2))[0], _single(scene, cfg)[0],
           rtol=2e-5, atol=2e-5)


def test_sharded_batched_pool_splits_at_max_wavefront(monkeypatch):
    """PT_MAX_WAVEFRONT splits each shard's batched wavefront into parts
    (the JAX sharded branch never splits): with 2-frame pools of spp 4 on
    mesh (2, 2) every shard traces 2 x 128 pixels x 4 lanes in >= 2
    parts, and film, rays, hints and G-buffer equal the unsplit ones."""
    scene = box_scene()
    cfg = RenderConfig(**dict(BASE, spp=4), spp_batch=True, denoise=True,
                       primary_priming=True)
    prime = torch.full((256, 3), -1, dtype=torch.int32)
    whole = _sharded(scene, cfg, _mesh(2, 2), prime=prime, gbuffer=True,
                     frames=2)
    calls = []
    real = trender._trace_pool_part

    def counted(scene, cfg, cam, pix_part, *a, **kw):
        calls.append(pix_part.shape[0])
        return real(scene, cfg, cam, pix_part, *a, **kw)

    monkeypatch.setattr(trender, "_trace_pool_part", counted)
    monkeypatch.setenv("PT_MAX_WAVEFRONT", "300")    # 128 x 4 lanes > 300
    split = _sharded(scene, cfg, _mesh(2, 2), prime=prime, gbuffer=True,
                     frames=2)
    assert len(calls) == 4 * 2 and sum(calls) == 4 * 128
    _close(split[0], whole[0], **EXACT_FILM)
    assert int(split[1]) == int(whole[1])
    assert torch.equal(split[2], whole[2])
    for k in whole[3]:
        _close(split[3][k], whole[3][k], err_msg=k, **EXACT_FILM)


def test_app_mesh_needs_torchrun(monkeypatch):
    from pathtracer_torch import app

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="torchrun"):
        app.main(["--scene", "cornell", "--width", "16", "--height", "16",
                  "--mesh", "2,2", "--device", "cpu"])
