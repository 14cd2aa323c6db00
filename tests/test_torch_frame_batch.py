"""Frame batching and the progressive renderer's extras, port vs the JAX package.

Port counterparts of tests/test_render.py:315-348 (one F-frame step
equals F single steps, with and without priming), :355-388 (auto frame
batching), :390-429 (pool parts with the G-buffer), :472-504 (motion
preview), :506-535 (the env-NEE sample window of a frame-batched pool)
and :538-553 (the firefly clamp). Within the port the tolerance is the
JAX tests' own (rtol 1e-4, atol 1e-5 batched against single steps; the
pool-part split to 1e-5). Each test also renders the same 16x16 scene
with the JAX package and holds the port's film to it with the robust
image gate of benchmarks/run_configs.py (nearest-hit winners can flip at
silhouettes between the two packages).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer.accel.cluster import build_scene_clusters as jbuild
from pathtracer.config import RenderConfig as JRenderConfig
from pathtracer.integrator.camera import Camera as JCamera
from pathtracer.render import Renderer as JRenderer
from pathtracer.render import render_frame as jrender_frame
from pathtracer.render import render_frame_batched as jrender_batched
from pathtracer.scene import procedural as jproc
from pathtracer.scene.build import MaterialDesc as JMaterial
from pathtracer.scene.build import SceneBuilder as JBuilder
from pathtracer_torch import render as trender
from pathtracer_torch.accel.cluster import build_scene_clusters as tbuild
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.integrator.camera import Camera
from pathtracer_torch.scene import procedural as tproc
from pathtracer_torch.scene.build import MaterialDesc, SceneBuilder
from tests.test_torch_priming import _box_scene
from tests.test_torch_render import _assert_gate

BOX_CAM = ((0.5, 0.5, 2.2), (0.5, 0.5, 0.0))
BATCH_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Small renders: two intra-op threads keep test files that run side
    by side from oversubscribing the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _cam(cls, spec=BOX_CAM):
    c = cls(position=spec[0])
    c.look_at(spec[1])
    c.moved = False
    return c


@pytest.fixture(scope="module")
def scenes():
    ts = tbuild(_box_scene(tproc, MaterialDesc, device="cpu"))
    assert ts.n_tris > 256          # the cluster route
    return jbuild(_box_scene(jproc, JMaterial)), ts


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               **(kw or BATCH_TOL))


BASE = dict(width=16, height=16, spp=2, max_depth=3, spp_batch=True)


@pytest.mark.parametrize("priming", [False, True])
def test_frame_batched_matches_progressive_loop(priming, scenes):
    js, ts = scenes
    cfg = RenderConfig(**BASE, primary_priming=priming)
    cfg_f = dataclasses.replace(cfg, frame_batch=2)
    r1 = trender.Renderer(ts, cfg, _cam(Camera), device="cpu")
    r2 = trender.Renderer(ts, cfg_f, _cam(Camera), device="cpu")
    r1.step()
    rays1 = int(r1.last_rays)
    r1.step()
    rays1 += int(r1.last_rays)
    r2.step()
    assert r1.film.frame == r2.film.frame == 2
    _close(r2.film.accum, r1.film.accum)
    assert int(r2.last_rays) == rays1
    if priming:
        assert r2._prime is not None and int(r2._prime[:, 0].max()) >= 0
    jr = JRenderer(js, JRenderConfig(**BASE, primary_priming=priming,
                                     frame_batch=2), _cam(JCamera))
    jr.step()
    assert int(jr.film.frame) == 2
    _assert_gate(r2.film.accum, jr.film.accum)


def test_auto_frame_batch_matches_single_steps(scenes):
    js, ts = scenes
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=3)
    ra = trender.Renderer(ts, cfg, _cam(Camera), device="cpu",
                          auto_frame_batch=3)
    ra.step()                                     # latency step: 1 frame
    assert ra.film.frame == 1
    ra.step()                                     # throughput step: 3
    assert ra.film.frame == 4
    rb = trender.Renderer(ts, cfg, _cam(Camera), device="cpu")
    for _ in range(4):
        rb.step()
    _close(ra.film.accum, rb.film.accum)
    jr = JRenderer(js, JRenderConfig(width=16, height=16, spp=2,
                                     max_depth=3), _cam(JCamera),
                   auto_frame_batch=3)
    jr.step(), jr.step()
    assert int(jr.film.frame) == 4
    _assert_gate(ra.film.accum, jr.film.accum)
    ra.camera.moved = True                        # a move resets and drops
    ra.step()                                     # back to a 1-frame step
    assert ra.film.frame == 1


def test_pool_parts_split_exact(scenes, monkeypatch):
    """PT_MAX_WAVEFRONT splits the F-frame pool into spatial parts: the
    same film, hints that are valid rows, and the same G-buffer (the
    features come from each pixel's first lane in both layouts)."""
    js, ts = scenes
    kw = dict(BASE, frame_batch=2, primary_priming=True, denoise=True)
    cfg = RenderConfig(**kw)

    def run():
        r = trender.Renderer(ts, cfg, _cam(Camera), device="cpu")
        r.step()
        return r.film.accum, r._prime, r._gbuf, int(r.last_rays)

    whole_img, whole_prime, whole_gb, whole_rays = run()
    # 16x16 x 2 spp x 2 frames = 1024 lanes; cap at 512 -> 2 parts
    monkeypatch.setenv("PT_MAX_WAVEFRONT", "512")
    part_img, part_prime, part_gb, part_rays = run()
    _close(part_img, whole_img, rtol=1e-5, atol=1e-6)
    assert part_rays == whole_rays
    assert part_prime.shape == whole_prime.shape
    assert bool((part_prime[:, 0] >= -1).all())
    assert bool((part_prime[:, 0] >= 0).any())
    assert set(whole_gb) == {"normal", "depth", "albedo", "m1", "m2"}
    for k in ("normal", "depth", "albedo"):
        assert torch.equal(part_gb[k], whole_gb[k]), k
    for k in ("m1", "m2"):
        _close(part_gb[k], whole_gb[k], err_msg=k)
    monkeypatch.delenv("PT_MAX_WAVEFRONT")
    jr = JRenderer(js, JRenderConfig(**kw), _cam(JCamera))
    jr.step()
    _assert_gate(whole_img, jr.film.accum)
    _assert_gate(whole_gb["m1"][..., None], jr._gbuf["m1"][..., None])


def test_motion_preview_semantics(scenes):
    """A moving-camera step renders a low-res preview without touching
    the film; the first static step then renders frame 1 exactly as a
    renderer without preview does (test_render.py:472-504)."""
    js, ts = scenes
    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=3)
    r = trender.Renderer(ts, cfg, _cam(Camera), device="cpu",
                         motion_preview=2)
    r.camera.process_mouse(10.0, 0.0)      # sets camera.moved
    film = r.step()                         # preview step
    assert film.frame == 0 and r._preview is not None
    img = r.display()
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    film = r.step()
    assert film.frame == 1 and r._preview is None
    r2 = trender.Renderer(ts, cfg, _cam(Camera), device="cpu")
    r2.camera.process_mouse(10.0, 0.0)
    r2.step()
    assert torch.equal(r.film.accum, r2.film.accum)
    jcam = _cam(JCamera)
    jcam.process_mouse(10.0, 0.0)
    jr = JRenderer(js, JRenderConfig(width=16, height=16, spp=1,
                                     max_depth=3), jcam, motion_preview=2)
    jr.step(), jr.step()
    assert int(jr.film.frame) == 1
    _assert_gate(r.film.accum, jr.film.accum)


def test_run_folds_every_frame_after_a_move(scenes):
    """Renderer.run(n) with camera.moved set and motion preview on folds n
    frames: the port does not copy the JAX Renderer.run, which suspends
    auto frame batching but not the preview and folds n - 1."""
    _, ts = scenes
    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=2)
    cam = _cam(Camera)
    cam.moved = True
    r = trender.Renderer(ts, cfg, cam, device="cpu", motion_preview=2,
                         auto_frame_batch=4)
    assert r.run(3).frame == 3
    assert r.motion_preview == 2 and r.auto_frame_batch == 4
    ref = trender.Renderer(ts, cfg, _cam(Camera), device="cpu").run(3)
    assert torch.equal(r.film.accum, ref.accum)


def _env_sphere(mod_builder, material, device=None):
    b = mod_builder()
    m = b.add_material(material(albedo=(0.6, 0.6, 0.6), roughness=1.0))
    sv, sf = (tproc if device else jproc).icosphere(1.0, (0, 0, 0), 2)
    b.add_mesh(sv, sf, m)
    env = np.ones((4, 8, 3), np.float32)
    env[1, 2] = 25.0
    b.set_envmap(env)
    return b.finalize() if device is None else b.finalize(device=device)


def test_env_nee_batched_frames_window():
    """render_frame_batched(frames=F) with cfg.frame_batch = 1 sizes the
    env-NEE table's sample window from the true pool (spp * F), so it
    reproduces F progressive frames (test_render.py:506-535)."""
    kw = dict(width=16, height=16, spp=2, max_depth=3, sky="envmap",
              emission_gain=1.0, env_importance_sampling=True,
              intersector="brute", spp_batch=True)
    ts = _env_sphere(SceneBuilder, MaterialDesc, "cpu")
    cfg = RenderConfig(**kw)
    cam = _cam(Camera, ((0, 0, 3), (0, 0, 0))).state(device="cpu")
    batched_sum, rays, _, _ = trender.render_frame_batched(ts, cfg, cam, 0,
                                                           frames=2)
    loop = sum(trender.render_frame(ts, cfg, cam, f) for f in range(2))
    _close(batched_sum, loop, rtol=2e-5, atol=2e-5)
    jsum = jrender_batched(_env_sphere(JBuilder, JMaterial), JRenderConfig(
        **kw), _cam(JCamera, ((0, 0, 3), (0, 0, 0))).state(), jnp.uint32(0),
        frames=2)[0]
    _assert_gate(batched_sum, jsum)


def test_clamp_radiance(scenes):
    """cfg.clamp_radiance bounds each path sample's radiance; 0 leaves
    the estimator as it is (test_render.py:538-553)."""
    js, ts = scenes
    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=3)
    cam = _cam(Camera).state(device="cpu")
    base = trender.render_frame(ts, cfg, cam, 0)
    off = trender.render_frame(ts, dataclasses.replace(cfg,
                                                       clamp_radiance=0.0),
                               cam, 0)
    assert torch.equal(base, off)
    img = trender.render_frame(ts, dataclasses.replace(cfg,
                                                       clamp_radiance=0.5),
                               cam, 0)
    assert float(img.max()) <= 0.5 + 1e-6
    assert float(base.max()) > 0.5          # the clamp binds here
    mask = base <= 0.5
    _close(img[mask], base[mask], rtol=1e-6, atol=0.0)
    jimg = jrender_frame(js, JRenderConfig(width=16, height=16, spp=1,
                                           max_depth=3, clamp_radiance=0.5),
                         _cam(JCamera).state(), 0)
    _assert_gate(img, jimg)


def test_app_frame_batch_checkpoint_and_aovs(tmp_path, capsys):
    """--frames rounds up to whole --frame-batch steps (the JAX CLI's
    rule: 3 frames at F=2 render 4), --aov writes the three AOV PNGs,
    and --checkpoint resumes the film where it stopped."""
    from pathtracer_torch import app
    from pathtracer_torch.film import film as tfilm

    out, ck = str(tmp_path / "m.png"), str(tmp_path / "ck.npz")
    argv = ["--scene", "materials", "--width", "16", "--height", "16",
            "--spp", "2", "--max-depth", "2", "--device", "cpu",
            "--checkpoint", ck, "--out", out]
    app.main(argv + ["--frame-batch", "2", "--frames", "3", "--aov",
                     "--denoise", "--tonemap", "reinhard"])
    assert tfilm.load_checkpoint(ck, device="cpu").frame == 4
    for name in ("normal", "depth", "albedo"):
        assert open(str(tmp_path / f"m_{name}.png"), "rb").read(4) == \
            b"\x89PNG"
    app.main(argv + ["--frames", "1"])
    assert "resumed at frame 4" in capsys.readouterr().out
    assert tfilm.load_checkpoint(ck, device="cpu").frame == 5
