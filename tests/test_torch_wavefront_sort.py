"""wavefront_sort, skip_nee and the median/morton accel split, port vs the JAX package.

32x32 renders of the Cornell box with a 1280-triangle sphere (cluster
route) against the JAX package's own renders of its own scene, under
the robust image gate of benchmarks/run_configs.py (inlier RMSE <= 5e-3,
<= 2% flips, relative mean shift <= 1e-3) with the ray counts equal:
- wavefront_sort in the per-sample loop, spp-batched, and on a (1, 1)
  mesh (JAX render_frame_sharded has no ray count there: the port's
  mesh equals its single device's);
- skip_nee;
- PT_FINE_METHOD=median PT_COARSE_METHOD=morton.
Within the port, the paths wavefront_sort touches: primed equals
unprimed (the split too), the G-buffer, frame batching split at
PT_MAX_WAVEFRONT, an in-process (2, 1) mesh (sharding's local rows) -
each within the gate of, and with the ray counts of, the port's own
render without the knob.

    python -m pytest tests/test_torch_wavefront_sort.py -q -p no:randomly
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pathtracer import render as jrender
from pathtracer.accel.cluster import build_scene_clusters as jbuild
from pathtracer.config import RenderConfig as JRenderConfig
from pathtracer.integrator.camera import Camera as JCamera
from pathtracer.parallel import sharding as jsharding
from pathtracer_torch import render as trender
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.parallel import sharding
from tests.test_torch_render import _assert_gate
from tests.test_torch_sharding import _jax_box_scene
from tests.test_torch_sharding_gloo import box_camera, box_scene

BASE = dict(width=32, height=32, spp=2, max_depth=3)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, port scene), each package's default accel."""
    return jbuild(_jax_box_scene()), box_scene()


def _jcam():
    c = JCamera(position=(0.5, 0.5, 2.2))
    c.look_at((0.5, 0.5, 0.0))
    return c.state()


def _tcam():
    return box_camera().state(device="cpu")


def _jax_frame(js, **kw):
    img, rays = jrender.render_frame_with_stats(
        js, JRenderConfig(**BASE, **kw), _jcam(), 0)
    return np.asarray(img), int(float(rays))


def _port_frame(ts, **kw):
    img, rays = trender.render_frame_with_stats(
        ts, RenderConfig(**BASE, **kw), _tcam(), 0)
    return img.numpy(), int(rays)


@pytest.mark.parametrize("kw", [
    dict(wavefront_sort=True), dict(wavefront_sort=True, spp_batch=True),
    dict(skip_nee=True)], ids=["wavefront_sort", "wavefront_sort-batched",
                               "skip_nee"])
def test_matches_jax_render(scenes, kw):
    js, ts = scenes
    jimg, jrays = _jax_frame(js, **kw)
    img, rays = _port_frame(ts, **kw)
    assert np.isfinite(img).all() and img.mean() > 0.0
    _assert_gate(img, jimg)
    assert rays == jrays
    if kw.get("skip_nee"):
        _, rays_nee = _port_frame(ts)
        assert rays < rays_nee


def test_wavefront_sort_mesh_1x1_matches_jax(scenes):
    js, ts = scenes
    jimg = np.asarray(jsharding.render_frame_sharded(
        js, JRenderConfig(**BASE, wavefront_sort=True), _jcam(), 0,
        jsharding.make_mesh(jax.devices()[:1], tile=1, sample=1)))
    cfg = RenderConfig(**BASE, wavefront_sort=True)
    img, rays, _, _ = sharding.render_frame_sharded(
        ts, cfg, _tcam(), 0, sharding.make_mesh(1, 1, world_size=1))
    _assert_gate(img.numpy(), jimg)
    single, single_rays = trender.render_frame_with_stats(ts, cfg, _tcam(),
                                                          0)
    assert torch.equal(img, single) and int(rays) == int(single_rays)


@pytest.fixture(scope="module")
def split_scenes():
    """Both packages' scenes with the median (closest) / morton
    (occlusion) split."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PT_FINE_METHOD", "median")
    mp.setenv("PT_COARSE_METHOD", "morton")
    try:
        out = jbuild(_jax_box_scene()), box_scene()
    finally:
        mp.undo()
    assert out[1].clusters is not out[1].clusters_fine
    return out


def test_accel_split_matches_jax(split_scenes):
    js, ts = split_scenes
    jimg, jrays = _jax_frame(js)
    img, rays = _port_frame(ts)
    _assert_gate(img, jimg)
    assert rays == jrays


@pytest.mark.parametrize("spp_batch", [False, True])
def test_accel_split_primed_equals_unprimed(split_scenes, spp_batch):
    """Hints re-tested with the rows of the accel of their call: the
    primed film and rays equal the unprimed ones, frame over frame."""
    ts = split_scenes[1]
    cfg = RenderConfig(**BASE, spp_batch=spp_batch)
    rb = trender.Renderer(ts, cfg, box_camera(), device="cpu")
    rp = trender.Renderer(ts, dataclasses.replace(cfg, primary_priming=True),
                          box_camera(), device="cpu")
    for _ in range(2):
        fb, fp = rb.step(), rp.step()
        assert int(rb.last_rays) == int(rp.last_rays)
    torch.testing.assert_close(fp.accum, fb.accum, rtol=1e-5, atol=1e-6)
    assert int(rp._prime[:, 0].max()) >= 0
    assert int(rp._prime[:, 1].max()) >= 0


def _gate_and_rays(out, ref):
    _assert_gate(out[0].numpy(), ref[0].numpy())
    assert int(out[1]) == int(ref[1])


@pytest.mark.parametrize("spp_batch", [False, True])
def test_wavefront_sort_primed_equals_unprimed(scenes, spp_batch):
    """Bounce 0 is not re-ordered, so the hint rows stay aligned."""
    ts = scenes[1]
    cfg = RenderConfig(**BASE, spp_batch=spp_batch, wavefront_sort=True)
    base = trender.render_frame_with_stats(ts, cfg, _tcam(), 0)
    primed = trender.render_frame_with_stats(
        ts, dataclasses.replace(cfg, primary_priming=True), _tcam(), 0)
    torch.testing.assert_close(primed[0], base[0], rtol=1e-5, atol=1e-6)
    assert int(primed[1]) == int(base[1])
    _gate_and_rays(base, trender.render_frame_with_stats(
        ts, dataclasses.replace(cfg, wavefront_sort=False), _tcam(), 0))


@pytest.mark.parametrize("spp_batch", [False, True])
def test_wavefront_sort_gbuffer_equals_unsorted(scenes, spp_batch):
    """The G-buffer rows come from bounce 0 (not re-ordered): the
    features equal the unsorted render's; the moments follow the film."""
    ts = scenes[1]
    cfg = RenderConfig(**BASE, spp_batch=spp_batch, capture_gbuffer=True)
    ref = trender.render_frame_with_stats(ts, cfg, _tcam(), 0, gbuffer=True)
    out = trender.render_frame_with_stats(
        ts, dataclasses.replace(cfg, wavefront_sort=True), _tcam(), 0,
        gbuffer=True)
    _gate_and_rays(out, ref)
    for k in ("normal", "depth", "albedo"):
        assert torch.equal(out[2][k], ref[2][k]), k
    _assert_gate(out[2]["m1"][..., None].numpy(),
                 ref[2]["m1"][..., None].numpy())


def test_wavefront_sort_frame_batch_split(scenes, monkeypatch):
    """Frame batching split into parts at PT_MAX_WAVEFRONT: each part
    scatters its lanes by their returned pixel ids."""
    ts = scenes[1]
    cfg = RenderConfig(**BASE, spp_batch=True, frame_batch=2,
                       wavefront_sort=True)
    whole = trender.render_frame_batched(ts, cfg, _tcam(), 0, frames=2)
    monkeypatch.setenv("PT_MAX_WAVEFRONT", "1000")
    parts = trender.render_frame_batched(ts, cfg, _tcam(), 0, frames=2)
    _gate_and_rays(parts, whole)
    _gate_and_rays(whole, trender.render_frame_batched(
        ts, dataclasses.replace(cfg, wavefront_sort=False), _tcam(), 0,
        frames=2))


@pytest.mark.parametrize("spp_batch", [False, True])
def test_wavefront_sort_mesh_2x1_equals_single(scenes, spp_batch):
    """An in-process (2, 1) mesh: each tile shard's lanes land on their
    own rows (sharding's inverse of the base pixel order)."""
    ts = scenes[1]
    cfg = RenderConfig(**BASE, spp_batch=spp_batch, wavefront_sort=True)
    img, rays, _, _ = sharding.render_frame_sharded(
        ts, cfg, _tcam(), 0, sharding.make_mesh(2, 1, world_size=2))
    single = trender.render_frame_with_stats(ts, cfg, _tcam(), 0)
    _gate_and_rays((img, rays), single)
