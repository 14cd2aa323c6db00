"""The pathtracer_torch slice end to end: live comparison with the JAX
renderer, the committed config 1/3 goldens, a jax-free run and the CLI.

Images are judged with the robust gate of benchmarks/run_configs.py
(inlier RMSE <= 5e-3, <= 2% winner flips, relative mean shift <= 1e-3):
same-seed renders differ only by float arithmetic, which flips nearest
hit winners at silhouettes.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pathtracer.accel.cluster import build_scene_clusters as jbuild
from pathtracer.config import RenderConfig as JRenderConfig
from pathtracer.integrator.camera import Camera as JCamera
from pathtracer.render import render_frame_batched as jrender_batched
from pathtracer.scene import procedural as jproc
from pathtracer_torch import render as trender
from pathtracer_torch.accel.cluster import accel_from_numpy
from pathtracer_torch.accel.cluster import build_scene_clusters as tbuild
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.integrator.camera import Camera
from pathtracer_torch.scene import procedural as tproc
from pathtracer_torch.scene.types import (META_FIELDS, OPTIONAL_FIELDS,
                                          TENSOR_FIELDS, scene_from_numpy)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")
BOX_CAM = ((0.5, 0.5, 2.2), (0.5, 0.5, 0.0))
SPONZA_CAM = ((3.0, 4.5, 6.0), (14.0, 3.0, 6.0))


def _cam(cls, spec):
    c = cls(position=spec[0])
    c.look_at(spec[1])
    return c


def robust_gate(img, golden):
    """(inlier RMSE, flip fraction, relative mean shift) of img against
    golden: [..., C] numpy, JAX or CPU torch arrays."""
    img, golden = np.asarray(img), np.asarray(golden)
    d = img - golden
    ad = np.abs(d).max(-1)
    inl = ad <= np.percentile(ad, 98.0)
    rmse = float(np.sqrt(np.mean(d[inl] ** 2)))
    flips = float((ad > 0.01).mean())
    mean_rel = abs(float(img.mean()) - float(golden.mean())) / max(
        abs(float(golden.mean())), 1e-6)
    return rmse, flips, mean_rel


def _assert_gate(img, golden):
    rmse, flips, mean_rel = robust_gate(img, golden)
    assert rmse <= 5e-3 and flips <= 0.02 and mean_rel <= 1e-3, \
        (rmse, flips, mean_rel)


@pytest.fixture(scope="module")
def live_slice():
    """JAX render of textured sponza_like, and the scene carried across."""
    js = jbuild(jproc.sponza_like(4000, textured=True).finalize())
    kw = dict(width=32, height=32, spp=2, max_depth=4, spp_batch=True)
    img, rays, _, _ = jrender_batched(js, JRenderConfig(**kw),
                                      _cam(JCamera, SPONZA_CAM).state(), 0)
    fields = {k: (None if getattr(js, k) is None else np.asarray(
        getattr(js, k))) for k in TENSOR_FIELDS + OPTIONAL_FIELDS}
    fields.update({k: getattr(js, k) for k in META_FIELDS})
    ts = scene_from_numpy(fields, device="cpu").with_clusters(
        accel_from_numpy(*(np.asarray(getattr(js.clusters, f)) for f in
                           ("aabb_lo", "aabb_hi", "blocks_t")),
                         device="cpu"))
    return ts, kw, np.asarray(img), float(rays)


def test_slice_matches_live_jax_render(live_slice):
    ts, kw, jimg, jrays = live_slice
    cfg = RenderConfig(**kw)
    img, rays, _, _ = trender.render_frame_batched(
        ts, cfg, _cam(Camera, SPONZA_CAM).state(device="cpu"), 0)
    img = img.numpy()
    assert img.shape == jimg.shape and np.isfinite(img).all()
    assert img.mean() > 0.0
    _assert_gate(img, jimg)
    assert abs(int(rays) - jrays) <= 1e-3 * jrays


@pytest.mark.parametrize("idx,scene_fn,kw", [
    (1, tproc.cornell_box, dict(spp_batch=False)),
    (3, lambda: tproc.cornell_box(materials_suite=True),
     dict(spp_batch=True)),
])
def test_golden_configs(idx, scene_fn, kw):
    """benchmarks/run_configs.py configs 1 and 3 at the 64x64 / 4 spp probe.

    Config 3 carries frame_batch > 1 there; without an env map that field
    only sizes the env-NEE window, so frame_batch=1 renders the same image.
    """
    scene = tbuild(scene_fn().finalize(device="cpu"))
    cfg = RenderConfig(width=64, height=64, spp=4, max_depth=6, **kw)
    img = trender.render_frame(scene, cfg,
                               _cam(Camera, BOX_CAM).state(device="cpu"), 0)
    golden = np.load(os.path.join(GOLDENS, f"config_{idx}_64.npz"))["img"]
    _assert_gate(img.numpy(), golden)


def test_renderer_progressive_accumulation():
    scene = tproc.cornell_box().finalize(device="cpu")
    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=3)
    r = trender.Renderer(scene, cfg, _cam(Camera, BOX_CAM), device="cpu")
    film = r.run(2)
    assert film.frame == 2 and int(r.last_rays) > 0
    cam = _cam(Camera, BOX_CAM).state(device="cpu")
    f0 = trender.render_frame(r.scene, cfg, cam, 0)
    f1 = trender.render_frame(r.scene, cfg, cam, 1)
    torch.testing.assert_close(film.accum, (f0 + f1) / 2, rtol=1e-6,
                               atol=1e-6)
    r.camera.look_at((0.4, 0.5, 0.0))         # a move resets the film
    assert r.step().frame == 1
    disp = r.display()
    assert disp.shape == (16, 16, 3) and 0.0 <= disp.min() <= disp.max() <= 1.0


def test_pool_part_split_matches_single_pool(monkeypatch):
    scene = tbuild(tproc.cornell_box(materials_suite=True).finalize(
        device="cpu"))
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=3,
                       spp_batch=True)
    cam = _cam(Camera, BOX_CAM).state(device="cpu")
    whole, rays, _, _ = trender.render_frame_batched(scene, cfg, cam, 0)
    monkeypatch.setenv("PT_MAX_WAVEFRONT", "200")      # -> 3 spatial parts
    split, rays_s, _, _ = trender.render_frame_batched(scene, cfg, cam,
                                                       0)
    assert int(rays) == int(rays_s)
    torch.testing.assert_close(split, whole, rtol=1e-5, atol=1e-5)
    per_sample = dataclasses.replace(cfg, spp_batch=False)
    looped = trender.render_frame(scene, per_sample, cam, 0)
    torch.testing.assert_close(looped, whole, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,n_s", [(7, 1), (5, 3), (64, 8), (300, 32)])
def test_sample_sum_is_index_adds_sum(m, n_s):
    """The film's per-pixel sample sum (render.sample_sum, a fixed order
    on every device) equals index_add_ on the CPU bit for bit, for
    sample-major lanes and for lanes in a random order given the stable
    sort of their rows; f32 [n, 3] radiance and f32 [n] moments."""
    from pathtracer_torch.render import sample_sum

    g = torch.Generator().manual_seed(m * 100 + n_s)
    v = torch.randn(n_s * m, 3, generator=g) * torch.rand(
        n_s * m, 1, generator=g) * 1e3
    rows = torch.arange(m).repeat(n_s)
    perm = torch.randperm(n_s * m, generator=g)
    for vals, rws, order in ((v, rows, None),
                             (v[perm], rows[perm],
                              torch.argsort(rows[perm], stable=True))):
        want = torch.zeros(m, 3).index_add_(0, rws, vals)
        assert torch.equal(sample_sum(vals, order, m, n_s), want)
        lum = vals[:, 1]
        assert torch.equal(sample_sum(lum, order, m, n_s),
                           torch.zeros(m).index_add_(0, rws, lum))


def test_port_runs_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from pathtracer_torch.config import RenderConfig\n"
        "from pathtracer_torch.integrator.camera import Camera\n"
        "from pathtracer_torch.render import Renderer\n"
        "from pathtracer_torch.scene.procedural import cornell_box\n"
        "c = Camera(position=(0.5, 0.5, 2.2)); c.look_at((0.5, 0.5, 0.0))\n"
        "cfg = RenderConfig(width=16, height=16, spp=1, max_depth=3)\n"
        "r = Renderer(cornell_box().finalize(device='cpu'), cfg, c,\n"
        "             device='cpu')\n"
        "m = float(r.run(1).accum.mean())\n"
        "bad = [k for k in sys.modules if k == 'pathtracer'\n"
        "       or k.startswith('pathtracer.') or k.startswith('jax')]\n"
        "assert not [k for k in bad if sys.modules[k] is not None], bad\n"
        "print(m)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert float(res.stdout.strip().splitlines()[-1]) > 0.0


def test_package_source_imports_no_jax():
    pkg = os.path.join(REPO, "pathtracer_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f)).read()
                assert "import jax" not in src, f
                assert "from jax" not in src, f
                assert "import pathtracer." not in src, f
                assert "from pathtracer." not in src, f
                assert "from pathtracer import" not in src, f


def test_app_renders_and_rejects_unported_flags(tmp_path):
    from pathtracer_torch import app

    out = str(tmp_path / "c.png")
    app.main(["--scene", "cornell", "--width", "16", "--height", "16",
              "--spp", "1", "--max-depth", "2", "--frames", "2",
              "--device", "cpu", "--out", out])
    assert open(out, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    # every JAX flag is parsed; the xla traversal backend is refused
    with pytest.raises(ValueError, match="not part of pathtracer_torch"):
        app.main(["--scene", "cornell", "--traversal-backend", "xla",
                  "--device", "cpu", "--out", out])
    with pytest.raises(SystemExit):
        app.main(["--scene", "cornell", "--no-such-flag", "--device", "cpu"])


def test_app_cli_json_lines(tmp_path):
    out = str(tmp_path / "m.png")
    res = subprocess.run(
        [sys.executable, "-m", "pathtracer_torch.app", "--scene",
         "materials", "--width", "16", "--height", "16", "--spp", "2",
         "--max-depth", "3", "--frames", "1", "--device", "cpu", "--out",
         out], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    rec = json.loads(res.stdout.splitlines()[0])
    assert rec["frame"] == 1 and rec["mean_radiance"] > 0.0
    assert rec["device"] == "cpu"
