"""G-buffer, denoiser, checkpoints, tone maps and thin lens, port vs the JAX package.

- atrous_denoise on seeded inputs (with and without the variance term,
  with sky pixels): rtol 1e-5, atol 1e-6;
- the primary-hit G-buffer against JAX render_frame_with_stats(...,
  gbuffer=True) at 1 spp: where both packages hit the same triangle
  (their primary-hit hints agree), normal, depth and albedo within 1e-5;
  at 4 spp every pixel's row is one of its samples' rows (the port's
  rule: its first sample's), and the moments m1/m2 of the batched frame
  equal the per-sample loop's (rtol 1e-4);
- checkpoints: an exact resume (test_render.py:125-141), and each
  package loads the other's file;
- reinhard/aces display and thin-lens primary rays against the JAX
  functions;
- the Renderer's denoised display and AOVs against the JAX Renderer's
  at 1 spp (robust image gate), and the frame-batched Renderer's display
  and AOVs against their invariants.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer.accel.cluster import build_scene_clusters as jbuild
from pathtracer.config import RenderConfig as JRenderConfig
from pathtracer.film import denoise as jdenoise
from pathtracer.film import film as jfilm
from pathtracer.integrator import camera as jcam
from pathtracer.render import Renderer as JRenderer
from pathtracer.render import render_frame_with_stats as jrender
from pathtracer.scene import procedural as jproc
from pathtracer.scene.build import MaterialDesc as JMaterial
from pathtracer_torch import render as trender
from pathtracer_torch.accel.cluster import build_scene_clusters as tbuild
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.film import denoise as tdenoise
from pathtracer_torch.film import film as tfilm
from pathtracer_torch.integrator import camera as tcam
from pathtracer_torch.scene import procedural as tproc
from pathtracer_torch.scene.build import MaterialDesc
from tests.test_torch_frame_batch import _cam
from tests.test_torch_priming import _box_scene
from tests.test_torch_render import _assert_gate as _gate


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def scenes():
    return jbuild(_box_scene(jproc, JMaterial)), tbuild(
        _box_scene(tproc, MaterialDesc, device="cpu"))


# --- denoiser ----------------------------------------------------------------

def _gbuffer_inputs(h=24, w=20, seed=0):
    rng = np.random.default_rng(seed)
    rad = rng.gamma(1.0, 0.5, (h, w, 3)).astype(np.float32)
    rad[::5, ::3] *= 40.0                                  # fireflies
    nrm = rng.normal(size=(h, w, 3)).astype(np.float32)
    nrm[:, : w // 2] = [0.0, 0.0, 1.0]                     # a flat wall
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    depth = rng.uniform(1.0, 4.0, (h, w)).astype(np.float32)
    depth[:4, :] = np.inf                                  # sky rows
    nrm[:4] = 0.0
    alb = rng.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)
    alb[:4] = 1.0
    var = rng.uniform(0.0, 2.0, (h, w)).astype(np.float32)
    return rad, nrm, depth, alb, var


@pytest.mark.parametrize("with_var,iterations", [(False, 3), (True, 3),
                                                 (True, 1), (False, 4)])
def test_atrous_denoise_matches_jax(with_var, iterations):
    rad, nrm, depth, alb, var = _gbuffer_inputs(seed=iterations)
    ref = jdenoise.atrous_denoise(
        *(jnp.asarray(x) for x in (rad, nrm, depth, alb)),
        iterations=iterations,
        variance=jnp.asarray(var) if with_var else None)
    got = tdenoise.atrous_denoise(
        *(torch.from_numpy(x) for x in (rad, nrm, depth, alb)),
        iterations=iterations,
        variance=torch.from_numpy(var) if with_var else None)
    assert got.dtype == torch.float32 and got.shape == rad.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    # sky pixels pass through untouched; the rest is really filtered
    np.testing.assert_array_equal(got.numpy()[:4], rad[:4])
    assert not np.allclose(got.numpy()[4:], rad[4:])


# --- G-buffer ----------------------------------------------------------------

def test_gbuffer_matches_jax_at_one_spp(scenes):
    js, ts = scenes
    kw = dict(width=16, height=16, spp=1, max_depth=3, primary_priming=True)
    _, _, jprime, jgb = jrender(js, JRenderConfig(**kw),
                                _cam(jcam.Camera).state(), 0,
                                return_prime=True, gbuffer=True)
    _, _, tprime, tgb = trender.render_frame_with_stats(
        ts, RenderConfig(**kw), _cam(tcam.Camera).state(device="cpu"), 0,
        return_prime=True, gbuffer=True)
    same = tprime[:, 0].numpy() == np.asarray(jprime)[:, 0]
    assert same.mean() >= 0.98
    for k in ("normal", "depth", "albedo"):
        t, j = tgb[k].numpy(), np.asarray(jgb[k])
        assert t.shape == j.shape, k
        fin = same & np.isfinite(np.asarray(jgb["depth"]))
        np.testing.assert_allclose(t[fin], j[fin], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    sky = same & (tprime[:, 0].numpy() < 0)
    assert np.isinf(tgb["depth"].numpy()[sky]).all()
    for k in ("m1", "m2"):
        assert tgb[k].shape == (16, 16)
        _gate(tgb[k].numpy()[..., None], np.asarray(jgb[k])[..., None])


def test_gbuffer_rows_come_from_one_sample(scenes):
    """4 spp in one wavefront: each pixel's row is its first sample's row
    (normal, depth and albedo together), the moments equal the
    per-sample loop's, and hit/sky rows are consistent
    (test_render.py:293-312)."""
    _, ts = scenes
    cfg = RenderConfig(width=16, height=16, spp=4, max_depth=3,
                       spp_batch=True)
    cam = _cam(tcam.Camera).state(device="cpu")
    _, _, gb = trender.render_frame_with_stats(ts, cfg, cam, 0, gbuffer=True)
    loop = dataclasses.replace(cfg, spp_batch=False)
    _, _, gl = trender.render_frame_with_stats(ts, loop, cam, 0,
                                               gbuffer=True)
    for k in ("m1", "m2"):
        np.testing.assert_allclose(gb[k].numpy(), gl[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    rows = torch.cat([gb["normal"], gb["depth"][:, None], gb["albedo"]], 1)
    per_sample = []
    for s in range(4):
        _, _, _, g = trender.render_sample(ts, cfg, cam, 0, s, gbuffer=True)
        per_sample.append(torch.cat([g["normal"], g["depth"][:, None],
                                     g["albedo"]], 1))
    assert torch.equal(rows, per_sample[0])
    assert not torch.equal(per_sample[0], per_sample[1])
    nrm, dep = gb["normal"].numpy(), gb["depth"].numpy()
    hit = np.isfinite(dep)
    assert hit.any() and (~hit).any()
    assert (np.linalg.norm(nrm[hit], axis=1) > 0.9).all()
    assert (np.linalg.norm(nrm[~hit], axis=1) < 1e-6).all()


def test_gbuffer_off_at_depth_one(scenes):
    _, ts = scenes
    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=1)
    out = trender.render_frame_with_stats(
        ts, cfg, _cam(tcam.Camera).state(device="cpu"), 0, gbuffer=True)
    assert len(out) == 3 and out[2] is None


# --- checkpoints ---------------------------------------------------------------

def test_checkpoint_resume_exact(scenes, tmp_path):
    """Save after frame 1, resume, render frame 2: bit-identical to a
    straight run (the counter-based RNG makes resume exact)."""
    _, ts = scenes
    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=3)
    r = trender.Renderer(ts, cfg, _cam(tcam.Camera), device="cpu")
    r.step()
    path = str(tmp_path / "ck.npz")
    tfilm.save_checkpoint(path, r.film)
    straight = r.step()
    r2 = trender.Renderer(ts, cfg, _cam(tcam.Camera), device="cpu")
    r2.film = tfilm.load_checkpoint(path, device="cpu")
    assert r2.film.frame == 1
    resumed = r2.step()
    assert resumed.frame == 2 and torch.equal(straight.accum, resumed.accum)


def test_checkpoints_cross_load(tmp_path):
    rng = np.random.default_rng(3)
    accum = rng.uniform(0, 5, (6, 9, 3)).astype(np.float32)
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tfilm.save_checkpoint(tpath, tfilm.Film(torch.from_numpy(accum), 7))
    jf = jfilm.load_checkpoint(tpath)
    np.testing.assert_array_equal(np.asarray(jf.accum), accum)
    assert int(jf.frame) == 7 and jf.frame.dtype == jnp.int32
    jfilm.save_checkpoint(jpath, jfilm.Film(jnp.asarray(accum * 2),
                                            jnp.int32(11)))
    tf = tfilm.load_checkpoint(jpath, device="cpu")
    assert tf.frame == 11 and isinstance(tf.frame, int)
    np.testing.assert_array_equal(tf.accum.numpy(), accum * 2)
    assert tfilm.rmse(tf.accum, accum) == pytest.approx(
        jfilm.rmse(np.asarray(jf.accum) * 2, accum))


# --- display and camera ----------------------------------------------------------

@pytest.mark.parametrize("tonemap", ["gamma", "reinhard", "aces"])
def test_tonemaps_match_jax(tonemap):
    x = np.random.default_rng(5).gamma(0.7, 2.0, (40, 30, 3)).astype(
        np.float32)
    x[0, :3] = [-1.0, 0.0, 1e4]
    got = tfilm.to_display(torch.from_numpy(x), tonemap).numpy()
    np.testing.assert_allclose(got, np.asarray(jfilm.to_display(
        jnp.asarray(x), tonemap)), rtol=1e-6, atol=1e-6)
    assert got.min() >= 0.0 and got.max() <= 1.0


@pytest.mark.parametrize("aperture,focus", [(0.1, 2.0), (0.5, 0.7),
                                            (0.0, 2.0), (0.2, 0.0)])
def test_thin_lens_rays_match_jax(aperture, focus):
    pos, tgt = (0.5, 0.5, 2.2), (0.4, 0.6, 0.0)
    jc, tc = jcam.Camera(position=pos), tcam.Camera(position=pos)
    jc.look_at(tgt)
    tc.look_at(tgt)
    w, h = 24, 16
    pix = np.arange(w * h, dtype=np.int32)
    samp = np.full(w * h, 3, np.uint32)
    jo, jd = jcam.generate_primary_rays(
        jc.state(), w, h, 60.0, jnp.asarray(pix), jnp.asarray(samp),
        aperture=aperture, focus_dist=focus)
    to, td = tcam.generate_primary_rays(
        tc.state(device="cpu"), w, h, 60.0, torch.from_numpy(pix),
        torch.from_numpy(samp.astype(np.int64)), aperture=aperture,
        focus_dist=focus)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=2e-6)
    pin_o, pin_d = tcam.generate_primary_rays(
        tc.state(device="cpu"), w, h, 60.0, torch.from_numpy(pix),
        torch.from_numpy(samp.astype(np.int64)))
    lens = aperture > 0.0 and focus > 0.0
    assert torch.equal(to, pin_o) != lens
    if lens:   # rays through one pixel meet on the focal plane
        front = torch.from_numpy(tc.front)
        hit = to + td * (focus / (td @ front))[:, None]
        pin = pin_o + pin_d * (focus / (pin_d @ front))[:, None]
        torch.testing.assert_close(hit, pin, rtol=0, atol=1e-5)


# --- the Renderer's display ---------------------------------------------------

def test_renderer_denoised_display_and_aovs_match_jax(scenes):
    """Four 1-spp frames (so the variance term is on): the denoised,
    aces-mapped display and the AOVs pass the gate against the JAX
    Renderer's. At 1 spp a pixel's G-buffer row has one writer in both
    packages; with several lanes per pixel the JAX scatter's winner is
    unspecified, so the frame-batched renderer below is held to its own
    invariants."""
    js, ts = scenes
    kw = dict(width=16, height=16, spp=1, max_depth=3, denoise=True,
              tonemap="aces")
    r = trender.Renderer(ts, RenderConfig(**kw), _cam(tcam.Camera),
                         device="cpu")
    jr = JRenderer(js, JRenderConfig(**kw), _cam(jcam.Camera))
    for _ in range(4):
        r.step(), jr.step()
    _gate(r.display(), jr.display())
    for k, img in jr.aovs().items():
        _gate(r.aovs()[k], img)


def test_renderer_frame_batched_denoise_and_aovs(scenes, tmp_path):
    _, ts = scenes
    kw = dict(width=16, height=16, spp=2, max_depth=3, spp_batch=True,
              frame_batch=2, denoise=True, tonemap="aces")
    r = trender.Renderer(ts, RenderConfig(**kw), _cam(tcam.Camera),
                         device="cpu")
    assert r.aovs() == {}
    r.step(), r.step()
    assert r.film.frame == 4 and r._gbuf_frames == 4
    disp = r.display()
    assert disp.shape == (16, 16, 3) and np.isfinite(disp).all()
    assert 0.0 <= disp.min() and disp.max() <= 1.0
    raw = tfilm.to_display(r.film.accum, "aces").numpy()
    assert not np.allclose(disp, raw)              # the denoiser ran
    r.denoise = False
    np.testing.assert_array_equal(r.display(), raw)
    aovs = r.aovs()
    assert sorted(aovs) == ["albedo", "depth", "normal"]
    for img in aovs.values():
        assert img.shape == (16, 16, 3) and np.isfinite(img).all()
        assert 0.0 <= img.min() and img.max() <= 1.0
    r.save_png(str(tmp_path / "d.png"))
    assert open(tmp_path / "d.png", "rb").read(4) == b"\x89PNG"
