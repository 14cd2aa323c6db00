"""Estimator variants of pathtracer_torch against the JAX package: the
Hosek-Wilkie sky, reference_quirks, and the LBVH slice end to end.

- hosek_wilkie_sky: the coefficient tables equal JAX's, and radiance
  agrees through assert_parity (tolerance below);
- reference_quirks: fetch_surface's emission and NEE against JAX's; the
  8x8 cases of the numpy oracle (tests/test_oracle.py:46-58, same
  tolerance); a live 32x32 render against JAX's under the robust gate;
  and the config-1 golden tests/golden_cornell_quirks_256.npy;
- the slice: renders of bunny_like(subdivisions=2) (324 triangles, so
  the bvh route is not demoted to brute force) at 32x32 on the bvh route
  against the JAX package's, with pcg, with sobol and with the Hosek
  sky, under the robust gate; priming on the bvh route leaves the film
  and the ray count unchanged.

The Hosek model is the reference's formula, exp(B / (cos(theta) + 0.01)),
which overflows for directions with cos(theta) in about (-0.0123, -0.0100):
both packages return inf/NaN there. Hosek renders are therefore compared
on the pixels finite in both, and a pixel finite in one render only
counts as a flipped pixel.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer.config import RenderConfig as JRenderConfig
from pathtracer.integrator import path as jpath
from pathtracer.integrator import sky as jsky
from pathtracer.integrator.camera import Camera as JCamera
from pathtracer.kernels import intersect as jisect
from pathtracer.render import render_frame as jrender_frame
from pathtracer.render import render_frame_batched as jrender_batched
from pathtracer.scene import procedural as jproc
from pathtracer.scene.types import Bvh as JBvh
from pathtracer_torch import render as trender
from pathtracer_torch.accel import lbvh
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.integrator import path as tpath
from pathtracer_torch.integrator import sky as tsky
from pathtracer_torch.integrator.camera import Camera
from pathtracer_torch.kernels import intersect as tisect
from pathtracer_torch.scene import procedural as tproc
from pathtracer_torch.scene.types import (META_FIELDS, OPTIONAL_FIELDS,
                                          TENSOR_FIELDS, scene_from_numpy)
from chip_smoke import finite_gate, quirks_golden_gate
from tests.oracle_ref import render_oracle
from tests.test_torch_render import _assert_gate
from tests.test_torch_shading import assert_parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX_CAM = ((0.5, 0.5, 2.2), (0.5, 0.5, 0.0))
BUNNY_CAM = ((0.0, 2.0, 5.0), (0.0, 1.2, 0.0))
SUNS = [(0.3, 0.6, 0.2), (0.0, 1.0, 0.0), (1.0, 0.05, -0.4)]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads keep this file's renders from oversubscribing
    the cores when test files run side by side."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _cam(cls, spec):
    c = cls(position=spec[0])
    c.look_at(spec[1])
    return c


# --- Hosek-Wilkie ----------------------------------------------------------

def test_hosek_tables_match():
    for name in ("_COEFFS_X", "_COEFFS_Y", "_COEFFS_Z", "_RAD_X", "_RAD_Y",
                 "_RAD_Z", "_XYZ_TO_RGB"):
        np.testing.assert_array_equal(getattr(tsky, name),
                                      getattr(jsky, name), err_msg=name)


def _hosek_f64(d, sun, intensity):
    """float64 evaluation of the same formula (the `exact` of
    assert_parity), and the magnitude |M| |xyz| each RGB channel sums."""
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    s = np.asarray(sun, np.float64)
    s = s / np.linalg.norm(s)
    theta = np.arccos(np.clip(d[:, 1], -1, 1))
    gamma = np.arccos(np.clip(d @ s, -1, 1))
    t = np.clip((np.pi / 2 - np.arccos(np.clip(s[1], -1, 1)))
                / (np.pi / 2), 0, 1) ** (1 / 3)
    w = np.array([(1 - t) ** 5, 5 * t * (1 - t) ** 4,
                  10 * t ** 2 * (1 - t) ** 3, 10 * t ** 3 * (1 - t) ** 2,
                  5 * t ** 4 * (1 - t), t ** 5])
    xyz = []
    for cf, rad in ((jsky._COEFFS_X, jsky._RAD_X),
                    (jsky._COEFFS_Y, jsky._RAD_Y),
                    (jsky._COEFFS_Z, jsky._RAD_Z)):
        c = w @ cf.reshape(6, 9).astype(np.float64)
        A, B, C, D, E, F, G, I, H = c
        cg, ct = np.cos(gamma), np.cos(theta)
        chi = (1 + cg * cg) / (1 + H * H - 2 * H * cg) ** 1.5
        val = ((1 + A * np.exp(B / (ct + 0.01)))
               * (C + D * np.exp(E * gamma) + F * cg * cg + G * chi
                  + I * np.sqrt(np.maximum(ct, 0))))
        xyz.append(val * (w @ rad.astype(np.float64)))
    xyz = np.stack(xyz, -1)
    m = jsky._XYZ_TO_RGB.astype(np.float64)
    return (np.maximum(xyz @ m.T, 0) * intensity,
            np.abs(xyz) @ np.abs(m).T * intensity)


def _hosek_b(sun):
    """Each channel's blended coefficient B (float64)."""
    s = np.asarray(sun, np.float64)
    s = s / np.linalg.norm(s)
    t = np.clip((np.pi / 2 - np.arccos(np.clip(s[1], -1, 1)))
                / (np.pi / 2), 0, 1) ** (1 / 3)
    w = np.array([(1 - t) ** 5, 5 * t * (1 - t) ** 4,
                  10 * t ** 2 * (1 - t) ** 3, 10 * t ** 3 * (1 - t) ** 2,
                  5 * t ** 4 * (1 - t), t ** 5])
    return np.array([(w @ cf.reshape(6, 9).astype(np.float64))[1]
                     for cf in (jsky._COEFFS_X, jsky._COEFFS_Y,
                                jsky._COEFFS_Z)])


@pytest.mark.parametrize("sun", SUNS)
def test_hosek_wilkie_sky_matches_jax(sun):
    """Directions over the sphere, away from the overflow band (its
    width 0.01 in cos(theta) either side). Tolerance from the formula's
    conditioning: arccos/cos/exp differ by an ulp or two between XLA and
    torch and the XYZ -> RGB sums cancel up to ~4x: rtol 2e-5, and atol
    2e-5 of the largest channel for the cancelled, clamped-at-0 channels.
    Below the horizon the term exp(x), x = B / (cos(theta) + 0.01) > 0,
    grows to e^40 (radiance ~1e17): the blended B carries ~100 ulps of
    the Bezier blend's cancellation, which exp turns into a relative
    error of X, Y, Z |x| times as large, and the RGB sums cancel far more
    than above it. So there a channel may be off by 2e-5 * (1 + |x|) of
    the magnitude |M| |xyz| it sums."""
    rng = np.random.default_rng(11)
    d = rng.normal(size=(20000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d[np.abs(d[:, 1] + 0.011) > 0.01]
    want = np.asarray(jsky.hosek_wilkie_sky(jnp.asarray(d), sun, 20.0))
    got = tsky.hosek_wilkie_sky(torch.from_numpy(d), sun, 20.0).numpy()
    exact, mag = _hosek_f64(d.astype(np.float64), sun, 20.0)
    assert np.isfinite(want).all() and (want > 0).any()
    up = d[:, 1] >= 0.0
    atol = 2e-5 * float(np.abs(want[up]).max())
    assert_parity("hosek_wilkie_sky above the horizon", got[up], want[up],
                  exact[up], rtol=2e-5, atol=atol)
    x = np.abs(_hosek_b(sun))[None, :] / np.abs(
        d[~up, 1:2].astype(np.float64) + 0.01)
    err = np.abs(got[~up] - want[~up]).astype(np.float64)
    bound = 2e-5 * (1 + x) * mag[~up] + atol
    worst = np.unravel_index(np.argmax(err / bound), err.shape)
    assert (err <= bound).all(), (
        "below the horizon", worst, float(got[~up][worst]),
        float(want[~up][worst]), float(exact[~up][worst]))


def test_hosek_overflow_band_matches_jax():
    """The reference's formula overflows just below the horizon; the
    port reproduces where."""
    ct = np.linspace(-0.02, 0.0, 4001).astype(np.float32)
    d = np.stack([np.sqrt(1 - ct * ct), ct, np.zeros_like(ct)], -1)
    want = np.asarray(jsky.hosek_wilkie_sky(jnp.asarray(d), SUNS[0], 20.0))
    got = tsky.hosek_wilkie_sky(torch.from_numpy(d), SUNS[0], 20.0).numpy()
    bad = ~np.isfinite(got).all(-1)
    assert bad.any()
    np.testing.assert_array_equal(bad, ~np.isfinite(want).all(-1))
    assert ct[bad].min() > -0.0125 and ct[bad].max() < -0.0099


def test_sky_radiance_dispatches_hosek():
    d = torch.tensor([[0.0, 1.0, 0.0], [0.6, 0.8, 0.0]])
    cfg = RenderConfig(sky="hosek", sun_intensity=3.0)
    torch.testing.assert_close(
        tsky.sky_radiance(cfg, d),
        tsky.hosek_wilkie_sky(d, cfg.sun_direction, 3.0), rtol=0, atol=0)


# --- reference_quirks ------------------------------------------------------

@pytest.fixture(scope="module")
def materials():
    return (jproc.cornell_box(materials_suite=True).finalize(),
            tproc.cornell_box(materials_suite=True).finalize(device="cpu"))


def _hits(n_tris, n, seed):
    rng = np.random.default_rng(seed)
    tri = rng.integers(-1, n_tris, n).astype(np.int32)
    a = rng.uniform(0, 1, n).astype(np.float32)
    b = rng.uniform(0, 1, n).astype(np.float32)
    u = np.minimum(a, 1 - b).astype(np.float32)
    v = (1 - np.maximum(a, 1 - b)).astype(np.float32)
    t = np.where(tri >= 0, rng.uniform(0.1, 5, n), np.inf).astype(np.float32)
    o = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tri, u, v, t, o, d


def _surfaces(materials, quirks, n=4000, seed=5):
    js, ts = materials
    tri, u, v, t, o, d = _hits(ts.n_tris, n, seed)
    jsurf = jpath.fetch_surface(js, jpath.pack_surface_rows(js), jisect.Hit(
        *map(jnp.asarray, (t, tri, u, v))), jnp.asarray(o), jnp.asarray(d),
        quirks)
    tsurf = tpath.fetch_surface(ts, tpath.pack_surface_rows(ts), tisect.Hit(
        *map(torch.from_numpy, (t, tri, u, v))), torch.from_numpy(o),
        torch.from_numpy(d), None, tpath.pack_material_rows(ts), quirks)
    return jsurf, tsurf, tri, d


def test_fetch_surface_quirks_emission_matches_jax(materials):
    """path.py:301: under quirks the emission is the material's as it
    stands, not scaled by the albedo factor (a gather: exact)."""
    jsurf, tsurf, tri, _ = _surfaces(materials, True)
    valid = tri >= 0
    np.testing.assert_array_equal(tsurf.emission.numpy()[valid],
                                  np.asarray(jsurf.emission)[valid])
    assert (tsurf.emission.numpy()[valid] > 0).any()


def test_nee_quirks_matches_jax(materials):
    """path.py:515 and :566: the shadow ray aimed behind the light with
    t_max = dist - eps, and no emission gain. That ray crosses the emitter
    within rounding of t_max wherever the receiver faces the light, so a
    few lanes decide their visibility on an ulp (about 0.5% of the shadow
    rays of a quirks render, none of a default one); those may flip,
    everything else agrees to float rounding."""
    js, ts = materials
    jsurf, tsurf, tri, d = _surfaces(materials, True)
    pix = np.arange(len(tri), dtype=np.int32)
    samp = np.full(len(tri), 3, np.uint32)
    shade = tri >= 0
    jv = js.tri_vertices(jnp.arange(js.n_tris))
    tv = tuple(torch.from_numpy(np.array(x)) for x in jv)
    ref = np.asarray(jpath._nee(
        js, JRenderConfig(reference_quirks=True), jsurf, -jnp.asarray(d),
        jnp.asarray(pix), jnp.asarray(samp), 1,
        lambda o_, d_, m, primary=False: jisect.occluded_brute(
            o_, d_, m, *jv), jnp.asarray(shade)))
    got = tpath._nee(
        ts, RenderConfig(reference_quirks=True), tsurf,
        -torch.from_numpy(d), torch.from_numpy(pix),
        torch.from_numpy(samp.astype(np.int64)), 1,
        lambda o_, d_, m, primary=False: tisect.occluded_brute(
            o_, d_, m, *tv), torch.from_numpy(shade)).numpy()
    assert (ref[shade] > 0).any()
    diff = np.abs(got - ref).max(-1)
    flip = diff > 1e-3 * np.maximum(np.abs(ref).max(-1), 1.0)
    assert flip.mean() <= 0.01
    np.testing.assert_allclose(got[~flip], ref[~flip], rtol=1e-4, atol=1e-5)


def _oracle_check(cfg, materials_suite, min_mean):
    """tests/test_oracle.py:_check on the port: all but <= 2% of pixels
    (branch-boundary flips) agree with the numpy oracle to 1e-3, with an
    inlier RMSE <= 1e-3."""
    scene = tproc.cornell_box(materials_suite=materials_suite) \
        .finalize(device="cpu")
    cam = _cam(Camera, BOX_CAM).state(device="cpu")
    img = trender.render_frame(scene, cfg, cam, 0).numpy()
    ora = render_oracle(scene, cfg, cam)
    assert img.mean() > min_mean
    per_pixel = np.abs(img - ora).max(axis=-1)
    outliers = per_pixel > 1e-3
    assert outliers.mean() <= 0.02, (outliers.sum(), per_pixel.max())
    rmse = float(np.sqrt(np.mean((img[~outliers] - ora[~outliers]) ** 2)))
    assert rmse <= 1e-3, rmse


@pytest.mark.parametrize("kw,suite,min_mean", [
    (dict(spp=4, max_depth=4), False, 0.1),     # diffuse
    (dict(spp=2, max_depth=6), True, 0.05),     # GGX, dielectric, RR
])
def test_quirks_estimator_matches_oracle(kw, suite, min_mean):
    _oracle_check(RenderConfig(width=8, height=8, reference_quirks=True,
                               intersector="brute", **kw), suite, min_mean)


def test_quirks_render_matches_live_jax():
    kw = dict(width=32, height=32, spp=2, max_depth=6, reference_quirks=True)
    jimg = np.asarray(jrender_frame(jproc.cornell_box().finalize(),
                                    JRenderConfig(**kw),
                                    _cam(JCamera, BOX_CAM).state(), 0))
    timg = trender.render_frame(
        tproc.cornell_box().finalize(device="cpu"), RenderConfig(**kw),
        _cam(Camera, BOX_CAM).state(device="cpu"), 0).numpy()
    assert np.isfinite(timg).all()
    _assert_gate(timg, jimg)


QUIRKS_ROW_STRIDE = 8     # CPU time: every 8th row of the 256x256 frame


def test_quirks_config1_matches_golden():
    """BASELINE config 1 with reference_quirks (256x256, 4 spp, depth 6,
    frame 0) on every 8th row: the RNG keys on the pixel, so these rows
    are those of the full frame (chip_smoke.py renders it whole).

    The gate (chip_smoke.quirks_golden_gate) is tests/test_golden.py:
    47-63's bound, RMSE <= 1e-4, over the pixels whose paths made the
    same decisions, with at most 0.5% of pixels apart by more than 1e-2:
    the quirk shadow ray decides NEE visibility on an ulp, and ~0.2% of
    pixels flip against XLA's arithmetic (ROADMAP.md Queue 3). The
    port's default estimator meets the plain bound on
    tests/golden_cornell_256 (RMSE ~1.2e-6, no such pixel)."""
    from pathtracer_torch.accel.cluster import build_scene_clusters

    scene = build_scene_clusters(tproc.cornell_box().finalize(device="cpu"))
    cfg = RenderConfig(width=256, height=256, spp=4, max_depth=6,
                       reference_quirks=True)
    cam = _cam(Camera, BOX_CAM).state(device="cpu")
    intersect_fn, occluded_fn, hint_fn = trender.make_intersectors(scene, cfg)
    rows = np.arange(0, 256, QUIRKS_ROW_STRIDE)
    pix = torch.from_numpy((rows[:, None] * 256 + np.arange(256)[None])
                           .reshape(-1).astype(np.int32))
    acc = torch.zeros((pix.shape[0], 3))
    for s in range(cfg.spp):
        samp = torch.full(pix.shape, s, dtype=torch.int64)
        o, d = trender._primary_rays(cfg, cam, pix, samp)
        rad, _, _, _ = tpath.trace_paths(scene, cfg, o, d, pix, samp,
                                         intersect_fn, occluded_fn,
                                         sample_window=1, hint_fn=hint_fn)
        acc += rad
    img = (acc / cfg.spp).numpy().reshape(len(rows), 256, 3)
    golden = np.load(os.path.join(REPO, "tests",
                                  "golden_cornell_quirks_256.npy"))[rows]
    res = quirks_golden_gate(img, golden)
    assert res["ok"], res


# --- the slice end to end on the bvh route ---------------------------------

@pytest.fixture(scope="module")
def bunny():
    """bunny_like(2) in both packages; the LBVH built by the port (bit
    for bit JAX's build_lbvh, tests/test_torch_lbvh.py) and carried
    across, which spares a JAX compile of the build."""
    js = jproc.bunny_like(subdivisions=2).finalize()
    fields = {k: (None if getattr(js, k) is None else np.asarray(
        getattr(js, k))) for k in TENSOR_FIELDS + OPTIONAL_FIELDS}
    fields.update({k: getattr(js, k) for k in META_FIELDS})
    ts = lbvh.build_scene_bvh(scene_from_numpy(fields, device="cpu"))
    assert ts.n_tris > 256
    js = js.with_bvh(JBvh(**{f.name: jnp.asarray(getattr(ts.bvh, f.name)
                                                 .numpy())
                             for f in dataclasses.fields(JBvh)}))
    return js, ts


@pytest.mark.parametrize("kw", [dict(), dict(sampler="sobol"),
                                dict(sky="hosek")],
                         ids=["pcg", "sobol", "hosek"])
def test_bvh_slice_matches_live_jax(bunny, kw):
    js, ts = bunny
    base = dict(width=32, height=32, spp=2, max_depth=4, intersector="bvh",
                spp_batch=True, **kw)
    jimg, jrays, _, _ = jrender_batched(js, JRenderConfig(**base),
                                        _cam(JCamera, BUNNY_CAM).state(), 0)
    timg, trays, _, _ = trender.render_frame_batched(
        ts, RenderConfig(**base), _cam(Camera, BUNNY_CAM).state(
            device="cpu"), 0)
    jimg, timg = np.asarray(jimg), timg.numpy()
    res = finite_gate(timg, jimg)
    assert res["ok"], res
    assert abs(int(trays) - float(jrays)) <= 1e-3 * float(jrays)
    if kw.get("sky") != "hosek":
        assert res["nonfinite"] == [0, 0] and timg.mean() > 0.0


def test_bvh_slice_priming_is_exact(bunny):
    _, ts = bunny
    kw = dict(width=32, height=32, spp=2, max_depth=4, intersector="bvh",
              spp_batch=True)
    cam = _cam(Camera, BUNNY_CAM).state(device="cpu")
    plain, rays, _, _ = trender.render_frame_batched(ts, RenderConfig(**kw),
                                                     cam, 1)
    prime = torch.full((32 * 32, 3), -1, dtype=torch.int32)
    cfg_p = RenderConfig(primary_priming=True, **kw)
    _, _, prime, _ = trender.render_frame_batched(ts, cfg_p, cam, 0, prime)
    assert int((prime[:, 0] >= 0).sum()) > 0
    primed, rays_p, _, _ = trender.render_frame_batched(ts, cfg_p, cam, 1,
                                                        prime)
    assert int(rays_p) == int(rays)
    torch.testing.assert_close(primed, plain, rtol=1e-5, atol=1e-6)
