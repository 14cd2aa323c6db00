"""pathtracer_torch camera rays, BSDF, sky, vector math and film vs the JAX package.

Same numpy inputs through both; float results agree within rtol 1e-6 /
atol 1e-6 (rsqrt, sin/cos and pow may differ by an ulp between XLA and
torch; XLA may also contract a*b+c on the host).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer.bsdf import microfacet as jmf
from pathtracer.film import film as jfilm
from pathtracer.integrator import camera as jcam
from pathtracer.integrator import sky as jsky
from pathtracer.utils import vmath as jvm
from pathtracer_torch.bsdf import microfacet as tmf
from pathtracer_torch.film import film as tfilm
from pathtracer_torch.integrator import camera as tcam
from pathtracer_torch.integrator import sky as tsky
from pathtracer_torch.utils import vmath as tvm

TOL = dict(rtol=1e-6, atol=1e-6)


def assert_parity(name, got, ref, exact, rtol, atol):
    """assert_allclose(got, ref, rtol, atol) for a port-vs-JAX float
    comparison. On a mismatch the message gives each side's largest error
    against `exact` (a float64 evaluation of the same function), the
    dtypes, JAX's x64 flag, torch's thread count and CPU capability, and
    the worst elements of both sides, so that a failure names the side
    that moved and the process state it moved in."""
    got, ref = np.asarray(got), np.asarray(ref)
    try:
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
    except AssertionError as e:
        exact = np.asarray(exact, np.float64)
        err_p = np.abs(got - exact)
        err_j = np.abs(ref - exact)
        bad = ~np.isclose(got, ref, rtol=rtol, atol=atol)
        worst = np.argsort(-np.abs(got - ref), axis=None)[:4]
        rows = [(tuple(int(k) for k in np.unravel_index(i, got.shape)),
                 float(got.flat[i]), float(ref.flat[i]),
                 float(exact.flat[i])) for i in worst]
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.size} elements apart; max "
            f"error vs float64: port {err_p.max():.3g}, JAX "
            f"{err_j.max():.3g}; dtypes port {got.dtype}, JAX {ref.dtype};"
            f" jax_enable_x64={jax.config.jax_enable_x64}; torch threads "
            f"{torch.get_num_threads()}, CPU capability "
            f"{torch.backends.cpu.get_cpu_capability()}; worst (index, "
            f"port, JAX, float64): {rows}\n{e}") from None


def _unit(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(kw or TOL))


@pytest.mark.parametrize("w,h,fov", [(64, 48, 70.0), (33, 17, 45.0)])
def test_primary_rays_match_jax(w, h, fov):
    pos, tgt = (3.0, 4.5, 6.0), (14.0, 3.0, 6.0)
    jc = jcam.Camera(position=pos)
    jc.look_at(tgt)
    tc = tcam.Camera(position=pos)
    tc.look_at(tgt)
    np.testing.assert_array_equal(tc.front, jc.front)
    np.testing.assert_array_equal(tc.up, jc.up)
    pix = np.arange(w * h, dtype=np.int32)[::-1].copy()
    samp = np.full(w * h, 7, np.uint32)
    jo, jd = jcam.generate_primary_rays(jc.state(), w, h, fov,
                                        jnp.asarray(pix), jnp.asarray(samp))
    to, td = tcam.generate_primary_rays(tc.state(device="cpu"), w, h, fov,
                                        torch.from_numpy(pix),
                                        torch.from_numpy(samp.astype(
                                            np.int64)))
    _close(to.numpy(), jo)
    _close(td.numpy(), jd)


def test_camera_controls_match_jax():
    jc, tc = jcam.Camera(position=(1, 2, 3)), tcam.Camera(position=(1, 2, 3))
    for c in (jc, tc):
        c.process_mouse(30.0, -400.0)
        c.process_keyboard("forward", 0.25)
        c.process_keyboard("left", 0.1)
    assert tc.pitch == jc.pitch == -40.0
    np.testing.assert_array_equal(tc.position, jc.position)
    np.testing.assert_array_equal(tc.right, jc.right)


def _shading_inputs(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    nrm = _unit(n, seed)
    v = _unit(n, seed + 1)
    v = np.where((v * nrm).sum(1, keepdims=True) < 0, -v, v)
    l_ = _unit(n, seed + 2)
    alb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    met = rng.uniform(0, 1, n).astype(np.float32)
    # roughness >= 0.2: below it the GGX peak (1 / (ndh^2 (a^2-1) + 1)^2)
    # amplifies XLA's host FMA contraction far beyond an ulp
    rough = rng.uniform(0.2, 1, n).astype(np.float32)
    u1 = rng.uniform(0, 1, n).astype(np.float32)
    u2 = rng.uniform(0, 1, n).astype(np.float32)
    return nrm, v, l_, alb, met, rough, u1, u2


def test_brdf_and_pdfs_match_jax():
    nrm, v, l_, alb, met, rough, *_ = _shading_inputs()
    J = jnp.asarray
    T = torch.from_numpy
    # the GGX peak amplifies f32 rounding: both packages sit within ~2e-5
    # of the float64 evaluation, so they agree to 5e-5 of each other
    got = tmf.eval_brdf(T(nrm), T(v), T(l_), T(alb), T(met), T(rough))
    _close(got, jmf.eval_brdf(J(nrm), J(v), J(l_), J(alb), J(met), J(rough)),
           rtol=5e-5, atol=1e-6)
    f64 = tmf.eval_brdf(*(T(x.astype(np.float64)) for x in
                          (nrm, v, l_, alb, met, rough)))
    _close(got.double(), f64, rtol=2e-5, atol=1e-6)
    _close(tmf.pdf_bsdf(T(nrm), T(v), T(l_), T(met), T(rough)),
           jmf.pdf_bsdf(J(nrm), J(v), J(l_), J(met), J(rough)),
           rtol=5e-5, atol=1e-6)
    _close(tmf.pdf_ggx(T(nrm), T(v), T(l_), T(rough)),
           jmf.pdf_ggx(J(nrm), J(v), J(l_), J(rough)), rtol=5e-5, atol=1e-6)
    _close(tmf.lobe_select_prob(T(met), T(rough)),
           jmf.lobe_select_prob(J(met), J(rough)))
    c = np.linspace(0, 1, 101, dtype=np.float32)
    _close(tmf.schlick_scalar(T(c), 0.04), jmf.schlick_scalar(J(c), 0.04))


def test_bsdf_sampling_matches_jax():
    nrm, v, _, _, _, rough, u1, u2 = _shading_inputs(seed=3)
    J = jnp.asarray
    T = torch.from_numpy
    D = lambda x: T(x.astype(np.float64))  # noqa: E731
    assert_parity("sample_cosine", tmf.sample_cosine(T(nrm), T(u1), T(u2)),
                  jmf.sample_cosine(J(nrm), J(u1), J(u2)),
                  tmf.sample_cosine(D(nrm), D(u1), D(u2)), rtol=1e-5,
                  atol=2e-6)
    assert_parity("sample_ggx",
                  tmf.sample_ggx(T(nrm), T(v), T(rough), T(u1), T(u2)),
                  jmf.sample_ggx(J(nrm), J(v), J(rough), J(u1), J(u2)),
                  tmf.sample_ggx(D(nrm), D(v), D(rough), D(u1), D(u2)),
                  rtol=1e-5, atol=2e-6)


def test_vmath_matches_jax():
    a, b = _unit(2000, 5), _unit(2000, 6)
    eta = np.random.default_rng(7).uniform(0.5, 1.6, 2000).astype(np.float32)
    J, T = jnp.asarray, torch.from_numpy
    _close(tvm.cross(T(a), T(b)), jvm.cross(J(a), J(b)))
    _close(tvm.normalize(T(a * 3.0)), jvm.normalize(J(a * 3.0)))
    tr, tt = tvm.refract(T(a), T(b), T(eta))
    jr, jt = jvm.refract(J(a), J(b), J(eta))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _close(tr, jr, rtol=1e-5, atol=1e-6)
    for x, y in zip(tvm.onb(T(a)), jvm.onb(J(a))):
        _close(x, y)


def test_gradient_sky_matches_jax():
    d = _unit(3000, 8)
    _close(tsky.gradient_sky(torch.from_numpy(d), 0.2),
           jsky.gradient_sky(jnp.asarray(d), 0.2))


def test_film_matches_jax():
    rng = np.random.default_rng(9)
    frames = rng.uniform(0, 3, (3, 8, 6, 3)).astype(np.float32)
    jf, tf = jfilm.new_film(6, 8), tfilm.new_film(6, 8, device="cpu")
    for f in frames:
        jf = jfilm.accumulate(jf, jnp.asarray(f))
        tf = tfilm.accumulate(tf, torch.from_numpy(f))
    assert tf.frame == int(jf.frame) == 3
    _close(tf.accum, jf.accum)
    _close(tfilm.to_display(tf.accum), jfilm.to_display(jf.accum))
    jm = jfilm.accumulate_many(jf, jnp.asarray(frames.sum(0)), 3)
    tm = tfilm.accumulate_many(tf, torch.from_numpy(frames.sum(0)), 3)
    assert tm.frame == int(jm.frame) == 6
    _close(tm.accum, jm.accum)
    for tonemap in ("reinhard", "aces"):
        _close(tfilm.to_display(tf.accum, tonemap),
               jfilm.to_display(jf.accum, tonemap))
    with pytest.raises(ValueError, match="gamma|reinhard|aces"):
        tfilm.to_display(tf.accum, "filmic")


def test_write_png_roundtrip(tmp_path):
    img = np.random.default_rng(1).uniform(0, 1, (9, 11, 3))
    p = str(tmp_path / "a.png")
    tfilm.write_png(p, torch.from_numpy(img.astype(np.float32)))
    back = tfilm.read_png(p)
    np.testing.assert_allclose(back, img, atol=1 / 255 + 1e-6)
