"""pathtracer_torch integrator pieces vs the JAX package's on the same inputs.

Packed attribute rows are exact; texture fetches (both the stochastic
one-tap and the 4-tap bilinear filter, with floor-mod wrapping of
negative coordinates) are exact in their texel choice; shading-point
reconstruction and NEE agree to float rounding; a whole brute-force
Cornell trace agrees with the JAX trace_paths under the robust gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer.config import RenderConfig as JRenderConfig
from pathtracer.integrator import path as jpath
from pathtracer.kernels import intersect as jisect
from pathtracer.scene import procedural as jproc
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.integrator import path as tpath
from pathtracer_torch.kernels import intersect as tisect
from pathtracer_torch.scene import procedural as tproc

_scenes = {}


def _scenes_for(name):
    if name not in _scenes:
        if name == "sponza":
            jb = jproc.sponza_like(4000, textured=True)
            tb = tproc.sponza_like(4000, textured=True)
        else:
            jb = jproc.cornell_box(materials_suite=True)
            tb = tproc.cornell_box(materials_suite=True)
        _scenes[name] = (jb.finalize(), tb.finalize(device="cpu"))
    return _scenes[name]


@pytest.mark.parametrize("name", ["sponza", "materials"])
def test_packed_rows_exact(name):
    js, ts = _scenes_for(name)
    np.testing.assert_array_equal(tpath.pack_material_rows(ts).numpy(),
                                  np.asarray(jpath.pack_material_rows(js)))
    a = tpath.pack_surface_rows(ts).numpy()
    b = np.asarray(jpath.pack_surface_rows(js))
    assert a.shape == b.shape
    # geometric normal is normalize(cross): rsqrt and XLA's contraction
    # may move it by an ulp; every other column is a pure gather
    np.testing.assert_array_equal(np.delete(a, [15, 16, 17], 1),
                                  np.delete(b, [15, 16, 17], 1))
    np.testing.assert_allclose(a[:, 15:18], b[:, 15:18], rtol=0, atol=1e-6)


@pytest.mark.parametrize("stochastic", [True, False])
def test_sample_texture_matches_jax(stochastic):
    js, ts = _scenes_for("sponza")
    rng = np.random.default_rng(3)
    n = 20000
    tex_id = rng.integers(-1, ts.textures.shape[0], n).astype(np.int32)
    u = rng.uniform(-3, 3, n).astype(np.float32)
    v = rng.uniform(-3, 3, n).astype(np.float32)
    tu = (rng.uniform(0, 1, n).astype(np.float32),
          rng.uniform(0, 1, n).astype(np.float32)) if stochastic else None
    ref = np.asarray(jpath._sample_texture(
        js.textures, js.tex_wh, jnp.asarray(tex_id), jnp.asarray(u),
        jnp.asarray(v), None if tu is None else tuple(map(jnp.asarray, tu))))
    got = tpath._sample_texture(
        ts.textures, ts.tex_wh, torch.from_numpy(tex_id),
        torch.from_numpy(u), torch.from_numpy(v),
        None if tu is None else tuple(map(torch.from_numpy, tu))).numpy()
    if stochastic:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def _hits(n_tris, n, seed):
    rng = np.random.default_rng(seed)
    tri = rng.integers(-1, n_tris, n).astype(np.int32)
    a = rng.uniform(0, 1, n).astype(np.float32)
    b = rng.uniform(0, 1, n).astype(np.float32)
    u = np.minimum(a, 1 - b).astype(np.float32)
    v = (1 - np.maximum(a, 1 - b)).astype(np.float32)
    t = np.where(tri >= 0, rng.uniform(0.1, 5, n), np.inf).astype(np.float32)
    o = rng.uniform(1, 20, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tri, u, v, t, o, d, rng


@pytest.mark.parametrize("name,stochastic", [("sponza", True),
                                             ("sponza", False),
                                             ("materials", True)])
def test_fetch_surface_matches_jax(name, stochastic):
    js, ts = _scenes_for(name)
    tri, u, v, t, o, d, rng = _hits(ts.n_tris, 8000, 4)
    tu = (rng.uniform(0, 1, len(tri)).astype(np.float32),
          rng.uniform(0, 1, len(tri)).astype(np.float32))
    jhit = jisect.Hit(*map(jnp.asarray, (t, tri, u, v)))
    thit = tisect.Hit(*map(torch.from_numpy, (t, tri, u, v)))
    jsurf = jpath.fetch_surface(
        js, jpath.pack_surface_rows(js), jhit, jnp.asarray(o), jnp.asarray(d),
        False, tuple(map(jnp.asarray, tu)) if stochastic else None,
        jpath.pack_material_rows(js))
    tsurf = tpath.fetch_surface(
        ts, tpath.pack_surface_rows(ts), thit, torch.from_numpy(o),
        torch.from_numpy(d),
        tuple(map(torch.from_numpy, tu)) if stochastic else None,
        tpath.pack_material_rows(ts))
    valid = tri >= 0
    for f in tpath.Surface._fields:
        a, b = getattr(tsurf, f).numpy(), np.asarray(getattr(jsurf, f))
        if f == "mat_type":
            np.testing.assert_array_equal(a, b)
            continue
        np.testing.assert_allclose(a[valid], b[valid], rtol=2e-5, atol=2e-5,
                                   err_msg=f)


def test_nee_matches_jax():
    js, ts = _scenes_for("materials")
    tri, u, v, t, o, d, rng = _hits(ts.n_tris, 4000, 5)
    o = rng.uniform(0.1, 0.9, (len(tri), 3)).astype(np.float32)
    jhit = jisect.Hit(*map(jnp.asarray, (t, tri, u, v)))
    thit = tisect.Hit(*map(torch.from_numpy, (t, tri, u, v)))
    jsurf = jpath.fetch_surface(js, jpath.pack_surface_rows(js), jhit,
                                jnp.asarray(o), jnp.asarray(d), False)
    tsurf = tpath.fetch_surface(ts, tpath.pack_surface_rows(ts), thit,
                                torch.from_numpy(o), torch.from_numpy(d),
                                None, tpath.pack_material_rows(ts))
    pix = np.arange(len(tri), dtype=np.int32)
    samp = np.full(len(tri), 3, np.uint32)
    shade = tri >= 0
    jv = jnp.asarray(np.stack([np.asarray(x) for x in js.tri_vertices(
        np.arange(js.n_tris))]))
    tv = torch.from_numpy(np.array(jv))

    def j_occ(o_, d_, tmax, primary=False):
        return jisect.occluded_brute(o_, d_, tmax, jv[0], jv[1], jv[2])

    def t_occ(o_, d_, tmax, primary=False):
        return tisect.occluded_brute(o_, d_, tmax, tv[0], tv[1], tv[2])

    ref = np.asarray(jpath._nee(js, JRenderConfig(), jsurf, -jnp.asarray(d),
                                jnp.asarray(pix), jnp.asarray(samp), 1,
                                j_occ, jnp.asarray(shade)))
    got = tpath._nee(ts, RenderConfig(), tsurf, -torch.from_numpy(d),
                     torch.from_numpy(pix),
                     torch.from_numpy(samp.astype(np.int64)), 1, t_occ,
                     torch.from_numpy(shade)).numpy()
    assert (ref[shade] > 0).any()
    diff = np.abs(got - ref).max(-1)
    # a visibility flip (shadow ray grazing a silhouette) is allowed for
    # a handful of lanes; everything else agrees to float rounding
    flip = diff > 1e-3 * np.maximum(np.abs(ref).max(-1), 1.0)
    assert flip.mean() <= 0.002
    np.testing.assert_allclose(got[~flip], ref[~flip], rtol=1e-4, atol=1e-5)


def test_trace_paths_matches_jax_bruteforce():
    """Whole integrator on the 2572-triangle materials box, brute force."""
    js, ts = _scenes_for("materials")
    w = h = 24
    cfg_kw = dict(width=w, height=h, spp=1, max_depth=4, intersector="brute")
    from pathtracer.integrator.camera import Camera as JCamera
    from pathtracer_torch.integrator.camera import Camera, \
        generate_primary_rays

    jc = JCamera(position=(0.5, 0.5, 2.2))
    jc.look_at((0.5, 0.5, 0.0))
    c = Camera(position=(0.5, 0.5, 2.2))
    c.look_at((0.5, 0.5, 0.0))
    pix = np.arange(w * h, dtype=np.int32)
    samp = np.zeros(w * h, np.uint32)
    from pathtracer.integrator.camera import generate_primary_rays as jgen

    jo, jd = jgen(jc.state(), w, h, 70.0, jnp.asarray(pix),
                  jnp.asarray(samp))
    to, td = generate_primary_rays(c.state(device="cpu"), w, h, 70.0,
                                   torch.from_numpy(pix),
                                   torch.zeros(w * h, dtype=torch.int64))
    jv = js.tri_vertices(jnp.arange(js.n_tris))
    tv = ts.tri_vertices(torch.arange(ts.n_tris))
    jrad, _, jrays, _, _ = jpath.trace_paths(
        js, JRenderConfig(**cfg_kw), jo, jd, jnp.asarray(pix),
        jnp.asarray(samp),
        lambda o, d, a, b, primary=False: jisect.intersect_brute(
            o, d, *jv, a, b),
        lambda o, d, m, primary=False, want_blocker=False:
            jisect.occluded_brute(o, d, m, *jv))
    trad, _, trays, _, _ = tpath.trace_paths(
        ts, RenderConfig(**cfg_kw), to, td, torch.from_numpy(pix),
        torch.zeros(w * h, dtype=torch.int64),
        lambda o, d, a, b, primary=False: tisect.intersect_brute(
            o, d, *tv, a, b),
        lambda o, d, m, primary=False, want_blocker=False:
            tisect.occluded_brute(o, d, m, *tv, want_blocker=want_blocker))
    jr, tr = np.asarray(jrad), trad.numpy()
    diff = np.abs(tr - jr).max(-1)
    assert (diff > 0.01).mean() <= 0.02
    assert abs(tr.mean() - jr.mean()) <= 1e-3 * jr.mean()
    assert abs(int(trays) - float(jrays)) <= 1e-3 * float(jrays)
