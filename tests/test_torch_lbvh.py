"""The LBVH route of pathtracer_torch against the JAX package.

- build_lbvh: every field of the Bvh bit for bit equal to JAX's, on
  random soups, coincident centroids (duplicate Morton codes) and trees
  of 1, 2, 3 and 5 triangles (tests/test_lbvh.py:56-95);
- the plain K5 / K6 traversals: hit ids and blocked flags equal to JAX's
  intersect_bvh / occluded_bvh and to the brute oracles, t/u/v within a
  bound derived from Moller-Trumbore's conditioning (XLA on the host
  contracts the cross and dot products into FMAs, the port does not),
  and bit for bit equal to the port's own brute route, which evaluates
  the same expressions;
- the bvh route end to end: against the brute route on Cornell
  (tests/test_render.py:76-82), and a primed frame equal to an unprimed
  one. Live renders against the JAX package are in
  tests/test_torch_estimators.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer.accel.lbvh import build_lbvh as jbuild_lbvh
from pathtracer.kernels.intersect import intersect_brute as jbrute
from pathtracer.kernels.intersect import occluded_brute as joccl_brute
from pathtracer.kernels.traverse import intersect_bvh as jintersect
from pathtracer.kernels.traverse import occluded_bvh as joccluded
from pathtracer_torch import kernels
from pathtracer_torch import render as trender
from pathtracer_torch.accel import lbvh
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.integrator.camera import Camera
from pathtracer_torch.kernels import intersect as tisect
from pathtracer_torch.kernels import traverse
from pathtracer_torch.scene import procedural as tproc

BOX_CAM = ((0.5, 0.5, 2.2), (0.5, 0.5, 0.0))
FIELDS = ("aabb_min", "aabb_max", "hit_link", "miss_link", "tri_id")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads keep this file's renders from oversubscribing
    the cores when test files run side by side."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _soup(t, seed, spread=0.4):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-spread, spread, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-spread, spread, (t, 3)).astype(np.float32)
    return v0, v1, v2


def _duplicates():
    """tests/test_lbvh.py:76: 8 triangles per centroid location."""
    rng = np.random.default_rng(5)
    base = rng.uniform(-1, 1, (10, 3)).astype(np.float32)
    v0 = np.repeat(base, 8, axis=0)
    off = rng.uniform(-0.2, 0.2, (80, 3)).astype(np.float32)
    return (v0, v0 + off,
            v0 - off + rng.uniform(-0.1, 0.1, (80, 3)).astype(np.float32))


SOUPS = {
    "random200": lambda: _soup(200, 42),
    "random3000": lambda: _soup(3000, 3, spread=0.1),
    "duplicates": _duplicates,
    "tiny1": lambda: _soup(1, 9, 0.5),
    "tiny2": lambda: _soup(2, 10, 0.5),
    "tiny3": lambda: _soup(3, 11, 0.5),
    "tiny5": lambda: _soup(5, 12, 0.5),
}


def _rays(n=500, seed=7, tris=None):
    """n rays from random origins (tests/conftest.py random_rays); with
    tris, the second half aims at random points of random triangles."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    if tris is not None:
        v0, v1, v2 = tris
        m = n // 2
        k = rng.integers(0, len(v0), m)
        b = rng.dirichlet((1.0, 1.0, 1.0), m).astype(np.float32)
        p = b[:, :1] * v0[k] + b[:, 1:2] * v1[k] + b[:, 2:] * v2[k]
        d[m:] = p - o[m:]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _mesh(v0, v1, v2):
    t = len(v0)
    verts = np.stack([v0, v1, v2], 1).reshape(-1, 3)
    return verts, np.arange(3 * t, dtype=np.int32).reshape(t, 3)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("x", [0, 1, 2, 3, 0xFFFF, 0x10000, 0x7FFFFFFF,
                               0x80000000, 0xFFFFFFFF, 0x00F0F0F0])
def test_clz32_matches_bit_length(x):
    got = int(lbvh._clz32(torch.tensor([x], dtype=torch.int64))[0])
    assert got == 32 - int(x).bit_length()


@pytest.mark.parametrize("name", list(SOUPS))
def test_build_lbvh_bit_exact(name):
    v0, v1, v2 = SOUPS[name]()
    jb = jbuild_lbvh(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2))
    tb = lbvh.build_lbvh(_t(v0), _t(v1), _t(v2))
    for f in FIELDS:
        want = np.asarray(getattr(jb, f))
        got = getattr(tb, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=f)


@pytest.mark.parametrize("name", ["random3000", "duplicates", "tiny3"])
def test_radix_tree_ranges_match_jax(name):
    """Ranges and splits of the internal nodes (the split search's masked
    `do { t = ceil(t/2) } while (t > 1)` included), on the sorted codes."""
    from pathtracer.accel import lbvh as jlbvh
    from pathtracer.accel import morton as jmorton

    v0, v1, v2 = SOUPS[name]()
    codes = np.sort(np.asarray(jmorton.morton_codes(
        (jnp.asarray(v0) + v1 + v2) / 3.0)), kind="stable")
    n = len(codes)
    want = jlbvh._radix_tree_ranges(jnp.asarray(codes), n)
    got = lbvh._radix_tree_ranges(torch.from_numpy(codes.astype(np.int64)),
                                  n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_build_scene_bvh_and_to():
    scene = lbvh.build_scene_bvh(tproc.cornell_box().finalize(device="cpu"))
    n = scene.n_tris
    assert scene.bvh.tri_id.shape == (2 * n - 1,)
    leaves = np.sort(scene.bvh.tri_id.numpy())[n - 1:]
    np.testing.assert_array_equal(leaves, np.arange(n))
    moved = scene.to("cpu")
    for f in FIELDS:
        assert torch.equal(getattr(moved.bvh, f), getattr(scene.bvh, f))


def _mt_tol(verts, idx, tri, o, d, t, u, v):
    """Per-ray bounds on |port - JAX| of t, u, v at a hit.

    t = (e2 . q) / det, u = (tv . p) / det, v = (d . q) / det with
    p = d x e2, q = tv x e1, tv = o - v0, det = e1 . p. Each product or
    sum rounds with relative error eps = 2^-24; contracting a*b + c into
    one FMA moves a result by at most a few such roundings of the
    magnitudes summed, never of the (possibly cancelled) result. So the
    error of a numerator is k * eps * (sum of |term| products), and of
    the quotient k * eps * (|num terms| + |x| * |det terms|) / |det|,
    with k = 16 for the chain of ~6 roundings on each side.
    """
    k_eps = 16 * 2.0 ** -24
    v0 = verts[idx[tri, 0]].astype(np.float64)
    e1 = verts[idx[tri, 1]] - verts[idx[tri, 0]]
    e2 = verts[idx[tri, 2]] - verts[idx[tri, 0]]
    nrm = lambda a: np.linalg.norm(a, axis=-1)    # noqa: E731
    tv = nrm(o) + nrm(v0)
    det_terms = nrm(e1) * nrm(d) * nrm(e2)
    det = np.abs(np.einsum("ij,ij->i", e1, np.cross(d, e2)))
    den = np.maximum(det, 1e-30)
    tol_t = k_eps * (nrm(e2) * tv * nrm(e1) + np.abs(t) * det_terms) / den
    tol_u = k_eps * (tv * nrm(d) * nrm(e2) + np.abs(u) * det_terms) / den
    tol_v = k_eps * (nrm(d) * tv * nrm(e1) + np.abs(v) * det_terms) / den
    return tol_t, tol_u, tol_v


@pytest.mark.parametrize("name", list(SOUPS))
def test_intersect_bvh_plain_matches_jax_and_brute(name):
    v0, v1, v2 = SOUPS[name]()
    o, d = _rays(tris=(v0, v1, v2))
    verts, idx = _mesh(v0, v1, v2)
    jb = jbuild_lbvh(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2))
    jh = jintersect(jb, jnp.asarray(idx), jnp.asarray(verts),
                    jnp.asarray(o), jnp.asarray(d), 1e-3, 1e20)
    jr = jbrute(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0),
                jnp.asarray(v1), jnp.asarray(v2), 1e-3, 1e20)
    packed = traverse.pack_bvh(lbvh.build_lbvh(_t(v0), _t(v1), _t(v2)),
                               _t(idx), _t(verts))
    visits = torch.zeros((), dtype=torch.int64)
    leaves = torch.zeros((), dtype=torch.int64)
    th = traverse.intersect_bvh_plain(packed, _t(o), _t(d), 1e-3, 1e20,
                                      node_visits=visits, leaf_tests=leaves)
    tri = th.tri.numpy()
    np.testing.assert_array_equal(tri, np.asarray(jh.tri))
    np.testing.assert_array_equal(tri, np.asarray(jr.tri))
    hit = tri >= 0
    assert hit.any() and (~hit).any()
    assert np.isinf(th.t.numpy()[~hit]).all()
    tol = _mt_tol(verts, idx, tri[hit], o[hit], d[hit], th.t.numpy()[hit],
                  th.u.numpy()[hit], th.v.numpy()[hit])
    for got, want, bound, nm in zip((th.t, th.u, th.v), (jh.t, jh.u, jh.v),
                                    tol, "tuv"):
        err = np.abs(got.numpy()[hit] - np.asarray(want)[hit])
        assert (err <= bound).all(), (nm, float(err.max()),
                                      float(bound[err.argmax()]))
    # the port's brute route evaluates the same expressions: bit-exact
    tb = tisect.intersect_brute(_t(o), _t(d), _t(v0), _t(v1), _t(v2), 1e-3,
                                1e20)
    assert torch.equal(tb.tri, th.tri)
    for got, want in ((th.t, tb.t), (th.u, tb.u), (th.v, tb.v)):
        assert torch.equal(got[_t(hit)], want[_t(hit)])
    assert 0 < int(leaves) <= int(visits)


@pytest.mark.parametrize("name", list(SOUPS))
def test_occluded_bvh_plain_matches_jax_and_brute(name):
    v0, v1, v2 = SOUPS[name]()
    o, d = _rays(tris=(v0, v1, v2))
    verts, idx = _mesh(v0, v1, v2)
    t_max = np.random.default_rng(3).uniform(0.5, 3.0, len(o)) \
        .astype(np.float32)
    jb = jbuild_lbvh(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2))
    jo = np.asarray(joccluded(jb, jnp.asarray(idx), jnp.asarray(verts),
                              jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t_max)))
    jr = np.asarray(joccl_brute(jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(t_max), jnp.asarray(v0),
                                jnp.asarray(v1), jnp.asarray(v2)))
    packed = traverse.pack_bvh(lbvh.build_lbvh(_t(v0), _t(v1), _t(v2)),
                               _t(idx), _t(verts))
    got = traverse.occluded_bvh_plain(packed, _t(o), _t(d), _t(t_max))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), jo)
    np.testing.assert_array_equal(got.numpy(), jr)
    brute = tisect.occluded_brute(_t(o), _t(d), _t(t_max), _t(v0), _t(v1),
                                  _t(v2))
    assert torch.equal(got, brute)


def test_wrappers_run_plain_on_cpu_and_count_no_launch():
    v0, v1, v2 = _soup(200, 42)
    o, d = _rays(64)
    verts, idx = _mesh(v0, v1, v2)
    packed = traverse.pack_bvh(lbvh.build_lbvh(_t(v0), _t(v1), _t(v2)),
                               _t(idx), _t(verts))
    kernels.reset_launch_counts()
    h = traverse.intersect_bvh(packed, _t(o), _t(d), 1e-3, 1e20)
    hp = traverse.intersect_bvh_plain(packed, _t(o), _t(d), 1e-3, 1e20)
    for a, b in zip(h, hp):
        assert torch.equal(a, b)
    assert torch.equal(traverse.occluded_bvh(packed, _t(o), _t(d), 2.0),
                       traverse.occluded_bvh_plain(packed, _t(o), _t(d),
                                                   2.0))
    assert kernels.LAUNCHES["bvh_closest"] == 0
    assert kernels.LAUNCHES["bvh_occluded"] == 0
    with pytest.raises(ValueError, match="unsupported device"):
        traverse.intersect_bvh(packed, _t(o).to("meta"), _t(d).to("meta"),
                               1e-3, 1e20)


def test_hint_test_reproduces_the_traversal():
    """hint_fn re-tests a ray's own hit triangle with the traversal's
    arithmetic: t/u/v bit-exact, and with the occlusion walk's policy a
    blocking triangle re-verifies."""
    v0, v1, v2 = _soup(200, 42)
    o, d = _rays()
    verts, idx = _mesh(v0, v1, v2)
    packed = traverse.pack_bvh(lbvh.build_lbvh(_t(v0), _t(v1), _t(v2)),
                               _t(idx), _t(verts))
    h = traverse.intersect_bvh_plain(packed, _t(o), _t(d), 1e-3, 1e20)
    hint = traverse.hint_test(packed)
    t, u, v, ok = hint(h.tri, _t(o), _t(d), 1e-3, 1e20)
    hit = h.tri >= 0
    assert torch.equal(ok, hit)
    for a, b in ((t, h.t), (u, h.u), (v, h.v)):
        assert torch.equal(a[hit], b[hit])
    _, _, _, front = hint(h.tri, _t(o), _t(d), 0.0, torch.inf,
                          front_only=True)
    blocked = traverse.occluded_bvh_plain(packed, _t(o), _t(d), torch.inf)
    assert bool((blocked | ~(front & hit)).all())


def _cam():
    c = Camera(position=BOX_CAM[0])
    c.look_at(BOX_CAM[1])
    return c


def test_bvh_route_matches_brute_route_end_to_end():
    """tests/test_render.py:76-82: same rays and RNG, only the intersector
    differs. Both evaluate Moller-Trumbore in the same order, so the
    images agree to the float sum order."""
    scene = lbvh.build_scene_bvh(tproc.cornell_box().finalize(device="cpu"))
    cfg = RenderConfig(width=24, height=24, spp=1, max_depth=3,
                       intersector="brute")
    cam = _cam().state(device="cpu")
    img_brute = trender.render_frame(scene, cfg, cam, 0)
    cfg_bvh = RenderConfig(width=24, height=24, spp=1, max_depth=3,
                           intersector="bvh")
    img_bvh = trender.render_frame(scene, cfg_bvh, cam, 0)
    np.testing.assert_allclose(img_bvh.numpy(), img_brute.numpy(),
                               rtol=1e-3, atol=1e-3)
    assert float(img_bvh.mean()) > 0.05


def test_renderer_builds_the_bvh_and_priming_is_exact():
    scene = tproc.cornell_box(materials_suite=True).finalize(device="cpu")
    kw = dict(width=16, height=16, spp=2, max_depth=4, intersector="bvh",
              spp_batch=True)
    plain = trender.Renderer(scene, RenderConfig(**kw), _cam(),
                             device="cpu")
    assert plain.scene.bvh is not None and plain.scene.clusters is None
    primed = trender.Renderer(scene, RenderConfig(primary_priming=True,
                                                  **kw), _cam(),
                              device="cpu")
    for _ in range(3):
        plain.step()
        primed.step()
        assert int(primed.last_rays) == int(plain.last_rays)
    assert int((primed._prime[:, 0] >= 0).sum()) > 0
    assert int((primed._prime[:, 1:] >= 0).sum()) == 0   # no blocker hints
    torch.testing.assert_close(primed.film.accum, plain.film.accum,
                               rtol=1e-5, atol=1e-6)
