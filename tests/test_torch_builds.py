"""The cluster accel's build methods and the accel split, port vs the JAX package.

Every method of pathtracer/accel/cluster.py:405 (morton, median, sah,
sahleaf, sahdeep, sahsplit, with PT_SAH_DUP, PT_SAH_DEEP and
PT_NATIVE_BUILD=0) builds the same accel in both packages: aabb_lo,
aabb_hi and blocks_t bit for bit, which fixes the triangle ids (row 12)
and their order in every cluster. That holds on a 260-triangle soup at
max_clusters=8, min_k=8 and on a procedural scene at min_k=128.

Ties: on a soup where half the triangles share one centroid the median
builds' sorts meet equal keys (cluster.py:121, :134). lax.sort is stable
by default there and the port sorts stably, so the ids agree bit for bit
today; the test holds them as sets per cluster (with the boxes, which
depend on the set only, bit for bit), the order inside a tie being no
contract of lax.sort's callers.

build_scene_clusters: the median/morton split gives each package the
same two accels; equal methods put one accel in both fields, kept
shared by Scene.to.

    python -m pytest tests/test_torch_builds.py -q -p no:randomly
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pathtracer.accel import cluster as jcluster
from pathtracer.scene import procedural as jproc
from pathtracer_torch.accel import cluster as tcluster
from pathtracer_torch.scene import procedural as tproc

FIELDS = ("aabb_lo", "aabb_hi", "blocks_t")

# (method, environment): every method, and each knob of the SAH builds
CASES = [(m, {}) for m in tcluster.METHODS] + [
    ("sahsplit", {"PT_SAH_DUP": "3.0"}),
    ("sahsplit", {"PT_NATIVE_BUILD": "0"}),
    ("sahsplit", {"PT_NATIVE_BUILD": "0", "PT_SAH_DUP": "1.1"}),
    ("sahdeep", {"PT_SAH_DEEP": "0.5"}),
]


def _id(case):
    method, env = case
    return "-".join([method] + [f"{k}={v}" for k, v in env.items()])


def soup(n=260, seed=4, dup=False):
    """tests/test_knob_matrix.py's soup; dup: the first half shares one
    triangle (equal centroids)."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.7, 0.7, (n, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.7, 0.7, (n, 3)).astype(np.float32)
    if dup:
        for v in (v0, v1, v2):
            v[: n // 2] = v[0]
    return v0, v1, v2


def _builds(v, method, env, monkeypatch, **kw):
    for k, val in env.items():
        monkeypatch.setenv(k, val)
    ja = jcluster.build_clusters(*(jnp.asarray(x) for x in v), method=method,
                                 **kw)
    ta = tcluster.build_clusters(*v, method=method, **kw)
    return ja, ta


def _assert_bits(ja, ta):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)), err_msg=f)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_soup_builds_bit_exact(case, monkeypatch):
    """260 triangles, max_clusters=8, min_k=8: K = 64 for the fixed-size
    methods, 8 for the SAH ones (128 clusters after padding)."""
    ja, ta = _builds(soup(), *case, monkeypatch, max_clusters=8, min_k=8)
    _assert_bits(ja, ta)
    ids = torch.round(ta.blocks_t[:, 12, :]).long() - 1
    assert set(ids[ids >= 0].tolist()) == set(range(260))


@pytest.mark.parametrize("method", tcluster.METHODS)
def test_duplicate_centroid_builds_agree_as_sets(method, monkeypatch):
    """Half the soup on one centroid: per cluster the same id set, the
    boxes bit for bit."""
    ja, ta = _builds(soup(dup=True), method, {}, monkeypatch,
                     max_clusters=8, min_k=8)
    for f in ("aabb_lo", "aabb_hi"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)), err_msg=f)
    jids = np.rint(np.asarray(ja.blocks_t)[:, 12, :]).astype(np.int64) - 1
    tids = torch.round(ta.blocks_t[:, 12, :]).long().numpy() - 1
    assert jids.shape == tids.shape
    for c in range(jids.shape[0]):
        assert set(jids[c][jids[c] >= 0]) == set(tids[c][tids[c] >= 0])


@pytest.fixture(scope="module")
def proc_tris():
    """A textured procedural interior of ~6k triangles, as numpy."""
    s = tproc.sponza_like(6000, textured=True).finalize(device="cpu")
    v = s.tri_vertices(torch.arange(s.n_tris))
    return tuple(x.numpy() for x in v)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_procedural_builds_bit_exact(case, proc_tris, monkeypatch):
    """min_k=128 and max_clusters=2048 (build_scene_clusters' own)."""
    ja, ta = _builds(proc_tris, *case, monkeypatch, max_clusters=2048,
                     min_k=128)
    _assert_bits(ja, ta)
    assert ta.tris_per_cluster == 128


def test_build_rejects_unknown_method():
    with pytest.raises(ValueError, match="method 'foo'"):
        tcluster.build_clusters(*soup(), method="foo")


@pytest.fixture(scope="module")
def scenes():
    """The same procedural scene from each package (bit-exact tables)."""
    return (jproc.sponza_like(3000, textured=False).finalize(),
            tproc.sponza_like(3000, textured=False).finalize(device="cpu"))


def test_scene_clusters_split_matches_jax(scenes, monkeypatch):
    """PT_FINE_METHOD=median PT_COARSE_METHOD=morton: clusters (the
    occlusion accel) and clusters_fine (the closest accel) bit for bit
    the JAX package's, and two different accels."""
    monkeypatch.setenv("PT_FINE_METHOD", "median")
    monkeypatch.setenv("PT_COARSE_METHOD", "morton")
    js = jcluster.build_scene_clusters(scenes[0])
    ts = tcluster.build_scene_clusters(scenes[1])
    _assert_bits(js.clusters, ts.clusters)
    _assert_bits(js.clusters_fine, ts.clusters_fine)
    assert ts.clusters is not ts.clusters_fine
    assert ts.clusters.n_clusters != ts.clusters_fine.n_clusters
    moved = ts.to("cpu")
    _assert_bits(js.clusters_fine, moved.clusters_fine)


def test_scene_clusters_default_is_one_shared_build(scenes, monkeypatch):
    """No knob: one sahsplit accel in both fields, the JAX package's bit
    for bit; Scene.to keeps it shared; an unknown method raises."""
    monkeypatch.delenv("PT_FINE_METHOD", raising=False)
    monkeypatch.delenv("PT_COARSE_METHOD", raising=False)
    js = jcluster.build_scene_clusters(scenes[0])
    ts = tcluster.build_scene_clusters(scenes[1])
    assert ts.clusters is ts.clusters_fine
    _assert_bits(js.clusters, ts.clusters)
    moved = ts.to("cpu")
    assert moved.clusters is moved.clusters_fine
    monkeypatch.setenv("PT_FINE_METHOD", "medain")
    with pytest.raises(ValueError, match="PT_FINE_METHOD"):
        tcluster.build_scene_clusters(scenes[1])
