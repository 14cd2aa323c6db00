"""pathtracer_torch scene tables and cluster accel vs the JAX package.

The port's builders re-home the JAX package's numpy generators, so the
tables must come out identical: integer/u8 fields exact, f32 fields
exact (the same numpy expressions), and the sahsplit accel (leaf order,
ids, boxes, Baldwin-Weber rows) exact.
"""

import numpy as np
import pytest
import torch

from pathtracer.accel.cluster import build_scene_clusters as jbuild
from pathtracer.scene import procedural as jproc
from pathtracer.utils import native as jnative
from pathtracer_torch.accel.cluster import accel_from_numpy
from pathtracer_torch.accel.cluster import build_scene_clusters as tbuild
from pathtracer_torch.scene import procedural as tproc
from pathtracer_torch.scene.types import (META_FIELDS, OPTIONAL_FIELDS,
                                          TENSOR_FIELDS, scene_from_numpy)
from pathtracer_torch.utils import native as tnative

SCENES = {
    "cornell": (jproc.cornell_box, tproc.cornell_box),
    "materials": (lambda: jproc.cornell_box(materials_suite=True),
                  lambda: tproc.cornell_box(materials_suite=True)),
    "sponza_textured": (lambda: jproc.sponza_like(4000, textured=True),
                        lambda: tproc.sponza_like(4000, textured=True)),
}
_cache = {}


def _pair(name):
    if name not in _cache:
        jf, tf = SCENES[name]
        _cache[name] = (jbuild(jf().finalize()),
                        tbuild(tf().finalize(device="cpu")))
    return _cache[name]


def _np(a):
    a = np.asarray(a)
    return a.astype(np.int64) if a.dtype == np.uint32 else a


@pytest.mark.parametrize("name", list(SCENES))
def test_finalize_matches_jax_field_by_field(name):
    js, ts = _pair(name)
    for f in TENSOR_FIELDS + OPTIONAL_FIELDS:
        a, b = getattr(js, f), getattr(ts, f)
        if a is None:
            assert b is None, f
            continue
        a, b = _np(a), b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    for f in META_FIELDS:
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.n_tris == js.n_tris
    if name == "sponza_textured":
        assert ts.has_textures and ts.tex_comp is not None


@pytest.mark.parametrize("name", list(SCENES))
def test_sahsplit_accel_matches_jax(name):
    js, ts = _pair(name)
    ja, ta = js.clusters, ts.clusters
    assert ta.n_clusters == ja.n_clusters and ta.n_clusters % 128 == 0
    for f in ("aabb_lo", "aabb_hi"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)), err_msg=f)
    jb, tb = np.asarray(ja.blocks_t), ta.blocks_t.numpy()
    # id row (leaf order + ids) exact; Baldwin-Weber rows exact too: the
    # port reproduces XLA's contraction of the cross products
    np.testing.assert_array_equal(tb[:, 12], jb[:, 12])
    np.testing.assert_array_equal(tb, jb)


@pytest.mark.parametrize("name", list(SCENES))
def test_accel_bw_rows_by_triangle(name):
    """bw_rows holds each triangle's Baldwin-Weber rows of blocks_t, the
    same on a built accel and on one carried from the JAX package."""
    js, ts = _pair(name)
    rows = ts.clusters.bw_rows
    assert rows.shape == (ts.n_tris, 12)
    slots = ts.clusters.blocks_t.transpose(1, 2).reshape(-1, 16)
    real = slots[:, 12] > 0.5
    ids = torch.round(slots[real, 12]).long() - 1
    assert torch.equal(rows[ids], slots[real, :12])
    carried = accel_from_numpy(*(np.asarray(getattr(js.clusters, f)) for f in
                                 ("aabb_lo", "aabb_hi", "blocks_t")),
                               device="cpu")
    assert torch.equal(carried.bw_rows, rows)


@pytest.mark.parametrize("name", list(SCENES))
def test_accel_lane_tables(name):
    """n_lanes is 1 + the last lane whose id row is > 0 (0 for a pad
    cluster) and blocks_lm is blocks_t lane-major, on a built accel and
    on one carried from the JAX package; `to` carries both."""
    js, ts = _pair(name)
    carried = accel_from_numpy(*(np.asarray(getattr(js.clusters, f)) for f in
                                 ("aabb_lo", "aabb_hi", "blocks_t")),
                               device="cpu")
    for acc in (ts.clusters, carried, ts.clusters.to("cpu")):
        bt = acc.blocks_t.numpy()
        want = np.array([1 + np.flatnonzero(ids > 0).max() if (ids > 0).any()
                         else 0 for ids in bt[:, 12, :]], np.int32)
        assert acc.n_lanes.dtype == torch.int32
        np.testing.assert_array_equal(acc.n_lanes.numpy(), want)
        assert acc.blocks_lm.is_contiguous()
        np.testing.assert_array_equal(acc.blocks_lm.numpy(),
                                      bt.transpose(0, 2, 1))
        assert (want == 0).any() and (want > 0).any()
    assert torch.equal(carried.n_lanes, ts.clusters.n_lanes)


def test_scene_and_accel_from_numpy_roundtrip():
    js, ts = _pair("materials")
    fields = {k: (None if getattr(js, k) is None else np.asarray(
        getattr(js, k))) for k in TENSOR_FIELDS + OPTIONAL_FIELDS}
    fields.update({k: getattr(js, k) for k in META_FIELDS})
    carried = scene_from_numpy(fields, device="cpu")
    for f in TENSOR_FIELDS:
        assert torch.equal(getattr(carried, f), getattr(ts, f)), f
    acc = accel_from_numpy(*(np.asarray(getattr(js.clusters, f)) for f in
                             ("aabb_lo", "aabb_hi", "blocks_t")),
                           device="cpu")
    assert torch.equal(acc.blocks_t, ts.clusters.blocks_t)
    moved = carried.with_clusters(acc).to("cpu")
    assert moved.clusters.n_clusters == acc.n_clusters


def test_native_sah_build_matches_jax_binding():
    js, _ = _pair("materials")
    v = [np.asarray(x) for x in js.tri_vertices(np.arange(js.n_tris))]
    jl, jlo, jhi = jnative.sah_split_build(*v, 128)
    tl, tlo, thi = tnative.sah_split_build(*v, 128)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jlo, tlo)
    np.testing.assert_array_equal(jhi, thi)


def test_native_png_encode_roundtrip():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (17, 23, 3), dtype=np.uint8)
    data = tnative.png_encode(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(jnative.png_decode(data), img)
    with pytest.raises(ValueError):
        tnative.png_encode(np.zeros((4, 4, 2), np.uint8))


def test_sponza_tri_count_class():
    s = tproc.sponza_like(target_tris=50_000).finalize(device="cpu")
    assert 40_000 < s.n_tris < 70_000
