"""Every PT_* knob of the JAX package, and knob combinations, in the port.

Coverage: the JAX package's source is read as text (no import) for every
PT_[A-Z_]+ name; each must be in pathtracer_torch.knobs.KNOBS as
honoured (and read by a module of the port), refused (make_intersectors
raises a ValueError naming it when it is set off its JAX default) or
equal (accepted at every value: PT_PERMUTE). A knob added to the JAX
package fails this test until the port decides what to do with it.

Combinations: the port's counterpart of tests/test_knob_matrix.py's
COMBOS, hit-exact against the brute-force oracle (which rays hit, the
triangle and t within rtol 1e-5; occlusion exactly). The JAX combos
set PT_SWEEP_CPI, which the port refuses: those combos drop it and say
so in their id, and the refusal has a case of its own; so do the key
schemes, fetch groups, frustum cull, packed schedule and sort scope
that the port retired. `backend` is the JAX package's choice of sweep
(Pallas or XLA); the port has one. Each honoured traversal knob also
meets the oracle alone, per call kind.

    python -m pytest tests/test_torch_knob_matrix.py -q -p no:randomly
"""

import glob
import os
import re

import numpy as np
import pytest
import torch

from pathtracer.kernels.intersect import intersect_brute
from pathtracer_torch import knobs
from pathtracer_torch.accel.cluster import build_clusters
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.kernels import cull, packet
from pathtracer_torch.render import make_intersectors
from tests.test_knob_matrix import _brute_all, _rays, _scene
from tests.test_torch_sharding_gloo import box_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX matrix's combos: (method, env, intersect kwargs, refused knobs
# the port drops); kwargs without `backend`. The retired key schemes,
# fetch groups, frustum cull, packed schedule and sort scope are refused
# by make_intersectors (test_refused_knob_raises_naming_it): the combos
# hold what is left of each, and combos 1 and 4, which would shrink to a
# build alone, take other traversal knobs
COMBOS = [
    ("sahsplit", {"PT_CLOSEST_DB": "1", "PT_OCCL_DB": "1"},
     dict(chunk_rays=128), ("PT_SWEEP_CPI",)),
    ("sahleaf", {"PT_DIR_BITS": "3"}, dict(dir_bits=3), ("PT_SWEEP_CPI",)),
    ("median", {}, dict(chunk_rays=64), ()),
    ("morton", {"PT_TILE_RAYS": "128", "PT_CHUNK_TILES": "1"}, {},
     ("PT_SWEEP_CPI",)),
    ("sahsplit", {"PT_NATIVE_BUILD": "0", "PT_SAH_DUP": "3.0"},
     dict(tile_rays=32), ()),
    # the port's own: knobs the JAX matrix reaches only through kwargs
    ("sah", {"PT_TILE_RAYS": "32", "PT_CHUNK_TILES": "2",
             "PT_CLOSEST_DB": "2", "PT_OCCL_DB": "3"}, {}, ()),
    ("sahdeep", {"PT_SAH_DEEP": "0.6", "PT_PERMUTE": "gather",
                 "PT_CULL_SKIP": "1", "PT_CULL_BLK": "64"}, {}, ()),
]


def _combo_id(combo):
    method, env, kw, dropped = combo
    parts = [method] + [f"{k}={v}" for k, v in env.items()] + [
        f"{k}={v}" for k, v in kw.items()]
    return "-".join(parts + [f"dropped-{k}" for k in dropped])


def _oracle_case(method="morton"):
    """The combos' scene and rays: (accel, torch o, d, JAX v0-v2, o, d)."""
    v0, v1, v2 = _scene()
    o, d = _rays()
    accel = build_clusters(*(np.array(x) for x in (v0, v1, v2)), 8,
                           min_k=8, method=method)
    to, td = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))
    return accel, to, td, (v0, v1, v2, o, d)


def _check_closest(accel, to, td, jax_args, **kw):
    """Closest hits against the brute-force oracle: which rays hit, the
    triangle, t within rtol 1e-5."""
    v0, v1, v2, o, d = jax_args
    ref = intersect_brute(o, d, v0, v1, v2, 1e-3, 1e20)
    hit = packet.intersect_clusters(accel, to, td, 1e-3, 1e20, **kw)
    rtri = np.asarray(ref.tri)
    np.testing.assert_array_equal(hit.tri.numpy() >= 0, rtri >= 0)
    m = rtri >= 0
    np.testing.assert_array_equal(hit.tri.numpy()[m], rtri[m])
    np.testing.assert_allclose(hit.t.numpy()[m], np.asarray(ref.t)[m],
                               rtol=1e-5)


def _check_occluded(accel, to, td, jax_args, **kw):
    """Occlusion below t_max 6 against the brute any-front-hit, exactly."""
    v0, v1, v2, o, d = jax_args
    t_max = torch.full((o.shape[0],), 6.0)
    blocked = packet.occluded_clusters(accel, to, td, t_max, **kw)
    gn = np.cross(np.asarray(v1 - v0), np.asarray(v2 - v0))
    front = (np.asarray(d) @ gn.T) < 0.0
    tb, _, _, okb = _brute_all(o, d, v0, v1, v2)
    ref_blocked = (okb & front & (tb > 0.0) & (tb < 6.0)).any(axis=1)
    np.testing.assert_array_equal(blocked.numpy(), ref_blocked)


@pytest.mark.parametrize("combo", COMBOS, ids=_combo_id)
def test_knob_combo_exactness(combo, monkeypatch):
    method, env, kw, _ = combo
    assert env or kw, "a combo must leave the plain default"
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    case = _oracle_case(method)
    _check_closest(*case, **kw)
    _check_occluded(*case, **kw)


# each remaining traversal knob off its default, alone: (env, call kinds)
ALONE = ([({"PT_TILE_RAYS": str(r)}, ("closest", "occluded"))
          for r in (32, 128, 256)]
         + [({"PT_CHUNK_TILES": "1"}, ("closest", "occluded"))]
         + [({"PT_CLOSEST_DB": str(b)}, ("closest",)) for b in (1, 2)]
         + [({"PT_OCCL_DB": str(b)}, ("occluded",)) for b in (1, 3)]
         + [({"PT_CULL_SKIP": "1", "PT_CULL_BLK": "64",
              "PT_TILE_RAYS": str(r)}, ("closest", "occluded"))
            for r in (32, 64, 128, 256)])


@pytest.mark.parametrize("env,kind", [
    pytest.param(env, kind, id="-".join(
        [f"{k}={v}" for k, v in env.items()] + [kind]))
    for env, kinds in ALONE for kind in kinds])
def test_honoured_knob_alone_matches_the_oracle(env, kind, monkeypatch):
    """One honoured traversal knob set off its default (K4 with its block
    width and a tile width), one call kind, hit-exact against the
    brute-force oracle. Under PT_CULL_SKIP=1 the scene's clusters pad to
    128 lanes, two blocks of 64, so K4 runs (its calls are counted)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    accel, to, td, jax_args = _oracle_case()
    skip_calls = []
    if "PT_CULL_SKIP" in env:
        assert cull.gated(accel.aabb_lo.shape[0], int(env["PT_CULL_BLK"]))
        real = cull.tile_cull_skip

        def counted(*a, **kw):
            skip_calls.append(kw["tile_rays"])
            return real(*a, **kw)
        monkeypatch.setattr(cull, "tile_cull_skip", counted)
    check = _check_closest if kind == "closest" else _check_occluded
    check(accel, to, td, jax_args)
    if "PT_CULL_SKIP" in env:
        assert skip_calls and set(skip_calls) == {int(env["PT_TILE_RAYS"])}


def _jax_knobs():
    """Every PT_* name in pathtracer/**/*.py, read as text."""
    names = set()
    for path in glob.glob(os.path.join(REPO, "pathtracer", "**", "*.py"),
                          recursive=True):
        with open(path, encoding="utf-8") as f:
            names.update(re.findall(r"PT_[A-Z_]+", f.read()))
    return names


def _port_source():
    text = []
    for path in glob.glob(os.path.join(REPO, "pathtracer_torch", "**",
                                       "*.py"), recursive=True):
        if os.path.basename(path) != "knobs.py":
            with open(path, encoding="utf-8") as f:
                text.append(f.read())
    return "\n".join(text)


# a value off the JAX default for each refused knob
REFUSED_VALUES = {"PT_SWEEP_SLOTS": "2", "PT_SWEEP_DEADGATE": "1",
                  "PT_SWEEP_GATE": "0", "PT_SWEEP_CPI": "8",
                  "PT_CULL_BACKEND": "xla", "PT_KEY_SCHEME": "mixed",
                  "PT_KEY_SCHEME_OCCL": "mixed", "PT_SCHED_PACK": "1",
                  "PT_SORT_SCOPE": "chunk", "PT_FETCH_GROUP": "2",
                  "PT_GROUP_PRIMARY": "2", "PT_GROUP_BOUNCE": "2",
                  "PT_GROUP_OCCL": "2"}
# the JAX defaults (and values the JAX package reads as them): accepted
DEFAULT_VALUES = {"PT_SWEEP_SLOTS": "4", "PT_SWEEP_DEADGATE": "0",
                  "PT_SWEEP_GATE": "1", "PT_CULL_BACKEND": "pallas",
                  "PT_KEY_SCHEME": "dirmajor",
                  "PT_KEY_SCHEME_OCCL": "dirmajor", "PT_SCHED_PACK": "0",
                  "PT_SORT_SCOPE": "global", "PT_FETCH_GROUP": "1",
                  "PT_GROUP_PRIMARY": "1", "PT_GROUP_BOUNCE": "1",
                  "PT_GROUP_OCCL": "1"}
# (knob, value) cases of the refusal; the TPU knobs' ids are their names
REFUSED_CASES = [pytest.param(name, REFUSED_VALUES[name], id=name)
                 for name in ("PT_CULL_BACKEND", "PT_SWEEP_CPI",
                              "PT_SWEEP_DEADGATE", "PT_SWEEP_GATE",
                              "PT_SWEEP_SLOTS")] + [
    pytest.param(name, value, id=f"{name}={value}")
    for name, value in [("PT_KEY_SCHEME", "mixed"),
                        ("PT_KEY_SCHEME", "firstcluster"),
                        ("PT_KEY_SCHEME_OCCL", "mixed"),
                        ("PT_KEY_SCHEME_OCCL", "firstcluster"),
                        ("PT_SCHED_PACK", "1"), ("PT_SORT_SCOPE", "chunk"),
                        ("PT_FETCH_GROUP", "2"), ("PT_GROUP_PRIMARY", "2"),
                        ("PT_GROUP_BOUNCE", "2"), ("PT_GROUP_OCCL", "2")]]


def test_every_jax_knob_is_covered():
    names = _jax_knobs()
    assert len(names) >= 30, sorted(names)
    missing = sorted(names - set(knobs.KNOBS))
    assert not missing, f"knobs the port neither honours nor refuses: " \
        f"{missing}"
    source = _port_source()
    for name in names:
        state, _ = knobs.KNOBS[name]
        if state == knobs.HONOURED:
            assert f'"{name}"' in source, f"{name} is honoured but no " \
                "module of the port reads it"
        elif state == knobs.REFUSED:
            with pytest.raises(ValueError, match=name):
                knobs.check_refused({name: REFUSED_VALUES[name]})
    assert set(REFUSED_VALUES) == {n for n, (s, _) in knobs.KNOBS.items()
                                   if s == knobs.REFUSED}
    knobs.check_refused(DEFAULT_VALUES)


@pytest.fixture(scope="module")
def cluster_scene():
    return box_scene()


@pytest.mark.parametrize("name,value", REFUSED_CASES)
def test_refused_knob_raises_naming_it(name, value, cluster_scene,
                                       monkeypatch):
    """make_intersectors refuses the knob off its default, never ignores
    it, giving the knob's own reason, and takes its JAX default."""
    monkeypatch.setenv(name, value)
    why = knobs.KNOBS[name][1]
    with pytest.raises(ValueError, match=re.escape(
            f"{name}={value!r} is refused by pathtracer_torch: {why}")):
        make_intersectors(cluster_scene, RenderConfig())
    if name in DEFAULT_VALUES:
        monkeypatch.setenv(name, DEFAULT_VALUES[name])
        make_intersectors(cluster_scene, RenderConfig())


@pytest.mark.parametrize("env,match", [
    ({"PT_TILE_RAYS": "96"}, "PT_TILE_RAYS=96"),
    ({"PT_CHUNK_TILES": "0"}, "PT_CHUNK_TILES"),
])
def test_honoured_knob_bad_values_raise(env, match, monkeypatch):
    """A value the JAX package would silently read as another one
    raises, naming the knob, in a closest and an occlusion call."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    v0, v1, v2 = (np.array(x) for x in _scene())
    accel = build_clusters(v0, v1, v2, 8, min_k=8, method="morton")
    o, d = (torch.from_numpy(np.array(x)) for x in _rays(n=640))
    with pytest.raises(ValueError, match=match):
        packet.occluded_clusters(accel, o, d, torch.full((640,), 6.0))
    with pytest.raises(ValueError, match=match):
        packet.intersect_clusters(accel, o, d, 1e-3, 1e20)


@pytest.mark.parametrize("knob", ["PT_BOUNCE_ACCEL", "PT_OCCL_ACCEL"])
def test_accel_knobs_route_calls(knob, monkeypatch):
    """With a median/morton split, PT_BOUNCE_ACCEL=morton sends bounce
    closest calls to the coarse accel and PT_OCCL_ACCEL=fine occlusion
    calls to the fine one (the accel each call traverses is recorded)."""
    monkeypatch.setenv("PT_FINE_METHOD", "median")
    monkeypatch.setenv("PT_COARSE_METHOD", "morton")
    scene = box_scene()
    seen = []

    def spy(name):
        real = getattr(packet, name)

        def call(accel, *a, **kw):
            seen.append((name, accel))
            return real(accel, *a, **kw)
        return call

    monkeypatch.setattr(packet, "intersect_clusters",
                        spy("intersect_clusters"))
    monkeypatch.setattr(packet, "occluded_clusters",
                        spy("occluded_clusters"))
    o, d = (torch.from_numpy(np.array(x)) for x in _rays(n=64))

    def route():
        seen.clear()
        fi, fo, _ = make_intersectors(scene, RenderConfig())
        fi(o, d, 1e-3, 1e20, primary=True)
        fi(o, d, 1e-3, 1e20)
        fo(o, d, 1.0)
        return [id(a) for _, a in seen]

    fine, coarse = id(scene.clusters_fine), id(scene.clusters)
    assert fine != coarse
    assert route() == [fine, fine, coarse]
    monkeypatch.setenv(knob, "morton" if knob == "PT_BOUNCE_ACCEL"
                       else "fine")
    assert route() == ([fine, coarse, coarse] if knob == "PT_BOUNCE_ACCEL"
                       else [fine, fine, fine])
    monkeypatch.setenv(knob, "sometimes")
    with pytest.raises(ValueError, match=knob):
        route()
