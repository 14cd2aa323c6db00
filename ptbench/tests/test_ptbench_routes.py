"""The accel build and the hit capture follow the configuration's
intersector. A throwaway configuration on each route (written, with its
cell and mix, under a root of its own, and on the brute route naming a
scene generator that exists only as a new module) runs end to end on
the CPU: it builds its accel inside the accel_build span, compares hits
above its lane floors and reads no disagreement. With the route's entry
points bypassed it compares none and fails; with an answer altered
where the route makes it, the share of bad hits fails."""

from __future__ import annotations

import importlib
import io
import json
import os
import sys
import types

import pytest

from ptbench import checks, run, scenes, spec
from ptbench.tests.conftest import last_json_line

SEED = 2**31 + 4099

BOX_GENERATOR = """
import numpy as np

from ptbench.scenes import procedural


def generate(lo=(-0.6, 0.3, -0.6), hi=(0.6, 1.5, 0.6)):
    '''A box of 12 triangles (outward winding) over a floor, under a
    ceiling light: 16 triangles.'''
    b = procedural.SceneSpec()
    grey = b.add_material(albedo=(0.7, 0.7, 0.7))
    body = b.add_material(albedo=(0.6, 0.3, 0.2))
    light = b.add_material(albedo=(1, 1, 1), emission=(8, 8, 8))
    v, i = procedural._quad([-4, 0, -4], [-4, 0, 4], [4, 0, 4], [4, 0, -4])
    b.add_mesh(v, i, grey)
    (x0, y0, z0), (x1, y1, z1) = lo, hi
    corners = np.array([[x0, y0, z0], [x1, y0, z0], [x1, y1, z0],
                        [x0, y1, z0], [x0, y0, z1], [x1, y0, z1],
                        [x1, y1, z1], [x0, y1, z1]], np.float32)
    faces = np.array([[0, 3, 2], [0, 2, 1], [4, 5, 6], [4, 6, 7],
                      [0, 4, 7], [0, 7, 3], [1, 2, 6], [1, 6, 5],
                      [0, 1, 5], [0, 5, 4], [3, 7, 6], [3, 6, 2]], np.int64)
    b.add_mesh(corners, faces, body)
    v, i = procedural._quad([-1, 3.5, -1], [1, 3.5, -1], [1, 3.5, 1],
                            [-1, 3.5, 1])
    b.add_mesh(v, i, light)
    return b
"""

# route: (generator, its args, intersector). The box's 16 triangles take
# the brute route under "cluster" too (render.make_intersectors: scenes
# of at most 256 triangles).
ROUTES = {
    "cluster": ("bunny_like", {"subdivisions": 2}, "cluster"),
    "bvh": ("bunny_like", {"subdivisions": 2}, "bvh"),
    "brute": ("box_on_floor", {}, "brute"),
    "small_cluster": ("box_on_floor", {}, "cluster"),
}


@pytest.fixture
def root(tmp_path, monkeypatch):
    """A checkout root holding BENCHMARK.json with one throwaway cell a
    route, their configuration and mix files, and the box generator as
    a new module."""
    gen_dir = tmp_path / "generators"
    gen_dir.mkdir()
    (gen_dir / "box_on_floor.py").write_text(BOX_GENERATOR)
    monkeypatch.setattr(scenes, "__path__",
                        list(scenes.__path__) + [str(gen_dir)])
    monkeypatch.delitem(sys.modules, "ptbench.scenes.box_on_floor",
                        raising=False)

    bench = spec.benchmark()
    base = spec.load_json(os.path.join(spec.ROOT, bench["configs"][0]["file"]))
    (tmp_path / "ptbench" / "configs").mkdir(parents=True)
    (tmp_path / "ptbench" / "traffic").mkdir()
    mix = dict(spec.load_json(os.path.join(
        spec.ROOT, "ptbench", "traffic", "accum_1024.json")),
        width=32, height=32, frame_batch=2, film_pixels=24, warmup_steps=1,
        trace_steps=1)
    (tmp_path / "ptbench" / "traffic" / "route_32.json").write_text(
        json.dumps(mix))
    for route, (gen, args, intersector) in ROUTES.items():
        name = f"route_{route}"
        cfg = dict(base, name=name, scene=dict(generator=gen, args=args),
                   camera=dict(position=[0.0, 2.0, 5.0],
                               target=[0.0, 1.2, 0.0]),
                   render=dict(base["render"], spp=1,
                               intersector=intersector))
        path = f"ptbench/configs/{name}.json"
        (tmp_path / path).write_text(json.dumps(cfg))
        bench["configs"].append(dict(bench["configs"][0], name=name,
                                     file=path))
        bench["workloads"].append({"name": f"route.{route}", "config": name,
                                   "traffic": "route_32", "chips": 1,
                                   "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(tmp_path)


def run_route(root, route, monkeypatch):
    """One run of the route's cell on the CPU -> (result line, Record)."""
    records = []

    class Spy(run.Record):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            records.append(self)

    monkeypatch.setattr(run, "Record", Spy)
    out = io.StringIO()
    assert run.run(spec.cell(f"route.{route}", root=root), SEED, 0.2, 0,
                   "cpu", out=out) is not None
    return last_json_line(out.getvalue()), records[0]


def count_calls(monkeypatch, mod, attr, calls):
    """Append `attr` to `calls` at each call of mod.attr."""
    real = getattr(mod, attr)

    def fn(*a, **kw):
        calls.append(attr)
        return real(*a, **kw)

    monkeypatch.setattr(mod, attr, fn)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_builds_its_accel_and_compares_its_hits(root, route,
                                                      monkeypatch):
    from pathtracer_torch.accel import cluster, lbvh

    builds, handed = [], []
    count_calls(monkeypatch, cluster, "build_scene_clusters", builds)
    count_calls(monkeypatch, lbvh, "build_scene_bvh", builds)
    make_renderer = run.make_renderer

    def spy(cell, scene, *a):
        handed.append(dict(cluster=scene.clusters is not None,
                           bvh=scene.bvh is not None))
        return make_renderer(cell, scene, *a)

    monkeypatch.setattr(run, "make_renderer", spy)
    line, rec = run_route(root, route, monkeypatch)
    checks_ = line["checks"]
    assert line["correct"] is True, checks_
    for kind in checks.LANE_KINDS:
        row = checks_[f"{kind}_lanes_per_step"]
        assert row["value"] >= row["limit"] > 0, (kind, row)
    for name in checks.LIMITS:
        assert checks_[name]["value"] == 0.0, (name, checks_[name])
    assert rec.spans["accel_build"] > 0.0
    # the build happens once, in build_scene's span: the Renderer is
    # handed the scene with its accel made and builds nothing
    intersector = ROUTES[route][2]
    want = {"cluster": ["build_scene_clusters"], "bvh": ["build_scene_bvh"],
            "brute": []}[intersector]
    assert builds == want
    assert handed == [dict(cluster=intersector == "cluster",
                           bvh=intersector == "bvh")]


@pytest.mark.parametrize("route", ["bvh", "brute", "small_cluster"])
def test_fault_route_entry_points_bypassed(root, route, monkeypatch):
    """The route reaching its intersector by another name than the
    module attributes HitCapture wraps: no hits are compared, and the
    lane floors make `correct` false."""
    from pathtracer_torch import render
    from pathtracer_torch.accel import bruteforce
    from pathtracer_torch.kernels import intersect, traverse

    if route == "bvh":
        monkeypatch.setattr(render, "traverse", types.SimpleNamespace(
            **vars(traverse)))
    else:
        monkeypatch.setattr(bruteforce, "isect", types.SimpleNamespace(
            **vars(intersect)))
    line, _ = run_route(root, route, monkeypatch)
    assert line["correct"] is False
    for kind in checks.LANE_KINDS:
        row = line["checks"][f"{kind}_lanes_per_step"]
        assert row["at_least"] and row["value"] == 0 < row["limit"]


@pytest.mark.parametrize("route", ["bvh", "brute"])
@pytest.mark.parametrize("kind", ["closest", "occluded"])
def test_fault_route_answer_altered(root, route, kind, monkeypatch):
    """A hit distance, or a shadow answer, altered where the route makes
    it: the captured lanes carry it, and its share fails."""
    from pathtracer_torch.kernels import intersect, traverse

    mod, attr = {("bvh", "closest"): (traverse, "intersect_bvh"),
                 ("bvh", "occluded"): (traverse, "occluded_bvh"),
                 ("brute", "closest"): (intersect, "intersect_brute"),
                 ("brute", "occluded"): (intersect, "occluded_brute")}[
                     (route, kind)]
    real = getattr(mod, attr)

    def fn(*a, **kw):
        out = real(*a, **kw)
        if kind == "closest":
            t = out.t.clone()
            t[::3] = t[::3] * 1.01
            return intersect.Hit(t=t, tri=out.tri, u=out.u, v=out.v)
        if isinstance(out, tuple):
            return (~out[0],) + tuple(out[1:])
        return ~out

    monkeypatch.setattr(mod, attr, fn)
    line, _ = run_route(root, route, monkeypatch)
    row = line["checks"][f"{kind}_bad_pct"]
    assert line["correct"] is False
    assert row["value"] > row["limit"]


def test_unknown_intersector_is_refused():
    with pytest.raises(ValueError, match="cluster, bvh or brute"):
        run.build_accel(None, "octree", "cpu")


def test_capture_wraps_every_routes_entry_points():
    """Inside the capture each entry point is the wrapper; after it, the
    program's own function again."""
    from ptbench import capture

    mods = {m: importlib.import_module(f"pathtracer_torch.kernels.{m}")
            for m in ("packet", "traverse", "intersect")}
    real = {(m, a): getattr(mods[m], a)
            for m, a, _, _ in capture.ENTRY_POINTS}
    assert len(real) == 6
    with capture.HitCapture(64, 1):
        for (m, a), fn in real.items():
            assert getattr(mods[m], a) is not fn
    for (m, a), fn in real.items():
        assert getattr(mods[m], a) is fn


@pytest.mark.parametrize("kind", ["scalar", "0-d", "per-ray"])
def test_captured_t_max_copies_nothing_from_the_host(kind, monkeypatch):
    """The captured t_max of the sampled lanes is the call's, whether
    the call passed a Python scalar, a 0-d or a per-ray tensor; a scalar
    is filled on the device, with no torch.as_tensor or torch.tensor (a
    blocking host-to-device copy on the card)."""
    import torch

    from ptbench import capture

    n = 300
    o, d = torch.rand(n, 3), torch.rand(n, 3)
    per_ray = torch.linspace(1.0, 2.0, n)
    t_max = {"scalar": 7.5, "0-d": torch.tensor(7.5),
             "per-ray": per_ray}[kind]
    want = per_ray if kind == "per-ray" else torch.full((n,), 7.5)
    cap = capture.HitCapture(64, 5)
    hit = types.SimpleNamespace(t=torch.rand(n), tri=torch.arange(n),
                                u=torch.rand(n), v=torch.rand(n))
    closest = cap._closest(lambda *a: hit, (1, 2, 3, 4))
    occluded = cap._occluded(lambda *a: torch.zeros(n, dtype=torch.bool),
                             (1, 2, 3))

    def refuse(*a, **kw):
        raise AssertionError("a tensor made from host data")

    monkeypatch.setattr(torch, "as_tensor", refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    cap.on = True
    closest(None, o, d, 1e-3, t_max)
    occluded(None, o, d, t_max)
    monkeypatch.undo()
    got = cap.gathered()
    for k in ("closest", "occluded"):
        lanes = [int(torch.nonzero((o == row).all(1))[0])
                 for row in got[k]["o"]]
        assert len(lanes) == 64
        assert torch.equal(got[k]["t_max"], want[lanes])
