"""Each cell's driver end to end at a tiny size on the CPU: the run
prints the contract's last line, the reference agrees with the program,
and planted faults of the timed path make `correct` false."""

from __future__ import annotations

import io

import pytest
import torch

from ptbench import checks, run
from ptbench.tests.conftest import last_json_line, tiny_cell

CELLS = ["sponza.accum_1080p", "envmap.accum_1024"]
SEED = 2**31 + 77


def run_tiny(name, trace=0, seconds=0.2, **traffic):
    out = io.StringIO()
    res = run.run(tiny_cell(name, **traffic), SEED, seconds, trace, "cpu",
                  out=out)
    assert res is not None
    return last_json_line(out.getvalue())


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_agrees_with_the_reference(name, capsys):
    line = run_tiny(name)
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["checks"]) == set(checks.limits(
        tiny_cell(name).traffic))
    for row in line["checks"].values():
        assert set(row) == {"value", "limit", "at_least"}
    assert set(line["metrics"]) == {m["name"] for m in tiny_cell(
        name).end_to_end}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    err = capsys.readouterr().err.strip().splitlines()
    tail = err[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)


def test_traced_line_carries_per_layer_metrics():
    line = run_tiny("sponza.accum_1080p", trace=1)
    m = line["metrics"]
    assert {"scene_build_s", "accel_build_s", "rays_per_frame"} <= set(m)
    assert "frame_ms" not in m
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(line["device"])


def test_fault_state_unchanged(monkeypatch):
    """A step that returns its state unchanged."""
    from pathtracer_torch.render import Renderer

    real = Renderer.step
    calls = {"n": 0}

    def step(self):
        calls["n"] += 1
        if calls["n"] > 1:          # after the warm-up step
            self.film = type(self.film)(accum=self.film.accum,
                                        frame=self.film.frame + 1)
            return self.film
        return real(self)

    monkeypatch.setattr(Renderer, "step", step)
    assert run_tiny("envmap.accum_1024")["correct"] is False


def test_fault_half_the_batch(monkeypatch):
    """Half of each wavefront left out, the mean taken over the rest."""
    from pathtracer_torch.integrator import path as path_mod

    real = path_mod.trace_paths

    def trace_paths(*a, **kw):
        out = list(real(*a, **kw))
        rad = out[0]
        h = rad.shape[0] // 2
        out[0] = torch.cat([rad[:h], rad[:h].mean(0, keepdim=True)
                            .expand(rad.shape[0] - h, 3)])
        return tuple(out)

    monkeypatch.setattr(path_mod, "trace_paths", trace_paths)
    assert run_tiny("envmap.accum_1024")["correct"] is False


@pytest.mark.parametrize("kind", ["closest", "occluded"])
def test_fault_answer_altered(monkeypatch, kind):
    """A hit distance, or a shadow answer, altered where it is made."""
    from pathtracer_torch.kernels import intersect, packet

    if kind == "closest":
        real = packet.intersect_clusters

        def fn(*a, **kw):
            hit = real(*a, **kw)
            t = hit.t.clone()
            t[::7] = t[::7] * 1.01
            return intersect.Hit(t=t, tri=hit.tri, u=hit.u, v=hit.v)

        monkeypatch.setattr(packet, "intersect_clusters", fn)
    else:
        real = packet.occluded_clusters

        def fn(*a, **kw):
            out = real(*a, **kw)
            if isinstance(out, tuple):
                return (out[0] ^ True,) + tuple(out[1:])
            return ~out

        monkeypatch.setattr(packet, "occluded_clusters", fn)
    line = run_tiny("sponza.accum_1080p")
    assert line["correct"] is False
    assert line["checks"][f"{kind}_bad_pct"]["value"] > \
        line["checks"][f"{kind}_bad_pct"]["limit"]


def test_fault_hit_entry_points_bypassed(monkeypatch):
    """The timed path reaching the packet layer by another name than the
    module attributes HitCapture wraps: no hits are compared, and the
    lane floor makes `correct` false."""
    import types

    from pathtracer_torch import render
    from pathtracer_torch.kernels import packet

    monkeypatch.setattr(render, "packet", types.SimpleNamespace(
        **vars(packet)))
    line = run_tiny("sponza.accum_1080p")
    assert line["correct"] is False
    for kind in checks.LANE_KINDS:
        row = line["checks"][f"{kind}_lanes_per_step"]
        assert row["at_least"] and row["value"] == 0 < row["limit"]
