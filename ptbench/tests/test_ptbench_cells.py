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


def run_tiny(name, trace=0, seconds=0.2, device="cpu", **traffic):
    out = io.StringIO()
    res = run.run(tiny_cell(name, **traffic), SEED, seconds, trace, device,
                  out=out)
    assert res is not None
    return last_json_line(out.getvalue())


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_agrees_with_the_reference(name, capsys):
    line = run_tiny(name)
    # the keys of an untraced line, in their order, as before tracing
    # was read: nothing of the traced passes reaches it
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert list(line["device"]) == ["platform", "kind", "count",
                                    "memory_peak_bytes"]
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
    err = capsys.readouterr().err.strip().splitlines()
    tail = err[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)


@pytest.mark.parametrize("name", CELLS)
def test_traced_line_carries_per_layer_metrics(name):
    """Every per-layer metric that the program's spans and counters give
    is in a traced CPU run's line (the kernel loads, the window's host
    busy time and syncs among them); those read from the device trace
    are left out, since a CPU run has no device op to read."""
    line = run_tiny(name, trace=1)
    m = line["metrics"]
    wanted = tiny_cell(name).per_layer
    assert set(m) == {w["name"] for w in wanted
                      if w["source"] != "device_trace"}
    assert {"scene_build_s", "accel_build_s", "kernel_load_s"} <= set(m)
    syncs = next(k for k in m if k.startswith("host_syncs_per_frame"))
    busy = next(k for k in m if k.startswith("host_busy_ms_per_frame"))
    assert m[syncs]["value"] > 0 and m[busy]["value"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(line["device"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_traced_line_on_the_card_reads_every_per_layer_metric(
        name, cuda_device):
    """On the card every per-layer metric of the cell gives a number:
    the kinds, idle and the program's stages from the profiled pass
    (tracing on), K2's replay."""
    line = run_tiny(name, trace=1, device=cuda_device)
    assert line["correct"] is True, line["checks"]
    m = line["metrics"]
    assert set(m) == {w["name"] for w in tiny_cell(name).per_layer}
    for k in m:
        if k.split(".")[0] in ("integrator_ms_per_frame",
                               "packet_ms_per_frame", "host_syncs_per_frame",
                               "host_busy_ms_per_frame"):
            assert m[k]["value"] > 0, k
    assert all(n.startswith(("pt.", "(none)"))
               for n, _ in line["breakdown"]["idle_gaps"])


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
