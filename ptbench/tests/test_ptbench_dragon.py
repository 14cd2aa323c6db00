"""The envmap_dragon configuration and its cell: the configuration states
the triangles its generator gives, the cell loads by name with its mix
(accum_1024 with its own floor of shadow lanes) and its two
per-layer metrics, whose readers give nothing where the program has no
such span, and a traced run on the CPU reads the span that needs no
device trace."""

from __future__ import annotations

import copy
import io

import pytest

from ptbench import run, scenes, spec
from ptbench.tests.conftest import last_json_line

CELL = "envmap_dragon.accum_1024_dragon"
SEED = 2**33 + 5
METRICS = ("schedule_sort_ms_per_frame", "k2_resumed_pct")


def test_config_states_the_triangles_its_generator_gives():
    cfg = spec.cell(CELL).config
    sc = cfg["scene"]
    built = scenes.generate(sc["generator"], sc["args"])
    assert sc["args"]["triangles"] == 871_414
    assert len(built.meshes[1]["indices"]) == 871_414
    assert built.n_tris == cfg["triangles"] == 871_418
    assert cfg["reduced"] == []


def test_cell_loads_by_name():
    c = spec.cell(CELL)
    assert (c.config_name, c.traffic_name, c.chips) == (
        "envmap_dragon", "accum_1024_dragon", 1)
    # accum_1024 but for the shadow lanes' floor, a quarter of the lowest
    # of a dozen seeds' readings (55.42)
    env = spec.cell("envmap.accum_1024").traffic
    assert c.traffic == dict(env, min_lanes_per_step=dict(
        env["min_lanes_per_step"], occluded=13))
    assert c.config["render"] == spec.cell("envmap.accum_1024").config[
        "render"]
    assert {m["name"] for m in c.end_to_end} == {"frame_ms.envmap",
                                                 "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in c.per_layer} == set(METRICS)
    others = {m["name"] for m in spec.cell("envmap.accum_1024").per_layer}
    for name in METRICS:
        assert name not in others and callable(spec.reader(name))


def profile(by_span, frames=16):
    return dict(device_s=1.0, busy_s=1.0, frames=frames, by_span=by_span)


@pytest.mark.parametrize("name", METRICS)
def test_readers_give_nothing_without_the_spans(name):
    read = spec.reader(name)
    assert read(run.Record()) is None
    assert read(run.Record(profile=profile({}))) is None
    other = {"pt.chunk": dict(device_s=0.5, self_device_s=0.1, idle_s=0.0,
                              attrs=[{}])}
    assert read(run.Record(profile=profile(other))) is None


def test_readers_read_the_spans():
    by_span = {
        "pt.schedule": dict(device_s=0.032, self_device_s=0.032,
                            idle_s=0.0, attrs=[{"tiles": 2048,
                                                "clusters": 9984}]),
        "pt.sweep.closest": dict(device_s=0.2, self_device_s=0.2,
                                 idle_s=0.0, attrs=[
                                     {"tiles": 2048, "columns": 48,
                                      "resumed": 512},
                                     {"tiles": 2048, "columns": 48,
                                      "resumed": 0}])}
    rec = run.Record(profile=profile(by_span, frames=16))
    assert spec.reader("schedule_sort_ms_per_frame")(rec) == \
        pytest.approx(2.0)
    assert spec.reader("k2_resumed_pct")(rec) == pytest.approx(12.5)


def test_traced_cpu_run_reads_the_resumed_share():
    """At 32x32 on a 3,000-triangle mesh the run is correct, and its
    traced line carries k2_resumed_pct (span attributes) but not the
    schedule sort's device time (no device op on the CPU)."""
    c = copy.deepcopy(spec.cell(CELL))
    c.config["scene"]["args"] = dict(triangles=3_000, tex_size=32,
                                     env_h=32, env_w=64)
    c.traffic.update(width=32, height=32, frame_batch=2, film_pixels=24,
                     warmup_steps=1, trace_steps=1)
    out = io.StringIO()
    assert run.run(c, SEED, 0.0, 1, "cpu", out=out) is not None
    line = last_json_line(out.getvalue())
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"k2_resumed_pct"}
    assert 0.0 <= line["metrics"]["k2_resumed_pct"]["value"] <= 100.0
