"""Cells, configurations, traffic mixes and metrics are found by name."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

from ptbench import drivers, spec

BENCH = spec.benchmark()


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_its_files(name):
    c = spec.cell(name)
    assert c.config["name"] == c.config_name
    mod = drivers.module(c.traffic["driver"])
    assert callable(mod.Driver) and callable(mod.reference) \
        and callable(mod.errors)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(metric))


def test_a_scoped_metric_is_read_by_its_base_reader():
    assert spec.reader("rays_per_frame.envmap") is \
        spec.reader("rays_per_frame")
    with pytest.raises(ModuleNotFoundError):
        spec.reader("no_such_metric.envmap")


def test_config_files_hold_every_render_field():
    import dataclasses

    from pathtracer_torch.config import RenderConfig

    fields = {f.name for f in dataclasses.fields(RenderConfig)}
    for c in BENCH["configs"]:
        cfg = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        assert set(cfg["render"]) == fields - {"width", "height",
                                               "frame_batch", "seed"}
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg["reduced"]) <= set(cfg)


def test_new_config_and_mix_are_found_from_new_files(tmp_path):
    """A later cell is new files plus new BENCHMARK.json entries."""
    root = tmp_path
    shutil.copytree(os.path.join(spec.ROOT, "ptbench", "traffic"),
                    root / "ptbench" / "traffic")
    (root / "ptbench" / "configs").mkdir()
    base = spec.load_json(os.path.join(spec.ROOT, BENCH["configs"][1]["file"]))
    new_cfg = dict(base, name="bunny_env_small")
    (root / "ptbench" / "configs" / "bunny_env_small.json").write_text(
        json.dumps(new_cfg))
    mix = dict(spec.load_json(os.path.join(
        spec.ROOT, "ptbench", "traffic", "accum_1024.json")), width=512,
        height=512)
    (root / "ptbench" / "traffic" / "accum_512.json").write_text(
        json.dumps(mix))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(BENCH["configs"][1], name="bunny_env_small",
                                 file="ptbench/configs/bunny_env_small.json"))
    bench["workloads"].append({"name": "bunny.accum_512",
                               "config": "bunny_env_small",
                               "traffic": "accum_512", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell("bunny.accum_512", root=str(root))
    assert c.config["name"] == "bunny_env_small"
    assert c.traffic["width"] == 512
    # a new cell reports every end-to-end metric without a workloads key
    assert {m["name"] for m in c.end_to_end} == {
        m["name"] for m in BENCH["end_to_end"] if "workloads" not in m}


def test_metric_scoping_by_workloads(tmp_path):
    """A metric with a workloads key is read only in the cells it lists."""
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append(dict(bench["per_layer"][0], name="only_env",
                                   workloads=["envmap.accum_1024"]))
    (tmp_path / "ptbench").mkdir()
    shutil.copytree(os.path.join(spec.ROOT, "ptbench", "traffic"),
                    tmp_path / "ptbench" / "traffic")
    shutil.copytree(os.path.join(spec.ROOT, "ptbench", "configs"),
                    tmp_path / "ptbench" / "configs")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = spec.cell("envmap.accum_1024", root=str(tmp_path))
    acc = spec.cell("sponza.accum_1080p", root=str(tmp_path))
    assert "only_env" in {m["name"] for m in env.per_layer}
    assert "only_env" not in {m["name"] for m in acc.per_layer}


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no.such_cell")


NEW_DRIVER = """
from ptbench.drivers import accum


class Driver(accum.Driver):
    def step(self):
        self.r.step()
        self.r.step()
        self.sync()


reference = accum.reference
errors = accum.errors
"""


def test_new_driver_is_found_from_a_new_file(tmp_path, monkeypatch):
    """A new kind of traffic is a new module under ptbench/drivers/ and
    a mix naming it: run.py and calibrate.py need no edit."""
    (tmp_path / "twice.py").write_text(NEW_DRIVER)
    monkeypatch.setattr(drivers, "__path__",
                        list(drivers.__path__) + [str(tmp_path)])
    monkeypatch.delitem(sys.modules, "ptbench.drivers.twice", raising=False)
    c = spec.cell("envmap.accum_1024")
    c.traffic["driver"] = "twice"
    mod = drivers.module("twice")
    assert mod.__file__ == str(tmp_path / "twice.py")
    assert mod.reference is drivers.module("accum").reference

    class R:
        steps = 0

        def step(self):
            R.steps += 1

    d = drivers.make(R(), c, 1, lambda: None)
    d.step()
    assert isinstance(d, mod.Driver) and R.steps == 2
