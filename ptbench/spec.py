"""Finding a cell's pieces by name.

BENCHMARK.json (at the checkout's root) names each cell's configuration
and traffic mix and lists the metrics. Every piece is a file of its own,
found by its name:

  the configuration's file     the `file` of its BENCHMARK.json entry
                               (ptbench/configs/<config>.json)
  its scene generator          ptbench/scenes/<generator>.py, named by the
                               configuration's `scene.generator`, whose
                               generate(**scene.args) gives the scene
                               (ptbench.scenes)
  its accel                    the configuration's `render.intersector`
                               (cluster, bvh or brute) picks the build
                               (ptbench.run.build_accel) and the entry
                               points whose hits are compared
                               (ptbench.capture)
  a traffic mix               ptbench/traffic/<traffic>.json
  the mix's driver             ptbench/drivers/<driver>.py, named by the
                               mix's `driver` (ptbench.drivers)
  a metric (either kind)       ptbench/metrics/<metric>.py, whose
                               read(record) gives its value or None; a
                               metric named <metric>.<scope>, one
                               quantity split by the cells that report
                               it, is read by <metric>'s reader

so a later configuration, scene, mix, driver or metric is new files and
new entries.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict         # the traffic mix's file
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root=ROOT, bench=None) -> Cell:
    """The cell `name` of BENCHMARK.json with its files loaded."""
    bench = bench or benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}: BENCHMARK.json has "
                       f"{', '.join(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(root, "ptbench", "traffic",
                                     f"{w['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in moved and _reports(m, name)]
    return Cell(name=name, config_name=w["config"],
                traffic_name=w["traffic"], chips=int(w["chips"]),
                config=config, traffic=traffic, end_to_end=e2e,
                per_layer=per_layer)


def reader(metric: str):
    """ptbench/metrics/<metric>.py's read function (for <metric>.<scope>
    too)."""
    mod = metric.split(".")[0].replace("-", "_")
    return importlib.import_module(f"ptbench.metrics.{mod}").read


def render_fields(cell: Cell, seed) -> dict:
    """The cell's RenderConfig fields: the configuration's, with the
    traffic's resolution and frame batching and the run's seed."""
    kw = dict(cell.config["render"])
    kw["sun_direction"] = tuple(kw["sun_direction"])
    t = cell.traffic
    return dict(kw, width=t["width"], height=t["height"],
                frame_batch=t["frame_batch"], seed=int(seed))
