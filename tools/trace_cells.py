#!/usr/bin/env python3
"""The benchmark's cells with pathtracer_torch.tracing on: device time
by stage, host syncs, idle by stage, and what tracing costs.

    python3 tools/trace_cells.py [--cells a,b] [--seed N] [--seconds S]

For each cell of BENCHMARK.json (default: all), in this process, it
builds the cell as `python3 -m ptbench` does (ptbench.run's scene,
Renderer and driver; PT_* cleared), runs the warm-up step, then four
windows of whole steps, --seconds each, with tracing off, on, on, off
(frame_ms of each: the on-cost), then the traffic's trace_steps more
steps under torch.profiler with tracing on. The spans and counters go
into a ptbench.run.Record as the benchmark would put them there
(`spans["kernel_load"]`, `tracing` from the on windows, the profile
dict with ptbench.stages.read's keys), and every per-layer reader of
ptbench/metrics reads it. Prints one JSON line a cell (also written to
chiprun_out/trace_cells/<cell>.json) with the metrics, the profiled
device time by bucket and its shares, idle by innermost span, the
windows, and the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out", "trace_cells")
READERS = ("integrator_ms_per_frame", "packet_ms_per_frame",
           "packet_idle_ms_per_frame", "host_syncs_per_frame",
           "host_busy_ms_per_frame", "kernel_load_s",
           "torch_ops_ms_per_frame", "sort_ms_per_frame",
           "cuda_kernels_ms_per_frame", "device_idle_pct")


def windows(driver, seconds, tracing):
    """Windows off, on, on, off: frames, seconds and frame_ms of each;
    the on windows' spans and host syncs."""
    out, spans, syncs = [], [], 0
    for on in (False, True, True, False):
        tracing.take()
        (tracing.enable if on else tracing.disable)()
        f0, s0 = driver.frames(), tracing.COUNTERS["host_syncs"]
        t0 = time.perf_counter()
        while True:
            driver.step()
            t = time.perf_counter() - t0
            if t >= seconds:
                break
        tracing.disable()
        frames = driver.frames() - f0
        if on:
            spans += tracing.take()
            syncs += tracing.COUNTERS["host_syncs"] - s0
        out.append({"tracing": on, "frames": frames, "seconds": t,
                    "frame_ms": 1e3 * t / frames,
                    "host_syncs": tracing.COUNTERS["host_syncs"] - s0})
    return out, spans, syncs


def profiled(driver, n, handwritten, tracing, sync):
    from torch.profiler import ProfilerActivity, profile

    from ptbench import stages, trace

    f0 = driver.frames()
    tracing.enable()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            driver.step()
        wall = time.perf_counter() - t0
    tracing.disable()
    tracing.take()
    sync()
    events = prof.events()
    p = trace.read(events, handwritten, wall)
    p.update(stages.read(events, handwritten))
    p["frames"] = driver.frames() - f0
    return p


def run_cell(cell, seed, seconds, device="cuda", out_dir=OUT):
    """One cell (a ptbench.spec.Cell) on `device`; returns its line."""
    import torch

    from pathtracer_torch import tracing
    from ptbench import drivers, run, spec, stages, trace

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    start = time.perf_counter()
    rec = run.Record()
    tracing.take()
    _, scene = run.build_scene(cell, device, rec)
    r = run.make_renderer(cell, scene, seed, device)
    driver = drivers.make(r, cell, seed, sync)
    for _ in range(cell.traffic["warmup_steps"]):
        driver.step()
    sync()
    setup_spans = tracing.take()
    rec.spans["kernel_load"] = stages.kernel_load_s(setup_spans)
    rec.setup_s = time.perf_counter() - start

    wins, spans, syncs = windows(driver, seconds, tracing)
    on = [w for w in wins if w["tracing"]]
    rec.frames = sum(w["frames"] for w in on)
    rec.window_s = sum(w["seconds"] for w in on)
    rec.tracing = stages.window(spans, syncs)
    hand = trace.handwritten_names(os.path.join(ROOT, "pathtracer_torch"))
    rec.profile = profiled(driver, cell.traffic["trace_steps"], hand,
                           tracing, sync)
    p = rec.profile
    metrics = {m: spec.reader(m)(rec) for m in READERS}
    dev = p["device_s"]
    line = {
        "cell": cell.name, "seed": seed, "device": device,
        "card": run.power_limit(),
        "metrics": metrics, "windows": wins,
        "kernel_loads": [dict(s["attrs"], seconds=(s["end_ns"]
                                                    - s["start_ns"]) / 1e9)
                         for s in setup_spans
                         if s["name"] == "pt.kernel_load"],
        "profile": {"frames": p["frames"], "window_s": p["window_s"],
                    "busy_s": p["busy_s"], "device_s": dev,
                    "by_bucket_s": {b: p[f"{b}_s"] for b in stages.BUCKETS},
                    "by_bucket_share": {b: p[f"{b}_s"] / dev if dev else None
                                        for b in stages.BUCKETS},
                    "unaccounted_share": stages.unaccounted_share(p),
                    "by_kind_s": p["by_kind"],
                    "idle_by_span_ms_per_frame": {
                        k: 1e3 * v / p["frames"]
                        for k, v in sorted(p["idle_by_span"].items(),
                                           key=lambda kv: -kv[1])},
                    "idle_gaps": p["idle_gaps"]},
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{cell.name}.json"), "w") as f:
        json.dump(line, f, indent=1)
    print(json.dumps(line), flush=True)
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tools/trace_cells.py")
    ap.add_argument("--cells", default=None)
    ap.add_argument("--seed", type=int, default=3_000_000_017)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from ptbench import run, spec

    run.prepare_environment()
    import torch

    if not torch.cuda.is_available():
        print("trace_cells: no CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(run.HOST_THREADS)
    names = (args.cells.split(",") if args.cells else
             [w["name"] for w in spec.benchmark()["workloads"]])
    for name in names:
        run_cell(spec.cell(name), args.seed, args.seconds)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
