"""Readings that the limits of ptbench.checks are set from (on the card).

    python3 -m ptbench.calibrate --workload <cell> --seconds <s>
        --seeds 11,12,... [--control-seeds 11,12,13]

One process builds the cell's scene once; then, for each seed, a fresh
Renderer runs the cell's warm-up and a window of --seconds exactly as a
run does, and the reference judges what it produced: the program's
readings. For each control seed the same window's output is also
replaced by the control, the reference computed in bfloat16 (the
precision below the configurations' float32) on the same captured lanes
and, through the driver's own `reference`, the same outputs (pixels and
sample ids), and judged as the program's output is: the control's
readings. One JSON line a seed and kind.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from ptbench import spec as spec_mod
from ptbench.run import (Record, build_scene, forbidden_modules, judge,
                         make_renderer, outputs, prepare_environment,
                         window)


def produce(cell, scene, seed, seconds, device):
    """One window of a run on `scene` -> (record, produced)."""
    import torch

    from ptbench import capture, drivers

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    r = make_renderer(cell, scene, seed, device)
    driver = drivers.make(r, cell, seed, sync)
    for _ in range(cell.traffic["warmup_steps"]):
        driver.step()
    rec = Record()
    with capture.HitCapture(cell.traffic["hit_rays_per_call"],
                            seed) as hits:
        window(driver, seconds, rec, hits)
    return rec, outputs(driver, hits, rec.steps, seed)


def control(cell, spec, seed, produced, device):
    """`produced` with every answer replaced by the bfloat16 reference's."""
    import torch

    from ptbench import drivers
    from ptbench.reference import brute, tables

    bf = torch.bfloat16
    tb = tables.build(spec, device=device, dtype=bf)
    hits = {}
    cl = produced["hits"]["closest"]
    if cl is not None:
        t, tri, u, v = brute.closest(tb.bw, cl["o"].to(bf), cl["d"].to(bf),
                                     cl["t_min"], cl["t_max"].to(bf))
        hits["closest"] = dict(cl, t=t.float(), tri=tri, u=u.float(),
                               v=v.float())
    else:
        hits["closest"] = None
    oc = produced["hits"]["occluded"]
    hits["occluded"] = None if oc is None else dict(
        oc, blocked=brute.occluded(tb.bw, oc["o"].to(bf), oc["d"].to(bf),
                                   oc["t_max"].to(bf)))
    ref = drivers.module(cell.traffic["driver"]).reference(
        tb, cell, seed, produced)
    return dict(produced, hits=hits,
                **{k: v.float().cpu().numpy() for k, v in ref.items()})


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m ptbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    prepare_environment()
    import numpy as np
    import torch

    cell = spec_mod.cell(args.workload)
    spec, scene = build_scene(cell, args.device, Record())
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        rec, produced = produce(cell, scene, seed, args.seconds,
                                args.device)
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
        numbers, diag = judge(cell, spec, seed, produced, args.device)
        print(json.dumps({"kind": "program", "seed": seed,
                          "numbers": numbers, "diag": diag,
                          "frames": rec.frames,
                          "frame_ms": 1e3 * rec.window_s / rec.frames,
                          "step_ms_p95": 1e3 * float(np.percentile(
                              rec.step_s, 95)),
                          "seconds": time.perf_counter() - t0}), flush=True)
        if seed in ctrl:
            numbers, diag = judge(cell, spec, seed, control(
                cell, spec, seed, produced, args.device), args.device)
            print(json.dumps({"kind": "control_bf16", "seed": seed,
                              "numbers": numbers, "diag": diag}),
                  flush=True)
    bad = forbidden_modules()
    if bad:
        print("forbidden modules:", bad, file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
