#!/usr/bin/env python3
"""Where a sweep launch's time goes: the bulk of its tiles or its longest.

    python3 tools/sweep_tail.py [--budgets 40,48,56] [--per-batch 4]

Builds chip_smoke.py's headline, records the K2 and K3 calls of one
unprimed frame's primary, bounce-0 shadow and bounce-1 batches as
chip_smoke.py does (every 16th chunk, at most --per-batch, default
PER_BATCH, up to 4, a batch and kernel), and for each recorded chunk
prints one JSON line: the columns each tile walks (mean and quantiles,
from the plain version's walk), the kernel's time on the whole chunk, on
its LONGEST longest-walking tiles alone and on the others, and the share
of the chunk's columns those tiles walk. If the longest tiles alone take
most of the chunk's time, the launch is bound by the sequential walk of
a few tiles, not by its total work.

K2 runs in two passes (csrc/sweep.cu): a K2 line also gives the tiles
pass B resumed (`resumed`, as the kernel listed them, checked against
the plain walk), the columns pass B tests (`pass_b_columns`: whole
rounds of RESUME_CTAS columns from RESUME_COLUMNS on) and those the
sequential walk visits past RESUME_COLUMNS (`pass_b_needed`), K2's time
as one pass (`sequential_ms`, a budget past every walk), and under
--budgets its time at each budget (`budget_ms`); then one line of both
passes' registers, CTAs an SM and pass B's clusters (`kernel_info`).
Times are CUDA-event means over REPS launches after one warm-up. Needs
one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LONGEST = (8, 64)
REPS = 5
PER_BATCH = 2
SEQUENTIAL = 1 << 30   # a budget no walk reaches: pass A alone


def mean_ms(fn):
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def k2_split(args, cols, budgets):
    """The two passes on one K2 chunk, as a dict."""
    import chip_smoke
    from pathtracer_torch.kernels import sweep

    res = dict(chip_smoke.k2_engagement("sweep_tail", args, cols),
               sequential_ms=mean_ms(
                   lambda: sweep._closest_cuda(*args, SEQUENTIAL)))
    if budgets:
        res["budget_ms"] = {n: mean_ms(lambda: sweep._closest_cuda(*args, n))
                            for n in budgets}
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--budgets", default="",
                    help="pass A budgets L to time K2 at, as L,L,...")
    ap.add_argument("--per-batch", type=int, default=PER_BATCH,
                    help="chunks a batch and kernel (at most 4)")
    opt = ap.parse_args(argv)
    budgets = [int(x) for x in opt.budgets.split(",") if x]

    import torch

    if not torch.cuda.is_available():
        print("sweep_tail: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from pathtracer_torch.kernels import sweep

    chip_smoke.phase_device()
    scene, cfg, cam = chip_smoke.headline_setup()
    shape = None
    for b in chip_smoke.capture_chunks(scene, cfg, cam):
        for name in ("sweep_closest", "sweep_occluded"):
            kernel = getattr(sweep, name)
            plain = getattr(sweep, name + "_plain")
            for args, kw in b[name][:opt.per_batch]:
                cols = torch.zeros(args[0].shape[0], dtype=torch.int64,
                                   device=args[0].device)
                plain(*chip_smoke.plain_args(args), tile_columns=cols)
                q = torch.quantile(cols.double(), torch.tensor(
                    [0.5, 0.9, 0.99, 1.0], dtype=torch.float64,
                    device=cols.device)).tolist()
                res = dict(kernel=name, batch=b["label"],
                           tiles=int(cols.numel()),
                           columns_mean=float(cols.double().mean()),
                           columns_q50_q90_q99_max=q,
                           ms=mean_ms(lambda: kernel(*args, **kw)))
                for n in LONGEST:
                    res.update(chip_smoke.tail_split(kernel, args, kw, cols,
                                                     n, mean_ms))
                if name == "sweep_closest":
                    res.update(k2_split(args, cols, budgets))
                    shape = (args[2].shape[2], args[4].tris_per_cluster)
                print(json.dumps(res), flush=True)
    if shape is not None:
        print(json.dumps({"kernel_info": {
            name: sweep.kernel_info(name, *shape)
            for name in ("sweep_closest", "sweep_resume")},
            "resume_columns": sweep.RESUME_COLUMNS,
            "resume_ctas": sweep.RESUME_CTAS}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
