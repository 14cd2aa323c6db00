#!/usr/bin/env python3
"""Where a sweep launch's time goes: the bulk of its tiles or its longest.

    python3 tools/sweep_tail.py

Builds chip_smoke.py's headline, records the K2 and K3 calls of one
unprimed frame's primary, bounce-0 shadow and bounce-1 batches as
chip_smoke.py does (every 16th chunk, at most 2 per batch and kernel),
and for each recorded chunk prints one JSON line: the columns each tile
walks (mean and quantiles, from the plain version's walk), the kernel's
time on the whole chunk, on its LONGEST longest-walking tiles alone and
on the others, and the share of the chunk's columns those tiles walk.
If the longest tiles alone take most of the chunk's time, the launch is
bound by the sequential walk of a few tiles, not by its total work.
Times are CUDA-event means over REPS launches after one warm-up. Prints
the card's name and power limit first. Needs one CUDA device.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LONGEST = (8, 64)
REPS = 5
PER_BATCH = 2


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


def main():
    import torch

    if not torch.cuda.is_available():
        print("sweep_tail: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from pathtracer_torch.kernels import sweep

    chip_smoke.phase_device()
    scene, cfg, cam = chip_smoke.headline_setup()
    for b in chip_smoke.capture_chunks(scene, cfg, cam):
        for name in ("sweep_closest", "sweep_occluded"):
            kernel = getattr(sweep, name)
            plain = getattr(sweep, name + "_plain")
            for args, kw in b[name][:PER_BATCH]:
                cols = torch.zeros(args[0].shape[0], dtype=torch.int64,
                                   device=args[0].device)
                plain(*chip_smoke.plain_args(args), tile_columns=cols)
                order = torch.argsort(cols, descending=True)
                q = torch.quantile(cols.double(), torch.tensor(
                    [0.5, 0.9, 0.99, 1.0], dtype=torch.float64,
                    device=cols.device)).tolist()
                res = dict(kernel=name, batch=b["label"],
                           tiles=int(cols.numel()),
                           columns_mean=float(cols.double().mean()),
                           columns_q50_q90_q99_max=q,
                           ms=mean_ms(lambda: kernel(*args, **kw)))

                def part(ix):
                    return tuple(a[ix].contiguous() if i < 4 else a
                                 for i, a in enumerate(args))

                for n in LONGEST:
                    top, rest = part(order[:n]), part(order[n:])
                    res[f"longest{n}_ms"] = mean_ms(lambda: kernel(*top, **kw))
                    res[f"others{n}_ms"] = mean_ms(
                        lambda: kernel(*rest, **kw))
                    res[f"longest{n}_column_share"] = float(
                        cols[order[:n]].sum() / cols.sum())
                print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
