#!/usr/bin/env python3
"""Run chip_smoke.py of two checkouts in turns on one card and compare.

    python3 tools/ab_smoke.py BASE_DIR CHANGE_DIR [--order ABBA]
                              [--out chiprun_out/ab]

BASE_DIR and CHANGE_DIR each hold a checkout of the repository (for
example `git archive` of the parent commit and of the change, unpacked
into a git-ignored directory). Runs `python3 chip_smoke.py` in them in
the order given (A = BASE, B = CHANGE; default ABBA, so drift over the
call falls on both), saves each run's output as OUT/<i>_<A|B>.log, and
prints one JSON line per run with the numbers PERF.md compares: per
kernel its ms per chunk and bound (K4 at each block width, as
tile_cull_skip_<blk>), K4's skip rate, tests and occupancy where the
run prints them, the headline's ms/frame, Mrays/s and peak memory (K1
route, K4 route, primed), and configs 3 and 4's ms/frame (config 4 also
on the K4 route where the run has it). Exits non-zero if a run fails.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

RUNS = ("headline", "headline_cull_skip", "headline_primed", "config4",
        "config4_cull_skip", "config4_primed", "config3_denoise")


def summarize(lines):
    """Numbers of one chip_smoke.py output (its JSON lines)."""
    out = {}
    for line in lines:
        if not line.startswith("{"):
            continue
        rec = json.loads(line)
        phase = rec.get("phase")
        if phase == "kernel_vs_plain":
            name = rec["kernel"]
            if name == "tile_cull_skip":
                name += f"_{rec.get('blk', 128)}"
            out[name] = dict(ms=rec["ms"], bound_ms=rec["bound_ms"],
                             ratio=rec["ms"] / rec["bound_ms"])
        elif phase == "k4_skip_rate":
            out[f"tile_cull_skip_{rec['blk']}"]["skip"] = rec["mean"]
        elif phase == "k4_work":
            out[f"tile_cull_skip_{rec['blk']}"].update(
                {k: rec[k] for k in ("needed_tests", "kernel_tests",
                                     "registers", "blocks_per_sm",
                                     "occupancy")})
        elif phase == "sweep_work":
            out[rec["kernel"]].update(
                {k: rec[k] for k in ("needed_tests", "dense_tests",
                                     "kernel_tests", "registers",
                                     "blocks_per_sm", "occupancy")})
        elif phase in RUNS:
            out[phase] = dict(ms_per_frame=rec["ms_per_frame"],
                              mrays_per_s=rec["mrays_per_s"],
                              peak_mem_bytes=rec["peak_mem_bytes"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base")
    ap.add_argument("change")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "ab"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    dirs = {"A": args.base, "B": args.change}
    failed = False
    for i, which in enumerate(args.order):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "chip_smoke.py"],
                             cwd=dirs[which], capture_output=True, text=True,
                             timeout=1200)
        with open(os.path.join(args.out, f"{i}_{which}.log"), "w") as f:
            f.write(res.stdout)
            f.write(res.stderr)
        lines = res.stdout.splitlines()
        print(json.dumps({"run": i, "tree": which, "dir": dirs[which],
                          "rc": res.returncode,
                          "seconds": time.perf_counter() - t0,
                          "card": lines[0] if lines else "",
                          **summarize(lines)}), flush=True)
        failed |= res.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
