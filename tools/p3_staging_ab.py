#!/usr/bin/env python3
"""Time P3's column staging of two checkouts in turns on one card.

    python3 tools/p3_staging_ab.py BASE_DIR CHANGE_DIR [--order ABBA]
                                   [--cpi 1 12] [--out chiprun_out/p3_ab]

BASE_DIR and CHANGE_DIR each hold a checkout of the repository (for
example `git archive` of two commits, unpacked into a git-ignored
directory). In each, in the order given (A = BASE, B = CHANGE; ABBA by
default, so drift over the call falls on both), one process runs
`pathtracer_torch.bench.sweep_attrib.attribution` at each cpi on the
driver's shapes (2,048 tiles of 64 rays, 64 and 192 columns) and, where
the checkout has it, K2's cost a column on the same schedule
(`k2_columns`). Each run prints one JSON line: per cpi the attribution
(loop floor, BW ALU, copies, per extra start, overlap, each variant's
us a column and ms a launch), and per variant P3's registers (from the
build's ptxas report), dynamic shared memory and blocks an SM at cpi 1
and 12 - computed from registers, threads and shared memory with the
H100's limits, and from the CUDA runtime where the checkout exports
it - beside the card's name and power limit. Exits non-zero if a run
fails. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# One checkout's run, in a process of its own (its own package, its own
# build under its pathtracer_torch/_build/).
_RUN = r"""
import json, re, subprocess, sys
import torch
from pathtracer_torch.bench import sweep_attrib
from pathtracer_torch.kernels import cuda_build, probes

cpis = [int(c) for c in sys.argv[1:]]
cuda_build.build("probes")
regs = {}
cur = None
for line in cuda_build.build_logs.get("probes", "").splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
        cur = m.group(1)
    m = re.search(r"Used (\d+) registers", line)
    if m and cur and "attrib_kernel" in cur:
        v = int(re.search(r"attrib_kernelILi(\d)E", cur).group(1))
        regs[probes.VARIANTS[v]] = int(m.group(1))
res = {"card": subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit",
     "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
    "registers": regs, "cpi": {}}
R, K = sweep_attrib.R, sweep_attrib.K
for cpi in cpis:
    a = sweep_attrib.attribution("cuda", cpi=cpi)
    if hasattr(probes, "attrib_stages"):
        stages = probes.attrib_stages(R, K, cpi)
        shmem = probes.attrib_shmem(R, K, cpi, stages)
        runtime = {v: probes.kernel_info(v, R, K, cpi)["blocks_per_sm"]
                   for v in probes.VARIANTS}
    else:     # the double-buffered cp.async ring
        stages = 2
        shmem = probes._lib().pt_attrib_shmem(R, K, cpi)
        runtime = None
    a["stages"], a["shmem"], a["blocks_per_sm_runtime"] = (stages, shmem,
                                                          runtime)
    res["cpi"][cpi] = a
if hasattr(sweep_attrib, "k2_columns"):
    k2 = sweep_attrib.k2_columns("cuda")
    res["k2"] = {"ms": k2["ms"], "per_col": k2["per_col"]}
print(json.dumps(res))
"""

SM_SHMEM = 233_472        # shared memory an SM (228 KB)
BLOCK_RESERVED = 1024     # shared memory the runtime keeps a block
SM_REGS, SM_WARPS, SM_BLOCKS = 65_536, 64, 32


def blocks_per_sm(regs, threads, shmem):
    """Resident blocks an SM of an H100 for a kernel of `regs` registers
    a thread (allocated 256 a warp at a time), `threads` a block and
    `shmem` bytes of dynamic shared memory a block."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = (SM_REGS // per_warp) // warps
    by_smem = SM_SHMEM // (shmem + BLOCK_RESERVED)
    return min(by_regs, by_smem, SM_WARPS // warps, SM_BLOCKS)


def summarize(rec, threads=256):
    """The numbers PERF.md compares from one run's JSON line."""
    out = {"card": rec["card"], "registers": rec["registers"]}
    if "k2" in rec:
        out["k2_us_per_col"] = rec["k2"]["per_col"]
    for cpi, a in rec["cpi"].items():
        row = {k: a.get(k) for k in ("loop_floor", "bw_alu", "copies",
                                     "copies_1", "per_extra_start", "full",
                                     "overlap", "stages", "shmem")}
        row["full_ms"] = a["ms"]["full"]
        row["per_col"] = a["per_col"]
        row["blocks_per_sm"] = {
            v: blocks_per_sm(r, threads, a["shmem"])
            for v, r in rec["registers"].items()}
        row["blocks_per_sm_runtime"] = a["blocks_per_sm_runtime"]
        out[f"cpi{cpi}"] = row
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base")
    ap.add_argument("change")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--cpi", type=int, nargs="+", default=[1, 12])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "p3_ab"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    dirs = {"A": args.base, "B": args.change}
    failed = False
    for i, which in enumerate(args.order):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-c", _RUN, *map(str, args.cpi)],
            cwd=dirs[which], capture_output=True, text=True, timeout=900)
        with open(os.path.join(args.out, f"{i}_{which}.log"), "w") as f:
            f.write(res.stdout + res.stderr)
        line = {"run": i, "tree": which, "rc": res.returncode,
                "seconds": time.perf_counter() - t0}
        if res.returncode == 0:
            line.update(summarize(json.loads(
                res.stdout.strip().splitlines()[-1])))
        else:
            failed = True
            line["stderr"] = res.stderr[-2000:]
        print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
