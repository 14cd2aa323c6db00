"""P2: the argmin extraction always run against gated by a branch (counterpart of benchmarks/cond_probe.py)

Times P2 (kernels/probes.cond_walk: 256 fake columns over a [64, 512]
tile, a grid of 64 steps) with the extraction always run and gated
behind a branch on whether any row may improve, with CUDA events. On
the card a grid step is a 2-CTA cluster whose gate waits on a cluster
barrier every step, a cost that K2 (one CTA a tile) would not pay, so
the ratio weighs this kernel's gate against the extractions it skips;
it is not what a skip in K2 would save.

    python -m pathtracer_torch.bench.cond_probe

prints ms per call for both and their ratio, then one JSON line.
"""

from __future__ import annotations

import json
import sys

import torch

from pathtracer_torch.bench.harness import time_call
from pathtracer_torch.kernels import probes

N_ITER, GRID = 256, 64


def probe_input(device):
    """x = arange(64 * 512) * 1e-3 as f32[1, 64, 512] (the JAX script's)."""
    n = probes.WALK_ROWS * probes.WALK_COLS
    return (torch.arange(n, dtype=torch.float32, device=device)
            * 1e-3).reshape(1, probes.WALK_ROWS, probes.WALK_COLS)


def run(device="cuda", reps=20):
    """{"always_ms", "gated_ms", "gated_over_always", "sum"} on the card."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"cond_probe times the card; got device {device}")
    x = probe_input(device)
    res = {}
    for label, gate in (("always", False), ("gated", True)):
        dt, out = time_call(
            lambda g=gate: probes.cond_walk(x, N_ITER, g, GRID), device,
            reps=reps)
        res[f"{label}_ms"] = dt * 1e3
        res[f"{label}_sum"] = float(out.sum())
    res["gated_over_always"] = res["gated_ms"] / res["always_ms"]
    return res


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("cond_probe: no CUDA device")
    res = run()
    for label in ("always", "gated"):
        print(f"{label:6s}: sum={res[f'{label}_sum']:.1f}  "
              f"{res[f'{label}_ms']:.4f} ms", flush=True)
    print(f"gated / always: {res['gated_over_always']:.3f}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
