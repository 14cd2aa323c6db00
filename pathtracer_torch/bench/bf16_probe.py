"""Is packed bf16 arithmetic faster than f32 on the card? (counterpart of benchmarks/bf16_probe.py)

Times P1 (kernels/probes.chain: 512 x 8 steps of the slab test's
sub/mul/min/max mix, then x + y) over [2048, 1024] in float32 and in
bfloat16 (packed bf16x2 instructions), with CUDA events, and the plain
PyTorch version of each (no counterpart of the JAX script's XLA leg).

    python -m pathtracer_torch.bench.bf16_probe

prints ms and Gops/s per dtype, the bf16 speedup, then one JSON line.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from pathtracer_torch.bench.harness import time_call
from pathtracer_torch.kernels import probes

N_ROWS, N_COLS = 2048, 1024
OPS_A_STEP = 8       # the JAX script's count of vector ops a chain step


def probe_inputs(device, n_rows=N_ROWS, seed=0):
    """x uniform in [0.25, 0.75), y = 1.1 x, float32 (as the JAX script)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n_rows, N_COLS)).astype(np.float32) \
        * np.float32(0.5) + np.float32(0.25)
    xf = torch.from_numpy(x).to(device)
    return xf, xf * 1.1


def run(device="cuda", steps=probes.CHAIN_STEPS):
    """{"f32_ms", "bf16_ms", "bf16_speedup", "gops_f32", "gops_bf16",
    "plain_f32_ms", "plain_bf16_ms"} on the card."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"bf16_probe times the card; got device {device}")
    xf, yf = probe_inputs(device)
    gops = xf.numel() * steps * OPS_A_STEP / 1e9
    res = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x, y = xf.to(dt), yf.to(dt)
        ms = time_call(lambda: probes.chain(x, y, steps), device)[0] * 1e3
        res[f"{name}_ms"] = ms
        res[f"gops_{name}"] = gops / ms * 1e3
        res[f"plain_{name}_ms"] = time_call(
            lambda: probes.chain_plain(x, y, steps), device, warmup=0,
            reps=1)[0] * 1e3
    res["bf16_speedup"] = res["f32_ms"] / res["bf16_ms"]
    return res


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("bf16_probe: no CUDA device")
    res = run()
    for name in ("f32", "bf16"):
        print(f"kernel {name:4s}: {res[f'{name}_ms']:8.3f} ms  "
              f"({res[f'gops_{name}']:.0f} Gops/s)   plain "
              f"{res[f'plain_{name}_ms']:8.1f} ms")
    print(f"\nbf16 speedup: x{res['bf16_speedup']:.2f}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
