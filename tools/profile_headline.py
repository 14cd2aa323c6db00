#!/usr/bin/env python3
"""Device-time breakdown of one headline frame of pathtracer_torch.

    python3 tools/profile_headline.py

Builds chip_smoke.py's headline (textured sponza_like(262_000), 1920x1080,
4 spp, depth 6, spp-batched, cluster intersector on the CUDA kernels),
renders one warm-up frame and two timed frames through Renderer, then one
frame under torch.profiler. Prints the card's name and power limit, the
frame times, the kernel launch counts of the profiled frame, the device
busy time (union of the device kernels' intervals) and idle share of that
frame, and key_averages() sorted by self device time and by self CPU
time. Needs one CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 2      # timed frames before the profiled one
ROWS = 40       # rows of the device-time table


def busy_ms(events):
    """Union of the device kernels' [start, end] intervals, in ms."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_headline: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from pathtracer_torch import kernels
    from pathtracer_torch.render import Renderer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    scene, cfg, cam = chip_smoke.headline_setup()
    r = Renderer(scene, cfg, cam, device=chip_smoke.DEVICE)
    for i in range(1 + FRAMES):
        t0 = time.perf_counter()
        r.step()
        torch.cuda.synchronize()
        print(f"frame {i}{' (warm-up)' if i == 0 else ''} ms "
              f"{(time.perf_counter() - t0) * 1e3} rays {int(r.last_rays)}")
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = busy_ms(prof.events())
    print(f"profiled_frame_ms {wall} launches {dict(kernels.LAUNCHES)}")
    print(f"device_busy_ms {busy} idle_share {1.0 - busy / wall}")
    ka = prof.key_averages()
    print(ka.table(sort_by="self_cuda_time_total", row_limit=ROWS))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=ROWS // 2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
