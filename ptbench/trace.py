"""Reading a torch.profiler trace of a few steps.

Device activity is every CUDA event of the trace (kernels, copies,
sets) but the device-side images of host ranges. Busy time is the union of their intervals (the arithmetic of
tools/profile_headline.py's busy_ms, copied). Kernels are split three
ways by name: the program's hand-written kernels (every `__global__`
function of its .cu sources), sorts (names holding "sort", as cub's
radix sorts and torch's bitonic sorts do), and the rest (PyTorch's own
kernels: the integrator's, the packet layer's and the film's eager ops).
"""

from __future__ import annotations

import glob
import os
import re

COPY_PREFIXES = ("Memcpy", "Memset")


def handwritten_names(package_dir) -> set:
    """Names of every __global__ function in the package's .cu files."""
    names = set()
    pat = re.compile(r"__global__\s+(?:void\s+)?(?:__\w+__\s*\([^)]*\)\s*)*"
                     r"(?:void\s+)?(\w+)\s*\(")
    for path in glob.glob(os.path.join(package_dir, "**", "*.cu"),
                          recursive=True):
        with open(path) as f:
            names.update(pat.findall(f.read()))
    names.discard("void")
    return names


def kind_of(name: str, handwritten: set) -> str:
    if name.startswith(COPY_PREFIXES):
        return "copy"
    bare = name.replace("(anonymous namespace)::", "")
    if bare.startswith("void "):
        bare = bare[5:]
    if re.split(r"[<(]", bare)[0].split("::")[-1].strip() in handwritten:
        return "handwritten"
    if "sort" in name.lower():
        return "sort"
    return "torch"


def union_s(spans) -> float:
    """Seconds covered by the union of [start, end] intervals (in us)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def read(events, handwritten: set, window_s: float) -> dict:
    """busy_s, device seconds by kind and by name, and the ten longest
    idle gaps named by the innermost host event spanning each."""
    import torch

    dev, host = [], []
    for e in events:
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((span, e.name))
        else:
            host.append((span, e.name))
    # a record_function range also shows on the device timeline, spanning
    # the kernels it launched; it is no device activity of its own
    host_names = {name for _, name in host}
    dev = [(span, name) for span, name in dev if name not in host_names]
    by_kind = {"handwritten": 0.0, "sort": 0.0, "torch": 0.0, "copy": 0.0}
    by_name = {}
    for (s, e), name in dev:
        sec = (e - s) / 1e6
        by_kind[kind_of(name, handwritten)] += sec
        by_name[name] = by_name.get(name, 0.0) + sec
    spans = sorted(s for s, _ in dev)
    gaps = []
    end = None
    for s, e in spans:
        if end is not None and s > end:
            gaps.append((s - end, end, s))
        end = e if end is None else max(end, e)
    gaps.sort(reverse=True)
    idle = []
    for length, a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        cover = [(he - hs, name) for (hs, he), name in host
                 if hs <= mid <= he]
        idle.append([min(cover)[1] if cover else "(no host event)",
                     length / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": union_s([s for s, _ in dev]), "window_s": window_s,
            "by_kind": by_kind,
            "device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": idle}
