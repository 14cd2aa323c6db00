"""The program's spans (pathtracer_torch.tracing) read against a
torch.profiler trace, and over a window on the host clock.

While tracing is on and a profiler records, each program span is a
record_function range named pt.* on the host timeline. A device op
(every device event of the trace but the device-side images of host
ranges, as ptbench.trace reads them) belongs to the innermost pt.* range
around the host call that launched it: the CUDA runtime event
(cudaLaunchKernel, cudaMemcpyAsync, ...) that carries the op's
correlation id. Each op falls in one bucket, by the names of the ranges
open at its launch:

  handwritten  the program's hand-written kernels, by name
               (ptbench.trace.kind_of), wherever launched
  packet       launched inside a pt.traverse.* range
  integrator   inside pt.bounce, pt.wavefront or pt.film, outside every
               pt.traverse.*
  step_self    inside pt.step only
  outside      launched outside every pt.* range
  unlinked     no runtime event in the trace carries its correlation id

Device idle is the gaps between device activity (ptbench.trace's rule);
a gap belongs to the innermost pt.* range open on the host at its
midpoint.

Beside the buckets, every pt.* name found in the trace is read by
itself (`by_span`), none listed here, so that a new span's metric is a
new reader and nothing else: the device seconds of the ops launched
with it open anywhere on the stack and with it innermost, the idle
seconds whose midpoint it spans, and the attributes its spans recorded
(tracing.take() of the same steps). Its count and host seconds are the
window's (host_spans), on the host clock.
"""

from __future__ import annotations

from ptbench import trace

TRAVERSE = ("pt.traverse.closest", "pt.traverse.occluded")
INTEGRATOR = ("pt.bounce", "pt.wavefront", "pt.film")
BUCKETS = ("handwritten", "packet", "integrator", "step_self", "outside",
           "unlinked")


def _bucket(open_names) -> str:
    if any(n in TRAVERSE for n in open_names):
        return "packet"
    if any(n in INTEGRATOR for n in open_names):
        return "integrator"
    if "pt.step" in open_names:
        return "step_self"
    return "outside"


def _open_at(ranges, times):
    """For each time of `times` (sorted), the names of the ranges
    (start, end, name), nested as spans of one thread are, open at it,
    outermost first. A range of no length holds nothing."""
    ranges = [r for r in ranges if r[1] > r[0]]
    bounds = sorted([(s, 1, name) for s, e, name in ranges]
                    + [(e, 0, name) for s, e, name in ranges])
    stack, out, i = [], [], 0
    for t in times:
        while i < len(bounds) and bounds[i][0] <= t:
            if bounds[i][1]:
                stack.append(bounds[i][2])
            elif bounds[i][2] in stack:
                del stack[len(stack) - 1 - stack[::-1].index(bounds[i][2])]
            i += 1
        out.append(tuple(stack))
    return out


def read(events, handwritten: set, spans=()) -> dict:
    """Device seconds by bucket (`<bucket>_s`, summed op durations), all
    device seconds (`device_s`), idle seconds under pt.traverse.*
    (`packet_idle_s`), idle seconds by the innermost range open at a
    gap's midpoint (`idle_by_span`, "(none)" outside every pt.*), the
    ten longest gaps named by that range and the innermost other host
    event there (`idle_gaps_by_span`, [[name, seconds]]), and per pt.*
    name of the trace (`by_span`): `device_s` (open anywhere on the
    stack at the launch),
    `self_device_s` (innermost), `idle_s` (open at the gap's midpoint)
    and `attrs`, the attributes of `spans` (tracing.take()) of that
    name, oldest first."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type != cuda]
    host_names = {e.name for e in host}
    dev = [e for e in events
           if e.device_type == cuda and e.name not in host_names]
    launch = {e.id: e.time_range.start for e in host
              if e.name.startswith("cu")}
    ranges = [(e.time_range.start, e.time_range.end, e.name) for e in host
              if e.name.startswith("pt.")]
    out = {f"{b}_s": 0.0 for b in BUCKETS}
    by_span = {name: {"device_s": 0.0, "self_device_s": 0.0, "idle_s": 0.0,
                      "attrs": []} for _, _, name in ranges}
    for sp in spans:
        if sp["name"] in by_span:
            by_span[sp["name"]]["attrs"].append(sp["attrs"])
    linked = sorted(((launch[e.id], e) for e in dev if e.id in launch),
                    key=lambda te: te[0])
    for e in dev:
        if e.id not in launch:
            out["handwritten_s" if trace.kind_of(e.name, handwritten)
                == "handwritten" else "unlinked_s"] += _sec(e)
    for (_, e), names in zip(linked, _open_at(ranges,
                                               [t for t, _ in linked])):
        b = ("handwritten" if trace.kind_of(e.name, handwritten)
             == "handwritten" else _bucket(names))
        out[f"{b}_s"] += _sec(e)
        for name in set(names):
            by_span[name]["device_s"] += _sec(e)
        if names:
            by_span[names[-1]]["self_device_s"] += _sec(e)
    out["device_s"] = sum(_sec(e) for e in dev)

    gaps, end = [], None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if end is not None and s > end:
            gaps.append((0.5 * (end + s), (s - end) / 1e6))
        end = e if end is None else max(end, e)
    stacks = _open_at(ranges, [m for m, _ in gaps])
    idle_by_span, packet_idle = {}, 0.0
    for (_, sec), names in zip(gaps, stacks):
        key = names[-1] if names else "(none)"
        idle_by_span[key] = idle_by_span.get(key, 0.0) + sec
        if any(n in TRAVERSE for n in names):
            packet_idle += sec
        for name in set(names):
            by_span[name]["idle_s"] += sec
    out["packet_idle_s"] = packet_idle
    out["idle_by_span"] = idle_by_span
    out["by_span"] = by_span
    longest = sorted(zip(gaps, stacks), key=lambda gs: -gs[0][1])[:10]
    out["idle_gaps_by_span"] = [[_gap_name(mid, names, host), sec]
                                for (mid, sec), names in longest]
    return out


def _gap_name(mid, names, host) -> str:
    """<innermost pt.* range>/<innermost other host event> at a gap's
    midpoint: "(none)" outside every pt.*, no "/" where no other event
    spans it."""
    cover = [(e.time_range.end - e.time_range.start, e.name) for e in host
             if e.time_range.start <= mid <= e.time_range.end
             and not e.name.startswith("pt.")]
    span = names[-1] if names else "(none)"
    return f"{span}/{min(cover)[1]}" if cover else span


def _sec(e) -> float:
    return (e.time_range.end - e.time_range.start) / 1e6


def window(spans: list, host_syncs: int) -> dict:
    """Over a window's spans (tracing.take()) and the rise of
    tracing.COUNTERS["host_syncs"] across it: the host syncs, and the
    host's busy seconds - the pt.step spans less the pt.sync time inside
    them, the time the host spent enqueueing."""
    steps = {s["id"]: s for s in spans if s["name"] == "pt.step"}
    busy = sum(s["end_ns"] - s["start_ns"] for s in steps.values())
    busy -= sum(s["end_ns"] - s["start_ns"] for s in spans
                if s["name"] == "pt.sync" and s["step"] in steps)
    return {"host_syncs": int(host_syncs), "host_busy_s": busy / 1e9}


def host_spans(spans: list) -> dict:
    """Per span name of a window's spans (tracing.take()): how many, and
    their host seconds (`count`, `host_s`)."""
    out = {}
    for s in spans:
        row = out.setdefault(s["name"], {"count": 0, "host_s": 0.0})
        row["count"] += 1
        row["host_s"] += (s["end_ns"] - s["start_ns"]) / 1e9
    return out


def kernel_load_s(spans: list) -> float:
    """Seconds in pt.kernel_load spans (the nvcc builds and dlopens)."""
    return sum(s["end_ns"] - s["start_ns"] for s in spans
               if s["name"] == "pt.kernel_load") / 1e9


def unaccounted_share(stages: dict) -> float:
    """How far the buckets but `outside` and `unlinked` fall short of
    all device time, as a share of it (0 when they account for all)."""
    if stages["device_s"] <= 0:
        return 0.0
    kept = sum(stages[f"{b}_s"] for b in BUCKETS[:4])
    return 1.0 - kept / stages["device_s"]

