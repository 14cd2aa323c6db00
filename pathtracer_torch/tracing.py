"""Spans and counters of pathtracer_torch.

Counters are plain host integers, counted whether tracing is on or off:

  LAUNCHES  kernel launches per kernel (kernels.LAUNCHES is this dict):
            cull.tile_cull for K1, cull.tile_cull_skip for K4,
            sweep.sweep_closest, sweep.sweep_occluded, sweep.sweep_occluded
            with want_blocker as "sweep_occluded_blocker",
            traverse.intersect_bvh as "bvh_closest" for K5,
            traverse.occluded_bvh as "bvh_occluded" for K6, and the probes
            of probes.py: chain as "chain_f32" / "chain_bf16" for P1,
            cond_walk as "cond_walk" / "cond_walk_gated" for P2,
            sweep_attrib for P3, and sampling/rng.pcg4d_uniform as
            "pcg4d" for K9 (one a PCG draw of uniform1/2/4 on CUDA
            tensors), and integrator/shade.Shader's K10 as "shade" (one
            a bounce it shades) and its resolve as "shade_resolve" (one
            a bounce with shadow queries). Each wrapper adds one where it
            launches its CUDA kernel and nowhere else, so a run can show
            that the main path went through the kernels.
  COUNTERS  "host_syncs": the program's blocking host syncs, one at each
            site inside a step where the host waits for the device
            (host_sync): chunk_live's read of the live-chunk flags, each
            copy of host data to the device (device_tensor), and the
            G-buffer's masked gather. Each site counts on every device,
            so a CPU run counts what a card's run syncs (but for the
            gradient sky's two copies a segment, which K10 does not
            make on a card).
            "shade_kernel" / "shade_plain": the bounces of
            path.trace_paths (the last segment included) shaded by K10
            and by the plain chain.

Spans are off by default; enable() and disable() switch them. Off, a
span site costs one flag test and returns a shared no-op span: it opens
no record_function, adds no device op and no host sync. On, a span
records its name, its start and end on time.perf_counter_ns(), its
parent span, its step (the id of its outermost span, so every span of
one Renderer.step shares the step's id) and its attributes, and keeps
them in memory until take() returns them. While a torch.profiler
records, each span also opens a torch.profiler.record_function of its
name, which puts it on the profiler's timeline (the device trace's
clock).

The spans, from the top (attributes in brackets):

  pt.step               Renderer.step [frames folded into the film]
  pt.wavefront          one wavefront: a pool part (render._trace_pool_part)
                        or one sample of the per-sample loop (render_sample)
  pt.bounce             one bounce of path.trace_paths, or its last
                        segment [depth]
  pt.traverse.closest   one closest-hit call of the intersector
  pt.traverse.occluded  one shadow call of the intersector
  pt.sort               the packet layer's coherence sort, or its unsort
  pt.chunk              one live chunk: the cull, the schedule sort, the sweep
  pt.schedule           packet._sorted_schedule, the per-tile schedule sort
                        [tiles, clusters]
  pt.sweep.closest      sweep.sweep_closest, K2's launches (both passes on
                        the card) [tiles, columns: pass A's column budget,
                        resumed: the tiles whose walk passes it, which
                        pass B finishes; on the card the device's count,
                        a tensor until take()]
  pt.sync               one blocking host sync (host_sync) [site:
                        chunk_live, copy or gbuffer]
  pt.film               film.accumulate / accumulate_many
  pt.kernel_load        cuda_build.load's build and dlopen of one library
                        [lib, built: whether nvcc ran]; recorded whether
                        tracing is on or off, since it runs once per
                        library per process
"""

from __future__ import annotations

import itertools
import time

import torch

LAUNCHES = {"tile_cull": 0, "tile_cull_skip": 0, "sweep_closest": 0,
            "sweep_occluded": 0, "sweep_occluded_blocker": 0,
            "bvh_closest": 0, "bvh_occluded": 0, "chain_f32": 0,
            "chain_bf16": 0, "cond_walk": 0, "cond_walk_gated": 0,
            "sweep_attrib": 0, "pcg4d": 0, "shade": 0, "shade_resolve": 0}
COUNTERS = {"host_syncs": 0, "shade_kernel": 0, "shade_plain": 0}
SPANS = []              # recorded spans, oldest first, until take()

_on = False
_open = []              # the open spans, innermost last
_ids = itertools.count(1)


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def enabled() -> bool:
    """Whether span sites record (a site that would compute an attribute
    only for its span asks first)."""
    return _on


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


class Span:
    """A recorded span; `with Span(name, attrs)` records it whatever the
    switch says (span() is the site that honours it)."""

    __slots__ = ("name", "attrs", "id", "parent", "step", "start_ns",
                 "end_ns", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.id = next(_ids)
        self.end_ns = None

    def set(self, **attrs):
        self.attrs.update(attrs)

    def __enter__(self):
        outer = _open[-1] if _open else None
        self.parent = outer.id if outer else None
        self.step = outer.step if outer else self.id
        _open.append(self)
        SPANS.append(self)
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _open.remove(self)
        return False

    def as_dict(self) -> dict:
        attrs = {k: v.item() if isinstance(v, torch.Tensor) else v
                 for k, v in self.attrs.items()}
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "step": self.step, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "attrs": attrs}


class _Off:
    """The shared span of every site while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


def span(name: str, **attrs):
    """A span of `name` around a `with` block: recorded while tracing is
    on, the shared no-op span while it is off."""
    if not _on:
        return _OFF
    return Span(name, attrs)


def host_sync(site: str):
    """Count one blocking host sync (COUNTERS["host_syncs"]) and span it
    (pt.sync, attribute site): `with host_sync(site):` around the
    statement that waits."""
    COUNTERS["host_syncs"] += 1
    return span("pt.sync", site=site)


def device_tensor(data, device, dtype=None):
    """`data` as a tensor on `device`. A tensor goes through
    torch.as_tensor; host data (numbers, lists, numpy arrays) is copied,
    and the copy is counted and spanned as a host sync: PyTorch copies
    pageable host memory to a CUDA device synchronously, the host waiting
    until the device's stream has drained. It counts on every device, so
    a CPU run counts the syncs a card's run makes."""
    if isinstance(data, torch.Tensor):
        return torch.as_tensor(data, dtype=dtype, device=device)
    with host_sync("copy"):
        return torch.tensor(data, dtype=dtype, device=device)


def take() -> list:
    """The recorded spans as dicts (name, id, parent, step, start_ns,
    end_ns - None while open - and attrs), oldest first; forgets them.
    An attribute the device holds (a tensor: pt.sweep.closest's
    `resumed` on the card) becomes its Python number here, a read that
    waits for the device; steps take nothing, so it falls after their
    last sync. Until then each such attribute keeps its buffer alive
    (K2's resume list, tiles + 3 words a call)."""
    out = [s.as_dict() for s in SPANS]
    SPANS.clear()
    return out
