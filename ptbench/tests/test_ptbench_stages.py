"""ptbench.stages on a synthetic trace with known spans, launches,
kernels and gaps; the readers of its metrics; and ptbench.trace's keys
unchanged by the program's ranges."""

from __future__ import annotations

import pytest
import torch

from ptbench import run, spec, stages, trace

HAND = {"tile_cull_kernel"}
READERS = ("integrator_ms_per_frame", "packet_ms_per_frame",
           "packet_idle_ms_per_frame", "host_syncs_per_frame",
           "host_busy_ms_per_frame", "kernel_load_s")


class _Event:
    def __init__(self, name, start, end, cuda=False, id=0):
        self.name = name
        self.id = id
        self.time_range = type("R", (), {"start": start, "end": end})()
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)


# the program's ranges on the host, in us
SPANS = [("pt.step", 0, 100), ("pt.wavefront", 1, 90), ("pt.bounce", 2, 60),
         ("pt.traverse.closest", 10, 40), ("pt.sort", 11, 15),
         ("pt.sync", 16, 25), ("pt.chunk", 26, 35), ("pt.film", 91, 95)]
# (launch time on the host, kernel, device start, device end, id)
KERNELS = [(2.5, "void at::native::vectorized_elementwise_kernel<4>()",
            3, 8, 1),                                    # integrator
           (12, "void at::native::radixSortKVInPlace<2>()", 18, 25, 2),
           (27, "(anonymous namespace)::tile_cull_kernel(float const*)",
            30, 40, 3),                                  # hand-written
           (28, "void at::native::CatArrayBatchedCopy<4>()", 40, 42, 4),
           (92, "void at::native::elementwise_kernel<128, 4>()", 93, 96,
            5),                                          # film
           (95.5, "void at::native::fill_kernel<4>()", 96, 97, 6),
           (150, "Memcpy HtoD (Pageable -> Device)", 152, 156, 7)]


def synthetic(with_spans=True):
    ev = [_Event("ptbench.step", 0, 101), _Event("ptbench.step", 0, 101,
                                                 True)]
    if with_spans:
        for name, a, b in SPANS:
            ev.append(_Event(name, a, b))
            ev.append(_Event(name, a + 1, b + 1, cuda=True))  # its image
    for t, name, a, b, i in KERNELS:
        ev.append(_Event("cudaLaunchKernel", t, t + 0.2, id=i))
        ev.append(_Event(name, a, b, cuda=True, id=i))
    ev.append(_Event("void unlinked_kernel()", 97, 99, cuda=True, id=99))
    return ev


def test_device_time_by_bucket_and_idle_under_traversal():
    out = stages.read(synthetic(), HAND)
    us = 1e-6
    assert out["integrator_s"] == pytest.approx(8 * us)    # 5 + 3
    assert out["packet_s"] == pytest.approx(9 * us)        # sort 7, cat 2
    assert out["handwritten_s"] == pytest.approx(10 * us)
    assert out["step_self_s"] == pytest.approx(1 * us)
    assert out["outside_s"] == pytest.approx(4 * us)
    assert out["unlinked_s"] == pytest.approx(2 * us)
    assert out["device_s"] == pytest.approx(34 * us)
    # gaps 8-18 (midpoint 13 in pt.sort), 25-30 (27.5 in pt.chunk),
    # 42-93 (67.5 in pt.wavefront), 99-152 (outside every span)
    assert out["packet_idle_s"] == pytest.approx(15 * us)
    assert out["idle_by_span"] == {
        "pt.sort": pytest.approx(10 * us), "pt.chunk": pytest.approx(5 * us),
        "pt.wavefront": pytest.approx(51 * us),
        "(none)": pytest.approx(53 * us)}
    assert stages.unaccounted_share(out) == pytest.approx(6 / 34)


def test_trace_keys_unchanged_by_the_programs_ranges():
    """The pt.* ranges and their device images leave every key of
    trace.read as it is but the names of the idle gaps."""
    with_spans = trace.read(synthetic(True), HAND, 1e-3)
    without = trace.read(synthetic(False), HAND, 1e-3)
    for key in ("busy_s", "window_s", "by_kind", "device_ops"):
        assert with_spans[key] == without[key], key
    lengths = [round(s, 12) for _, s in with_spans["idle_gaps"]]
    assert lengths == [round(s, 12) for _, s in without["idle_gaps"]]
    assert [n for n, _ in with_spans["idle_gaps"]] == [
        "(no host event)", "pt.wavefront", "pt.sort", "pt.chunk"]


def test_window_and_kernel_loads_from_spans():
    def span(name, id, step, a, b):
        return {"name": name, "id": id, "step": step, "parent": None,
                "start_ns": a, "end_ns": b, "attrs": {}}

    spans = [span("pt.kernel_load", 1, 1, 0, 2_000_000_000),
             span("pt.step", 2, 2, 0, 1_000_000), span("pt.sync", 3, 2,
                                                        10, 300_010),
             span("pt.sync", 4, 4, 0, 5_000),             # outside a step
             span("pt.step", 5, 5, 0, 500_000)]
    assert stages.window(spans, 7) == {"host_syncs": 7,
                                       "host_busy_s": pytest.approx(1.2e-3)}
    assert stages.kernel_load_s(spans) == pytest.approx(2.0)


def test_readers_read_the_record_or_return_none():
    rec = run.Record()
    assert all(spec.reader(m)(rec) is None for m in READERS)
    rec.profile = {"frames": 2, "busy_s": 1.0}          # a run before them
    assert all(spec.reader(m)(rec) is None for m in READERS)
    rec.frames = 4
    rec.spans["kernel_load"] = 1.5
    rec.tracing = {"host_syncs": 44, "host_busy_s": 2.0}
    rec.profile.update(integrator_s=0.5, packet_s=0.25, packet_idle_s=0.125)
    got = {m: spec.reader(m)(rec) for m in READERS}
    assert got == {"integrator_ms_per_frame": 250.0,
                   "packet_ms_per_frame": 125.0,
                   "packet_idle_ms_per_frame": 62.5,
                   "host_syncs_per_frame": 11.0,
                   "host_busy_ms_per_frame": 500.0, "kernel_load_s": 1.5}
