"""ptbench.stages on a synthetic trace with known spans, launches,
kernels and gaps; the readers of its metrics; ptbench.trace's keys
unchanged by the program's ranges; a span that no module of ptbench
names read by one new reader; and the traced window's record from a
stub driver."""

from __future__ import annotations

import types

import pytest
import torch

from ptbench import metrics, run, spec, stages, trace

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


# a span no module of ptbench names: around the traversal, and innermost
# around the film's first launch
EXAMPLE = [("pt.example", 9, 45), ("pt.example", 91.5, 94)]
EXAMPLE_ATTRS = [{"pixels": 64, "iterations": 5}, {"pixels": 32}]


def synthetic(with_spans=True, example=False):
    ev = [_Event("ptbench.step", 0, 101), _Event("ptbench.step", 0, 101,
                                                 True)]
    if with_spans:
        for name, a, b in SPANS + (EXAMPLE if example else []):
            ev.append(_Event(name, a, b))
            ev.append(_Event(name, a + 1, b + 1, cuda=True))  # its image
    for t, name, a, b, i in KERNELS:
        ev.append(_Event("cudaLaunchKernel", t, t + 0.2, id=i))
        ev.append(_Event(name, a, b, cuda=True, id=i))
    ev.append(_Event("void unlinked_kernel()", 97, 99, cuda=True, id=99))
    return ev


def example_spans():
    """tracing.take() of the synthetic steps: the example's two spans
    among the others."""
    return [{"name": "pt.step", "attrs": {"frames": 1}}] + [
        {"name": "pt.example", "attrs": a} for a in EXAMPLE_ATTRS]


@pytest.mark.parametrize("example", [False, True])
def test_device_time_by_bucket_and_idle_under_traversal(example):
    """The fixed buckets read the same with a span they do not know."""
    out = stages.read(synthetic(example=example), HAND,
                      example_spans() if example else ())
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
    # the longest gaps, by the innermost span and the host event there
    assert [[n, round(sec / us, 6)] for n, sec in out["idle_gaps_by_span"]
            ] == [["(none)", 53], ["pt.wavefront/ptbench.step", 51],
                  ["pt.sort/ptbench.step", 10], ["pt.chunk/ptbench.step", 5]]
    assert ("pt.example" in out["by_span"]) is example


def test_a_span_no_module_names_is_read_by_name():
    """pt.example: the device seconds of the ops launched with it on the
    stack (the sort, K1 and the cat under the traversal, the film's
    first kernel) and innermost (that kernel alone), the idle it spans
    and its spans' attributes. (Its count and host seconds are the
    window's: test_window_record_from_a_stub_driver.)"""
    us = 1e-6
    row = stages.read(synthetic(example=True), HAND,
                      example_spans())["by_span"]["pt.example"]
    assert row == {"device_s": pytest.approx(22 * us),
                   "self_device_s": pytest.approx(3 * us),
                   "idle_s": pytest.approx(15 * us),
                   "attrs": EXAMPLE_ATTRS}
    by_span = stages.read(synthetic(), HAND)["by_span"]
    assert set(by_span) == {name for name, _, _ in SPANS}
    assert by_span["pt.traverse.closest"]["device_s"] == \
        pytest.approx(19 * us)
    assert by_span["pt.step"]["self_device_s"] == pytest.approx(1 * us)


def test_a_new_spans_metric_is_one_new_reader(tmp_path, monkeypatch):
    """A reader in a module of its own, found by its name and reading
    only the record, gives pt.example's device ms a frame."""
    (tmp_path / "example_ms_per_frame.py").write_text(
        "def read(rec):\n"
        "    p = rec.profile\n"
        "    row = p and p['by_span'].get('pt.example')\n"
        "    if not row or not p['frames']:\n"
        "        return None\n"
        "    return 1e3 * row['device_s'] / p['frames']\n")
    monkeypatch.setattr(metrics, "__path__",
                        list(metrics.__path__) + [str(tmp_path)])
    read = spec.reader("example_ms_per_frame.scope")
    rec = run.Record()
    assert read(rec) is None
    rec.profile = dict(stages.read(synthetic(example=True), HAND,
                                   example_spans()), frames=2)
    assert read(rec) == pytest.approx(22e-6 * 1e3 / 2)


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
    assert stages.host_spans(spans) == {
        "pt.kernel_load": {"count": 1, "host_s": pytest.approx(2.0)},
        "pt.step": {"count": 2, "host_s": pytest.approx(1.5e-3)},
        "pt.sync": {"count": 2, "host_s": pytest.approx(3.05e-4)}}


def test_readers_read_the_record_or_return_none():
    rec = run.Record()
    assert all(spec.reader(m)(rec) is None for m in READERS)
    rec.frames = 4
    rec.spans["kernel_load"] = 1.5
    rec.tracing = {"host_syncs": 44, "host_busy_s": 2.0}
    # a pass with no device op (a CPU run) gives no device reading
    rec.profile = {"frames": 2, "busy_s": 0.0, "device_s": 0.0,
                   "integrator_s": 0.0, "packet_s": 0.0,
                   "packet_idle_s": 0.0}
    assert [m for m in READERS if spec.reader(m)(rec) is None] == list(
        READERS[:3])
    rec.profile.update(busy_s=1.0, device_s=1.0, integrator_s=0.5,
                       packet_s=0.25, packet_idle_s=0.125)
    got = {m: spec.reader(m)(rec) for m in READERS}
    assert got == {"integrator_ms_per_frame": 250.0,
                   "packet_ms_per_frame": 125.0,
                   "packet_idle_ms_per_frame": 62.5,
                   "host_syncs_per_frame": 11.0,
                   "host_busy_ms_per_frame": 500.0, "kernel_load_s": 1.5}


class StubDriver:
    """Steps that open pt.step and pt.example and make one host sync;
    spans of the driver's own."""

    def __init__(self):
        self.r = types.SimpleNamespace(last_rays=10)
        self.n = 0
        self.spans = {"readback": []}

    def step(self):
        from pathtracer_torch import tracing

        with tracing.span("pt.step"):
            with tracing.span("pt.example", pixels=4):
                with tracing.host_sync("stub"):
                    pass
        self.n += 2
        self.spans["readback"].append(0.25)

    def frames(self):
        return self.n


@pytest.mark.parametrize("traced", [False, True])
def test_window_record_from_a_stub_driver(traced):
    """Traced, the window's host syncs, span counts and host seconds and
    counter rises land in Record.tracing, and tracing is off again
    after it; untraced, nothing is recorded. The driver's own spans are
    copied either way."""
    from pathtracer_torch import tracing

    tracing.take()
    rec, driver = run.Record(), StubDriver()
    run.window(driver, 0.01, rec, types.SimpleNamespace(on=False), traced)
    assert rec.steps >= 1 and rec.frames == 2 * rec.steps
    assert rec.spans["driver.readback"] == [0.25] * rec.steps
    assert tracing.span("pt.after") is tracing.span("pt.after2")  # off
    assert tracing.take() == []
    if not traced:
        assert rec.tracing is None and rec.rays is None
        return
    t = rec.tracing
    assert t["host_syncs"] == rec.steps
    assert t["counters"] == {"host_syncs": rec.steps}
    assert {n: row["count"] for n, row in t["spans"].items()} == {
        "pt.step": rec.steps, "pt.example": rec.steps, "pt.sync": rec.steps}
    assert 0 < t["spans"]["pt.example"]["host_s"] <= \
        t["spans"]["pt.step"]["host_s"] < rec.window_s
    assert 0 < t["host_busy_s"] <= t["spans"]["pt.step"]["host_s"]
    assert spec.reader("host_syncs_per_frame")(rec) == 0.5
    assert rec.rays == 10 * rec.steps
