"""The work counts, the reference's pieces and the trace arithmetic."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ptbench import checks, trace
from ptbench.reference import brute, rng
from ptbench.roofline import k2


def one_ray_chunk(t_end):
    """One tile of 32 rays, only ray 0 live, along +x from the origin;
    three clusters at x in [1,2], [3,4] and [10,11] holding 5, 7 and 9
    real triangles."""
    r = 32
    rays = torch.zeros((1, 6, r))
    rays[0, 0, 1:] = 1e30
    rays[0, 3, :] = 1.0
    lo = torch.tensor([[1.0, -1, -1], [3.0, -1, -1], [10.0, -1, -1]])
    hi = lo + torch.tensor([1.0, 2, 2])
    n_real = torch.tensor([5, 7, 9])
    te = torch.full((1, r), t_end)
    st = torch.zeros((1, 3))
    return k2.chunk_work(st, st.int(), rays, te, lo, hi, n_real, te, 1e-3)


def test_k2_counts_the_clusters_entered_before_the_hit():
    f, b = one_ray_chunk(3.5)
    assert f == (5 + 7) * k2.FLOPS_PER_TEST
    assert b == k2.RAY_BYTES + 2 * k2.SCHED_BYTES + 12 * k2.TRI_BYTES
    f, _ = one_ray_chunk(100.0)
    assert f == 21 * k2.FLOPS_PER_TEST


def test_pcg4d_draws_match_the_program():
    from pathtracer_torch.sampling import rng as prog

    pix = torch.arange(0, 5000, 7)
    samp = torch.arange(pix.shape[0]) * 3
    for depth, salt in ((0, 0), (3, 8), (5, 11)):
        a = rng.uniform4(pix, samp, depth, salt, 2**31 + 9, torch.float32)
        b = prog.uniform4(pix, samp, depth, salt, 2**31 + 9)
        assert torch.equal(a, b)


def test_brute_queries_on_a_quad():
    from ptbench.reference.tables import _bw_rows

    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    bw = torch.from_numpy(_bw_rows(v[[0, 0]], v[[1, 2]], v[[2, 3]]))
    o = torch.tensor([[0.25, 0.5, 1.0], [0.75, 0.25, 1.0], [2.0, 2.0, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]] * 3)
    t, tri, _, _ = brute.closest(bw, o, d, 1e-3, 1e20)
    assert torch.equal(tri, torch.tensor([1, 0, -1]))
    assert torch.allclose(t[:2], torch.tensor([1.0, 1.0]))
    # the quad's normal is +z: rays from +z meet its front and are
    # blocked, rays from below meet its back and are not
    assert brute.occluded(bw, o, d, 5.0).tolist() == [True, True, False]
    assert not brute.occluded(bw, o * torch.tensor([1, 1, -1.0]), -d,
                              5.0).any()


def test_pixel_errors_and_verdict():
    ref = torch.tensor([[1.0, 1.0, 1.0], [0.5, 0.5, 0.5]], dtype=torch.float64)
    e = checks.pixel_errors(np.array([[1.0, 1.0, 1.0], [0.6, 0.5, 0.5]]), ref)
    assert e[0] == 0 and e[1] > checks.PIX_REL
    traffic = {"min_lanes_per_step": {"closest": 10, "occluded": 5}}
    good = {"closest_bad_pct": 0.0, "occluded_bad_pct": 0.0,
            "image_bad_pct": 0.0, "closest_lanes_per_step": 10.0,
            "occluded_lanes_per_step": 7.5}
    ok, rows = checks.verdict(good, traffic)
    assert ok and rows["image_bad_pct"]["limit"] == checks.LIMITS[
        "image_bad_pct"]
    assert rows["closest_lanes_per_step"] == {"value": 10.0, "limit": 10,
                                              "at_least": True}
    assert rows["image_bad_pct"]["at_least"] is False
    for name, bad in (("image_bad_pct", float("nan")),
                      ("image_bad_pct", 10.5),
                      ("occluded_lanes_per_step", 4.9),
                      ("closest_lanes_per_step", 0.0)):
        ok, _ = checks.verdict(dict(good, **{name: bad}), traffic)
        assert not ok, name


def test_union_of_intervals():
    assert trace.union_s([(0, 2e6), (1e6, 3e6), (5e6, 6e6)]) == \
        pytest.approx(4.0)


def test_kernel_kinds_from_the_program_sources():
    import os

    import pathtracer_torch

    hand = trace.handwritten_names(os.path.dirname(pathtracer_torch.__file__))
    assert {"tile_cull_kernel", "sweep_closest_kernel",
            "sweep_occluded_kernel"} <= hand
    assert trace.kind_of("void sweep_closest_kernel<4>(float const*)",
                         hand) == "handwritten"
    # as the card's profiler names them
    assert trace.kind_of("void (anonymous namespace)::sweep_closest_kernel"
                         "<4>(float const*, int const*, int)",
                         hand) == "handwritten"
    assert trace.kind_of("(anonymous namespace)::tile_cull_kernel(float "
                         "const*, float const*, float, int)",
                         hand) == "handwritten"
    assert trace.kind_of("void at_cuda_detail::cub::DeviceRadixSortOnesweep"
                         "Kernel<int>()", hand) == "sort"
    assert trace.kind_of("void at::native::elementwise_kernel<128, 4>()",
                         hand) == "torch"
    assert trace.kind_of("Memcpy HtoD (Pageable -> Device)", hand) == "copy"


class _Event:
    def __init__(self, name, start, end, cuda):
        import torch

        self.name = name
        self.time_range = type("R", (), {"start": start, "end": end})()
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)


def test_trace_leaves_out_host_ranges_on_the_device_timeline():
    ev = [_Event("ptbench.step", 0, 10e6, False),
          _Event("ptbench.step", 0, 10e6, True),
          _Event("void sweep_closest_kernel<4>()", 1e6, 3e6, True),
          _Event("void at::native::elementwise_kernel<4>()", 5e6, 6e6, True),
          _Event("aten::add", 3.5e6, 4.5e6, False)]
    out = trace.read(ev, {"sweep_closest_kernel"}, 10.0)
    assert out["busy_s"] == pytest.approx(3.0)
    assert out["by_kind"]["handwritten"] == pytest.approx(2.0)
    assert out["by_kind"]["torch"] == pytest.approx(1.0)
    assert [n for n, _ in out["device_ops"]] == [
        "void sweep_closest_kernel<4>()",
        "void at::native::elementwise_kernel<4>()"]
    assert out["idle_gaps"][0] == ["aten::add", pytest.approx(2.0)]
