"""pathtracer_torch.tracing: the span tree of a Renderer.step, the
host_syncs counter, and what a span site costs while tracing is off.

The file imports neither jax nor the JAX package. Its `cuda` test, which
holds host_syncs to torch's sync debug mode on a headline-shaped step,
runs on a card with:

    python -m pytest tests/test_torch_tracing.py -m cuda --noconftest -q
"""

import collections
import traceback
import warnings

import pytest
import torch

from pathtracer_torch import kernels, tracing
from pathtracer_torch.accel.cluster import build_scene_clusters
from pathtracer_torch.accel.lbvh import build_scene_bvh
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.integrator.camera import Camera
from pathtracer_torch.render import Renderer
from pathtracer_torch.scene import procedural

BOX_CAM = ((0.5, 0.5, 2.2), (0.5, 0.5, 0.0))
SPONZA_CAM = ((3.0, 4.5, 6.0), (14.0, 3.0, 6.0))
TRAVERSE = ("pt.traverse.closest", "pt.traverse.occluded")
# RenderConfig fields of the runs below, by the loop they take
LOOPS = {"pool": dict(spp=2, spp_batch=True),
         "frame_batch": dict(spp=1, spp_batch=True, frame_batch=2),
         "per_sample": dict(spp=2, spp_batch=False)}


def _camera(spec):
    cam = Camera(position=spec[0])
    cam.look_at(spec[1])
    return cam


@pytest.fixture(scope="module")
def box():
    """Cornell box with two spheres: 2,572 triangles, on the cluster
    route, with an emitter for NEE."""
    return build_scene_clusters(procedural.cornell_box(spheres=True)
                                .finalize(device="cpu"))


@pytest.fixture(autouse=True)
def _one_thread(request):
    """The CPU tests' small renders on one thread: the suite runs several
    workers at once, and short ops spread over every core by each of
    them oversubscribe the machine."""
    n = torch.get_num_threads()
    if request.node.get_closest_marker("cuda") is None:
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


def _renderer(scene, route="cluster", **fields):
    cfg = RenderConfig(**dict(dict(width=16, height=16, max_depth=4,
                                   intersector=route), **fields))
    return Renderer(scene, cfg, _camera(BOX_CAM), device="cpu")


def _traced_step(r):
    tracing.enable()
    try:
        r.step()
    finally:
        tracing.disable()
    return tracing.take()


def _ancestors(span, by_id):
    out = []
    while span["parent"] is not None:
        span = by_id[span["parent"]]
        out.append(span["name"])
    return out


def _wavefronts(cfg):
    return 1 if cfg.spp_batch or cfg.frame_batch > 1 else cfg.spp


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_step_records_the_span_tree(box, loop):
    r = _renderer(box, **LOOPS[loop])
    spans = _traced_step(r)
    by_id = {s["id"]: s for s in spans}
    steps = [s for s in spans if s["name"] == "pt.step"]
    assert len(steps) == 1 and steps[0]["parent"] is None
    assert steps[0]["attrs"] == {"frames": r.cfg.frame_batch}
    assert {s["step"] for s in spans} == {steps[0]["id"]}
    names = {s["name"] for s in spans}
    assert names == {"pt.step", "pt.wavefront", "pt.bounce", "pt.film",
                     "pt.sort", "pt.chunk", "pt.sync", *TRAVERSE}
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]
        up = _ancestors(s, by_id)
        if s["name"] in ("pt.chunk", "pt.sort") or s["attrs"] == {
                "site": "chunk_live"}:
            assert any(a in TRAVERSE for a in up), (s, up)
        if s["name"] in TRAVERSE:
            assert up[0] == "pt.bounce" and "pt.wavefront" in up, up
        if s["name"] == "pt.bounce":
            assert up == ["pt.wavefront", "pt.step"]
        if s["name"] == "pt.film":
            assert up == ["pt.step"]
    depths = [s["attrs"]["depth"] for s in spans if s["name"] == "pt.bounce"]
    assert depths == list(range(r.cfg.max_depth)) * _wavefronts(r.cfg)


def _syncs(spans, site):
    return sum(s["name"] == "pt.sync" and s["attrs"]["site"] == site
               for s in spans)


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_host_syncs_count_one_a_traversal_call(box, loop):
    """Every closest call (max_depth a wavefront) and every NEE shadow
    call (one a bounce but the last segment) reads chunk_live's flags
    once; the other syncs are copies of host data. Off, the counter
    rises as on and nothing is recorded."""
    r = _renderer(box, **LOOPS[loop])
    before = tracing.COUNTERS["host_syncs"]
    r.step()
    off = tracing.COUNTERS["host_syncs"] - before
    assert tracing.SPANS == []
    r.reset()
    before = tracing.COUNTERS["host_syncs"]
    spans = _traced_step(r)
    assert tracing.COUNTERS["host_syncs"] - before == off
    calls = (2 * r.cfg.max_depth - 1) * _wavefronts(r.cfg)
    assert sum(s["name"] in TRAVERSE for s in spans) == calls
    assert _syncs(spans, "chunk_live") == calls
    assert _syncs(spans, "chunk_live") + _syncs(spans, "copy") == off


@pytest.mark.parametrize("route", ["brute", "bvh"])
def test_other_routes_open_the_traversal_spans(route):
    scene = procedural.cornell_box().finalize(device="cpu")
    if route == "bvh":
        scene = build_scene_bvh(scene)
    r = _renderer(scene, route, spp=1, max_depth=3)
    before = tracing.COUNTERS["host_syncs"]
    spans = _traced_step(r)
    names = [s["name"] for s in spans]
    assert names.count("pt.traverse.closest") == 3
    assert names.count("pt.traverse.occluded") == 2
    assert "pt.chunk" not in names and _syncs(spans, "chunk_live") == 0
    assert tracing.COUNTERS["host_syncs"] - before == names.count("pt.sync")


def test_off_opens_no_record_function_and_records_nothing(box, monkeypatch):
    """Off, even under a recording profiler: no record_function is opened
    (it is patched to raise), no span is kept, and the profiler sees the
    same ops as on a traced step of the same frame."""
    r = _renderer(box, spp=1, width=8, height=8, max_depth=2)

    def ops(prof):
        return [e.name for e in prof.events() if not e.name.startswith("pt.")]

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as on:
        _traced_step(r)

    def refuse(*a, **kw):
        raise AssertionError("record_function opened while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as off:
        r.reset()
        r.step()
    assert tracing.SPANS == [] and not tracing._on
    assert not any(e.name.startswith("pt.") for e in off.events())
    assert sorted(ops(off)) == sorted(ops(on))
    assert tracing.span("pt.step") is tracing.span("pt.bounce", depth=1)


def test_spans_reach_the_profiler_timeline(box):
    r = _renderer(box, spp=1, width=8, height=8, max_depth=2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        spans = _traced_step(r)
    ranges = [e for e in prof.events() if e.name.startswith("pt.")]
    assert sorted(e.name for e in ranges) == sorted(s["name"] for s in spans)


def test_launch_table_is_tracings():
    assert kernels.LAUNCHES is tracing.LAUNCHES
    assert kernels.reset_launch_counts is tracing.reset_launch_counts
    saved = dict(tracing.LAUNCHES)
    tracing.LAUNCHES["tile_cull"] += 3
    kernels.reset_launch_counts()
    assert set(kernels.LAUNCHES.values()) == {0}
    tracing.LAUNCHES.update(saved)


def test_spans_nest_and_take_forgets():
    tracing.enable()
    with tracing.span("a") as a:
        a.set(k=1)
        with tracing.span("b"):
            pass
    with tracing.Span("c", {}):
        pass
    tracing.disable()
    with tracing.Span("always", {}):
        with tracing.span("dropped"):
            pass
    a, b, c, always = tracing.take()
    assert (a["parent"], b["parent"], c["parent"]) == (None, a["id"], None)
    assert (a["step"], b["step"], c["step"]) == (a["id"], a["id"], c["id"])
    assert a["attrs"] == {"k": 1} and always["name"] == "always"
    assert tracing.take() == []


def _site(stack):
    """The innermost frames of pathtracer_torch in a stack (else of the
    whole stack, the recorder's own left out), as text."""
    own = [f for f in stack if "pathtracer_torch" in f.filename]
    return " <- ".join(f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno}"
                       for f in reversed((own or stack[:-2])[-3:]))


@pytest.mark.cuda
def test_host_syncs_equal_the_sync_debug_warnings():
    """One headline-shaped step (textured sponza_like(262k), 1920x1080,
    4 spp, depth 6, one wavefront) under torch's sync debug mode: each
    synchronizing CUDA call warns, and host_syncs must rise by as many.
    The sites print on stdout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = build_scene_clusters(procedural.sponza_like(
        262_000, textured=True).finalize(device="cpu"))
    cfg = RenderConfig(width=1920, height=1080, spp=4, max_depth=6,
                       spp_batch=True)
    r = Renderer(scene, cfg, _camera(SPONZA_CAM), device="cuda")
    r.step()
    torch.cuda.synchronize()
    sites = collections.Counter()

    def record(message, *a, **kw):
        if "called a synchronizing CUDA operation" in str(message):
            sites[_site(traceback.extract_stack())] += 1

    before = tracing.COUNTERS["host_syncs"]
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")   # which itself warns
        warnings.showwarning = record
        try:
            r.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counted = tracing.COUNTERS["host_syncs"] - before
    print("host_syncs", counted, "sync warnings", sum(sites.values()))
    for site, n in sites.most_common():
        print(f"{n:5d}  {site}")
    assert sum(sites.values()) >= 2 * cfg.max_depth - 1   # chunk_live's
    assert counted == sum(sites.values()), sites
