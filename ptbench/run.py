"""One run of one cell: set up, warm up, measure, compare, print one line.

    python3 -m ptbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Every run is one process on one card. It clears every PT_* variable
(the program's knobs run at their defaults), points the Triton cache at
a fixed directory under ptbench/.cache/ (the program's nvcc libraries
stay in its own pathtracer_torch/_build/), generates the cell's scene
(ptbench.scenes) and hands it to the program as arrays through
SceneBuilder, builds the accel that the configuration's intersector
uses and moves the scene to the card (build_accel), and constructs
pathtracer_torch.render.Renderer as the CLI does. The cell's
driver (ptbench/drivers/<driver>.py, named by the traffic mix) runs its
warm-up steps (set-up ends there; the program's pt.kernel_load spans of
set-up are read then) and then whole steps until --seconds have passed,
the step in flight finishing. --trace 1 turns the program's tracing
(pathtracer_torch.tracing) on across the window, then profiles a few
more steps with it on (device time by kind and idle: ptbench.trace; by
the program's spans: ptbench.stages), and replays a sample of K2's
chunks; --trace 0 leaves tracing off. Then the program's state is
freed and the plain reference (ptbench.reference) judges what the
window produced (ptbench.checks). The last line on
stdout is the result; the last lines on stderr are the numbers
compared, each beside its limit. Without a CUDA card (or with fewer
than the cell asks for) it exits with 2 and prints no result; if jax,
jaxlib, flax or the JAX package is loaded after the window it exits
with 3.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

from ptbench import spec as spec_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "pathtracer")
CACHE_DIR = os.path.join(spec_mod.PKG_DIR, ".cache")


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


HOST_THREADS = 2


def prepare_environment(env=os.environ):
    """Port defaults, in-checkout caches and few host threads, before the
    port (or torch) is imported."""
    for k in [k for k in env if k.startswith("PT_")]:
        del env[k]
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        env[k] = str(HOST_THREADS)
    env["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Record:
    """What a run measured; the metric readers read it."""

    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0
    frames: int = 0
    step_s: list = dataclasses.field(default_factory=list)
    window_peak_bytes: int = 0
    peak_bytes: int = 0
    spans: dict = dataclasses.field(default_factory=dict)
    rays: int = None
    tracing: dict = None    # the traced window's spans and counters
    profile: dict = None    # the profiled steps, tracing on
    k2: dict = None


def build_accel(scene, intersector, device):
    """The scene on `device` with the accel its route traverses, built as
    the Renderer would build it: the cluster accel on the host, then the
    move ("cluster"); the move, then the LBVH on the device ("bvh"); the
    move alone ("brute")."""
    import torch

    if intersector == "cluster":
        from pathtracer_torch.accel.cluster import build_scene_clusters

        scene = build_scene_clusters(scene).to(device)
    elif intersector == "bvh":
        from pathtracer_torch.accel import lbvh

        scene = lbvh.build_scene_bvh(scene.to(device))
    elif intersector == "brute":
        scene = scene.to(device)
    else:
        raise ValueError(f"unknown intersector {intersector!r}: expected "
                         f"cluster, bvh or brute")
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return scene


def build_scene(cell, device, rec):
    """The cell's SceneSpec, and the program's scene with its accel on
    `device` (spans scene_build and accel_build)."""
    from pathtracer_torch.scene.build import MaterialDesc, SceneBuilder

    from ptbench import scenes

    sc = cell.config["scene"]
    spec = scenes.generate(sc["generator"], sc["args"])
    t0 = time.perf_counter()
    b = SceneBuilder()
    for m in spec.materials:
        b.add_material(MaterialDesc(**m))
    for t in spec.textures:
        b.add_texture(t)
    if spec.envmap is not None:
        b.set_envmap(spec.envmap)
    for m in spec.meshes:
        b.add_mesh(**m)
    scene = b.finalize(device="cpu")
    t1 = time.perf_counter()
    scene = build_accel(scene, cell.config["render"]["intersector"], device)
    rec.spans["scene_build"] = t1 - t0
    rec.spans["accel_build"] = time.perf_counter() - t1
    return spec, scene


def make_renderer(cell, scene, seed, device):
    from pathtracer_torch.config import RenderConfig
    from pathtracer_torch.integrator.camera import Camera
    from pathtracer_torch.render import Renderer

    cam = Camera(position=cell.config["camera"]["position"])
    cam.look_at(cell.config["camera"]["target"])
    return Renderer(scene, RenderConfig(**spec_mod.render_fields(cell, seed)),
                    cam, device=device)


def window(driver, seconds, rec, hits, trace=False):
    """Whole steps until `seconds` have passed, capturing hits; fills
    rec, and copies the driver's own spans into rec.spans as
    driver.<name>. With `trace`, the program's tracing is on across the
    steps: rec.rays, and rec.tracing from the window's spans and the
    rise of every counter (stages.window's keys, `spans` by name,
    `counters`)."""
    from pathtracer_torch import tracing

    from ptbench import stages

    rays = 0
    f0 = driver.frames()
    if trace:
        tracing.take()
        before = dict(tracing.COUNTERS)
        tracing.enable()
    hits.on = True
    t_w0 = time.perf_counter()
    k = 0
    while True:
        ta = time.perf_counter()
        driver.step()
        tb = time.perf_counter()
        rec.step_s.append(tb - ta)
        if trace:
            rays = rays + driver.r.last_rays
        k += 1
        if tb - t_w0 >= seconds:
            break
    hits.on = False
    rec.window_s = tb - t_w0
    rec.steps = k
    rec.frames = driver.frames() - f0
    if trace:
        tracing.disable()
        rise = {key: n - before.get(key, 0)
                for key, n in tracing.COUNTERS.items()}
        spans = tracing.take()
        rec.tracing = dict(stages.window(spans, rise["host_syncs"]),
                           spans=stages.host_spans(spans), counters=rise)
        rec.rays = int(rays)
    for name, secs in getattr(driver, "spans", {}).items():
        rec.spans[f"driver.{name}"] = list(secs)


def profile_steps(driver, n, device, handwritten):
    """torch.profiler over n more steps with the program's tracing on,
    its pt.* ranges on the profiler's timeline -> ptbench.trace.read's
    keys (trace.read passes over those ranges), ptbench.stages.read's
    with the attributes of the steps' spans, and the frames the steps
    completed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pathtracer_torch import tracing

    from ptbench import stages, trace

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    f0 = driver.frames()
    tracing.take()
    tracing.enable()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            driver.step()
        wall = time.perf_counter() - t0
    tracing.disable()
    events = prof.events()
    return dict(trace.read(events, handwritten, wall),
                frames=driver.frames() - f0,
                **stages.read(events, handwritten, tracing.take()))


def power_limit():
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def outputs(driver, hits, steps, seed):
    """What the window produced, for the reference: the captured hits,
    the window's steps, the benchmark's camera and the driver's own
    outputs."""
    return {"hits": hits.gathered(), "steps": steps,
            "camera": driver.camera, **driver.outputs(seed)}


def judge(cell, spec, seed, produced, device):
    """The numbers compared, from what the window produced. Returns
    (numbers, diagnostics)."""
    import torch

    from ptbench import checks, drivers
    from ptbench.reference import tables

    tb = tables.build(spec, device=device)
    numbers, diag = {}, {}
    cap = produced["hits"]
    for kind, fn in (("closest", checks.closest_bad),
                     ("occluded", checks.occluded_bad)):
        flags = fn(tb, cap[kind]) if cap[kind] is not None else \
            torch.zeros(0, dtype=torch.bool)
        numbers[f"{kind}_bad_pct"] = checks.pct(flags)
        numbers[f"{kind}_lanes_per_step"] = \
            int(flags.numel()) / max(1, produced["steps"])
        diag[f"{kind}_lanes"] = int(flags.numel())
    mod = drivers.module(cell.traffic["driver"])
    errs = mod.errors(produced, mod.reference(tb, cell, seed, produced))
    numbers["image_bad_pct"] = checks.pct(errs > checks.PIX_REL)
    diag["image_err"] = checks.summary(errs)
    return numbers, diag


def run(cell, seed, seconds, trace, device, out=sys.stdout, start=None):
    """One run of `cell`; prints the result line to `out` and returns it
    (None when the run may not report)."""
    start = time.perf_counter() if start is None else start
    prepare_environment()
    import torch

    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        torch.set_num_threads(HOST_THREADS)
    if is_cuda and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < cell.chips):
        log(f"ptbench: {cell.name} needs {cell.chips} CUDA device(s); "
            f"available: {torch.cuda.is_available()}, "
            f"count: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return None
    from pathtracer_torch import knobs, tracing
    # loaded before set-up's spans open, so that accel_build times the
    # build and no import: packet (and the cluster accel) and the LBVH
    from pathtracer_torch.accel import lbvh  # noqa: F401
    from pathtracer_torch.kernels import LAUNCHES, packet, sweep  # noqa: F401

    from ptbench import capture, checks, drivers, stages
    from ptbench import trace as trace_mod

    log("knobs", json.dumps({k: [state, os.environ.get(k)]
                             for k, (state, _) in knobs.KNOBS.items()}))

    def sync():
        if is_cuda:
            torch.cuda.synchronize()

    rec = Record()
    t_imports = time.perf_counter() - start
    spec, scene = build_scene(cell, device, rec)
    r = make_renderer(cell, scene, seed, device)
    driver = drivers.make(r, cell, seed, sync)
    t_warm = time.perf_counter()
    for _ in range(cell.traffic["warmup_steps"]):
        driver.step()
    rec.spans["warmup"] = time.perf_counter() - t_warm
    rec.spans["imports"] = t_imports
    sync()
    rec.setup_s = time.perf_counter() - start
    rec.spans["kernel_load"] = stages.kernel_load_s(tracing.take())
    getattr(driver, "spans", {}).clear()
    if is_cuda:
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    for k in LAUNCHES:
        LAUNCHES[k] = 0

    with capture.HitCapture(cell.traffic["hit_rays_per_call"],
                            seed) as hits:
        window(driver, seconds, rec, hits, trace=bool(trace))
    launches = {k: v for k, v in LAUNCHES.items() if v}
    if is_cuda:
        rec.window_peak_bytes = torch.cuda.max_memory_allocated()
    log("setup_s", rec.setup_s, json.dumps(rec.spans))
    log(f"window steps {rec.steps} frames {rec.frames} "
        f"seconds {rec.window_s} samples {len(rec.step_s)}")
    log("launches", json.dumps(launches))
    log("step_s", json.dumps(rec.step_s))

    if trace:
        hand = trace_mod.handwritten_names(os.path.dirname(
            os.path.abspath(sys.modules["pathtracer_torch"].__file__)))
        t0 = time.perf_counter()
        rec.profile = profile_steps(driver, cell.traffic["trace_steps"],
                                    device, hand)
        log("profiled seconds", time.perf_counter() - t0)
        log("tracing", json.dumps(rec.tracing))
        log("profile", json.dumps(dict(rec.profile, by_span={
            name: {k: v for k, v in row.items() if k != "attrs"}
            for name, row in rec.profile["by_span"].items()})))
        if is_cuda:
            from ptbench.roofline import k2 as k2_mod

            with capture.K2Capture(sweep, 16,
                                   cell.traffic["k2_chunks"]) as k2cap:
                driver.step()
            rec.k2 = k2_mod.replay(k2cap.chunks, sweep.sweep_closest)
            k2cap.chunks.clear()
            log("k2", json.dumps(rec.k2), "power", power_limit())
    if is_cuda:
        rec.peak_bytes = max(setup_peak, torch.cuda.max_memory_allocated())

    produced = outputs(driver, hits, rec.steps, seed)
    del r, scene, driver, hits
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    numbers, diag = judge(cell, spec, seed, produced, device)
    log("reference", json.dumps(diag), "seconds", time.perf_counter() - t0)
    correct, rows = checks.verdict(numbers, cell.traffic)

    bad = forbidden_modules()
    if bad:
        log("ptbench: forbidden modules loaded:", ", ".join(bad))
        return None

    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in names:
        v = spec_mod.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(rec.peak_bytes)}
    result = {"correct": bool(correct), "attempted": rec.steps, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace and rec.profile:
        dev["busy_s"] = rec.profile["busy_s"]
        dev["window_s"] = rec.profile["window_s"]
        # gaps named by the program's spans
        result["breakdown"] = {"device_ops": rec.profile["device_ops"],
                               "idle_gaps": rec.profile["idle_gaps_by_span"]}
    result["checks"] = rows
    for name, row in rows.items():
        side = ">=" if row["at_least"] else "<="
        log(f"check {name} {row['value']} limit {side} {row['limit']}")
    print(json.dumps(result), file=out, flush=True)
    return result


def main(argv=None, start=None):
    ap = argparse.ArgumentParser(prog="python3 -m ptbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec_mod.cell(args.workload)
    res = run(cell, args.seed, args.seconds, args.trace, "cuda",
              start=start)
    if res is None:
        return 3 if forbidden_modules() else 2
    return 0
