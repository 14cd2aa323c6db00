#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: python3 chip_smoke.py

Drives pathtracer_torch's main path - the textured sponza_like interior
(~262k triangles), 1920x1080, 4 spp, depth 6, spp-batched wavefront,
cluster intersector on the hand-written kernels - and checks it:

1. device: card name and power limit, versions, builds of the native
   library and of the CUDA kernels (csrc/*.cu, nvcc, sm_90a);
2. each kernel (K1 tile cull, K2 closest sweep, K3 occlusion sweep)
   against its plain PyTorch version on the card, replaying the arguments
   the main path handed the kernels in chunks of the headline frame's
   primary, bounce-0 shadow and bounce-1 batches: K1 bit-exact, K2
   hit-exact with t/u/v bit-exact, K3 exact;
3. the config 1/3/5 golden gates at 64x64, 4 spp, through the kernels
   (robust gate of benchmarks/run_configs.py);
4. the headline: one warm-up frame and --frames timed frames through
   Renderer, with launch counts reset just before and read just after.

Prints one JSON line of per-kernel results, then as its last line
{"ok": true, "device": {...}}. Exits non-zero, with no result line,
without a CUDA device, outside a checkout of the repository, or when
any phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")
# robust image gate of benchmarks/run_configs.py:127-174
RMSE_TOL, OUTLIER_TOL, MEAN_TOL = 5e-3, 0.02, 1e-3
DEVICE = "cuda"
# the headline: bench.py's textured sponza_like at 1080p (never cut)
HEADLINE_TRIS, HEADLINE_W, HEADLINE_H = 262_000, 1920, 1080
BATCH_NAMES = ("primary", "shadow0", "bounce1")   # first traversal calls
CHUNK_STRIDE = 16   # compare every 16th chunk of a batch ...
CMP_CHUNKS = 4      # ... and at most 4 chunks per batch
KERNELS = {
    "tile_cull": ("pathtracer_torch/csrc/cull.cu",
                  "pathtracer/kernels/pallas_cull.py:35"),
    "sweep_closest": ("pathtracer_torch/csrc/sweep.cu",
                      "pathtracer/kernels/pallas_sweep.py:98"),
    "sweep_occluded": ("pathtracer_torch/csrc/sweep.cu",
                       "pathtracer/kernels/pallas_sweep.py:223"),
}


def log(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


class PhaseError(RuntimeError):
    pass


def robust_gate(img, golden):
    import numpy as np

    d = img - golden
    ad = np.abs(d).max(-1)
    inl = ad <= np.percentile(ad, 98.0)
    rmse = float(np.sqrt(np.mean(d[inl] ** 2)))
    flips = float((ad > 0.01).mean())
    mean_rel = abs(float(img.mean()) - float(golden.mean())) / max(
        abs(float(golden.mean())), 1e-6)
    ok = rmse <= RMSE_TOL and flips <= OUTLIER_TOL and mean_rel <= MEAN_TOL
    return dict(inlier_rmse=rmse, flip_frac=flips, mean_rel=mean_rel, ok=ok)


def phase_device():
    import torch

    from pathtracer_torch.kernels import cuda_build
    from pathtracer_torch.utils import native

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    t0 = time.perf_counter()
    native.build()
    t1 = time.perf_counter()
    for name in ("cull", "sweep"):
        cuda_build.build(name)
    t2 = time.perf_counter()
    for name, text in cuda_build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas[{name}] {line.strip()}", flush=True)
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], gpu=torch.cuda.get_device_name(0),
        native_build_s=t1 - t0, kernels_build_s=t2 - t1)


def headline_setup():
    from pathtracer_torch.accel.cluster import build_scene_clusters
    from pathtracer_torch.config import RenderConfig
    from pathtracer_torch.integrator.camera import Camera
    from pathtracer_torch.scene.procedural import sponza_like

    t0 = time.perf_counter()
    scene = sponza_like(target_tris=HEADLINE_TRIS, textured=True).finalize()
    t1 = time.perf_counter()
    scene = build_scene_clusters(scene).to(DEVICE)
    t2 = time.perf_counter()
    cfg = RenderConfig(width=HEADLINE_W, height=HEADLINE_H, spp=4,
                       max_depth=6, intersector="cluster",
                       traversal_backend="pallas", spp_batch=True)
    cam = Camera(position=(3.0, 4.5, 6.0))
    cam.look_at((14.0, 3.0, 6.0))
    log("scene", tris=scene.n_tris, clusters=scene.clusters.n_clusters,
        build_s=t1 - t0, accel_s=t2 - t1)
    return scene, cfg, cam


def capture_chunks(scene, cfg, cam):
    """Kernel arguments of the headline frame's primary, bounce-0 shadow
    and bounce-1 batches, recorded inside packet.py's chunk bodies while
    render_frame renders one headline frame: every CHUNK_STRIDE-th chunk
    of each batch, at most CMP_CHUNKS of them.
    """
    from pathtracer_torch import render
    from pathtracer_torch.kernels import cull, sweep

    real = {"tile_cull": cull.tile_cull, "sweep_closest": sweep.sweep_closest,
            "sweep_occluded": sweep.sweep_occluded,
            "make_intersectors": render.make_intersectors}
    batches, cur = [], {"batch": None, "keep": False}

    def copies(args, per_chunk):    # clone the per-chunk tensors only
        return tuple(a.clone() if i in per_chunk else a
                     for i, a in enumerate(args))

    def rec_cull(*a, **kw):
        b = cur["batch"]
        cur["keep"] = False
        if b is not None:
            b["chunks"] += 1
            cur["keep"] = ((b["chunks"] - 1) % CHUNK_STRIDE == 0
                           and len(b["tile_cull"]) < CMP_CHUNKS)
            if cur["keep"]:
                b["tile_cull"].append((copies(a, (2, 3, 4)), dict(kw)))
        return real["tile_cull"](*a, **kw)

    def rec_sweep(name):
        def call(*a):
            if cur["keep"]:
                cur["batch"][name].append(copies(a, (0, 1, 2, 3)))
            return real[name](*a)
        return call

    def traversal(fn):              # one call = one batch of rays
        def call(*a, **kw):
            i = len(batches)
            cur["batch"] = None
            if i < len(BATCH_NAMES):
                cur["batch"] = {"label": BATCH_NAMES[i], "chunks": 0,
                                **{k: [] for k in KERNELS}}
            batches.append(cur["batch"])
            return fn(*a, **kw)
        return call

    def make_intersectors(scene, cfg):
        return tuple(map(traversal, real["make_intersectors"](scene, cfg)))

    cull.tile_cull = rec_cull
    sweep.sweep_closest = rec_sweep("sweep_closest")
    sweep.sweep_occluded = rec_sweep("sweep_occluded")
    render.make_intersectors = make_intersectors
    try:
        render.render_frame(scene, cfg, cam.state(DEVICE), 0)
    finally:
        cull.tile_cull = real["tile_cull"]
        sweep.sweep_closest = real["sweep_closest"]
        sweep.sweep_occluded = real["sweep_occluded"]
        render.make_intersectors = real["make_intersectors"]
    return [b for b in batches if b is not None]


def timed(fn):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_kernels(scene, cfg, cam):
    import torch

    from pathtracer_torch.kernels import cull, sweep

    mods = {"tile_cull": cull, "sweep_closest": sweep, "sweep_occluded": sweep}
    stats = {k: {"ms": [], "plain_ms": [], "max_abs_err": 0.0, "calls": 0}
             for k in KERNELS}

    def compare(name, label, args, kw=None):
        kw = kw or {}
        kernel = getattr(mods[name], name)
        plain = getattr(mods[name], name + "_plain")
        kernel(*args, **kw)                                   # warm-up
        out, ms = timed(lambda: kernel(*args, **kw))
        ref, ms_p = timed(lambda: plain(*args, **kw))
        if name == "tile_cull":
            if not torch.equal(out, ref):
                bad = int((out != ref).sum())
                raise PhaseError(f"K1 {label}: {bad} entries differ")
            fin = torch.isfinite(out)
            err = float((out[fin] - ref[fin]).abs().max()) \
                if bool(fin.any()) else 0.0
        elif name == "sweep_closest":
            if not torch.equal(out[1], ref[1]):
                bad = int((out[1] != ref[1]).sum())
                raise PhaseError(f"K2 {label}: {bad} rays hit another "
                                 "triangle")
            for x, y, nm in zip(out[::2] + out[3:], ref[::2] + ref[3:],
                                ("t", "u", "v")):
                if not torch.equal(x, y):
                    raise PhaseError(f"K2 {label}: {nm} not bit-exact "
                                     f"(max {float((x - y).abs().max())})")
            hit = out[1] >= 0
            err = float((out[0][hit] - ref[0][hit]).abs().max()) \
                if bool(hit.any()) else 0.0
        else:
            err = float(int((out != ref).sum()))
            if err:
                raise PhaseError(f"K3 {label}: {int(err)} rays differ")
        s = stats[name]
        s["ms"].append(ms)
        s["plain_ms"].append(ms_p)
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["calls"] += 1

    for b in capture_chunks(scene, cfg, cam):
        for args, kw in b["tile_cull"]:
            compare("tile_cull", b["label"], args, kw)
        for name in ("sweep_closest", "sweep_occluded"):
            for args in b[name]:
                compare(name, b["label"], args)
        log("kernels_batch", batch=b["label"], chunks=b["chunks"],
            compared=len(b["tile_cull"]))
    for name, s in stats.items():
        if not s["calls"]:
            raise PhaseError(f"{name}: never compared")
        log("kernel_vs_plain", kernel=name, chunks=s["calls"],
            ms=sum(s["ms"]) / s["calls"],
            plain_ms=sum(s["plain_ms"]) / s["calls"],
            max_abs_err=s["max_abs_err"])
    return stats


def phase_goldens():
    import numpy as np

    from pathtracer_torch.accel.cluster import build_scene_clusters
    from pathtracer_torch.config import RenderConfig
    from pathtracer_torch.integrator.camera import Camera
    from pathtracer_torch.render import render_frame
    from pathtracer_torch.scene import procedural

    def cam(pos, tgt):
        c = Camera(position=pos)
        c.look_at(tgt)
        return c

    box = ((0.5, 0.5, 2.2), (0.5, 0.5, 0.0))
    # benchmarks/run_configs.py configs 1, 3, 5 at the 64x64 / 4 spp probe
    configs = [
        (1, procedural.cornell_box, dict(spp_batch=False), box),
        (3, lambda: procedural.cornell_box(materials_suite=True),
         dict(spp_batch=True), box),
        (5, procedural.sponza_like, dict(spp_batch=True),
         ((3.0, 4.5, 6.0), (14.0, 3.0, 6.0))),
    ]
    failed = []
    for idx, scene_fn, kw, c in configs:
        t0 = time.perf_counter()
        scene = build_scene_clusters(scene_fn().finalize()).to(DEVICE)
        cfg = RenderConfig(width=64, height=64, spp=4, max_depth=6, **kw)
        img = render_frame(scene, cfg, cam(*c).state(DEVICE), 0)
        img = img.cpu().numpy()
        g = np.load(os.path.join(GOLDEN_DIR, f"config_{idx}_64.npz"))["img"]
        res = robust_gate(img, g)
        log("golden", config=idx, tris=scene.n_tris,
            seconds=time.perf_counter() - t0, **res)
        if not res["ok"]:
            failed.append(idx)
    if failed:
        raise PhaseError(f"golden gate failed for configs {failed}")


def phase_headline(scene, cfg, cam, frames):
    import torch

    from pathtracer_torch import kernels
    from pathtracer_torch.kernels import packet
    from pathtracer_torch.render import Renderer

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    r = Renderer(scene, cfg, cam, device=DEVICE)
    t0 = time.perf_counter()
    r.step()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    times, rays = [], []
    for _ in range(frames):
        t0 = time.perf_counter()
        r.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rays.append(int(r.last_rays))
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    img = r.film.accum
    finite = bool(torch.isfinite(img).all())
    mean = float(img.mean())
    # cost of one chunk_live host sync (11 traversal calls per frame)
    o = torch.rand((cfg.width * cfg.height * cfg.spp, 3), device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        packet.chunk_live(o, packet.CHUNK_TILES * packet.TILE_RAYS)
    sync_ms = (time.perf_counter() - t0) / 20 * 1e3
    ms = sum(times) / len(times) * 1e3
    log("headline", width=cfg.width, height=cfg.height, spp=cfg.spp,
        max_depth=cfg.max_depth, tris=scene.n_tris, warmup_s=warm_s,
        frame_ms=[t * 1e3 for t in times], ms_per_frame=ms,
        rays_per_frame=rays, mrays_per_s=sum(rays) / sum(times) / 1e6,
        peak_mem_bytes=peak, launches=counts, image_mean=mean,
        image_finite=finite, chunk_live_ms=sync_ms)
    if not finite or not mean > 0.0:
        raise PhaseError(f"headline image bad: finite={finite} mean={mean}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise PhaseError(f"main path launched no {missing}")
    return counts, ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=2,
                    help="timed headline frames after one warm-up frame")
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import pathtracer_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    try:
        phase_device()
        scene, cfg, cam = headline_setup()
        stats = phase_kernels(scene, cfg, cam)
        phase_goldens()
        counts, _ = phase_headline(scene, cfg, cam, args.frames)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kern = []
    for name, (src, replaces) in KERNELS.items():
        s = stats[name]
        kern.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": s["max_abs_err"],
                     "ms": sum(s["ms"]) / s["calls"],
                     "plain_ms": sum(s["plain_ms"]) / s["calls"]})
    log("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kern}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
