"""Benchmark harness: Mrays/s + ms/frame with exact ray counts (counterpart of pathtracer/bench/harness.py).

Frames are timed one by one and grouped into windows; the headline is
the MEDIAN window, so a disturbed stretch shows as window spread instead
of polluting one long mean, and `bench_interleaved` alternates windows
between legs so that two configurations see the same conditions.

A timed step ends with float(rays), which waits for the frame's ray
count, and then torch.cuda.synchronize(device) on a CUDA device, so no
frame's work runs on into the next one's timing.
"""

from __future__ import annotations

import hashlib
import os
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from pathtracer_torch.config import RenderConfig
from pathtracer_torch.integrator.camera import Camera
from pathtracer_torch.render import (_initial_prime, render_frame_batched,
                                     render_frame_with_stats)
from pathtracer_torch.scene.types import Scene


# the package's own directory: its sources make source_hash()
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_SUFFIXES = (".py", ".cu", ".cuh", ".cpp", ".h")


def bench_device(env=os.environ):
    """cuda unless PT_PLATFORM=cpu; raises without a card."""
    platform = env.get("PT_PLATFORM", "cuda")
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("cuda", "gpu"):
        raise ValueError(f"PT_PLATFORM={platform!r}: cpu or cuda")
    if not torch.cuda.is_available():
        raise RuntimeError("pathtracer_torch.bench: no CUDA device; set "
                           "PT_PLATFORM=cpu for a run on the CPU")
    return torch.device("cuda")


def device_record(device):
    """{"platform", "kind", "count"} of the device a result came from."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count()}


def source_hash(root=PACKAGE_DIR):
    """sha256 of the package's sources (path and bytes of every .py and
    CUDA/C++ file, build outputs and caches left out): names the tree a
    results file was written by."""
    h = hashlib.sha256()
    for top, dirs, files in os.walk(root):
        dirs[:] = sorted(d for d in dirs
                         if d not in ("_build", "__pycache__"))
        for name in sorted(files):
            if name.endswith(SOURCE_SUFFIXES):
                path = os.path.join(top, name)
                h.update(os.path.relpath(path, root).encode() + b"\0")
                with open(path, "rb") as f:
                    h.update(f.read())
    return h.hexdigest()


@dataclass
class BenchResult:
    mrays_per_sec: float        # from the median window
    ms_per_frame: float         # median window mean
    rays_per_frame: float
    frames: int
    width: int
    height: int
    spp: int
    # window diagnostics (ms/frame per window + spread)
    window_ms: List[float] = field(default_factory=list)
    ms_min: float = 0.0
    ms_max: float = 0.0
    ms_std: float = 0.0

    def as_dict(self):
        return {
            "mrays_per_sec": self.mrays_per_sec,
            "ms_per_frame": self.ms_per_frame,
            "rays_per_frame": self.rays_per_frame,
            "frames": self.frames,
            "resolution": [self.width, self.height],
            "spp": self.spp,
            "window_ms": [round(w, 3) for w in self.window_ms],
            "ms_min": round(self.ms_min, 3),
            "ms_max": round(self.ms_max, 3),
            "ms_std": round(self.ms_std, 3),
        }


def time_call(fn, device, warmup=1, reps=3):
    """(seconds a call, the last call's output): CUDA events over `reps`
    calls after `warmup` on a card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps * 1e-3, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) / reps, out


def _sync(rays, device):
    r = float(rays)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return r


def _step(scene, cfg, cam, frame_idx, prime):
    """One timed render step: F=cfg.frame_batch frames' samples at once."""
    F = cfg.frame_batch
    if F > 1:
        prime = _initial_prime(cfg, prime, scene.device)
        img, rays, prime_o, _ = render_frame_batched(
            scene, cfg, cam, frame_idx, prime, frames=F)
        return img, rays, prime_o
    return render_frame_with_stats(scene, cfg, cam, frame_idx, prime, True)


def _frame_times(scene, cfg, cam, start, frames, prime):
    """Render `frames` steps, syncing each; per-step (dt, rays).

    With cfg.frame_batch=F each step covers F progressive frames (the
    frame index advances by F); _result renormalizes to per-frame stats.
    """
    times, rays_seen = [], []
    for i in range(frames):
        t0 = time.perf_counter()
        _, rays, prime = _step(scene, cfg, cam,
                               start + i * cfg.frame_batch, prime)
        r = _sync(rays, scene.device)
        times.append(time.perf_counter() - t0)
        rays_seen.append(r)
    return times, rays_seen, prime


def _result(times, rays_seen, cfg, windows):
    n = len(times)
    windows = max(1, min(windows, n))
    # split frame times into `windows` near-equal chunks
    bounds = [round(k * n / windows) for k in range(windows + 1)]
    win_ms = []
    for a, b in zip(bounds, bounds[1:]):
        if b > a:
            win_ms.append(sum(times[a:b]) / (b - a) * 1e3)
    med_ms = statistics.median(win_ms)
    # frame_batch steps cover F frames each: renormalize to per-frame
    F = cfg.frame_batch
    if F > 1:
        win_ms = [wm / F for wm in win_ms]
        med_ms = med_ms / F
    rays_pf = sum(rays_seen) / n / F
    return BenchResult(
        mrays_per_sec=rays_pf / med_ms / 1e3,
        ms_per_frame=med_ms,
        rays_per_frame=rays_pf,
        frames=n,
        width=cfg.width, height=cfg.height, spp=cfg.spp,
        window_ms=win_ms,
        ms_min=min(win_ms), ms_max=max(win_ms),
        ms_std=statistics.pstdev(win_ms) if len(win_ms) > 1 else 0.0,
    )


def _warm(scene, cfg, cam, warmup):
    """`warmup` synced steps (first-use builds and caches); the priming
    hints they chain are returned for the timed steps."""
    prime = None   # priming hints chain across frames (Renderer.step)
    for i in range(warmup):
        _, rays, prime = _step(scene, cfg, cam, i * cfg.frame_batch, prime)
        _sync(rays, scene.device)
    return prime


def bench_scene(scene: Scene, cfg: RenderConfig, camera: Camera,
                warmup: int = 4, frames: int = 8,
                windows: int = 4) -> BenchResult:
    """Time progressive frames; returns median-window throughput stats.

    Warm-up steps (kernel builds, allocator growth) are synced one by one
    and excluded.
    """
    cam = camera.state(device=scene.device)
    prime = _warm(scene, cfg, cam, warmup)
    times, rays_seen, _ = _frame_times(scene, cfg, cam,
                                       warmup * cfg.frame_batch, frames,
                                       prime)
    return _result(times, rays_seen, cfg, windows)


def bench_interleaved(scenes: Dict[str, Scene], cfg: RenderConfig,
                      camera: Camera, warmup: int = 3, frames: int = 4,
                      windows: int = 4) -> Dict[str, BenchResult]:
    """Bench several scenes under ONE config with interleaved windows.

    Each window renders `ceil(frames/windows)`-ish frames of every scene
    in turn, so all legs sample the same conditions. Use this for A/B
    legs that must be comparable (e.g. textured vs untextured).
    """
    labels = list(scenes)
    cams = {lab: camera.state(device=scenes[lab].device) for lab in labels}
    primes = {lab: _warm(scenes[lab], cfg, cams[lab], warmup)
              for lab in labels}

    windows = max(1, min(windows, frames))
    bounds = [round(k * frames / windows) for k in range(windows + 1)]
    times = {lab: [] for lab in labels}
    rays_seen = {lab: [] for lab in labels}
    for a, b in zip(bounds, bounds[1:]):
        if b <= a:
            continue
        for lab in labels:
            t, r, primes[lab] = _frame_times(
                scenes[lab], cfg, cams[lab], (warmup + a) * cfg.frame_batch,
                b - a, primes[lab])
            times[lab] += t
            rays_seen[lab] += r
    return {lab: _result(times[lab], rays_seen[lab], cfg, windows)
            for lab in labels}
