"""Top-level render API (counterpart of pathtracer/render.py).

A frame is: primary rays for every (pixel, sample) -> trace_paths with
the chosen intersector -> scatter-add into pixels -> film.accumulate.
With cfg.spp_batch all spp samples of a frame are one wavefront
(render_frame_batched); otherwise a host loop of per-sample wavefronts
(render_sample). With cfg.primary_priming on the cluster intersector,
per-pixel hints (path.trace_paths) chain across samples and frames.
`Renderer` is the progressive driver; every entry point takes an
explicit device.

Not ported yet (ROADMAP.md Queue 1): G-buffer/denoiser, the
mesh/sharded path, motion preview, auto frame batching, checkpoints.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from pathtracer_torch import config as config_mod
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.film import film as film_mod
from pathtracer_torch.integrator import camera as cam_mod
from pathtracer_torch.integrator import path as path_mod
from pathtracer_torch.kernels import intersect as isect
from pathtracer_torch.kernels import packet, sweep
from pathtracer_torch.scene.types import Scene


def make_intersectors(scene: Scene, cfg: RenderConfig):
    """(intersect_fn, occluded_fn, hint_fn) for the configured intersector.

    Scenes of at most 256 triangles use the dense brute-force test, as
    the JAX package does. The cluster route runs packet traversal through
    the kernel wrappers (CUDA kernels on CUDA tensors, never demoted).
    occluded_fn(..., want_blocker=True) also returns blocker hints.
    hint_fn(tri, o, d, t_min, t_max, front_only=False) -> (t, u, v, ok)
    re-tests a hint (path.trace_paths) with the route's own ray-triangle
    arithmetic: the accel's Baldwin-Weber rows on the cluster route, so
    a verified primary hit carries the t/u/v the sweep would report and a
    verified shadow blocker is one the occlusion sweep would accept;
    Moller-Trumbore on the brute route. front_only adds the occlusion
    routes' front-facing test.
    """
    use_brute = (cfg.intersector == "brute"
                 or (cfg.intersector == "cluster" and scene.n_tris <= 256))
    if use_brute:
        v0, v1, v2 = scene.tri_vertices(
            torch.arange(scene.n_tris, device=scene.device))

        def intersect_fn(o, d, t_min, t_max, primary=False):
            return isect.intersect_brute(o, d, v0, v1, v2, t_min, t_max)

        def occluded_fn(o, d, t_max, primary=False, want_blocker=False):
            return isect.occluded_brute(o, d, t_max, v0, v1, v2,
                                        want_blocker=want_blocker)

        return intersect_fn, occluded_fn, isect.hint_test(v0, v1, v2)

    if scene.clusters is None:
        raise ValueError("cfg.intersector='cluster' but the scene has no "
                         "cluster accel; call "
                         "accel.cluster.build_scene_clusters(scene) first")
    accel = scene.clusters
    sort_rays = cfg.packet_sort

    def intersect_fn(o, d, t_min, t_max, primary=False):
        # primary rays arrive in swizzled 8x8 pixel-block order, already
        # tighter than the coherence key: they skip the sort
        return packet.intersect_clusters(accel, o, d, t_min, t_max,
                                         sort_rays=sort_rays and not primary)

    def occluded_fn(o, d, t_max, primary=False, want_blocker=False):
        return packet.occluded_clusters(accel, o, d, t_max,
                                        sort_rays=sort_rays,
                                        want_blocker=want_blocker)

    def hint_fn(tri, o, d, t_min, t_max, front_only=False):
        return sweep.bw_hit(accel.bw_rows[tri.clamp(min=0).long()], o, d,
                            t_min, t_max, front_only=front_only)

    return intersect_fn, occluded_fn, hint_fn


# Pixel-block swizzle: consecutive lanes cover 8x8 pixel blocks, so each
# 64-ray tile is a compact screen square. Pixel ids keep their row-major
# values, so per-pixel RNG streams are swizzle-invariant.
BLOCK_W = 8
BLOCK_H = 8


def _swizzled_pixel_ids(w: int, h: int, device="cpu"):
    """Flat pixel ids in (block_y, block_x, in_y, in_x) order, or None."""
    if w % BLOCK_W or h % BLOCK_H:
        return None
    ys = torch.arange(h, device=device).reshape(h // BLOCK_H, BLOCK_H)
    xs = torch.arange(w, device=device).reshape(w // BLOCK_W, BLOCK_W)
    y = ys[:, None, :, None]
    x = xs[None, :, None, :]
    return (y * w + x).reshape(-1).to(torch.int32)


def _base_pixels(w, h, device):
    swz = _swizzled_pixel_ids(w, h, device)
    return swz if swz is not None else torch.arange(
        w * h, dtype=torch.int32, device=device)


def render_sample(scene: Scene, cfg: RenderConfig, cam: cam_mod.CameraState,
                  frame_idx: int, s: int, prime=None):
    """ONE sample per pixel -> (radiance f32[H, W, 3], rays int64 scalar,
    prime_out). prime: i32[W*H, 3] hints in pixel order, or None."""
    intersect_fn, occluded_fn, hint_fn = make_intersectors(scene, cfg)
    w, h = cfg.width, cfg.height
    dev = scene.device
    pixel_ids = _base_pixels(w, h, dev)
    sample_ids = torch.full((w * h,), frame_idx * cfg.spp + s,
                            dtype=torch.int64, device=dev)
    o, d = cam_mod.generate_primary_rays(cam, w, h, cfg.fov_deg, pixel_ids,
                                         sample_ids, cfg.seed, cfg.sampler)
    radiance, rays, prime_out = path_mod.trace_paths(
        scene, cfg, o, d, pixel_ids, sample_ids, intersect_fn, occluded_fn,
        prime=prime, sample_window=1, hint_fn=hint_fn)
    img = torch.zeros((w * h, 3), dtype=torch.float32, device=dev)
    img[pixel_ids.long()] = radiance
    return img.reshape(h, w, 3), rays, prime_out


def _trace_pool_part(scene: Scene, cfg: RenderConfig,
                     cam: cam_mod.CameraState, frame_idx: int, pix_part,
                     prime_part=None):
    """Trace ALL cfg.spp samples of one pixel part as one wavefront.

    Returns the part's per-pixel radiance SUM [m, 3], the ray count and
    the part's hints [m, 3] (rows follow pix_part; None unprimed).
    """
    w, h = cfg.width, cfg.height
    m = pix_part.shape[0]
    dev = pix_part.device
    intersect_fn, occluded_fn, hint_fn = make_intersectors(scene, cfg)
    # sample-major lane order: each sample's segment keeps the swizzle
    pixel_ids = pix_part.repeat(cfg.spp)
    rows = torch.arange(m, device=dev).repeat(cfg.spp)
    sample_ids = frame_idx * cfg.spp + torch.arange(
        cfg.spp, dtype=torch.int64, device=dev).repeat_interleave(m)
    o, d = cam_mod.generate_primary_rays(cam, w, h, cfg.fov_deg, pixel_ids,
                                         sample_ids, cfg.seed, cfg.sampler)
    radiance, rays, prime_out = path_mod.trace_paths(
        scene, cfg, o, d, pixel_ids, sample_ids, intersect_fn, occluded_fn,
        prime=prime_part, local_pix=rows, sample_window=cfg.spp,
        hint_fn=hint_fn)
    part_img = torch.zeros((m, 3), dtype=torch.float32, device=dev)
    # atomics on CUDA: the per-pixel sum order varies at the ulp level
    part_img.index_add_(0, rows, radiance)
    return part_img, rays, prime_out


def render_frame_batched(scene: Scene, cfg: RenderConfig,
                         cam: cam_mod.CameraState, frame_idx: int,
                         prime=None):
    """ALL cfg.spp samples of one frame as one wavefront.

    The pool splits into spatial parts of at most PT_MAX_WAVEFRONT lanes
    (default POOL_SATURATION_LANES) along the swizzled lane order; each
    part traces all samples of a contiguous run of 8x8 pixel blocks, with
    its pixels' rows of the hints. prime: i32[W*H, 3] hints in pixel
    order, or None (unprimed). Returns (mean radiance f32[H, W, 3], rays,
    prime_out in the same layout, or None).
    """
    w, h = cfg.width, cfg.height
    n = w * h
    base_pix = _base_pixels(w, h, scene.device)
    cap = int(os.environ.get("PT_MAX_WAVEFRONT",
                             str(config_mod.POOL_SATURATION_LANES)))
    parts = max(1, -(-(n * cfg.spp) // cap))
    bounds = [n * p // parts for p in range(parts + 1)]
    img = torch.zeros((n, 3), dtype=torch.float32, device=scene.device)
    primed = prime is not None
    prime_out = torch.empty_like(prime) if primed else None
    rays = 0
    for p in range(parts):
        pix_part = base_pix[bounds[p]:bounds[p + 1]]
        rows = pix_part.long()
        part_img, rays_p, prime_p = _trace_pool_part(
            scene, cfg, cam, frame_idx, pix_part,
            prime[rows] if primed else None)
        img[rows] = part_img            # parts partition the pixels
        if primed:
            prime_out[rows] = prime_p
        rays = rays + rays_p
    return (img / cfg.spp).reshape(h, w, 3), rays, prime_out


def render_frame_with_stats(scene: Scene, cfg: RenderConfig,
                            cam: cam_mod.CameraState, frame_idx: int,
                            prime=None, return_prime: bool = False):
    """One frame's radiance estimate (mean of cfg.spp samples) and rays.

    With cfg.primary_priming on the cluster intersector, `prime` (the
    previous frame's hints, or None) seeds this frame's first sample and
    the hints chain across its samples; return_prime appends this
    frame's hints (None when priming is off).
    """
    if not (cfg.primary_priming and cfg.intersector == "cluster"):
        prime = None
    elif prime is None:
        prime = torch.full((cfg.width * cfg.height, 3), -1,
                           dtype=torch.int32, device=scene.device)
    if cfg.spp_batch and cfg.spp > 1:
        radiance, rays, prime = render_frame_batched(scene, cfg, cam,
                                                     frame_idx, prime)
    else:
        radiance = None
        rays = 0
        for s in range(cfg.spp):
            r, k, prime = render_sample(scene, cfg, cam, frame_idx, s,
                                        prime)
            radiance = r if radiance is None else radiance + r
            rays = rays + k
        radiance = radiance / cfg.spp
    return (radiance, rays, prime) if return_prime else (radiance, rays)


def render_frame(scene: Scene, cfg: RenderConfig, cam: cam_mod.CameraState,
                 frame_idx: int):
    """One frame's linear radiance f32[H, W, 3]."""
    return render_frame_with_stats(scene, cfg, cam, frame_idx)[0]


class Renderer:
    """Headless progressive renderer: owns (scene, cfg, camera, film) on `device`.

    `step()` renders one frame and folds it into the film; a camera move
    resets accumulation (main.cpp:678-681). With priming the hints chain
    across frames and are kept across camera moves: they are re-verified
    against the new rays, so stale ones cost one dense test each.
    """

    def __init__(self, scene: Scene, cfg: RenderConfig,
                 camera: Optional[cam_mod.Camera] = None, *, device):
        self.device = torch.device(device)
        if cfg.intersector == "cluster" and scene.clusters is None:
            from pathtracer_torch.accel import cluster

            scene = cluster.build_scene_clusters(scene)
        self.scene = scene.to(self.device)
        self.cfg = cfg
        self.camera = camera or cam_mod.Camera()
        self.film = film_mod.new_film(cfg.width, cfg.height,
                                      device=self.device)
        self.last_rays = 0
        self._prime = None      # hints chained across frames (priming)

    def reset(self):
        self.film = film_mod.new_film(self.cfg.width, self.cfg.height,
                                      device=self.device)

    def step(self) -> film_mod.Film:
        if self.camera.moved:
            self.reset()
            self.camera.moved = False
        radiance, rays, self._prime = render_frame_with_stats(
            self.scene, self.cfg, self.camera.state(device=self.device),
            self.film.frame, prime=self._prime, return_prime=True)
        self.last_rays = rays
        self.film = film_mod.accumulate(self.film, radiance)
        return self.film

    def run(self, n_frames: int) -> film_mod.Film:
        for _ in range(n_frames):
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.film

    def display(self) -> np.ndarray:
        """Tone-mapped current image, f32 [H, W, 3] in [0, 1]."""
        return film_mod.to_display(self.film.accum,
                                   self.cfg.tonemap).cpu().numpy()

    def save_png(self, path: str):
        film_mod.write_png(path, self.display())
