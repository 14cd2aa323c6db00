"""Top-level render API (counterpart of pathtracer/render.py).

A frame is: primary rays for every (pixel, sample) -> trace_paths with
the chosen intersector -> each pixel's samples summed in a fixed order
(sample_sum) -> film.accumulate.
With cfg.spp_batch all spp samples of a frame are one wavefront
(render_frame_batched), and with cfg.frame_batch = F > 1 the samples of
F consecutive frames are (frame batching: the same sample set, folded
with film.accumulate_many); otherwise a host loop of per-sample
wavefronts (render_sample). With cfg.primary_priming on the cluster or
bvh intersector, per-pixel hints (path.trace_paths) chain across
samples and frames. With a G-buffer (cfg.denoise or
cfg.capture_gbuffer) a frame also returns the primary-hit features and
the SVGF luminance moments m1/m2 that feed film/denoise.py.

`Renderer` runs the progressive loop: frame batching, auto frame
batching, motion preview, the running-mean G-buffer, the denoised and
tone-mapped display, AOVs. Every entry point takes an explicit device.
With a mesh (parallel/sharding.py) each step renders this rank's
(tile, sample) shard and the ranks reduce their shards into one film.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from pathtracer_torch import config as config_mod
from pathtracer_torch import knobs, tracing
from pathtracer_torch.accel import bruteforce
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.film import film as film_mod
from pathtracer_torch.integrator import camera as cam_mod
from pathtracer_torch.integrator import path as path_mod
from pathtracer_torch.kernels import intersect as isect
from pathtracer_torch.kernels import packet, sweep, traverse
from pathtracer_torch.scene.types import Scene
from pathtracer_torch.utils import vmath


def make_intersectors(scene: Scene, cfg: RenderConfig):
    """(intersect_fn, occluded_fn, hint_fn) for the configured intersector.

    Scenes of at most 256 triangles use the dense brute-force test, as
    the JAX package does. The cluster route runs packet traversal through
    the kernel wrappers (CUDA kernels on CUDA tensors, never demoted):
    closest calls on scene.clusters_fine and occlusion calls on
    scene.clusters, with the per-call accel and fetch-group knobs
    (PT_BOUNCE_ACCEL, PT_OCCL_ACCEL, PT_GROUP_*); its intersect_fn and
    occluded_fn also take cull="frustum" (K7). It raises on a refused
    knob (knobs.check_refused).
    occluded_fn(..., want_blocker=True) also returns blocker hints.
    hint_fn(tri, o, d, t_min, t_max, front_only=False) -> (t, u, v, ok)
    re-tests a hint (path.trace_paths) with the route's own ray-triangle
    arithmetic: the accel's Baldwin-Weber rows on the cluster route, so
    a verified primary hit carries the t/u/v the sweep would report and a
    verified shadow blocker is one the occlusion sweep would accept;
    Moller-Trumbore on the brute route, and the packed triangle rows of
    the traversal on the bvh route. front_only adds the occlusion routes'
    front-facing test. The bvh route (K5/K6, kernels/traverse.py) reports
    no blocker hints: with want_blocker its hints are all -1, as in the
    JAX package, so shadow priming never skips a traversal there.
    """
    use_brute = (cfg.intersector == "brute"
                 or (cfg.intersector == "cluster" and scene.n_tris <= 256))
    if use_brute:
        v0, v1, v2 = scene.tri_vertices(
            torch.arange(scene.n_tris, device=scene.device))
        intersect_fn, occluded_fn = bruteforce.make_brute_intersectors(
            v0, v1, v2)
        return intersect_fn, occluded_fn, isect.hint_test(v0, v1, v2)

    if cfg.intersector == "bvh":
        if scene.bvh is None:
            raise ValueError("cfg.intersector='bvh' but the scene has no "
                             "BVH; call accel.lbvh.build_scene_bvh(scene) "
                             "first")
        packed = traverse.pack_bvh(scene.bvh, scene.indices, scene.positions)

        def intersect_fn(o, d, t_min, t_max, primary=False):
            with tracing.span("pt.traverse.closest"):
                return traverse.intersect_bvh(packed, o.contiguous(),
                                              d.contiguous(), t_min, t_max)

        def occluded_fn(o, d, t_max, primary=False, want_blocker=False):
            with tracing.span("pt.traverse.occluded"):
                blocked = traverse.occluded_bvh(packed, o.contiguous(),
                                                d.contiguous(), t_max)
                if want_blocker:
                    return blocked, torch.full(o.shape[:1], -1,
                                               dtype=torch.int32,
                                               device=o.device)
                return blocked

        return intersect_fn, occluded_fn, traverse.hint_test(packed)

    if scene.clusters is None:
        raise ValueError("cfg.intersector='cluster' but the scene has no "
                         "cluster accel; call "
                         "accel.cluster.build_scene_clusters(scene) first")
    knobs.check_refused()
    accel = scene.clusters
    accel_fine = scene.clusters_fine or accel
    # closest calls trace the fine accel (bounce calls the coarse one
    # under PT_BOUNCE_ACCEL=morton), occlusion calls the coarse one (the
    # fine one under PT_OCCL_ACCEL=fine); render.py:46-104
    bounce_accel = (accel if knobs.choice("PT_BOUNCE_ACCEL", "fine",
                                          ("fine", "morton")) == "morton"
                    else accel_fine)
    occl_accel = (accel_fine if knobs.choice("PT_OCCL_ACCEL", "coarse",
                                             ("coarse", "fine")) == "fine"
                  else accel)
    # fetch groups per call kind, falling back to PT_FETCH_GROUP
    group = {name: (knobs.integer(name, 1) if os.environ.get(name)
                    else None)
             for name in ("PT_GROUP_PRIMARY", "PT_GROUP_BOUNCE",
                          "PT_GROUP_OCCL")}
    # with the integrator's per-bounce wavefront sort the rays arrive
    # compacted and coherence-ordered: the packet layer skips its sort
    sort_rays = (not cfg.wavefront_sort) and cfg.packet_sort

    def intersect_fn(o, d, t_min, t_max, primary=False, cull="ray"):
        # primary rays arrive in swizzled 8x8 pixel-block order, already
        # tighter than the coherence key: they skip the sort
        return packet.intersect_clusters(
            accel_fine if primary else bounce_accel, o, d, t_min, t_max,
            sort_rays=sort_rays and not primary, cull=cull,
            group=group["PT_GROUP_PRIMARY" if primary
                        else "PT_GROUP_BOUNCE"])

    def occluded_fn(o, d, t_max, primary=False, want_blocker=False,
                    cull="ray"):
        return packet.occluded_clusters(occl_accel, o, d, t_max,
                                        sort_rays=sort_rays,
                                        want_blocker=want_blocker, cull=cull,
                                        group=group["PT_GROUP_OCCL"])

    def hint_fn(tri, o, d, t_min, t_max, front_only=False):
        # a shadow blocker (front_only) is re-tested with the rows of the
        # accel the occlusion calls traverse, a primary hit with those of
        # the accel the primary closest call traverses
        rows = (occl_accel if front_only else accel_fine).bw_rows
        return sweep.bw_hit(rows[tri.clamp(min=0).long()], o, d,
                            t_min, t_max, front_only=front_only)

    return intersect_fn, occluded_fn, hint_fn


# Pixel-block swizzle: consecutive lanes cover 8x8 pixel blocks, so each
# 64-ray tile is a compact screen square. Pixel ids keep their row-major
# values, so per-pixel RNG streams are swizzle-invariant.
BLOCK_W = 8
BLOCK_H = 8


def _swizzled_pixel_ids(w: int, h: int, device):
    """Flat pixel ids in (block_y, block_x, in_y, in_x) order on `device`,
    or None."""
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
                  frame_idx: int, s: int, prime=None, gbuffer: bool = False):
    """ONE sample per pixel -> (radiance f32[H, W, 3], rays int64 scalar,
    prime_out, gbuf). prime: i32[W*H, 3] hints in pixel order, or None;
    gbuf (with gbuffer): primary-hit rows in pixel order, or None."""
    with tracing.span("pt.wavefront"):
        intersect_fn, occluded_fn, hint_fn = make_intersectors(scene, cfg)
        w, h = cfg.width, cfg.height
        dev = scene.device
        pixel_ids = _base_pixels(w, h, dev)
        sample_ids = torch.full((w * h,), frame_idx * cfg.spp + s,
                                dtype=torch.int64, device=dev)
        o, d = _primary_rays(cfg, cam, pixel_ids, sample_ids)
        radiance, pix_out, rays, prime_out, gbuf = path_mod.trace_paths(
            scene, cfg, o, d, pixel_ids, sample_ids, intersect_fn,
            occluded_fn, prime=prime, sample_window=1, hint_fn=hint_fn,
            want_gbuffer=gbuffer)
        img = torch.zeros((w * h, 3), dtype=torch.float32, device=dev)
        # lanes come back beside their pixel ids (permuted under
        # cfg.wavefront_sort): one scatter lands them row-major
        img[pix_out.long()] = radiance
        return img.reshape(h, w, 3), rays, prime_out, gbuf


def _primary_rays(cfg: RenderConfig, cam, pixel_ids, sample_ids):
    return cam_mod.generate_primary_rays(
        cam, cfg.width, cfg.height, cfg.fov_deg, pixel_ids, sample_ids,
        cfg.seed, cfg.sampler, aperture=cfg.aperture,
        focus_dist=cfg.focus_dist)


def _part_bounds(n_pixels: int, lanes_per_pixel: int):
    """Pixel bounds of the spatial parts a pool of n_pixels x
    lanes_per_pixel lanes splits into: at most PT_MAX_WAVEFRONT lanes a
    part (default POOL_SATURATION_LANES), contiguous in lane order."""
    cap = int(os.environ.get("PT_MAX_WAVEFRONT",
                             str(config_mod.POOL_SATURATION_LANES)))
    parts = max(1, -(-(n_pixels * lanes_per_pixel) // cap))
    return [n_pixels * p // parts for p in range(parts + 1)]


def _trace_pool_part(scene: Scene, cfg: RenderConfig,
                     cam: cam_mod.CameraState, pix_part, samples,
                     sample_window: int, prime_part=None,
                     gbuffer: bool = False):
    """Trace the sample ids `samples` (int64 [S]) of one pixel part as one
    wavefront, sample-major; sample_window sizes the env-NEE table (the
    span of sample ids the pool's samples come from).

    Returns the part's per-pixel radiance SUM [m, 3], the ray count, the
    part's hints [m, 3] (rows follow pix_part; None unprimed) and its
    G-buffer rows with the luminance moments m1/m2 summed over samples
    (None without gbuffer).
    """
    with tracing.span("pt.wavefront"):
        m = pix_part.shape[0]
        dev = pix_part.device
        n_s = samples.shape[0]
        intersect_fn, occluded_fn, hint_fn = make_intersectors(scene, cfg)
        # sample-major lane order: each sample's segment keeps the swizzle
        pixel_ids = pix_part.repeat(n_s)
        rows = torch.arange(m, device=dev).repeat(n_s)
        sample_ids = samples.repeat_interleave(m)
        o, d = _primary_rays(cfg, cam, pixel_ids, sample_ids)
        radiance, pix_out, rays, prime_out, gbuf = path_mod.trace_paths(
            scene, cfg, o, d, pixel_ids, sample_ids, intersect_fn, occluded_fn,
            prime=prime_part, local_pix=rows, sample_window=sample_window,
            hint_fn=hint_fn, want_gbuffer=gbuffer, n_pixels=m)
        # lanes may come back permuted (cfg.wavefront_sort): a lane's part row
        # comes from its returned pixel id through the inverse part table
        inv_part = torch.zeros((cfg.width * cfg.height,), dtype=torch.int64,
                               device=dev)
        inv_part[pix_part.long()] = torch.arange(m, device=dev)
        rows = inv_part[pix_out.long()]
        order = None if not cfg.wavefront_sort else torch.argsort(rows,
                                                                  stable=True)
        part_img = sample_sum(radiance, order, m, n_s)
        if gbuf is not None:
            lum = vmath.luminance(radiance)
            gbuf = dict(gbuf, m1=sample_sum(lum, order, m, n_s),
                        m2=sample_sum(lum * lum, order, m, n_s))
        return part_img, rays, prime_out, gbuf


def sample_sum(values, order, m: int, n_s: int):
    """Per-row sums [m, ...] of the n_s samples each of m rows.

    values [n_s * m, ...] holds the lanes sample-major (lane s * m + r is
    row r's sample s) when order is None; else values[order] holds them
    row-major, each row's samples in lane order (a stable sort of the
    lanes' rows). A row's samples are added one after another in lane
    order, so the sum is the same on every run, on the card as on the
    CPU, and equal to index_add_'s on the CPU (index_add_'s CUDA atomics
    add them in no fixed order).
    """
    if order is None:
        per = values.reshape((n_s, m) + values.shape[1:])
    else:
        per = values[order].reshape((m, n_s) + values.shape[1:]
                                    ).transpose(0, 1)
    out = torch.zeros_like(per[0])
    for s in range(n_s):
        out += per[s]
    return out


def render_frame_batched(scene: Scene, cfg: RenderConfig,
                         cam: cam_mod.CameraState, frame_idx: int,
                         prime=None, gbuffer: bool = False, frames: int = 1):
    """ALL cfg.spp samples of `frames` consecutive frames as one wavefront.

    The samples are frame_idx * spp + [0, spp * frames): the same sample
    set (and estimator) as `frames` single frames, only the float
    summation order differs. The pool splits into spatial parts of at
    most PT_MAX_WAVEFRONT lanes (default POOL_SATURATION_LANES) along the
    swizzled lane order; each part traces all samples of a contiguous run
    of 8x8 pixel blocks, with its pixels' rows of the hints. prime:
    i32[W*H, 3] hints in pixel order, or None (unprimed).

    Returns (SUM over the frames of their mean radiance f32[H, W, 3] -
    fold it with film.accumulate_many(film, img, frames) - rays,
    prime_out in prime's layout or None, gbuf or None). gbuf holds
    normal f32[W*H, 3], depth f32[W*H], albedo f32[W*H, 3] in pixel order
    and the moments m1/m2 f32[H, W], summed over the frames like the
    radiance.
    """
    w, h = cfg.width, cfg.height
    n = w * h
    spp_eff = cfg.spp * frames
    base_pix = _base_pixels(w, h, scene.device)
    samples = frame_idx * cfg.spp + torch.arange(
        spp_eff, dtype=torch.int64, device=scene.device)
    bounds = _part_bounds(n, spp_eff)
    img = torch.zeros((n, 3), dtype=torch.float32, device=scene.device)
    primed = prime is not None
    prime_out = torch.empty_like(prime) if primed else None
    gbuf = None
    rays = 0
    for p in range(len(bounds) - 1):
        pix_part = base_pix[bounds[p]:bounds[p + 1]]
        rows = pix_part.long()
        part_img, rays_p, prime_p, gbuf_p = _trace_pool_part(
            scene, cfg, cam, pix_part, samples, spp_eff,
            prime[rows] if primed else None, gbuffer)
        img[rows] = part_img            # parts partition the pixels
        if primed:
            prime_out[rows] = prime_p
        if gbuf_p is not None:
            if gbuf is None:
                gbuf = {k: v.new_empty((n,) + v.shape[1:])
                        for k, v in gbuf_p.items()}
            for k, v in gbuf_p.items():
                gbuf[k][rows] = v
        rays = rays + rays_p
    if gbuf is not None:
        gbuf["m1"] = (gbuf["m1"] / cfg.spp).reshape(h, w)
        gbuf["m2"] = (gbuf["m2"] / cfg.spp).reshape(h, w)
    return (img / cfg.spp).reshape(h, w, 3), rays, prime_out, gbuf


def _initial_prime(cfg: RenderConfig, prime, device):
    """The hint table a frame starts from: None without priming, all -1
    before the first primed frame. Priming runs on the cluster and bvh
    routes (the JAX package primes the cluster route only; on the bvh
    route the port's verified primary hint bounds K5's walk, and its
    film equals the unprimed one)."""
    if not (cfg.primary_priming and cfg.intersector in ("cluster", "bvh")):
        return None
    if prime is None:
        prime = torch.full((cfg.width * cfg.height, 3), -1,
                           dtype=torch.int32, device=device)
    return prime


def render_frame_with_stats(scene: Scene, cfg: RenderConfig,
                            cam: cam_mod.CameraState, frame_idx: int,
                            prime=None, return_prime: bool = False,
                            gbuffer: bool = False):
    """One frame's radiance estimate (mean of cfg.spp samples) and rays.

    With cfg.primary_priming on the cluster or bvh intersector, `prime`
    (the previous frame's hints, or None) seeds this frame's first sample and
    the hints chain across its samples; return_prime appends this
    frame's hints (None when priming is off). gbuffer appends the
    frame's G-buffer (None at max_depth 1): one primary lane's features
    per pixel in spp-batched frames, the mean over samples in the
    per-sample loop, and the moments m1/m2 f32[H, W] (means over the
    samples of the luminance and its square) either way.
    """
    want_gb = gbuffer and cfg.max_depth > 1
    prime = _initial_prime(cfg, prime, scene.device)
    if cfg.spp_batch and cfg.spp > 1:
        radiance, rays, prime, gb = render_frame_batched(
            scene, cfg, cam, frame_idx, prime, gbuffer=want_gb)
    else:
        radiance = None
        rays = 0
        gb = None
        for s in range(cfg.spp):
            r, k, prime, g = render_sample(scene, cfg, cam, frame_idx, s,
                                           prime, gbuffer=want_gb)
            radiance = r if radiance is None else radiance + r
            rays = rays + k
            if want_gb:
                lum = vmath.luminance(r)
                g = dict(g, m1=lum, m2=lum * lum)
                gb = g if gb is None else {k_: gb[k_] + g[k_] for k_ in gb}
        radiance = radiance / cfg.spp
        if gb is not None:
            gb = {k_: v / cfg.spp for k_, v in gb.items()}
    out = (radiance, rays)
    if return_prime:
        out = out + (prime,)
    if gbuffer:
        out = out + (gb,)
    return out


def render_frame(scene: Scene, cfg: RenderConfig, cam: cam_mod.CameraState,
                 frame_idx: int):
    """One frame's linear radiance f32[H, W, 3]."""
    return render_frame_with_stats(scene, cfg, cam, frame_idx)[0]


def render_step(scene: Scene, cfg: RenderConfig, cam: cam_mod.CameraState,
                film: film_mod.Film) -> film_mod.Film:
    """One progressive step: render at film.frame and fold into the film."""
    return film_mod.accumulate(film, render_frame(scene, cfg, cam,
                                                  film.frame))


class Renderer:
    """Headless progressive renderer: owns (scene, cfg, camera, film) on `device`.

    `step()` renders one frame - or cfg.frame_batch = F frames as one
    wavefront - and folds it into the film; a camera move resets
    accumulation (main.cpp:678-681). With priming the hints chain across
    frames and are kept across camera moves: they are re-verified
    against the new rays, so stale ones cost one dense test each.

    auto_frame_batch = F > 1: the step after construction or a camera
    move renders one frame (latency), every later step F frames as one
    wavefront (throughput); the sample set is that of single steps.
    motion_preview = s > 1: the step after a camera move renders a 1-spp,
    depth <= 3 preview at 1/s of the resolution, which display()
    upscales; the film never sees it. With cfg.denoise or
    cfg.capture_gbuffer the G-buffer is kept as a running mean over the
    frames for the denoiser (display) and the AOVs.

    mesh (parallel/sharding.make_mesh): every step renders this rank's
    (tile, sample) shard and the ranks reduce the shards, so every rank
    holds the same film, hints and G-buffer. The motion preview stays a
    single-device render on each rank (deterministic: every rank shows
    the same preview).
    """

    def __init__(self, scene: Scene, cfg: RenderConfig,
                 camera: Optional[cam_mod.Camera] = None, *, device,
                 mesh=None, auto_frame_batch: int = 0,
                 motion_preview: int = 0):
        self.device = torch.device(device)
        self.mesh = mesh
        if cfg.intersector == "bvh" and scene.bvh is None:
            from pathtracer_torch.accel import lbvh

            scene = lbvh.build_scene_bvh(scene.to(self.device))
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
        self._gbuf = None       # running-mean G-buffer (denoise / AOVs)
        self._gbuf_frames = 0
        # display-time toggles; cfg stays the source of G-buffer capture
        self.denoise = cfg.denoise
        self.tonemap = cfg.tonemap
        self.auto_frame_batch = int(auto_frame_batch)
        self.motion_preview = int(motion_preview)
        self._frames_done = 0
        self._preview = None

    def reset(self):
        self.film = film_mod.new_film(self.cfg.width, self.cfg.height,
                                      device=self.device)
        self._gbuf = None
        self._gbuf_frames = 0
        self._frames_done = 0

    def _step_preview(self) -> film_mod.Film:
        """Moving-camera step: low-res 1-spp preview, film untouched."""
        s = self.motion_preview
        cfg_p = dataclasses.replace(
            self.cfg, width=max(16, (self.cfg.width // s) // 8 * 8),
            height=max(16, (self.cfg.height // s) // 8 * 8), spp=1,
            spp_batch=False, frame_batch=1, denoise=False,
            primary_priming=False, max_depth=min(3, self.cfg.max_depth))
        self._preview, self.last_rays = render_frame_with_stats(
            self.scene, cfg_p, self.camera.state(device=self.device), 0)
        return self.film

    def _fold_gbuf(self, gb, frames: int):
        """Running mean of per-frame G-buffers over the film's frames."""
        if gb is None:
            return
        if self._gbuf is None:
            self._gbuf = gb
        else:
            k = self._gbuf_frames
            self._gbuf = {n: (v * k + gb[n] * frames) / (k + frames)
                          for n, v in self._gbuf.items()}
        self._gbuf_frames += frames

    def step(self) -> film_mod.Film:
        with tracing.span("pt.step") as sp:
            return self._step(sp)

    def _step(self, sp) -> film_mod.Film:
        if self.camera.moved:
            self.reset()
            self.camera.moved = False
            if self.motion_preview > 1:
                sp.set(frames=0)
                return self._step_preview()
        self._preview = None
        want_gb = ((self.cfg.denoise or self.cfg.capture_gbuffer)
                   and self.cfg.max_depth > 1)
        cam = self.camera.state(device=self.device)
        f = self.cfg.frame_batch
        if f == 1 and self.auto_frame_batch > 1 and self._frames_done > 0:
            f = self.auto_frame_batch
        sp.set(frames=f)
        if self.mesh is not None or f > 1:
            prime = _initial_prime(self.cfg, self._prime, self.device)
            if self.mesh is not None:
                from pathtracer_torch.parallel import sharding

                radiance_sum, rays, prime, gb = sharding.render_frame_sharded(
                    self.scene, self.cfg, cam, self.film.frame, self.mesh,
                    prime, gbuffer=want_gb, frames=f)
            else:
                radiance_sum, rays, prime, gb = render_frame_batched(
                    self.scene, self.cfg, cam, self.film.frame, prime,
                    gbuffer=want_gb, frames=f)
            if gb is not None:
                # moments come back summed over the F frames; the features
                # are one primary lane's (sharded loop branch: the mean)
                gb = dict(gb, m1=gb["m1"] / f, m2=gb["m2"] / f)
            self.film = film_mod.accumulate_many(self.film, radiance_sum, f)
        else:
            out = render_frame_with_stats(
                self.scene, self.cfg, cam, self.film.frame,
                prime=self._prime, return_prime=True, gbuffer=want_gb)
            radiance, rays, prime = out[:3]
            gb = out[3] if want_gb else None
            self.film = film_mod.accumulate(self.film, radiance)
        self._prime = prime
        self._fold_gbuf(gb, f)
        self.last_rays = rays
        self._frames_done += f
        return self.film

    def run(self, n_frames: int) -> film_mod.Film:
        """n_frames steps (each folds cfg.frame_batch frames).

        Auto frame batching and motion preview are suspended, so no step
        is a batch of another size or a preview: a run that starts with
        camera.moved set folds every step (the JAX Renderer.run suspends
        only auto frame batching and folds one step fewer there).
        """
        saved = self.auto_frame_batch, self.motion_preview
        self.auto_frame_batch = self.motion_preview = 0
        try:
            for _ in range(n_frames):
                self.step()
        finally:
            self.auto_frame_batch, self.motion_preview = saved
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.film

    def denoised(self):
        """The film's linear radiance through the a-trous denoiser
        (film/denoise.py), its edge stops taken from the running
        G-buffer; the film itself is never modified. The raw film before
        any G-buffer."""
        if self._gbuf is None:
            return self.film.accum
        from pathtracer_torch.film import denoise as dn

        h, w = self.cfg.height, self.cfg.width
        # variance of the MEAN estimate from the luminance moments; a 1-3
        # sample second moment is degenerate, so the variance term waits
        # for 4 samples
        n_s = max(1, self._gbuf_frames * self.cfg.spp)
        var = ((self._gbuf["m2"] - self._gbuf["m1"] ** 2) / n_s
               if n_s >= 4 else None)
        return dn.atrous_denoise(
            self.film.accum, self._gbuf["normal"].reshape(h, w, 3),
            self._gbuf["depth"].reshape(h, w),
            self._gbuf["albedo"].reshape(h, w, 3),
            iterations=self.cfg.denoise_iterations, variance=var)

    def display(self) -> np.ndarray:
        """Tone-mapped current image, f32 [H, W, 3] in [0, 1].

        While a motion preview stands, it is nearest-upscaled to the
        display size. With denoise on, the film goes through denoised().
        """
        if self._preview is not None:
            p = film_mod.to_display(self._preview,
                                    self.tonemap).cpu().numpy()
            ys = (np.arange(self.cfg.height) * p.shape[0]) // self.cfg.height
            xs = (np.arange(self.cfg.width) * p.shape[1]) // self.cfg.width
            return p[ys][:, xs]
        linear = self.denoised() if self.denoise else self.film.accum
        return film_mod.to_display(linear, self.tonemap).cpu().numpy()

    def save_png(self, path: str):
        film_mod.write_png(path, self.display())

    def aovs(self) -> dict:
        """Display-ready AOVs of the G-buffer, f32 [H, W, 3] numpy each:
        normal mapped [-1, 1] -> [0, 1], depth as 1 / (1 + d) (sky 0),
        albedo clipped to [0, 1]. {} before a frame with a G-buffer."""
        if self._gbuf is None:
            return {}
        h, w = self.cfg.height, self.cfg.width
        n = self._gbuf["normal"].cpu().numpy().reshape(h, w, 3)
        d = self._gbuf["depth"].cpu().numpy().reshape(h, w)
        a = self._gbuf["albedo"].cpu().numpy().reshape(h, w, 3)
        return {
            "normal": np.clip(n * 0.5 + 0.5, 0.0, 1.0),
            "depth": np.repeat((1.0 / (1.0 + np.where(
                np.isfinite(d), d, np.inf)))[..., None], 3, axis=-1),
            "albedo": np.clip(a, 0.0, 1.0),
        }


def render_progressive(scene: Scene, cfg: RenderConfig,
                       camera: cam_mod.Camera, n_frames: int, *, device):
    """Run n_frames progressive steps on `device`; returns the film."""
    return Renderer(scene, cfg, camera, device=device).run(n_frames)
