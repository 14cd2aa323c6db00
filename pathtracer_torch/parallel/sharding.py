"""Multi-device rendering over a (tile, sample) mesh of ranks (counterpart
of pathtracer/parallel/sharding.py).

The JAX package drives every device from one controller with shard_map.
The port is SPMD: one process per rank (torchrun, or torch.multiprocessing),
each rendering on its own device, with torch.distributed carrying the one
collective family.

- tile axis: the frame's lanes (pixels in the 8x8-block swizzled order)
  split into `tile` contiguous slices; a rank traces its tile's slice.
- sample axis: the spp samples of a frame split into `sample` runs of
  spp / sample samples; a rank traces its run.

A rank computes its shard's contribution to full-size, lane-order
buffers (zero outside its tile slice, hints -1 there); then one
all_reduce per buffer over the mesh's group adds the sample shards and
assembles the tiles in one call: SUM for the radiance, the G-buffer and
the ray count, MAX for the hints (any rank's verified hint is exact, and
ranks outside the tile contribute -1, so this is the reference's pmax).
Every rank ends with the same film. The RNG keys on (pixel, global
sample), so the layout does not change the estimate.

A mesh whose rank is None holds every rank in this process, as the JAX
package's single-controller mesh does: the shards render one after
another and reduce in process (the CPU tests use it).

The caller initialises the process group (torch.distributed.
init_process_group): NCCL for CUDA tensors, gloo for CPU tensors. Gloo
also reduces CUDA tensors, so several ranks can share one card; only
all_reduce is used, which gloo supports for CUDA tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from pathtracer_torch import render
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.integrator import camera as cam_mod
from pathtracer_torch.integrator import path as path_mod
from pathtracer_torch.scene.types import Scene
from pathtracer_torch.utils import vmath

_FEATURES = ("normal", "depth", "albedo")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (tile, sample) mesh of tile * sample ranks, laid out row-major:
    rank r sits at (tile_idx, sample_idx) = divmod(r, sample). rank None:
    every rank in this process. group: the process group the shards
    reduce over (the default group; None without one)."""

    tile: int
    sample: int
    rank: Optional[int] = None
    group: Any = None

    @property
    def size(self) -> int:
        return self.tile * self.sample

    @property
    def shape(self):
        return (self.tile, self.sample)

    def coords(self, rank: Optional[int] = None):
        """(tile_idx, sample_idx) of `rank` (default this process's)."""
        r = self.rank if rank is None else rank
        if r is None:
            raise ValueError("this mesh holds every rank in one process; "
                             "name the rank")
        return divmod(r, self.sample)


def make_mesh(tile: Optional[int] = None, sample: Optional[int] = None, *,
              world_size: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """A (tile, sample) mesh over world_size ranks, reducing over the
    default process group.

    Default factorization (the JAX package's): sample = 2 if the rank
    count is even, else 1; tile = ranks / sample. world_size defaults to
    the size of the initialised process group, and rank to this
    process's rank in it; with no process group initialised, rank None
    puts every rank in this process. Building a mesh never initialises
    a process group.
    """
    if world_size is None:
        if not dist.is_initialized():
            raise ValueError("make_mesh: no process group is initialised; "
                             "call torch.distributed.init_process_group "
                             "first, or pass world_size")
        world_size = dist.get_world_size()
    group = dist.group.WORLD if dist.is_initialized() else None
    if rank is None and group is not None:
        rank = dist.get_rank()
    n = int(world_size)
    if tile is None or sample is None:
        sample = 2 if n % 2 == 0 and n >= 2 else 1
        tile = n // sample
    if tile < 1 or sample < 1 or tile * sample != n:
        raise ValueError(f"mesh ({tile}, {sample}) does not cover {n} "
                         "ranks")
    if rank is not None and not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a world of {n}")
    return Mesh(tile=int(tile), sample=int(sample), rank=rank, group=group)


@dataclasses.dataclass
class Contribution:
    """One shard's part of a frame, in full-size lane-order buffers.

    radiance f32[n, 3]: per-lane sums over the shard's samples, zero
    outside its tile slice; rays int64[1]; prime i32[n, 3] hints (-1
    outside the slice) or None; gbuf {normal f32[n, 3], depth f32[n],
    albedo f32[n, 3], m1 f32[n], m2 f32[n]} sums or None; batched: which
    branch rendered it (sets the G-buffer's normalisation).
    """

    radiance: torch.Tensor
    rays: torch.Tensor
    prime: Optional[torch.Tensor]
    gbuf: Optional[dict]
    batched: bool

    def buffers(self):
        """(tensor, reduce op) in the order every rank reduces them."""
        out = [(self.radiance, "sum"), (self.rays, "sum")]
        if self.prime is not None:
            out.append((self.prime, "max"))
        for v in (self.gbuf or {}).values():
            out.append((v, "sum"))
        return out


def _check(cfg: RenderConfig, mesh_shape):
    n_tile, n_sample = mesh_shape
    n_pix = cfg.width * cfg.height
    if n_pix % n_tile:
        raise ValueError(f"pixels {n_pix} not divisible by tile axis "
                         f"{n_tile}")
    if cfg.spp % n_sample:
        raise ValueError(f"spp {cfg.spp} not divisible by sample axis "
                         f"{n_sample}")


def shard_contribution(scene: Scene, cfg: RenderConfig,
                       cam: cam_mod.CameraState, frame_idx: int, mesh_shape,
                       coords, prime=None, gbuffer: bool = False,
                       frames: int = 1) -> Contribution:
    """The contribution of shard `coords` = (tile_idx, sample_idx) of a
    (tile, sample) mesh to frames frame_idx .. frame_idx + frames - 1.

    The shard traces its tile's lane slice at the samples (frame_idx + f)
    * spp + sample_idx * spp / sample + [0, spp / sample) of each frame f.
    With cfg.spp_batch or frames > 1 (and more than one such sample)
    they trace as one wavefront, split into spatial parts of at most
    PT_MAX_WAVEFRONT lanes like the single-device pool; its G-buffer
    features come from sample shard 0 only (each row from its lowest
    sample, as on one device) and its moments are sums. Otherwise one
    wavefront a sample, with the hints chained across them and every
    G-buffer field summed. prime: i32[W*H, 3] hints in pixel order, or
    None (unprimed).
    """
    _check(cfg, mesh_shape)
    n_tile, n_sample = mesh_shape
    t_idx, s_idx = coords
    w, h = cfg.width, cfg.height
    n = w * h
    m = n // n_tile
    lo = t_idx * m
    local_spp = cfg.spp // n_sample
    dev = scene.device
    pix = render._base_pixels(w, h, dev)[lo:lo + m]
    prime_local = prime[pix.long()] if prime is not None else None
    want_gb = gbuffer and cfg.max_depth > 1
    first = frame_idx * cfg.spp + s_idx * local_spp
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    hints = (torch.full((n, 3), -1, dtype=torch.int32, device=dev)
             if prime is not None else None)
    rays = torch.zeros((1,), dtype=torch.int64, device=dev)
    gbuf = None

    def put_gbuf(rows, gb):
        nonlocal gbuf
        if gbuf is None:
            gbuf = {k: v.new_zeros((n,) + v.shape[1:]) for k, v in gb.items()}
        for k, v in gb.items():
            gbuf[k][rows] = v

    batched = (cfg.spp_batch or frames > 1) and local_spp * frames > 1
    if batched:
        samples = (first + cfg.spp * torch.arange(
            frames, dtype=torch.int64, device=dev)[:, None]
            + torch.arange(local_spp, dtype=torch.int64,
                           device=dev)[None, :]).reshape(-1)
        bounds = render._part_bounds(m, samples.numel())
        for a, b in zip(bounds[:-1], bounds[1:]):
            img_p, rays_p, prime_p, gb_p = render._trace_pool_part(
                scene, cfg, cam, pix[a:b], samples, cfg.spp * frames,
                prime_local[a:b] if prime_local is not None else None,
                want_gb)
            rows = slice(lo + a, lo + b)
            radiance[rows] = img_p
            if hints is not None:
                hints[rows] = prime_p
            if gb_p is not None:
                if s_idx != 0:   # features: sample shard 0's rows only
                    gb_p = dict(gb_p, **{k: torch.zeros_like(gb_p[k])
                                         for k in _FEATURES})
                put_gbuf(rows, gb_p)
            rays += rays_p
    else:
        intersect_fn, occluded_fn, hint_fn = render.make_intersectors(
            scene, cfg)
        lane_rows = torch.arange(m, device=dev)
        # a pixel id's position in the lane-order buffers (lanes may come
        # back permuted under cfg.wavefront_sort)
        inv_base = torch.zeros((n,), dtype=torch.int64, device=dev)
        inv_base[render._base_pixels(w, h, dev).long()] = torch.arange(
            n, device=dev)
        gb_sum = None
        for s in range(local_spp):
            sample_ids = torch.full((m,), first + s, dtype=torch.int64,
                                    device=dev)
            o, d = render._primary_rays(cfg, cam, pix, sample_ids)
            r, pix_out, k, prime_o, gb = path_mod.trace_paths(
                scene, cfg, o, d, pix, sample_ids, intersect_fn,
                occluded_fn, prime=prime_local, local_pix=lane_rows,
                sample_window=1, hint_fn=hint_fn, want_gbuffer=want_gb,
                n_pixels=m)
            r_rows = torch.empty_like(r)          # one lane a pixel
            r_rows[inv_base[pix_out.long()] - lo] = r
            r = r_rows
            radiance[lo:lo + m] += r
            rays += k
            if prime_local is not None:
                prime_local = prime_o      # hints chain across the loop
            if want_gb:
                lum = vmath.luminance(r)
                gb = dict(gb, m1=lum, m2=lum * lum)
                gb_sum = gb if gb_sum is None else {
                    key: gb_sum[key] + gb[key] for key in gb_sum}
        if hints is not None:
            hints[lo:lo + m] = prime_local
        if gb_sum is not None:
            put_gbuf(slice(lo, lo + m), gb_sum)
    return Contribution(radiance, rays, hints, gbuf, batched)


def combine(parts) -> Contribution:
    """Reduce contributions in this process, in the order given: the
    all_reduce of every shard held by one process."""
    out = dataclasses.replace(parts[0])
    bufs = [t.clone() for t, _ in out.buffers()]
    for p in parts[1:]:
        for acc, (t, op) in zip(bufs, p.buffers()):
            if op == "max":
                torch.maximum(acc, t, out=acc)
            else:
                acc += t
    it = iter(bufs)
    out.radiance, out.rays = next(it), next(it)
    if out.prime is not None:
        out.prime = next(it)
    if out.gbuf is not None:
        out.gbuf = {k: next(it) for k in out.gbuf}
    return out


def all_reduce(c: Contribution, group=None) -> Contribution:
    """Reduce every rank's contribution in place over `group`: one
    torch.distributed.all_reduce per buffer."""
    for t, op in c.buffers():
        dist.all_reduce(t, op=(dist.ReduceOp.MAX if op == "max"
                               else dist.ReduceOp.SUM), group=group)
    return c


def finish(c: Contribution, cfg: RenderConfig, lane_pix):
    """Divide the reduced sums by spp and un-swizzle lane order into
    pixel order: (radiance f32[H, W, 3], rays int64 scalar, hints
    i32[W*H, 3] or None, gbuf or None) as render_frame_batched returns
    them. Batched: the moments m1/m2 divide by spp (the features are one
    sample's); loop: every G-buffer field does."""
    w, h = cfg.width, cfg.height
    idx = lane_pix.long()

    def unswizzle(a):
        out = torch.empty_like(a)
        out[idx] = a
        return out

    img = unswizzle(c.radiance / cfg.spp).reshape(h, w, 3)
    prime = unswizzle(c.prime) if c.prime is not None else None
    gbuf = None
    if c.gbuf is not None:
        gbuf = {k: unswizzle(v if c.batched and k in _FEATURES
                             else v / cfg.spp) for k, v in c.gbuf.items()}
        gbuf["m1"] = gbuf["m1"].reshape(h, w)
        gbuf["m2"] = gbuf["m2"].reshape(h, w)
    return img, c.rays.reshape(()), prime, gbuf


def render_frame_sharded(scene: Scene, cfg: RenderConfig,
                         cam: cam_mod.CameraState, frame_idx: int,
                         mesh: Mesh, prime=None, gbuffer: bool = False,
                         frames: int = 1):
    """Render `frames` frames from frame_idx across the mesh.

    Returns (SUM over the frames of their mean radiance f32[H, W, 3],
    rays, hints in pixel order or None, gbuf or None), the same on every
    rank, as render.render_frame_batched returns them: fold the radiance
    with film.accumulate_many(film, img, frames). With mesh.rank set this
    rank renders its shard and the ranks all_reduce; with rank None this
    process renders every shard and reduces them in turn.
    """
    _check(cfg, mesh.shape)
    args = (scene, cfg, cam, frame_idx, mesh.shape)
    kw = dict(prime=prime, gbuffer=gbuffer, frames=frames)
    if mesh.rank is None:
        c = combine([shard_contribution(*args, mesh.coords(r), **kw)
                     for r in range(mesh.size)])
    else:
        world = dist.get_world_size(mesh.group)
        if world != mesh.size:
            raise ValueError(f"mesh {mesh.shape} needs {mesh.size} ranks, "
                             f"the process group has {world}")
        c = all_reduce(shard_contribution(*args, mesh.coords(), **kw),
                       mesh.group)
    return finish(c, cfg, render._base_pixels(cfg.width, cfg.height,
                                              scene.device))
