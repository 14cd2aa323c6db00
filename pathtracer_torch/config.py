"""Render configuration (counterpart of pathtracer/config.py).

Same fields and defaults as the JAX `RenderConfig`, so a config can be
carried across field by field. The two default-off knobs this port
does not implement (wavefront_sort, skip_nee) raise `ValueError` naming
the ROADMAP item that covers them.

traversal_backend: only "pallas", the hand-written traversal kernels
(kernels/cull.py, kernels/sweep.py): CUDA kernels for CUDA tensors,
their plain PyTorch versions for CPU tensors. The JAX package's "xla"
route is a lockstep Moller-Trumbore sweep; the port has no second route
and rejects it.
"""

from __future__ import annotations

import dataclasses

# Wavefront pool-saturation point in lanes, and the default
# PT_MAX_WAVEFRONT spatial-part split threshold (render.py).
POOL_SATURATION_LANES = 1 << 23


def saturating_frame_batch(width: int, height: int, spp: int,
                           cap: int = 8) -> int:
    """Frames per step that grow the pool toward POOL_SATURATION_LANES
    (the '--frame-batch auto' policy; pathtracer/config.py:35-44)."""
    pool = width * height * spp
    return max(1, min(cap, POOL_SATURATION_LANES // pool))


def _unported(what: str, item: str):
    return ValueError(f"{what} is not ported to pathtracer_torch yet "
                      f"(ROADMAP.md Queue 1, {item})")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (hashable)."""

    width: int = 1280
    height: int = 720
    spp: int = 4
    max_depth: int = 6
    fov_deg: float = 70.0

    rr_start_depth: int = 3
    rr_clamp_lo: float = 0.05
    rr_clamp_hi: float = 0.95
    throughput_cutoff: float = 1e-4

    emission_gain: float = 10.0

    sky: str = "gradient"
    env_importance_sampling: bool = False
    sky_gain: float = 0.2
    sun_direction: tuple = (0.3, 0.6, 0.2)
    sun_intensity: float = 20.0

    seed: int = 0
    sampler: str = "pcg"

    aperture: float = 0.0
    focus_dist: float = 0.0

    t_min: float = 1e-3
    t_max: float = 1e20
    shadow_eps: float = 1e-4

    env_nee_cell: int = 8
    env_shadow_rr: float = 0.0

    reference_quirks: bool = False

    intersector: str = "cluster"
    traversal_backend: str = "pallas"

    rays_per_chunk: int = 0

    wavefront_sort: bool = False
    packet_sort: bool = True
    spp_batch: bool = False
    frame_batch: int = 1

    skip_nee: bool = False
    primary_priming: bool = False

    denoise: bool = False
    denoise_iterations: int = 3
    clamp_radiance: float = 0.0
    tonemap: str = "gamma"
    capture_gbuffer: bool = False
    stochastic_texture_filtering: bool = True

    def __post_init__(self):
        # the JAX package's own validation, same messages
        if self.width <= 0 or self.height <= 0:
            raise ValueError("resolution must be positive")
        if self.spp <= 0:
            raise ValueError("spp must be positive")
        if self.env_nee_cell < 1:
            raise ValueError("env_nee_cell must be >= 1")
        if self.aperture < 0.0:
            raise ValueError("aperture must be >= 0")
        if self.tonemap not in ("gamma", "reinhard", "aces"):
            raise ValueError("tonemap must be gamma|reinhard|aces")
        if self.aperture > 0.0 and self.focus_dist <= 0.0:
            raise ValueError("aperture > 0 requires focus_dist > 0 "
                             "(the focal plane distance)")
        if self.max_depth <= 0:
            raise ValueError("max_depth must be positive")
        if self.sky not in ("gradient", "black", "hosek", "envmap"):
            raise ValueError(f"unknown sky model: {self.sky!r}")
        if self.intersector not in ("cluster", "bvh", "brute"):
            raise ValueError(f"unknown intersector: {self.intersector!r}")
        if self.traversal_backend not in ("pallas", "xla"):
            raise ValueError(
                f"unknown traversal backend: {self.traversal_backend!r}")
        if self.traversal_backend == "xla":
            raise ValueError(
                "traversal_backend='xla' (the JAX package's lockstep sweep) "
                "is not part of pathtracer_torch: 'pallas' runs the CUDA "
                "kernels on CUDA tensors and their plain versions on CPU "
                "tensors")
        if self.sampler not in ("pcg", "sobol"):
            raise ValueError(f"unknown sampler: {self.sampler!r}")
        if self.frame_batch < 1:
            raise ValueError("frame_batch must be >= 1")
        if self.frame_batch > 1 and not self.spp_batch:
            raise ValueError("frame_batch > 1 requires spp_batch "
                             "(the cross-frame pool IS the batched "
                             "wavefront)")
        # what the port does not implement yet
        if self.wavefront_sort:
            raise _unported("wavefront_sort", "item 11 (default-off knobs)")
        if self.skip_nee:
            raise _unported("skip_nee", "item 11 (default-off knobs)")

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    @property
    def aspect(self) -> float:
        return self.width / self.height
