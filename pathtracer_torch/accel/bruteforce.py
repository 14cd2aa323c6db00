"""Brute-force O(n) intersector as an accel "backend" (counterpart of
pathtracer/accel/bruteforce.py).

The exactness oracle of the accel routes - thin wrappers over
kernels/intersect.py, with the call interface render.make_intersectors
gives every route: intersect_fn takes `primary` (unused here) and
occluded_fn also takes `want_blocker` (the lowest blocking triangle as
the shadow-priming hint).
"""

from __future__ import annotations

from pathtracer_torch import tracing
from pathtracer_torch.kernels import intersect as isect


def make_brute_intersectors(v0, v1, v2):
    """Returns (intersect_fn, occluded_fn) closing over triangle tensors
    f32 [T, 3]."""

    def intersect_fn(o, d, t_min, t_max, primary=False):
        with tracing.span("pt.traverse.closest"):
            return isect.intersect_brute(o, d, v0, v1, v2, t_min, t_max)

    def occluded_fn(o, d, t_max, primary=False, want_blocker=False):
        with tracing.span("pt.traverse.occluded"):
            return isect.occluded_brute(o, d, t_max, v0, v1, v2,
                                        want_blocker=want_blocker)

    return intersect_fn, occluded_fn
