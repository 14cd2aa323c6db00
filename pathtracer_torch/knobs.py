"""The JAX package's PT_* environment knobs, and what the port does with each.

Every knob that `pathtracer/` reads is in KNOBS, in one of three states:

  honoured  the port reads it where the JAX package does, with the same
            default, and gives it the same meaning;
  refused   either TPU mechanics with no counterpart on the card (a DMA
            ring depth, a Pallas gate, a per-iteration cost of the v5e
            sweep, the XLA cull), or an alternative of the packet layer
            that was slower than the default on the card (a coherence
            key, the schedule sort, the sort scope, fetch groups): set
            to anything but the JAX default, it makes `check_refused`
            raise a ValueError naming it and giving its own reason;
  equal     accepted at every value because every value gives the same
            result in the port (PT_PERMUTE: the sort network and the
            gather give the same permutation, and the port gathers).

`render.make_intersectors` calls `check_refused` on every frame's
intersectors, so a refused knob never goes unnoticed. The honoured knobs
are read per call, not at import (the JAX package reads PT_TILE_RAYS,
PT_CHUNK_TILES and PT_SWEEP_SLOTS once, at import).
"""

from __future__ import annotations

import os

HONOURED, REFUSED, EQUAL = "honoured", "refused", "equal"

# the packet layer's alternatives: time a frame against the default's on
# an H100 (80 GB HBM3, 700 W), 30 s of the benchmark's 1920x1080 headline
# (4 spp, depth 6) and of its 1024x1024 env map (8 frames a step); "one
# frame": a single headline frame timed earlier, before the integrator's
# draws and shading became kernels
_LOST = "slower than the default on the card: "
_TPU = "TPU mechanics with no counterpart on the card: "

# knob -> (state, where the port reads it, or why it is refused / equal)
KNOBS = {
    "PT_FINE_METHOD": (HONOURED, "accel/cluster.build_scene_clusters"),
    "PT_COARSE_METHOD": (HONOURED, "accel/cluster.build_scene_clusters"),
    "PT_SAH_DUP": (HONOURED, "accel/cluster.build_clusters (sahsplit)"),
    "PT_SAH_DEEP": (HONOURED, "accel/cluster.build_clusters (sahdeep)"),
    "PT_NATIVE_BUILD": (HONOURED, "accel/cluster.build_clusters (sahsplit: "
                        "0 runs the numpy oracle)"),
    "PT_BOUNCE_ACCEL": (HONOURED, "render.make_intersectors"),
    "PT_OCCL_ACCEL": (HONOURED, "render.make_intersectors"),
    "PT_DIR_BITS": (HONOURED, "kernels/packet._coherence_key"),
    "PT_CLOSEST_DB": (HONOURED, "kernels/packet.intersect_clusters"),
    "PT_OCCL_DB": (HONOURED, "kernels/packet.occluded_clusters"),
    "PT_CHUNK_TILES": (HONOURED, "kernels/packet (tiles per chunk)"),
    "PT_TILE_RAYS": (HONOURED, "kernels/packet (rays per tile: 32, 64, "
                     "128 or 256, the widths the sweep kernels take)"),
    "PT_CULL_SKIP": (HONOURED, "kernels/cull.tile_cull (K4)"),
    "PT_CULL_BLK": (HONOURED, "kernels/cull.tile_cull (K4's block width)"),
    "PT_MAX_WAVEFRONT": (HONOURED, "render._part_bounds"),
    "PT_PLATFORM": (HONOURED, "bench/__main__ (cpu or cuda)"),
    "PT_PERMUTE": (EQUAL, "sortnet and gather give the same permutation; "
                   "the port always gathers"),
    "PT_SWEEP_SLOTS": (REFUSED, _TPU + "the depth of the Pallas sweep's "
                       "DMA ring (pallas_sweep.py:48); the port's sweeps "
                       "stage through a two-slot cp.async ring in shared "
                       "memory"),
    "PT_SWEEP_DEADGATE": (REFUSED, _TPU + "the Pallas sweep's dead-tile "
                          "prefetch gate (pallas_sweep.py:55); a CUDA "
                          "block whose tile visits no column stages "
                          "nothing"),
    "PT_SWEEP_GATE": (REFUSED, _TPU + "the Pallas sweep's gated argmin "
                      "extraction (pallas_sweep.py:412); the port's K2 "
                      "merges its candidates once a column"),
    "PT_SWEEP_CPI": (REFUSED, _TPU + "the clusters a Pallas sweep "
                     "iteration opens, sized to the v5e per-iteration "
                     "cost (pallas_sweep.py:359); the port's K2 walks one "
                     "cluster a column"),
    "PT_CULL_BACKEND": (REFUSED, _TPU + "'xla' selects the JAX package's "
                        "XLA cull (packet.py:406); the port's plain "
                        "versions never run on the card, so there is no "
                        "second cull"),
    "PT_KEY_SCHEME": (REFUSED, _LOST + "the mixed key took 1.16x the "
                      "dirmajor key's time a frame on the headline, 1.19x "
                      "on the env map (one frame: 1.106x), and the "
                      "firstcluster keys 1.21x and 1.14x (1.125x); the "
                      "port sorts by dirmajor alone"),
    "PT_KEY_SCHEME_OCCL": (REFUSED, _LOST + "the occlusion calls take the "
                           "dirmajor key as the closest calls do; the "
                           "firstcluster keys of both call kinds took "
                           "1.21x the default's time a frame on the "
                           "headline and 1.14x on the env map (one frame: "
                           "1.125x)"),
    "PT_SCHED_PACK": (REFUSED, _LOST + "the packed u32 schedule sort took "
                      "1.31x the stable sort's time a frame on the "
                      "headline and 1.20x on the env map (one frame: "
                      "1.175x)"),
    "PT_SORT_SCOPE": (REFUSED, _LOST + "a sort per chunk took 2.01x the "
                      "time a frame of one sort of the whole wavefront "
                      "on the headline and 6.35x on the env map (one "
                      "frame: 1.606x): only the whole wavefront's sort "
                      "parks the dead lanes in whole chunks the "
                      "traversal skips"),
    "PT_FETCH_GROUP": (REFUSED, _LOST + "sweeps over groups of 2 clusters "
                       "took 1.17x the time a frame of one cluster a "
                       "column on the headline and 1.00x on the env map "
                       "(one frame: 1.092x)"),
    "PT_GROUP_PRIMARY": (REFUSED, _LOST + "fetch groups of the primary "
                         "closest calls, as PT_FETCH_GROUP's of every "
                         "call (1.17x at 2 on the headline)"),
    "PT_GROUP_BOUNCE": (REFUSED, _LOST + "fetch groups of the bounce "
                        "closest calls, as PT_FETCH_GROUP's of every call "
                        "(1.17x at 2 on the headline)"),
    "PT_GROUP_OCCL": (REFUSED, _LOST + "fetch groups of the occlusion "
                      "calls, as PT_FETCH_GROUP's of every call (1.17x "
                      "at 2 on the headline)"),
}


def _is_int(value: str, n: int) -> bool:
    try:
        return int(value) == n
    except ValueError:
        return False


def _refused_value(name: str, value: str) -> bool:
    """Does `value` of refused knob `name` leave the JAX default?"""
    if name == "PT_SWEEP_SLOTS":
        return max(2, int(value)) != 4
    if name == "PT_SWEEP_DEADGATE":
        return value != "0"
    if name == "PT_SWEEP_GATE":
        return value == "0"
    if name == "PT_SWEEP_CPI":
        return value != ""
    if name == "PT_CULL_BACKEND":
        return value == "xla"
    if name in ("PT_KEY_SCHEME", "PT_KEY_SCHEME_OCCL"):
        return value not in ("", "dirmajor")
    if name == "PT_SCHED_PACK":
        return value != "0"
    if name == "PT_SORT_SCOPE":
        return value != "global"
    if name == "PT_FETCH_GROUP":
        return not _is_int(value, 1)
    if name.startswith("PT_GROUP_"):
        return value != "" and not _is_int(value, 1)
    raise KeyError(name)


def check_refused(env=None):
    """Raise ValueError naming the first refused knob set off its JAX
    default in `env` (default os.environ)."""
    env = os.environ if env is None else env
    for name, (state, why) in KNOBS.items():
        if state != REFUSED or name not in env:
            continue
        if _refused_value(name, env[name]):
            raise ValueError(
                f"{name}={env[name]!r} is refused by pathtracer_torch: "
                f"{why}; unset it")


def choice(name: str, default: str, allowed):
    """Knob `name` (default when unset or empty), checked against
    `allowed`: an honoured knob set to a value the JAX package would
    silently read as another one raises instead."""
    value = os.environ.get(name) or default
    if value not in allowed:
        raise ValueError(f"{name}={value!r}: expected one of "
                         f"{', '.join(allowed)}")
    return value


def integer(name: str, default: int, allowed=None) -> int:
    """Integer knob `name` (default when unset or empty)."""
    raw = os.environ.get(name) or str(default)
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r}: expected an integer") from None
    if allowed is not None and value not in allowed:
        raise ValueError(f"{name}={value}: expected one of "
                         f"{', '.join(map(str, allowed))}")
    return value
