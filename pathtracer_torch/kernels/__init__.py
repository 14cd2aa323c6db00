"""Traversal kernels and their host side.

LAUNCHES counts kernel launches per wrapper (cull.tile_cull,
sweep.sweep_closest, sweep.sweep_occluded): each wrapper adds one where
it launches its CUDA kernel and nowhere else, so a run can show that the
main path went through the kernels.
"""

LAUNCHES = {"tile_cull": 0, "sweep_closest": 0, "sweep_occluded": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
