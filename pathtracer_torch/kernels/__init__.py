"""Traversal kernels and their host side.

LAUNCHES counts kernel launches per kernel (cull.tile_cull for K1,
cull.tile_cull_skip for K4, sweep.sweep_closest, sweep.sweep_occluded,
sweep.sweep_occluded with want_blocker as "sweep_occluded_blocker",
traverse.intersect_bvh as "bvh_closest" for K5 and traverse.occluded_bvh
as "bvh_occluded" for K6): each wrapper adds one where
it launches its CUDA kernel and nowhere else, so a run can show that the
main path went through the kernels.
"""

LAUNCHES = {"tile_cull": 0, "tile_cull_skip": 0, "sweep_closest": 0,
            "sweep_occluded": 0, "sweep_occluded_blocker": 0,
            "bvh_closest": 0, "bvh_occluded": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
