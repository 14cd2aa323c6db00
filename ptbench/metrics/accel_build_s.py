"""accel_build_s: the span around the accel build that the configuration's
intersector takes (ptbench.run.build_accel), in s: on the cluster route
build_scene_clusters and then the move of the scene and its accel to the
device; on the bvh route the move and then the LBVH build on the device;
on the brute route the move alone."""


def read(rec):
    return rec.spans.get("accel_build")
