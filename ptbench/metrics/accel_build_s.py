"""accel_build_s: the span around build_scene_clusters and the move of
the scene and its accel to the device, in s."""


def read(rec):
    return rec.spans.get("accel_build")
