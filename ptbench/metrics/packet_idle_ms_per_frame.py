"""packet_idle_ms_per_frame: device idle, per frame of the profiled
steps (the program's tracing on), in the gaps whose midpoint lies inside
a pt.traverse.* span on the profiler's clock (ptbench.stages): the sync
drains and the chunk loop's launches, in ms."""


def read(rec):
    p = rec.profile
    if not p or p["device_s"] <= 0 or not p["frames"]:
        return None
    return 1e3 * p["packet_idle_s"] / p["frames"]
