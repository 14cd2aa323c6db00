"""packet_ms_per_frame: device time, per frame of the profiled steps (the
program's tracing on), of the ops launched inside its pt.traverse.*
spans that are not hand-written kernels: keys, sorts, gathers, cats,
scatters (ptbench.stages), in ms."""


def read(rec):
    p = rec.profile
    if not p or p["device_s"] <= 0 or not p["frames"]:
        return None
    return 1e3 * p["packet_s"] / p["frames"]
