"""integrator_ms_per_frame: device time, per frame of the profiled steps
(the program's tracing on), of the ops launched inside its pt.bounce,
pt.wavefront or pt.film spans and outside every pt.traverse.* span
(ptbench.stages), in ms."""


def read(rec):
    p = rec.profile
    if not p or p["device_s"] <= 0 or not p["frames"]:
        return None
    return 1e3 * p["integrator_s"] / p["frames"]
