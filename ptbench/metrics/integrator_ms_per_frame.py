"""integrator_ms_per_frame: device time, per frame of the profiled
steps, of the ops launched inside the program's pt.bounce, pt.wavefront
or pt.film spans and outside every pt.traverse.* span (ptbench.stages,
a run with pathtracer_torch.tracing on), in ms."""


def read(rec):
    p = rec.profile
    if not p or "integrator_s" not in p or not p["frames"]:
        return None
    return 1e3 * p["integrator_s"] / p["frames"]
