"""host_busy_ms_per_frame: over the traced window on the host clock, the
program's pt.step spans less the pt.sync time inside them - the host's
enqueue time, without the profiler's overhead - over the window's frames
(`rec.tracing`, ptbench.stages.window), in ms."""


def read(rec):
    t = rec.tracing
    if not t or not rec.frames:
        return None
    return 1e3 * t["host_busy_s"] / rec.frames
