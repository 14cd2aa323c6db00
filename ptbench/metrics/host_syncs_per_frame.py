"""host_syncs_per_frame: the rise of pathtracer_torch.tracing's
host_syncs counter over the traced window, over the window's frames
(`rec.tracing`, ptbench.stages.window)."""


def read(rec):
    t = rec.tracing
    if not t or not rec.frames:
        return None
    return t["host_syncs"] / rec.frames
