"""rays_per_frame: Renderer.last_rays summed over the window's steps
(in the traced run), over the window's frames."""


def read(rec):
    if rec.rays is None or not rec.frames:
        return None
    return rec.rays / rec.frames
