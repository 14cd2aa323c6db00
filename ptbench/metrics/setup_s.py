"""setup_s: process start to the first timed step, in s: imports, the
kernel libraries, the scene, the accel, the upload, the Renderer and
the cell's warm-up steps."""


def read(rec):
    return rec.setup_s
