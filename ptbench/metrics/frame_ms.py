"""frame_ms: window wall time over the frames the window completed
(each driver's frames(): for accumulation, folded into the film), in
ms."""


def read(rec):
    return 1e3 * rec.window_s / rec.frames if rec.frames else None
