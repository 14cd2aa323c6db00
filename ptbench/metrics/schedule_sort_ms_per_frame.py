"""schedule_sort_ms_per_frame: device time, per frame of the profiled
steps (the program's tracing on), of the ops launched inside its
pt.schedule spans - the packet layer's per-tile schedule sort of each
live chunk, apart from the coherence sort - in ms. None where the
program has no such span."""


def read(rec):
    p = rec.profile
    if not p or p["device_s"] <= 0 or not p["frames"]:
        return None
    row = p["by_span"].get("pt.schedule")
    if row is None:
        return None
    return 1e3 * row["device_s"] / p["frames"]
