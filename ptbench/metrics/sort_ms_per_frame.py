"""sort_ms_per_frame: device time of the sort kernels, per frame of the
profiled steps, in ms."""


def read(rec):
    p = rec.profile
    if not p or p["busy_s"] <= 0 or not p["frames"]:
        return None
    return 1e3 * p["by_kind"]["sort"] / p["frames"]
