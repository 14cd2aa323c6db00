"""device_idle_pct: the share of the profiled steps' wall time that no
device activity covers, in %."""


def read(rec):
    p = rec.profile
    if not p or p["busy_s"] <= 0 or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
