"""k2_roofline_pct: the least time K2's replayed chunks need (the larger
of their FLOPs over 67 TFLOP/s and their bytes over 3.35 TB/s, see
ptbench.roofline.k2) over the time K2 took on them, in %."""


def read(rec):
    k = rec.k2
    if not k or not k["chunks"] or k["seconds"] <= 0:
        return None
    return 100.0 * k["bound_s"] / k["seconds"]
