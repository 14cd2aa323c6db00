"""k2_resumed_pct: of the tiles K2 walked in the profiled steps, the
share whose walk passed pass A's column budget, so that pass B finished
it on a thread-block cluster, in %: 100 x the sum of the pt.sweep.closest
spans' `resumed` over the sum of their `tiles`. None where the program
has no such span."""


def read(rec):
    p = rec.profile
    if not p:
        return None
    row = p["by_span"].get("pt.sweep.closest")
    if row is None:
        return None
    attrs = [a for a in row["attrs"] if "resumed" in a]
    tiles = sum(a["tiles"] for a in attrs)
    if not tiles:
        return None
    return 100.0 * sum(a["resumed"] for a in attrs) / tiles
