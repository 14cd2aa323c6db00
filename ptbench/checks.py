"""The comparison that decides `correct`.

Five numbers, each against a limit set from readings (PERF.md gives the
readings and how each limit lies between them):

  closest_bad_pct   of the closest-hit lanes the window traced (a strided
                    sample of every captured call), the share whose hit
                    disagrees with a brute-force closest hit over every
                    triangle: hit against miss, a hit distance off by
                    more than T_REL of the reference's, or a reported
                    triangle, u or v that the triangle's own test does not
                    give back.
  occluded_bad_pct  of the sampled shadow lanes, the share whose blocked
                    flag differs from a brute-force any-hit query.
  image_bad_pct     of the driver's output items (ptbench.drivers: the
                    accumulated film at pixels drawn from the seed), the
                    share whose value differs from the reference's by more
                    than PIX_REL (relative, against |reference| plus a
                    floor of 1% of the sample's mean).
  closest_lanes_per_step, occluded_lanes_per_step
                    the sampled lanes of each kind a window step, held to
                    at least the mix's `min_lanes_per_step`: a timed path
                    that no longer calls the entry points HitCapture wraps
                    compares no hits, and fails here instead.
"""

from __future__ import annotations

import numpy as np
import torch

from ptbench.reference import brute, paths

T_REL = 1e-4        # hit distance agreement, relative to max(1, t)
UV_ABS = 1e-3       # barycentric agreement of the reported triangle
PIX_REL = 1e-3      # pixel agreement, relative
LANE_CHUNK = 8192   # reference paths traced together

# upper limit of each share, between the program's readings on a dozen
# seeds a cell and the control's on three (PERF.md section 2): closest 0
# and 38.6-100, occluded 0 and 5.3-6.7, image 0-2.34 and 72.3-100
LIMITS = {"closest_bad_pct": 1.0, "occluded_bad_pct": 1.0,
          "image_bad_pct": 10.0}
LANE_KINDS = ("closest", "occluded")


def seed_rng(seed: int, salt: int) -> np.random.Generator:
    """A numpy generator keyed on (seed, salt); any integer seed."""
    return np.random.default_rng([int(seed) % (1 << 64), salt])


def sample_pixels(seed, n_pixels, k, salt):
    return seed_rng(seed, salt).choice(n_pixels, size=min(k, n_pixels),
                                       replace=False)


def closest_bad(tb, cap):
    """Per-lane disagreement flags of captured closest-hit lanes, given
    the program's answers in cap (t, tri, u, v) or the control's."""
    o, d = cap["o"].to(tb.dtype), cap["d"].to(tb.dtype)
    t_max = cap["t_max"].to(tb.dtype)
    t_min = cap["t_min"]
    t_r, tri_r, _, _ = brute.closest(tb.bw, o, d, t_min, t_max)
    prog_hit = cap["tri"] >= 0
    ref_hit = tri_r >= 0
    t_p = cap["t"].double()
    scale = torch.clamp(t_r.double().abs(), min=1.0)
    far = (t_p - t_r.double()).abs() > T_REL * scale
    own_t, own_u, own_v, own = brute.triangle(
        tb.bw, cap["tri"].long(), o, d, t_min, t_max)
    own_bad = ~own | ((own_t.double() - t_p).abs() > T_REL * scale) \
        | ((own_u.double() - cap["u"].double()).abs() > UV_ABS) \
        | ((own_v.double() - cap["v"].double()).abs() > UV_ABS)
    return (prog_hit != ref_hit) | (prog_hit & ref_hit & (far | own_bad))


def occluded_bad(tb, cap):
    ref = brute.occluded(tb.bw, cap["o"].to(tb.dtype), cap["d"].to(tb.dtype),
                         cap["t_max"].to(tb.dtype))
    return ref != cap["blocked"].bool()


def reference_pixels(tb, rc, cam, pixel_ids, n_samples):
    """Reference value [K, 3] (float64) of each pixel: the mean over
    sample ids 0..n_samples-1."""
    dev = tb.positions.device
    k = len(pixel_ids)
    pix = torch.as_tensor(np.repeat(pixel_ids, n_samples), device=dev)
    samp = torch.arange(n_samples, device=dev).repeat(k)
    out = torch.zeros((k * n_samples, 3), dtype=torch.float64, device=dev)
    for a in range(0, pix.shape[0], LANE_CHUNK):
        b = min(pix.shape[0], a + LANE_CHUNK)
        out[a:b] = paths.trace(tb, rc, cam, pix[a:b], samp[a:b]).double()
    return out.reshape(k, n_samples, 3).mean(dim=1)


def pixel_errors(img, ref):
    """Relative error of each pixel (max over channels)."""
    img = torch.as_tensor(np.asarray(img), dtype=torch.float64,
                          device=ref.device)
    floor = 0.01 * ref.abs().mean()
    return ((img - ref).abs() / (ref.abs() + floor)).amax(dim=1)


def pct(flags) -> float:
    n = int(flags.numel())
    return 100.0 * float(flags.sum()) / n if n else 0.0


def summary(errs) -> dict:
    """Quantiles of per-pixel errors, for the diagnostics line."""
    e = errs.double().cpu().numpy()
    if not e.size:
        return {}
    return {f"q{q}": float(np.quantile(e, q / 100)) for q in (50, 90, 99)} \
        | {"max": float(e.max()), "n": int(e.size)}


def limits(traffic) -> dict:
    """{name: (limit, "max" | "min")} of every number compared."""
    out = {k: (v, "max") for k, v in LIMITS.items()}
    for kind in LANE_KINDS:
        out[f"{kind}_lanes_per_step"] = (
            traffic["min_lanes_per_step"][kind], "min")
    return out


def verdict(numbers: dict, traffic) -> tuple:
    """(correct, {name: {"value", "limit", "at_least"}}) for the numbers
    compared: a share at most its limit, a lane count at least its."""
    rows = {}
    for k, (lim, side) in limits(traffic).items():
        v = numbers[k]
        ok = np.isfinite(v) and (v <= lim if side == "max" else v >= lim)
        rows[k] = {"value": v, "limit": lim, "at_least": side == "min",
                   "ok": bool(ok)}
    correct = all(r.pop("ok") for r in rows.values())
    return correct, rows
