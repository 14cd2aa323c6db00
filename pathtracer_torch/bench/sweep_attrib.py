"""Attribution of K2's per-column cost on the card (counterpart of benchmarks/sweep_attrib.py).

Runs the five variants of P3 (kernels/probes.sweep_attrib: K2's column
body on a synthetic stream in which every tile walks exactly n_cols
columns of cpi clusters, staged by P3's own ring of TMA bulk copies) at
two schedule lengths; cost per (tile, column) = dt / dcols removes the
launch and the per-tile work:

  empty   loop, barrier, schedule read        -> loop floor
  nodma   + lane test on a zeroed slot        -> loop floor + BW ALU
  noalu   + the copy ring, cpi copies         -> loop floor + copies
  dma1    as noalu with ONE contiguous copy   -> the copies' start share
  full    everything                          -> a column's cost

  BW ALU          = nodma - empty
  copies          = noalu - empty
  per extra start = (noalu - dma1) / (cpi - 1)
  overlap         = full - noalu - BW ALU   (< 0: copies hide under ALU)

On the card the variants are timed with CUDA events over `reps` launches
after `warmup` launches; a (tile, column) cost is amortized over the
whole card, so it is the rate of a launch that fills it: the default
tile count is K2's chunk (2,048 tiles of 64 rays). Beside them K2
itself (kernels/sweep.sweep_closest) runs P3's schedule at cpi 1, where
a column is K2's one cluster of 128 lanes (k2_columns); its dt / dcols
is the rate `us_per_col` gives pair_metrics' cost model, and the
driver prints P3 full's cost a column over it. The lengths are the JAX
driver's: 64 and 192 columns on the card, 16 and 24 with --device cpu
(the plain versions, as its interpret mode), where the tile count
defaults to the JAX driver's 256.

    python -m pathtracer_torch.bench.sweep_attrib [--cpi 12] [--tiles N]

prints one line a variant, the attribution and K2's rate, then one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import sys
import types

import numpy as np
import torch

from pathtracer_torch.bench.harness import time_call
from pathtracer_torch.kernels import probes, sweep

R = 64          # rays a tile (packet.TILE_RAYS)
K = 128         # lanes a cluster
LANES = 128     # the JAX probe pads a schedule to a multiple of lcm(cpi, 128)
TILES = 2048    # K2's chunk (packet.CHUNK_TILES): fills the card
CLUSTERS = 2048
COLS = (64, 192)
PLAIN_TILES, PLAIN_COLS = 256, (16, 24)   # the JAX driver's interpret mode
T_MIN = 1e-3    # P3's (sweep_attrib's default) and K2's on this schedule


def probe_inputs(tiles, c_clusters=CLUSTERS, device="cuda", seed=1):
    """Random Baldwin-Weber rows and rays, as the JAX probe makes them:
    (blocks_lm f32[C, K, 16], rays f32[tiles, 6, R])."""
    rng = np.random.default_rng(seed)
    blocks = rng.normal(size=(c_clusters, 16, K)).astype(np.float32)
    rays = rng.normal(size=(tiles, 6, R)).astype(np.float32)
    lm = torch.from_numpy(np.ascontiguousarray(blocks.transpose(0, 2, 1)))
    return lm.to(device), torch.from_numpy(rays).to(device)


def schedule(tiles, n_cols, cpi, c_clusters, device="cuda"):
    """run_variant's stream: st 0 for n_cols columns then +inf up to a
    multiple of lcm(cpi, 128) entries, si uniform cluster ids (seed 0)."""
    cs = n_cols * cpi
    mult = cpi * LANES // int(np.gcd(cpi, LANES))
    cs_pad = int(-(-cs // mult) * mult)
    st = np.zeros((tiles, cs_pad), np.float32)
    st[:, cs:] = np.inf
    rng = np.random.default_rng(0)
    si = rng.integers(0, c_clusters, (tiles, 1, cs_pad)).astype(np.int32)
    return (torch.from_numpy(st).to(device),
            torch.from_numpy(si[:, 0]).to(device))


def run_variant(variant, tiles, n_cols, cpi, c_clusters, blocks_lm, rays,
                warmup=3, reps=3):
    """(seconds a launch, sum of the output) of one variant at one
    schedule length."""
    st, si = schedule(tiles, n_cols, cpi, c_clusters, blocks_lm.device)
    dt, out = time_call(lambda: probes.sweep_attrib(st, si, rays, blocks_lm,
                                                    cpi, variant),
                        blocks_lm.device, warmup, reps)
    return dt, float(out.sum())


def attribution(device="cuda", tiles=None, cpi=1, cols=None,
                c_clusters=CLUSTERS, variants=probes.VARIANTS, warmup=3,
                reps=3):
    """Per variant ms a launch at each length, us a (tile, column) and
    the per-tile intercept in us, and the shares of a column: {"ms":
    {...}, "per_col": {...}, "per_tile": {...},
    "loop_floor", "bw_alu", "copies", "copies_1", "per_extra_start",
    "full", "overlap"} (the shares where their variants ran). tiles and
    cols default to TILES and COLS on the card, PLAIN_TILES and
    PLAIN_COLS on the CPU."""
    device = torch.device(device)
    card = device.type == "cuda"
    if tiles is None:
        tiles = TILES if card else PLAIN_TILES
    if cols is None:
        cols = COLS if card else PLAIN_COLS
    blocks_lm, rays = probe_inputs(tiles, c_clusters, device)
    a, b = cols
    per_col, per_tile, ms = {}, {}, {}
    for v in variants:
        dta, _ = run_variant(v, tiles, a, cpi, c_clusters, blocks_lm, rays,
                             warmup, reps)
        dtb, _ = run_variant(v, tiles, b, cpi, c_clusters, blocks_lm, rays,
                             warmup, reps)
        ms[v] = [dta * 1e3, dtb * 1e3]
        per_col[v] = (dtb - dta) / ((b - a) * tiles) * 1e6
        # the cols -> time line's intercept: per-tile fixed cost (ring
        # warm-up, dispatch, the tile's loads) amortized
        per_tile[v] = dta / tiles * 1e6 - a * per_col[v]
    res = dict(tiles=tiles, cpi=cpi, cols=list(cols), ms=ms,
               per_col=per_col, per_tile=per_tile)
    e = per_col.get("empty")
    if e is not None:
        res["loop_floor"] = e
        if "nodma" in per_col:
            res["bw_alu"] = per_col["nodma"] - e
        if "noalu" in per_col:
            res["copies"] = per_col["noalu"] - e
        if "dma1" in per_col:
            res["copies_1"] = per_col["dma1"] - e
    if "noalu" in per_col and "dma1" in per_col:
        res["per_extra_start"] = ((per_col["noalu"] - per_col["dma1"])
                                  / max(cpi - 1, 1))
    if "full" in per_col:
        res["full"] = per_col["full"]
        if "bw_alu" in res and "noalu" in per_col:
            res["overlap"] = per_col["full"] - per_col["noalu"] - res["bw_alu"]
    return res


def k2_accel(blocks_lm):
    """P3's cluster table as K2 reads it: every lane a real triangle (id
    row 12 set to 1, so its id 0 passes K2's pad filter; n_lanes K)."""
    lm = blocks_lm.clone()
    lm[:, :, 12] = 1.0
    return types.SimpleNamespace(
        blocks_lm=lm, blocks_t=lm.transpose(1, 2),
        n_lanes=torch.full((lm.shape[0],), lm.shape[1], dtype=torch.int32,
                           device=lm.device))


def k2_columns(device="cuda", tiles=None, cols=None, c_clusters=CLUSTERS,
               blocks_lm=None, rays=None, warmup=3, reps=3):
    """K2 (sweep.sweep_closest) on P3's schedule at cpi 1, t_cap +inf,
    t_min T_MIN: {"ms": [a launch at each length], "per_col": us a
    (tile, column), dt / dcols, "per_tile": us, the intercept, "t": [K2's
    t f32[tiles, R] at each length]}. blocks_lm and rays default to
    probe_inputs'; tiles and cols as in attribution. On the schedule's
    rows K2 finds what P3's full variant finds: its t + n_cols is P3's
    output bit for bit."""
    device = torch.device(device)
    card = device.type == "cuda"
    if tiles is None:
        tiles = TILES if card else PLAIN_TILES
    if cols is None:
        cols = COLS if card else PLAIN_COLS
    if blocks_lm is None:
        blocks_lm, rays = probe_inputs(tiles, c_clusters, device)
    accel = k2_accel(blocks_lm)
    cap = torch.full((tiles, R), torch.inf, dtype=torch.float32,
                     device=device)
    dts, ts = [], []
    for n_cols in cols:
        st, si = schedule(tiles, n_cols, 1, c_clusters, device)
        dt, (t, _, _, _) = time_call(
            lambda: sweep.sweep_closest(st, si, rays, cap, accel, T_MIN),
            device, warmup, reps)
        dts.append(dt)
        ts.append(t)
    a, b = cols
    per_col = (dts[1] - dts[0]) / ((b - a) * tiles) * 1e6
    return dict(ms=[dt * 1e3 for dt in dts], per_col=per_col,
                per_tile=dts[0] / tiles * 1e6 - a * per_col, t=ts)


def us_per_col(device="cuda"):
    """The card's cost of one K2 column a tile, in us amortized over a
    launch that fills the card: K2 itself on P3's schedule, dt / dcols
    (k2_columns)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("us_per_col measures the card; got "
                         f"device {device}")
    return k2_columns(device)["per_col"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpi", type=int, default=1,
                    help="clusters a column (K2: 1; the JAX probe: 12)")
    ap.add_argument("--tiles", type=int, default=None,
                    help=f"tiles a launch (default {TILES} on the card, "
                    f"{PLAIN_TILES} on the CPU)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("sweep_attrib: no CUDA device (use --device cpu "
                         "for a plain-version run at a tiny size)")
    res = attribution(args.device, args.tiles, args.cpi)
    k2 = k2_columns(args.device, res["tiles"])
    res["k2_per_col"] = k2["per_col"]
    res["k2_ms"] = k2["ms"]
    res["full_over_k2"] = res["full"] / k2["per_col"]
    for v, pc in res["per_col"].items():
        print(f"{v:6s}: {pc:8.4f} us/col  per-tile fixed "
              f"{res['per_tile'][v]:8.3f} us", flush=True)
    print(f"\nattribution (cpi={args.cpi}, {args.cpi * K} lanes a column):")
    print(f"  loop floor          {res['loop_floor']:8.4f} us")
    print(f"  BW ALU              {res['bw_alu']:8.4f} us")
    print(f"  copies ({args.cpi} starts)  {res['copies']:8.4f} us")
    print(f"  copies (1 start)    {res['copies_1']:8.4f} us")
    print(f"  per extra start     {res['per_extra_start']:8.4f} us")
    print(f"  full                {res['full']:8.4f} us "
          f"(overlap {res['overlap']:+.4f})")
    print(f"  K2 (cpi 1)          {k2['per_col']:8.4f} us "
          f"(P3 full / K2 {res['full_over_k2']:.3f})")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
