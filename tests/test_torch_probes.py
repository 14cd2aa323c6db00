"""P1-P3, the TPU probes of benchmarks/, against their ports' plain versions.

CPU: each plain PyTorch version of kernels/probes.py against the JAX
probe on identical inputs made with numpy. P1 against bf16_probe.chain
under jax.jit (pallas_chain, its Pallas wrapper, has no interpret switch
and refuses the CPU), bit for bit in float32 and bfloat16 at 1, 2, 8 and
16 steps (the probe's 512 x 8 steps settle to a few constants within ~8,
so longer runs would compare constants). P2 and P3 against
pl.pallas_call built around cond_probe._kernel / sweep_attrib._kernel as
run / run_variant build them, in interpret mode: P2 bit for bit, P3's
four degenerate variants +inf in both, its full variant hit for hit with
t within a few roundings of its summed terms (XLA contracts a*b+c into
FMAs on the host; the port rounds each product and sum, as its
-fmad=false kernel does). The CUDA kernels are held to these plain
versions in tests/test_torch_cuda.py and by chip_smoke.py.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from benchmarks import bf16_probe, cond_probe, sweep_attrib
from pathtracer.kernels.pallas_sweep import LANES, SLOTS
from pathtracer_torch.bench import sweep_attrib as tattrib
from pathtracer_torch.kernels import LAUNCHES, probes
from tests.test_torch_cuda import attrib_stop_case, exact_schedule


# --- P1 ------------------------------------------------------------------

def _chain_inputs(seed, wide):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(64, 1024)).astype(np.float32) * np.float32(0.5) \
        + np.float32(0.25)
    y = x * np.float32(1.1)
    if wide:    # signs, zeros, tiny and large magnitudes
        x = (rng.normal(size=x.shape) * 10.0 ** rng.integers(
            -30, 4, x.shape)).astype(np.float32)
        y = rng.normal(size=x.shape).astype(np.float32)
        x[0, :8] = [0.0, -0.0, 1e-40, -1e-40, 0.0, -0.0, 1e-45, 2.0]
        y[0, :8] = [0.0, 0.0, -0.0, 1e-40, -0.0, -0.0, -1e-45, 2.0]
    return x, y


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("steps", [1, 2, 8, 16])
@pytest.mark.parametrize("wide", [False, True])
def test_chain_matches_jax_bit_for_bit(monkeypatch, dtype, steps, wide):
    x, y = _chain_inputs(steps, wide)
    # the JAX chain runs ITERS x UNROLL steps
    monkeypatch.setattr(bf16_probe, "ITERS", max(1, steps // 8))
    monkeypatch.setattr(bf16_probe, "UNROLL", min(steps, 8))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    # a fresh function: jit's trace cache would keep another ITERS
    ref = jax.jit(lambda a, b: bf16_probe.chain(a, b))(
        jnp.asarray(x).astype(jd), jnp.asarray(y).astype(jd))
    td = getattr(torch, dtype)
    got = probes.chain(torch.from_numpy(x).to(td),
                       torch.from_numpy(y).to(td), steps)
    assert got.dtype == td
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    np.testing.assert_array_equal(got, ref)
    if steps <= 2 and (wide or dtype == "float32"):
        # before the chain settles (within ~8 steps) the output still
        # varies with the input; on the probe's range a bf16 output near
        # 1.01 has only its two neighbouring values
        assert np.unique(got).size > 100


# --- P2 ------------------------------------------------------------------

def _jax_cond(x, n_iter, gate, grid):
    kern = functools.partial(cond_probe._kernel, n_iter=n_iter, gate=gate)
    r, lanes = x.shape[1:]
    return np.asarray(pl.pallas_call(
        kern,
        grid=(grid,),
        in_specs=[pl.BlockSpec((1, r, lanes), lambda i: (0, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, r, 1), lambda i: (0, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, r, 1), jnp.float32),
        interpret=True,
    )(jnp.asarray(x)))


def _cond_input(kind):
    n = probes.WALK_ROWS * probes.WALK_COLS
    if kind == "probe":      # cond_probe.run's input
        return (np.arange(n, dtype=np.float32) * np.float32(1e-3)).reshape(
            1, probes.WALK_ROWS, probes.WALK_COLS)
    rng = np.random.default_rng(3)
    x = rng.integers(0, 40, (1, probes.WALK_ROWS, probes.WALK_COLS))
    x = (x * 7.0 - 150.0 * np.arange(probes.WALK_ROWS)[None, :, None])
    if kind == "steps":      # rows far apart: the gate closes for most
        x[0, 1::2] += 1e4
    return x.astype(np.float32)


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("kind", ["probe", "ties", "steps"])
def test_cond_walk_matches_pallas_interpret(gate, kind):
    x = _cond_input(kind)
    ref = _jax_cond(x, 16, gate, 2)
    got = probes.cond_walk(torch.from_numpy(x), 16, gate)
    assert got.shape == (1, probes.WALK_ROWS, 1)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_cond_walk_gate_changes_the_walk():
    """Where rows lie far apart the gate skips steps in which some rows
    would still improve: gated and always-extract differ, as in JAX."""
    x = _cond_input("steps")
    x[0, 1::2] = x[0, 1::2] - 1e4 + 150.0     # later steps improve odd rows
    x = np.ascontiguousarray(x)
    t = torch.from_numpy(x)
    a = probes.cond_walk(t, 16, False).numpy()
    g = probes.cond_walk(t, 16, True).numpy()
    np.testing.assert_array_equal(a, _jax_cond(x, 16, False, 1))
    np.testing.assert_array_equal(g, _jax_cond(x, 16, True, 1))


# --- P3 ------------------------------------------------------------------

_K, _R = sweep_attrib.K, sweep_attrib.R


def _jax_attrib(variant, tiles, n_cols, cpi, c_clusters, blocks, rays):
    """run_variant's pallas_call in interpret mode -> (out, st, si)."""
    cs = n_cols * cpi
    mult = cpi * LANES // np.gcd(cpi, LANES)
    cs_pad = int(-(-cs // mult) * mult)
    st = np.zeros((tiles, 1, cs_pad), np.float32)
    st[:, :, cs:] = np.inf
    rng = np.random.default_rng(0)
    si = rng.integers(0, c_clusters, (tiles, 1, cs_pad)).astype(np.int32)
    kern = functools.partial(sweep_attrib._kernel, cpi=cpi,
                             n_cols=cs_pad // cpi, variant=variant)
    vspec = lambda d2, d3: pl.BlockSpec(  # noqa: E731
        (1, d2, d3), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    sspec = lambda d3: pl.BlockSpec(  # noqa: E731
        (1, 1, d3), lambda i: (i, 0, 0), memory_space=pltpu.SMEM)
    fn = pl.pallas_call(
        kern,
        grid=(tiles,),
        in_specs=[sspec(cs_pad), sspec(cs_pad), vspec(6, _R),
                  pl.BlockSpec(memory_space=pltpu.ANY)],
        out_specs=[vspec(1, _R)],
        out_shape=[jax.ShapeDtypeStruct((tiles, 1, _R), jnp.float32)],
        scratch_shapes=[
            pltpu.VMEM((SLOTS, cpi, 16, _K) if variant == "dma1"
                       else (SLOTS, 16, cpi * _K), jnp.float32),
            pltpu.SemaphoreType.DMA((SLOTS,)),
        ],
        interpret=True,
    )
    out = fn(jnp.asarray(st), jnp.asarray(si), jnp.asarray(rays),
             jnp.asarray(blocks))[0]
    return np.asarray(out), st[:, 0], si[:, 0]


@pytest.fixture(scope="module")
def attrib_case():
    """4 tiles, 4 columns of 2 clusters out of 64 (the JAX probe's K)."""
    tiles, n_cols, cpi, c = 4, 4, 2, 64
    blocks_lm, rays = tattrib.probe_inputs(tiles, c, "cpu")
    blocks = blocks_lm.transpose(1, 2).contiguous().numpy()
    outs = {v: _jax_attrib(v, tiles, n_cols, cpi, c, blocks, rays.numpy())
            for v in probes.VARIANTS}
    return dict(tiles=tiles, n_cols=n_cols, cpi=cpi, c=c, blocks=blocks,
                blocks_lm=blocks_lm, rays=rays, outs=outs)


def test_attrib_schedule_is_run_variants(attrib_case):
    c = attrib_case
    st, si = tattrib.schedule(c["tiles"], c["n_cols"], c["cpi"], c["c"],
                              "cpu")
    _, jst, jsi = c["outs"]["full"]
    np.testing.assert_array_equal(st.numpy(), jst)
    np.testing.assert_array_equal(si.numpy(), jsi)


@pytest.mark.parametrize("variant", probes.VARIANTS)
def test_sweep_attrib_matches_pallas_interpret(attrib_case, variant):
    c = attrib_case
    ref, st, si = c["outs"][variant]
    before = dict(LAUNCHES)
    got = probes.sweep_attrib(torch.from_numpy(st), torch.from_numpy(si),
                              c["rays"], c["blocks_lm"], c["cpi"],
                              variant).numpy()
    assert LAUNCHES == before           # the CPU route launches nothing
    assert got.shape == ref.shape == (c["tiles"], 1, _R)
    if variant != "full":
        assert np.isinf(ref).all() and np.isinf(got).all()
        return
    hit = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), hit)
    assert 0 < hit.sum() < hit.size
    # every tile walked n_cols columns: out = t + n_cols. t agrees with
    # JAX's within 32 roundings of the terms it sums (as K2's plain
    # version against Pallas interpret): the lane is the one whose
    # float64 t is nearest the port's
    t_got = got[hit].astype(np.float64) - c["n_cols"]
    t_ref = ref[hit].astype(np.float64) - c["n_cols"]
    rows = c["blocks"][si[:, :c["n_cols"] * c["cpi"]]]   # [T, cols, 16, K]
    rays = c["rays"].numpy().astype(np.float64)
    ti, ri = np.nonzero(hit[:, 0])
    for k, (tt, rr) in enumerate(zip(ti, ri)):
        o, d = rays[tt, 0:3, rr], rays[tt, 3:6, rr]
        lanes = rows[tt].transpose(0, 2, 1).reshape(-1, 16).astype(
            np.float64)
        num = lanes[:, 3] - lanes[:, 0:3] @ o
        t64 = num / (lanes[:, 0:3] @ d)
        r = lanes[np.argmin(np.abs(t64 - t_got[k]))]
        no = np.abs(r[0:3] * o).sum()
        scale = (abs(r[3]) + no) * abs(t_got[k]) / max(
            abs(r[3] - (r[0:3] * o).sum()), 1e-30) + abs(t_got[k])
        assert abs(t_got[k] - t_ref[k]) <= 32 * 2.0 ** -24 * scale
    # the sum then rounds at the column count's magnitude
    np.testing.assert_allclose(got[hit], ref[hit], rtol=1e-6)


def test_sweep_attrib_rejects_bad_shapes():
    st = torch.zeros((2, 6))
    si = torch.zeros((2, 6), dtype=torch.int32)
    rays = torch.zeros((2, 6, 64))
    lm = torch.zeros((8, _K, 16))
    with pytest.raises(ValueError, match="whole, positive number"):
        probes.sweep_attrib(st, si, rays, lm, 4, "full")
    with pytest.raises(ValueError, match="whole, positive number"):
        probes.sweep_attrib(st[:, :0], si[:, :0], rays, lm, 1, "full")
    with pytest.raises(ValueError, match="variant"):
        probes.sweep_attrib(st, si, rays, lm, 2, "dma2")
    with pytest.raises(ValueError, match="t_min"):
        probes.sweep_attrib(st, si, rays, lm, 2, "full", t_min=-1.0)


def test_attribution_arithmetic_on_cpu():
    """The driver's shares on the plain route: every variant runs, and
    the shares are the differences sweep_attrib.main prints."""
    res = tattrib.attribution("cpu", tiles=2, cpi=2, cols=(2, 3),
                              c_clusters=64, warmup=0, reps=1)
    pc = res["per_col"]
    assert set(pc) == set(probes.VARIANTS)
    assert res["bw_alu"] == pc["nodma"] - pc["empty"]
    assert res["copies"] == pc["noalu"] - pc["empty"]
    assert res["per_extra_start"] == pc["noalu"] - pc["dma1"]
    assert res["overlap"] == pc["full"] - pc["noalu"] - res["bw_alu"]
    with pytest.raises(ValueError, match="card"):
        tattrib.us_per_col("cpu")


def _kernel_counts(st, si, rays, blocks_t, cpi, variant, t_min):
    """The lane test of sweep_column.cuh's test_closest, one thread (ray,
    part) at a time in float32 scalars: the branches it takes."""
    f = np.float32
    counts = dict.fromkeys(probes.LANE_COUNTS, 0)
    tiles, cs = st.shape
    blk = blocks_t if variant == "full" else np.zeros_like(blocks_t)
    for tile in range(tiles):
        best = np.full(_R, np.inf, np.float32)
        for col in range(cs // cpi):
            if not (st[tile, col * cpi] < np.inf
                    and st[tile, col * cpi] < best.max()):
                break
            counts["columns"] += 1
            lanes = np.concatenate([blk[si[tile, col * cpi + q]].T
                                    for q in range(cpi)])   # [L, 16]
            new = best.copy()
            for r in range(_R):
                o, d = rays[tile, 0:3, r], rays[tile, 3:6, r]
                if not best[r] > f(t_min):
                    continue
                for p in range(probes.PARTS):
                    c_t = best[r]
                    for a in lanes[p::probes.PARTS]:
                        counts["lanes"] += 1
                        denom = d[0] * a[0] + d[1] * a[1] + d[2] * a[2]
                        num = a[3] - (o[0] * a[0] + o[1] * a[1]
                                      + o[2] * a[2])
                        if not (abs(denom) > f(1e-12) and (
                                num > 0 if denom > 0 else num < 0)):
                            continue
                        counts["signs"] += 1
                        t = num * (f(1.0) / denom)
                        if not (t > f(t_min) and t < c_t):
                            continue
                        counts["in_range"] += 1
                        h = o + t * d
                        u = a[4] * h[0] + a[5] * h[1] + a[6] * h[2] + a[7]
                        v = a[8] * h[0] + a[9] * h[1] + a[10] * h[2] + a[11]
                        if u >= 0 and v >= 0 and u + v <= 1:
                            counts["hits"] += 1
                            c_t = t
                    new[r] = min(new[r], c_t)
            best = new
    return counts


@pytest.mark.parametrize("variant,cpi", [("full", 1), ("full", 2),
                                         ("nodma", 1)])
def test_sweep_attrib_counts_are_the_kernels_branches(variant, cpi):
    """The plain version's branch counts (P3's bound) equal a scalar walk
    of the kernel's lane loop, and counting leaves the output as it is."""
    tiles, n_cols, c = 2, 3, 16
    blocks_lm, rays = tattrib.probe_inputs(tiles, c, "cpu", seed=3)
    st, si = tattrib.schedule(tiles, n_cols, cpi, c, "cpu")
    blocks_t = blocks_lm.transpose(1, 2).contiguous()
    counts = {}
    with np.errstate(all="ignore"):
        got = probes.sweep_attrib_plain(st, si, rays, blocks_t, cpi, variant,
                                        counts=counts)
        want = _kernel_counts(st.numpy(), si.numpy(), rays.numpy(),
                              blocks_t.numpy(), cpi, variant, 1e-3)
    assert counts == want
    assert counts["columns"] == tiles * n_cols
    if variant == "full":
        assert 0 < counts["hits"] < counts["in_range"] < counts["signs"] \
            < counts["lanes"]
    else:        # a zeroed slot: every lane fails the sign test
        assert counts["signs"] == 0
    ref = probes.sweep_attrib_plain(st, si, rays, blocks_t, cpi, variant)
    assert torch.equal(got, ref)


def test_attrib_driver_picks_the_jax_lengths(capsys):
    """The driver's lengths are the JAX driver's, by device: (16, 24)
    columns on the CPU (its interpret mode), (64, 192) on the card; it
    takes no length option."""
    assert tattrib.COLS == (64, 192) and tattrib.PLAIN_COLS == (16, 24)
    assert tattrib.main(["--device", "cpu", "--tiles", "1"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["cols"] == [16, 24] and res["tiles"] == 1
    assert set(res["per_col"]) == set(probes.VARIANTS)
    with pytest.raises(SystemExit):
        tattrib.main(["--device", "cpu", "--cols", "2", "3"])


# --- P3's ring and K2's rate ------------------------------------------------

@pytest.mark.parametrize("tile_rays", [32, 64])
@pytest.mark.parametrize("cpi", range(1, 14))
def test_attrib_stages_fit_the_card(tile_rays, cpi):
    """At K = 128 every cpi of 1-13 gets a ring that fits a block's
    232,448 bytes beside the candidate slabs and barriers: 3 stages
    wherever 3 fit (cpi <= 9), else 2; cpi 14 needs more than 2 stages
    can have, and the wrapper refuses it."""
    s = probes.attrib_stages(tile_rays, _K, cpi)
    shmem = probes.attrib_shmem(tile_rays, _K, cpi, s)
    assert shmem <= probes.SHMEM_LIMIT
    three = probes.attrib_shmem(tile_rays, _K, cpi, 3) <= probes.SHMEM_LIMIT
    assert s == (3 if three else 2)
    assert three == (cpi <= 9)
    # ring, slabs (2 x 4 parts x R x 5 words), one 8-byte barrier a stage
    assert shmem == s * cpi * _K * 64 + 2 * 4 * tile_rays * 20 + 8 * s
    assert probes.attrib_shmem(tile_rays, _K, 14, 2) > probes.SHMEM_LIMIT


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_us_per_col_raises_off_the_card(device):
    with pytest.raises(ValueError, match="card"):
        tattrib.us_per_col(device)


@pytest.mark.parametrize("cols", [(1, 2), (2, 5)])
def test_k2_columns_is_p3_full_on_its_schedule(cols):
    """K2 (the plain sweep_closest) on P3's schedule at cpi 1 through
    k2_columns finds P3 full's hits: its t + n_cols is P3's output bit
    for bit at each length, as chip_smoke.py holds the two kernels; every
    lane of its table is a real triangle and t_cap is +inf."""
    tiles, c = 3, 16
    res = tattrib.k2_columns("cpu", tiles=tiles, cols=cols, c_clusters=c,
                             warmup=0, reps=1)
    assert set(res) == {"ms", "per_col", "per_tile", "t"}
    lm, rays = tattrib.probe_inputs(tiles, c, "cpu")
    acc = tattrib.k2_accel(lm)
    assert bool((acc.blocks_lm[:, :, 12] == 1.0).all())
    assert torch.equal(acc.blocks_lm[:, :, :12], lm[:, :, :12])
    assert acc.n_lanes.tolist() == [_K] * c
    for n_cols, t in zip(cols, res["t"]):
        st, si = tattrib.schedule(tiles, n_cols, 1, c, "cpu")
        p3 = probes.sweep_attrib(st, si, rays, lm, 1, "full")
        assert bool(torch.isfinite(t).any())
        assert torch.equal((t + float(n_cols)).view(torch.int32),
                           p3[:, 0].view(torch.int32))


@pytest.mark.parametrize("cpi,n_cols,stop_col,inf_col",
                         [(1, 7, 3, 5), (2, 6, 4, 2), (12, 4, 2, 3)])
def test_attrib_stop_case_stops_mid_walk(cpi, n_cols, stop_col, inf_col):
    """The cuda tests' stop case on the plain version: full stops at
    stop_col on even tiles (its output is the walk cut there) and at
    inf_col on odd ones; without the stop it would walk on."""
    st, si, rays, lm = attrib_stop_case(4, n_cols, cpi, stop_col, inf_col,
                                        64, "cpu")
    blocks_t = lm.transpose(1, 2)
    got = probes.sweep_attrib_plain(st, si, rays, blocks_t, cpi, "full")
    assert bool(torch.isfinite(got).all())        # every ray hits the wall
    for rows, cut in ((slice(0, None, 2), stop_col),
                      (slice(1, None, 2), inf_col)):
        part = probes.sweep_attrib_plain(
            st[rows, :cut * cpi].contiguous(),
            si[rows, :cut * cpi].contiguous(), rays[rows], blocks_t, cpi,
            "full")
        assert torch.equal(got[rows], part)
    walk = probes.sweep_attrib_plain(torch.zeros_like(st), si, rays,
                                     blocks_t, cpi, "full")
    assert not torch.equal(walk[0::2], got[0::2])
    # the variants without lane tests walk every finite entry
    assert torch.isinf(probes.sweep_attrib_plain(st, si, rays, blocks_t,
                                                 cpi, "noalu")).all()


def test_exact_schedule_is_the_schedule_cut():
    st, si = exact_schedule(2, 3, 4, 16, "cpu")
    pst, psi = tattrib.schedule(2, 3, 4, 16, "cpu")
    assert st.shape == (2, 12) and st.is_contiguous()
    assert torch.equal(st, pst[:, :12]) and torch.equal(si, psi[:, :12])
    assert bool((st == 0).all()) and bool(torch.isinf(pst[:, 12:]).all())
