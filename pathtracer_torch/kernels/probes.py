"""P1-P3, the JAX package's TPU micro-probes, as kernels of the port (csrc/probes.cu).

  chain(x, y, steps)                      P1, benchmarks/bf16_probe.py:56
      `steps` steps of the slab test's op mix, then x + y, in
      the inputs' dtype: float32 (chain_f32) or bfloat16 (chain_bf16,
      packed bf16x2 on the card).
  cond_walk(x, n_iter, gate, grid)        P2, benchmarks/cond_probe.py:24
      x f32[1, 64, 512] -> best + aux f32[1, 64, 1]: n_iter fake columns
      x + i, each row's min, its argmin extraction always or (gate) only
      when some row may improve; on the card a grid step is a 2-CTA
      cluster.
  sweep_attrib(st, si, rays, blocks_lm, cpi, variant, t_min)
                                          P3, benchmarks/sweep_attrib.py:56
      K2's column body on a synthetic schedule, one of VARIANTS ->
      best_t + acc f32[tiles, 1, R]; on the card its columns come
      through a ring of attrib_stages() stages filled by TMA bulk copies.

Each wrapper runs the plain PyTorch version for CPU tensors and launches
its CUDA kernel for CUDA tensors (or raises); it adds one to its count
in kernels.LAUNCHES where it launches. The plain versions repeat the
kernels' arithmetic in the same order of roundings.
"""

from __future__ import annotations

import ctypes

import torch

from pathtracer_torch.kernels import LAUNCHES, cuda_build
from pathtracer_torch.kernels.intersect import DET_EPS
from pathtracer_torch.kernels.sweep import _bw_lane

CHAIN_STEPS = 512 * 8       # bf16_probe.ITERS x bf16_probe.UNROLL
WALK_ROWS, WALK_COLS = 64, 512   # cond_probe's tile
VARIANTS = ("empty", "nodma", "noalu", "dma1", "full")
DMA1_SPAN = 1024            # dma1 copies clusters (col % (1024 // cpi)) * cpi
SHMEM_LIMIT = 232_448       # dynamic shared memory a block on an H100
PARTS = 4                   # threads a ray in K2's column (kParts)
RING_STAGES = 3             # most stages of P3's ring
LANE_COUNTS = ("columns", "lanes", "signs", "in_range", "hits")

_SIG = {
    "pt_chain_f32": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "pt_chain_bf16": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "pt_cond_walk": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    "pt_attrib_shmem": [ctypes.c_int] * 4,
    "pt_attrib_info": [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4,
    "pt_sweep_attrib": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_float,
                        ctypes.c_void_p, ctypes.c_void_p],
}


def _lib():
    return cuda_build.load("probes", _SIG)


def _check(name, t, dtype, device, shape=None):
    if t.device != device or t.dtype != dtype or not t.is_contiguous() or (
            shape is not None and tuple(t.shape) != tuple(shape)):
        want = f"{tuple(shape)} " if shape is not None else ""
        raise ValueError(f"{name}: want contiguous {dtype} {want}on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _route(name, t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cuda"


# --- P1 ------------------------------------------------------------------

def chain_plain(x, y, steps=CHAIN_STEPS):
    """bf16_probe.chain in x's dtype; its Python constants are cast to
    that dtype first, as JAX's weakly typed scalars are."""
    c = {v: torch.tensor(v, dtype=x.dtype, device=x.device)
         for v in (0.25, 0.5, 0.51)}
    for _ in range(steps):
        t1 = (x - y) * x
        t2 = (y - x) * y
        x = torch.minimum(t1, t2) * c[0.25] + c[0.5]
        y = torch.maximum(t1, t2) * c[0.25] + c[0.51]
    return x + y


def chain(x, y, steps=CHAIN_STEPS):
    """P1: the chain over x, y (float32 or bfloat16, same shape). Its
    domain is a chain that stays finite (the probe's x in [0.25, 0.75],
    any x, y in [-1, 1]): on NaN the kernel's min/max keep the other
    operand, torch.minimum/maximum the NaN."""
    if not _route("chain", x):
        return chain_plain(x, y, steps)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"chain: dtype {x.dtype} (float32 or bfloat16)")
    _check("chain y", y, x.dtype, x.device, x.shape)
    _check("chain x", x, x.dtype, x.device, y.shape)
    n = x.numel()
    if x.dtype == torch.bfloat16 and n % 2:
        raise ValueError(f"chain: bf16x2 needs an even element count, "
                         f"got {n}")
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = _lib()
    name = "chain_f32" if x.dtype == torch.float32 else "chain_bf16"
    rc = getattr(lib, f"pt_{name}")(x.data_ptr(), y.data_ptr(),
                                    out.data_ptr(), n, int(steps),
                                    cuda_build.stream_ptr(x.device))
    cuda_build.check_launch(rc, name)
    LAUNCHES[name] += 1
    return out


# --- P2 ------------------------------------------------------------------

def cond_walk_plain(x, n_iter, gate, extractions=None):
    """cond_probe._kernel on x f32[1, 64, 512] -> f32[1, 64, 1].

    uj is t at the row's argmin (the first minimal lane), which is what
    the JAX kernel's one-hot sum gives for finite t. extractions:
    optional int64 0-d tensor, incremented by the steps that run the
    extraction (all n_iter without the gate)."""
    x0 = x[0]
    r = x0.shape[0]
    best = torch.full((r, 1), 1e30, dtype=torch.float32, device=x.device)
    aux = torch.zeros((r, 1), dtype=torch.float32, device=x.device)
    for i in range(n_iter):
        t = x0 + torch.tensor(float(i), dtype=torch.float32,
                              device=x.device)
        tj = t.amin(dim=1, keepdim=True)
        go = tj < best
        if gate:
            open_ = tj.min() < best.min() + 100.0
            go = go & open_
        if extractions is not None:
            extractions += open_ if gate else 1
        uj = torch.gather(t, 1, torch.argmin(t, dim=1, keepdim=True))
        best, aux = torch.where(go, tj, best), torch.where(go, uj, aux)
    return (best + aux)[None]


def cond_walk(x, n_iter=256, gate=False, grid=64):
    """P2 on x f32[1, 64, 512]; the card runs `grid` identical grid
    steps of a 2-CTA cluster each."""
    if not _route("cond_walk", x):
        return cond_walk_plain(x, n_iter, gate)
    _check("cond_walk x", x, torch.float32, x.device,
           (1, WALK_ROWS, WALK_COLS))
    out = torch.empty((1, WALK_ROWS, 1), dtype=torch.float32,
                      device=x.device)
    name = "cond_walk_gated" if gate else "cond_walk"
    rc = _lib().pt_cond_walk(x.data_ptr(), int(n_iter), int(grid),
                             int(bool(gate)), out.data_ptr(),
                             cuda_build.stream_ptr(x.device))
    cuda_build.check_launch(rc, name)
    LAUNCHES[name] += 1
    return out


# --- P3 ------------------------------------------------------------------

def attrib_shmem(tile_rays, k, cpi, stages):
    """Dynamic shared memory of P3's kernel (csrc/probes.cu
    attrib_shmem): the ring, `stages` x cpi clusters of k lanes of 16
    floats; K2's candidate slabs, 2 x PARTS x tile_rays x 5 words; one
    8-byte mbarrier a stage."""
    return (stages * cpi * k * 16 * 4 + 2 * PARTS * tile_rays * 5 * 4
            + stages * 8)


def attrib_stages(tile_rays, k, cpi):
    """Stages of P3's ring for tile_rays rays a tile and cpi clusters of
    k lanes a column: the most, up to RING_STAGES, whose shared memory
    fits SHMEM_LIMIT, and never fewer than 2 (the double buffer; a
    column too large for two stages is refused by the wrapper). Up to
    two columns are then in flight ahead of the one tested. At cpi 1
    three stages take 34,840 bytes a block: shared memory allows 6 blocks
    an SM, more than the 5 that full's 48 registers allow; the variants
    with fewer registers (empty, noalu, dma1) go from 8 blocks to 6."""
    fit = [s for s in range(2, RING_STAGES + 1)
           if attrib_shmem(tile_rays, k, cpi, s) <= SHMEM_LIMIT]
    return max(fit, default=2)


def kernel_info(variant, tile_rays=64, k=128, cpi=1):
    """Registers and local (spill) bytes a thread, threads a block,
    resident blocks and the occupancy (resident warps / 64) an SM of P3's
    `variant` at its ring of attrib_stages(tile_rays, k, cpi), from the
    CUDA runtime (needs a card; the ptxas report is
    cuda_build.build_logs["probes"])."""
    stages = attrib_stages(tile_rays, k, cpi)
    vals = [ctypes.c_int(0) for _ in range(4)]
    rc = _lib().pt_attrib_info(VARIANTS.index(variant), tile_rays, k, cpi,
                               stages, *(ctypes.byref(v) for v in vals))
    cuda_build.check_launch(rc, f"kernel_info({variant})")
    regs, local, blocks, threads = (v.value for v in vals)
    return dict(registers=regs, local_bytes=local, threads=threads,
                blocks_per_sm=blocks, occupancy=blocks * threads / 32 / 64,
                stages=stages,
                shmem=attrib_shmem(tile_rays, k, cpi, stages))


def _lane_counts(blk, o, d, t_min, best, live, counts):
    """Add to `counts` the branches K2's column body (sweep_column.cuh:
    test_closest) takes on one column: blk f32[tiles, 16, L] the
    column's L lanes, o/d 3-tuples of [tiles, R, 1], best [tiles, R] the
    rays' best t as the column starts, live [tiles] the tiles that walk
    it. Thread (ray, part p) tests lanes p, p + PARTS, ... with its
    candidate t seeded from best and lowered by each hit; "lanes" are
    the lanes tested (rays with best > t_min), "signs" those that pass
    the sign test, "in_range" those with t_min < t < the candidate t,
    "hits" those also inside the triangle."""
    ox, oy, oz = o
    dx, dy, dz = d
    nx, ny, nz, dpl, r1x, r1y, r1z, c1, r2x, r2y, r2z, c2 = (
        blk[:, i, None, :] for i in range(12))
    denom = dx * nx + dy * ny + dz * nz
    num = dpl - (ox * nx + oy * ny + oz * nz)
    signs = (denom.abs() > DET_EPS) & torch.where(denom > 0.0, num > 0.0,
                                                  num < 0.0)
    t = num * torch.reciprocal(denom)
    hx, hy, hz = ox + t * dx, oy + t * dy, oz + t * dz
    u = r1x * hx + r1y * hy + r1z * hz + c1
    v = r2x * hx + r2y * hy + r2z * hz + c2
    inside = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    above = signs & (t > t_min)
    # a part's candidate before lane l: best, lowered by the part's
    # earlier lanes that hit (a hit with t >= the candidate lowers nothing)
    tiles, r, lanes = t.shape
    hit_t = torch.where(above & inside, t, torch.inf).reshape(
        tiles, r, lanes // PARTS, PARTS)
    before = torch.cat((torch.full_like(hit_t[:, :, :1], torch.inf),
                        hit_t.cummin(dim=2).values[:, :, :-1]), dim=2)
    cand = torch.minimum(before, best[:, :, None, None]).reshape(t.shape)
    in_range = above & (t < cand)
    m = (live[:, None] & (best > t_min))[:, :, None]
    counts["columns"] += int(live.sum())
    counts["lanes"] += int(m.sum()) * lanes
    counts["signs"] += int((signs & m).sum())
    counts["in_range"] += int((in_range & m).sum())
    counts["hits"] += int((in_range & inside & m).sum())


def sweep_attrib_plain(st, si, rays, blocks_t, cpi, variant, t_min=1e-3,
                       counts=None):
    """sweep_attrib._kernel in lockstep over tiles: st f32 / si i32
    [tiles, cs] (cs a multiple of cpi), rays f32[tiles, 6, R], blocks_t
    f32[C, 16, K] -> best_t + acc f32[tiles, 1, R]. A tile walks column
    col (clusters si[col*cpi : (col+1)*cpi]) while col < cs / cpi,
    st[col*cpi] < inf and acc < 3e38 - and, where it tests lanes, while
    st[col*cpi] lies below its largest best t (K2's rule, which the
    kernel keeps; it never fires on st of 0 and +inf with t_min >= 0).

    counts: optional dict; the variants that test lanes add to it (keys
    LANE_COUNTS, see _lane_counts) the tile columns walked and the lane
    test's branches the kernel takes on this data."""
    if counts is not None:
        for key in LANE_COUNTS:
            counts.setdefault(key, 0)
    if variant not in VARIANTS:
        raise ValueError(f"sweep_attrib: variant {variant!r} not in "
                         f"{VARIANTS}")
    tiles, cs = st.shape
    r = rays.shape[2]
    k = blocks_t.shape[2]
    dev = st.device
    alu = variant in ("nodma", "full")
    best = torch.full((tiles, r), torch.inf, dtype=torch.float32,
                      device=dev)
    acc = torch.zeros(tiles, dtype=torch.float32, device=dev)
    live = torch.ones(tiles, dtype=torch.bool, device=dev)
    o = tuple(rays[:, i, :, None] for i in range(3))
    d = tuple(rays[:, i, :, None] for i in range(3, 6))
    zero = torch.zeros((tiles, 16, k), dtype=torch.float32, device=dev)
    for col in range(cs // cpi):
        entry = st[:, col * cpi]
        live = live & (entry < torch.inf) & (acc < 3e38)
        if alu:
            live = live & (entry < best.amax(dim=1))
        if not bool(live.any()):
            break
        ids = si[:, col * cpi:(col + 1) * cpi].long()
        if alu and counts is not None:
            blk = (blocks_t[ids].permute(0, 2, 1, 3).reshape(tiles, 16, -1)
                   if variant == "full" else zero.repeat(1, 1, cpi))
            _lane_counts(blk, o, d, t_min, best, live, counts)
        if alu:
            for q in range(cpi):
                blk = blocks_t[ids[:, q]] if variant == "full" else zero
                t, _, _, _ = _bw_lane(blk, o, d, t_min, best[:, :, None])
                tj = t.amin(dim=2)
                best = torch.where(live[:, None] & (tj < best), tj, best)
        elif variant == "noalu":
            row = blocks_t[ids][:, :, 0, :].reshape(tiles, -1)
            acc = torch.where(live, acc + row.sum(dim=1) * 1e-30, acc)
        elif variant == "dma1":
            cid = (col % max(1, DMA1_SPAN // cpi)) * cpi
            acc = torch.where(live, acc + blocks_t[cid, 0].sum() * 1e-30,
                              acc)
        acc = torch.where(live, acc + 1.0, acc)
    return (best + acc[:, None])[:, None, :]


def sweep_attrib(st, si, rays, blocks_lm, cpi, variant, t_min=1e-3):
    """P3: one variant of the column walk. blocks_lm f32[C, K, 16] is the
    lane-major copy of blocks_t (each lane's 16 rows contiguous, as K2
    reads them); the CPU route runs sweep_attrib_plain on blocks_t."""
    if variant not in VARIANTS:
        raise ValueError(f"sweep_attrib: variant {variant!r} not in "
                         f"{VARIANTS}")
    if not t_min >= 0.0:
        raise ValueError(f"sweep_attrib: t_min {t_min} must be >= 0")
    tiles, cs = st.shape
    if cpi < 1 or cs % cpi or cs == 0:
        raise ValueError(f"sweep_attrib: {cs} schedule entries are no "
                         f"whole, positive number of {cpi}-cluster columns")
    if not _route("sweep_attrib", st):
        return sweep_attrib_plain(st, si, rays, blocks_lm.transpose(1, 2),
                                  cpi, variant, t_min)
    dev = st.device
    r = rays.shape[2] if rays.dim() == 3 else -1
    c, k, _ = blocks_lm.shape
    _check("sweep_attrib st", st, torch.float32, dev, (tiles, cs))
    _check("sweep_attrib si", si, torch.int32, dev, (tiles, cs))
    _check("sweep_attrib rays", rays, torch.float32, dev, (tiles, 6, r))
    _check("sweep_attrib blocks_lm", blocks_lm, torch.float32, dev,
           (c, k, 16))
    if r not in (32, 64):
        raise ValueError(f"sweep_attrib: tile_rays {r} must be 32 or 64")
    if cpi > 32:
        raise ValueError(f"sweep_attrib: cpi {cpi} above 32 (warp 0 holds "
                         "a column's cluster ids, one a lane)")
    if blocks_lm.data_ptr() % 16:
        raise ValueError("sweep_attrib: blocks_lm must start at a 16-byte "
                         "boundary (the source of TMA bulk copies)")
    stages = attrib_stages(r, k, int(cpi))
    shmem = attrib_shmem(r, k, int(cpi), stages)
    if shmem > SHMEM_LIMIT:
        raise ValueError(f"sweep_attrib: cpi {cpi} x {k} lanes needs "
                         f"{shmem} B of shared memory a block (at most "
                         f"{SHMEM_LIMIT})")
    span = max(1, DMA1_SPAN // cpi)
    if variant == "dma1" and min(cs // cpi, span) * cpi > c:
        raise ValueError(f"sweep_attrib: dma1 copies clusters up to "
                         f"{min(cs // cpi, span) * cpi}, the table has {c}")
    out = torch.empty((tiles, 1, r), dtype=torch.float32, device=dev)
    if tiles == 0:
        return out
    rc = _lib().pt_sweep_attrib(
        VARIANTS.index(variant), st.data_ptr(), si.data_ptr(), tiles, cs,
        rays.data_ptr(), blocks_lm.data_ptr(), k, r, int(cpi), stages,
        float(t_min), out.data_ptr(), cuda_build.stream_ptr(dev))
    cuda_build.check_launch(rc, f"sweep_attrib({variant})")
    LAUNCHES["sweep_attrib"] += 1
    return out
