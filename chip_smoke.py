#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: python3 chip_smoke.py

Drives pathtracer_torch's paths on the card and checks them:

1. device: card name and power limit, versions, builds of the native
   libraries (host runtime and image decoders) and of the CUDA kernels
   (one compiler per source, all started together);
2. each kernel against its plain PyTorch version on the card, replaying
   the arguments the main path itself handed it: K1 tile cull, K2 closest
   sweep and K3 occlusion sweep in chunks of an unprimed headline frame's
   primary, bounce-0 shadow and bounce-1 batches (K1 bit-exact, K2
   hit-exact with t/u/v bit-exact, K3 exact); K3b (occlusion sweep with
   blocker hints) in chunks of a primed headline frame's bounce-0 shadow
   batch (bit-exact blocked and btri, blocked equal to K3's, every hint a
   front-facing blocker with 0 < t < t_max), and K1/K2 once more on that
   frame's primary batch, whose t_max is per ray; K4 (the block-gated
   cull) on every replayed K1 chunk at blk 128 and 256, bit-exact against
   its plain version and against K1, its block mask equal to
   sc_mask_plain, and on the adversarial chunks of
   tests/test_torch_cuda.py (parked rays, pad boxes, equal negative 1/d);
   K4's skip rate per batch kind against the JAX package's probe, with
   the share of blocks no ray enters at all and of blocks only parked
   rays keep; K4's slab tests needed and run, registers, occupancy and
   share of bound; per sweep kernel the lane tests its data needs, those
   a kernel testing every lane of every visited column runs, and those
   the kernel runs (from the plain versions' column walk), with its
   registers and occupancy; for K2 also its pass B's (the long walks'
   tail on thread-block clusters) and per compared chunk the tiles pass
   B resumed (exactly those whose plain walk passes the budget), the
   columns it tested, and the chunk's time beside its 8 longest tiles'
   alone and the others' (`per_chunk`; `--only kernels` runs this phase
   alone after the device phase); K1-K3 at
   128 and 256 rays a tile on a chunk a batch of frames traced under
   PT_TILE_RAYS=128 and 256 (as at 64), K4 at blk 128 on their K1
   chunks (bit-exact), with each width's ms a chunk, bound, lane tests
   and columns walked (`tile_rays` on the kernel_vs_plain and sweep_work
   lines), and pair_metrics' bounce-1 visited and needed columns at 32,
   64, 128 and 256 rays a tile (`tile_width_columns`);
   probes: P1-P3 (kernels/probes.py, the JAX package's TPU probes)
   through their drivers (bench/bf16_probe, cond_probe, sweep_attrib at
   cpi 1 and 12) with the launch counts set to 0 just before and read
   just after - P1's f32 and bf16 times and speedup, P2's gated and
   always-extract times in both designs (a grid step on one CTA, and on
   a 2-CTA cluster: the kept one), P3's attribution of a column - then
   each kernel against its plain version (P1 f32 and bf16 at 2 and 4096
   steps and P2 gated and ungated, both designs, bit-exact, with P2's
   SASS instruction counts of the walk and the extraction, P3's full
   variant hit-exact
   with t bit-exact and the others +inf, at cpi 1 and 12, with each
   variant's registers, ring stages and blocks an SM); K2 on P3's
   schedule at cpi 1 (bench/sweep_attrib.k2_columns), its t bit for bit
   P3's, and K2's cost a column beside P3 full's (logged, no limit:
   P3 stages its columns its own way, K2 is pair_metrics' rate); P3's
   bound from the lane-test branches its plain version counts on the
   run's data; K9 (the PCG4D draw of sampling/rng.py) bit for bit against
   its plain version at a headline wavefront's 8,294,400 lanes in the
   main path's word layout, each timed beside K9's bytes bound
   (`k9_vs_plain`), and the headline run must launch it; K10 (a
   bounce's shading, integrator/shade.py) and its resolve against the
   plain chain on a headline wavefront's bounce 0 and last segment, the
   traversal's answers replayed to both (the traversal calls' parked
   lanes equal, rays and radiance within SHADE_ULPS ulps, the ray count
   exact), K10's ms beside its bytes bound and both paths' ms
   (`k10_vs_plain`), and configs 1-5's 64x64 golden gates with every
   bounce shaded by K10 (`k10_goldens`; `--only shade` runs these two
   alone after the device phase);
3. configs: the config sweep (pathtracer_torch/bench/configs.py, the
   port of benchmarks/run_configs.py, whose configs, cameras and golden
   gate this script imports) at BASELINE's sizes - configs 1-5 through
   run_config (3 warm-up steps, --frames timed steps, the 64x64 / 4 spp
   probe against tests/goldens), then config 4 under PT_CULL_SKIP=1,
   the launch counts set to 0 just before each run and read just after:
   every accuracy_ok true, ms/frame finite and positive, configs 2-5
   launching K1 (K4 and no K1 under PT_CULL_SKIP=1), K2 and K3; one
   `configs` line each with the record, K1-K4 launches, peak memory and
   seconds; then `python -m pathtracer_torch.bench.configs --configs 1
   --scale 0.25 --frames 1 --no-check` in a subprocess must exit 0 with
   its line;
4. the headline - textured sponza_like (~262k triangles), 1920x1080,
   4 spp, depth 6, spp-batched - unprimed with K1, unprimed with
   PT_CULL_SKIP=1 (K4 only: same ray counts frame for frame, film within
   the gate), and primed: one warm-up frame and --frames timed frames
   each through Renderer, launch counts reset just before and read just
   after each run; the primed film must pass the gate against the
   unprimed one with the same ray counts;
   variants: the headline once per default-off alternative of the
   cluster route (VARIANTS: the median/morton accel split, the sah,
   sahleaf and sahdeep builds, wavefront_sort, PT_TILE_RAYS=32, 128
   and 256 and skip_nee), one warm-up and one timed frame each, against
   the default
   route's run of the same frames: rays within 1e-5 and the film within
   the gate (skip_nee: fewer rays, a finite display), and config 5's
   64x64 golden under the same knobs (skip_nee: finite); ms/frame,
   Mrays/s, the ratio to the default, build seconds and peak memory per
   variant;
   bench: python -m pathtracer_torch.bench in this process at the
   headline with BENCH_FRAMES=2 (its default 8 cut to keep the phase
   near 30 s; 4 warm-up frames a leg, the textured and the interleaved
   untextured leg as the entry runs them), launch counts set to 0 just
   before and read just after (K1-K3 must launch): its JSON line, a
   finite positive value, pair_metrics without error and with the rate
   K2 itself ran at in that run (bench/sweep_attrib.k2_columns, K2
   launched there); pair_metrics' visited/needed counts on
   a 131,072-ray bounce-1 batch equal with K1 and with the plain cull;
   K2's measured time on the whole bounce-1 batch beside the model's
   sweep_model_ms;
5. assets: the headline scene exported to .glb by the port's exporter
   and loaded back by its glTF loader (export, load and accel seconds,
   the file's bytes), its host tables equal to the procedural build's
   (geometry and light tables bit for bit, material fields per face,
   texels per texture pair) and its blocks_t equal; the 1080p headline
   rendered from the file with phase 4's ray counts and a film within
   its gate; then app.main on the card composing the .glb under an
   '@tx,ty,tz,scale,ry' transform, an OBJ/MTL with a map_Kd PNG and an
   LDR PNG env map, all written by the port;
6. viewer: viewer.run_interactive on the .glb headline (4 spp) with
   auto frame batch 8 and motion preview 2, stdin piped and stdout
   captured: a fresh camera's preview, a single frame and an 8-frame
   batch, then a camera move and the same three kinds again; every
   display finite and in [0, 1], every ANSI body rows - 1 lines, K1-K3
   launched, ms per step; then app.main --orbit --quiet at 256x256 on
   the .glb: four PNGs and no output;
   images: the port's PNG/JPEG/TGA/BMP decoders, no PIL
   and no fallback: every committed fixture of tests/data/images held
   bit for bit to its committed PIL arrays; decode seconds per
   megapixel of 1024x1024 8-bit and 16-bit PNG, 4:2:0 baseline and
   progressive JPEG, raw 24-bit and RLE 32-bit TGA, and 24-bit and RLE8
   BMP beside the card's name and power limit; an OBJ/MTL whose map_Kd
   are an RLE TGA and an RLE4 BMP rendered at 256x256 on K1-K3, film and
   rays bit for bit those of the scene built from PIL's arrays; a .glb of
   the textured sponza_like (target 20k triangles) whose images are JPEG and
   16-bit PNG bytes: its tables, and its film and rays at 256x256, the
   headline's 4 spp (K1-K3), bit for bit those of the scene built from
   the decoded arrays directly (the film adds a pixel's samples in a
   fixed order, render.sample_sum);
7. config 4 at BASELINE's size and frame batch (1024x1024, 1 spp, depth
   6, env-map NEE, frame_batch = saturating_frame_batch = 8), unprimed,
   unprimed with PT_CULL_SKIP=1 (K4 where its 256 clusters gate: same
   ray counts, film within the gate) and primed, and one 8-frame step
   held to 8 single-frame steps (gate, equal rays);
8. config 3 at BASELINE's size (materials suite, 512x512, 4 spp, depth
   6, frame_batch 8: two steps = 64 spp) with the denoiser: the denoised
   display finite and in [0, 1], three AOVs;
9. lbvh: config 2's scene (bunny_like(), ~80k triangles) with its LBVH
   built on the card, bit for bit the CPU build; K5 (closest) and K6
   (any-hit) BVH walks against their plain versions (t/u/v/tri and
   blocked bit-exact) on the arguments the main path handed them in one
   step of config 2 on the bvh route, with the nodes and leaf tests the
   data needs and the bound they give;
10. config 2 at BASELINE's size on the bvh route (512x512, 1 spp, depth
   6, frame_batch = saturating_frame_batch = 8): K5/K6 and none of
   K1-K4 launched, the film within the gate of the cluster route's on
   the same seed, and config 2's 64x64 golden gate on the bvh route;
11. estimators: Sobol draws on the card equal to the CPU's over 2M
   lanes (sample ids up to 2^32 - 1); config 3 at its size with
   sampler="sobol" against pcg (ms/frame, finite film); config 1 with
   reference_quirks (256x256, 4 spp, depth 6) against
   tests/golden_cornell_quirks_256.npy; the Hosek sky on config 2's
   scene at 64x64, the card's film against the port's CPU render;
12. sharded (parallel/sharding.py): the headline through Renderer(mesh=
   ...) over NCCL at world size 1 in this process, its film within the
   gate of phase 4's and its ray counts equal; then SHARD_RANKS gloo
   ranks spawned on cuda:0 (sharing its SMs: their times say nothing of
   scaling), each with its own scenes: the collectives on CUDA tensors
   (SUM f32 and int64, MAX int32), the headline unprimed and primed on
   mesh (1, ranks), goldens 1-5 and config 3 with the denoiser on mesh
   (ranks, 1); every rank must launch K1-K3 (K3b primed), hold the same
   films (checksums) and exit 0 within SHARD_TIMEOUT_S, and the films
   pass the gates against tests/goldens and phases 4 and 8 (the primed
   one also against the unprimed one, with equal rays); all_reduce ms
   and bytes a step and peak memory per rank are logged.

Prints one JSON line of per-kernel results, then as its last line
{"ok": true, "device": {...}}. Exits non-zero, with no result line,
without a CUDA device, outside a checkout of the repository, or when
any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
# the five BASELINE configs, their cameras and the golden gate: one
# definition, the config sweep's (python -m pathtracer_torch.bench.configs)
from pathtracer_torch.bench.configs import (  # noqa: E402
    MEAN_TOL, OUTLIER_TOL, RMSE_TOL, SPONZA_CAM, accuracy_probe,
    build_configs, camera, load_golden, load_scene, probe_cfg, robust_gate,
    run_config)

DEVICE = "cuda"
# the headline: bench.py's textured sponza_like at 1080p (never cut)
HEADLINE_TRIS, HEADLINE_W, HEADLINE_H = 262_000, 1920, 1080
BATCH_NAMES = ("primary", "shadow0", "bounce1")   # first traversal calls
CHUNK_STRIDE = 16   # compare every 16th chunk of a batch ...
CMP_CHUNKS = 4      # ... and at most 4 chunks per batch
# the tile widths the sweeps take beside the default 64 (PT_TILE_RAYS):
# K1-K3 (K4 on the K1 chunks) replayed from frames traced at each,
# WIDE_CMP_CHUNKS chunks a batch (a chunk holds 2048 tiles of R rays)
WIDE_TILES = (128, 256)
TILE_WIDTHS = (32, 64) + WIDE_TILES
WIDE_CMP_CHUNKS = 1
KERNELS = {
    "tile_cull": ("pathtracer_torch/csrc/cull.cu",
                  "pathtracer/kernels/pallas_cull.py:35"),
    "sweep_closest": ("pathtracer_torch/csrc/sweep.cu",
                      "pathtracer/kernels/pallas_sweep.py:98"),
    "sweep_occluded": ("pathtracer_torch/csrc/sweep.cu",
                       "pathtracer/kernels/pallas_sweep.py:223"),
    "sweep_occluded_blocker": ("pathtracer_torch/csrc/sweep.cu",
                               "pathtracer/kernels/pallas_sweep.py:223 "
                               "(want_blocker=True)"),
    "tile_cull_skip": ("pathtracer_torch/csrc/cull.cu",
                       "pathtracer/kernels/pallas_cull.py:66"),
    # XLA code in the JAX package (lax.while_loop), not Pallas
    "bvh_closest": ("pathtracer_torch/csrc/traverse.cu",
                    "pathtracer/kernels/traverse.py:140"),
    "bvh_occluded": ("pathtracer_torch/csrc/traverse.cu",
                     "pathtracer/kernels/traverse.py:206"),
    # the TPU probes P1-P3 of benchmarks/
    "chain_f32": ("pathtracer_torch/csrc/probes.cu",
                  "benchmarks/bf16_probe.py:56"),
    "chain_bf16": ("pathtracer_torch/csrc/probes.cu",
                   "benchmarks/bf16_probe.py:56 (bfloat16)"),
    "cond_walk": ("pathtracer_torch/csrc/probes.cu",
                  "benchmarks/cond_probe.py:24"),
    "cond_walk_gated": ("pathtracer_torch/csrc/probes.cu",
                        "benchmarks/cond_probe.py:24 (gate=True)"),
    "sweep_attrib": ("pathtracer_torch/csrc/probes.cu",
                     "benchmarks/sweep_attrib.py:56"),
    # XLA code in the JAX package: one PCG4D draw of uniform4
    "pcg4d": ("pathtracer_torch/csrc/rng.cu",
              "pathtracer/sampling/rng.py:47 (pcg4d, via uniform4 :80)"),
    # XLA code in the JAX package: a bounce's shading chain
    "shade": ("pathtracer_torch/csrc/shade.cu",
              "pathtracer/integrator/path.py:686 (segment) and :795 "
              "(bounce)"),
}
KERNEL_IDS = {"tile_cull": "K1", "sweep_closest": "K2",
              "sweep_occluded": "K3", "sweep_occluded_blocker": "K3b",
              "tile_cull_skip": "K4"}
CLUSTER_KERNELS = ("tile_cull", "tile_cull_skip", "sweep_closest",
                   "sweep_occluded", "sweep_occluded_blocker")
BVH_KERNELS = ("bvh_closest", "bvh_occluded")
UNPRIMED_KERNELS = ("tile_cull", "sweep_closest", "sweep_occluded")
PRIMED_KERNELS = UNPRIMED_KERNELS + ("sweep_occluded_blocker",)
SKIP_KERNELS = ("tile_cull_skip", "sweep_closest", "sweep_occluded")
SKIP_BLKS = (128, 256)   # K4 block widths replayed (PT_CULL_BLK default 128)
# K4's skip rates in the JAX package's probe (benchmarks/cull_block_probe.py:
# 640x360, 262k triangles; blocks where no cluster passes K1's test)
JAX_SKIP = {128: {"primary": 0.870, "shadow0": 0.821, "bounce1": 0.680},
            256: {"primary": 0.793, "shadow0": 0.692, "bounce1": 0.576}}
# Least-time model of one NVIDIA H100 SXM (NVIDIA's data sheet, 700 W):
# 67e12 FP32 FLOP/s outside the tensor cores counts an FMA as two; the
# kernels are built with -fmad=false (bit-exact against their plain
# versions), so each mul, add, compare or min/max is one instruction, at
# half that rate. HBM3 at 3.35e12 bytes/s.
PEAK_FP32_INSTR, PEAK_BYTES = 67e12 / 2, 3.35e12
# FP32 instructions per pair, counted off csrc/*.cu (a division as one):
CULL_OPS = 28   # (ray, cluster): 6 sub, 6 mul, 10 min/max, 3 tests, 3
BW_OPS = {"sweep_closest": 38,             # (ray, triangle): bw_lane
          "sweep_occluded": 40,            # + denom < 0, t < t_max
          "sweep_occluded_blocker": 40}
# K5/K6, off csrc/traverse.cu: a node visit is a slab test (6 sub, 6 mul,
# 10 min/max, 3 compares); a leaf test Moller-Trumbore (52: crosses,
# dots, the reciprocal, 6 range tests), K5 + the strict t < best_t, K6 +
# the front-facing test (cross, dot, compare) and t < t_max
SLAB_OPS = 25
LEAF_OPS = {"bvh_closest": 53, "bvh_occluded": 68}
NODE_BYTES, TRI_BYTES = 32, 36
SOBOL_LANES = 1 << 21
# K9 at a headline wavefront (1920 x 1080 pixels x 4 spp-batched samples)
# in the main path's word layout, RNG_REPEATS draws a timing. Its bound
# is bytes: each lane reads an int32 pixel and an int64 sample id and
# writes 16 B (its ~40 integer instructions take about a third of that)
RNG_LANES, RNG_REPEATS = HEADLINE_W * HEADLINE_H * 4, 20
# K10 on a headline wavefront: bounce 0 and the last segment of a depth-2
# trace_paths, the traversal's answers replayed, SHADE_REPEATS timings a
# path. Its bound is bytes, each input read once and each output written
# once: a lane reads its state and hit (SHADE_LANE_IN: active, o, d,
# throughput, radiance, prev_pdf, pixel and sample ids, t/tri/u/v) and
# writes the next state, its sky or emission term, a shadow ray, a pending
# term and its flag (SHADE_LANE_OUT); the tables once: the surface rows of
# the triangles hit, the material rows, the composite texels and the
# light rows. Floats may sit SHADE_ULPS ulps of their row's magnitude
# from the plain chain's.
SHADE_REPEATS, SHADE_ULPS = 3, 8
SHADE_LANE_IN = 1 + 4 * 12 + 4 + 4 + 8 + 16
SHADE_LANE_OUT = 4 * 12 + 4 + 1 + 28 + 12 + 1
# the sharded phase: gloo ranks sharing cuda:0, and how long they may run
SHARD_RANKS, SHARD_TIMEOUT_S = 2, 300
# the images phase: the .glb render's size, the PNG sizes whose decode is
# timed (made in the phase: 8-bit by the port's encoder, 16-bit by
# tests/image_codecs.png_file) and the timed decodes of each file
IMAGE_RENDER, IMAGE_BENCH_PX, IMAGE_REPEATS = 256, 1024, 5


def log(phase, **kw):
    # one write a line: the sharded phase's ranks share this stdout
    sys.stdout.write(json.dumps({"phase": phase, **kw}) + "\n")
    sys.stdout.flush()


class PhaseError(RuntimeError):
    pass


def baseline(idx):
    """BASELINE config idx at its published size: (name, scene_fn, cfg,
    camera) of bench/configs.build_configs(1.0)."""
    return build_configs(1.0)[idx - 1]


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi failed: {smi.stderr.strip()}")


def phase_device():
    import torch

    from pathtracer_torch.kernels import cuda_build
    from pathtracer_torch.utils import native

    print(card_line(), flush=True)
    t0 = time.perf_counter()
    errors = []

    def run(fn, *a):
        try:
            fn(*a)
        except Exception as e:     # reported below, after every build ends
            errors.append(e)

    builds = [threading.Thread(target=run, args=(native.build, lib))
              for lib in native.LIBS] + [
        threading.Thread(target=run, args=(cuda_build.build, name))
        for name in ("cull", "sweep", "traverse", "probes", "rng",
                     "shade")]
    for t in builds:
        t.start()
    for t in builds:
        t.join()
    if errors:
        raise PhaseError(f"build failed: {errors[0]}")
    for name, text in cuda_build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas[{name}] {line.strip()}", flush=True)
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], gpu=torch.cuda.get_device_name(0),
        build_s=time.perf_counter() - t0)


def headline_setup():
    from pathtracer_torch.accel.cluster import build_scene_clusters
    from pathtracer_torch.config import RenderConfig
    from pathtracer_torch.scene.procedural import sponza_like

    t0 = time.perf_counter()
    scene = sponza_like(target_tris=HEADLINE_TRIS,
                        textured=True).finalize(device="cpu")
    t1 = time.perf_counter()
    scene = build_scene_clusters(scene).to(DEVICE)
    t2 = time.perf_counter()
    cfg = RenderConfig(width=HEADLINE_W, height=HEADLINE_H, spp=4,
                       max_depth=6, intersector="cluster",
                       traversal_backend="pallas", spp_batch=True)
    log("scene", tris=scene.n_tris, clusters=scene.clusters.n_clusters,
        build_s=t1 - t0, accel_s=t2 - t1)
    return scene, cfg, camera(SPONZA_CAM)


@contextlib.contextmanager
def knob_env(env):
    """Set environment variables for the duration of a block."""
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def capture_chunks(scene, cfg, cam, frame_idx=0, prime=None, env=None,
                   stride=CHUNK_STRIDE):
    """Kernel arguments of one frame's primary, bounce-0 shadow and
    bounce-1 batches, recorded inside packet.py's chunk bodies while
    render_frame_with_stats renders the frame: every stride-th chunk of
    each batch, at most CMP_CHUNKS of them. env: knobs set for the frame.
    """
    from pathtracer_torch import render
    from pathtracer_torch.kernels import cull, sweep

    real = {"tile_cull": cull.tile_cull,
            "sweep_closest": sweep.sweep_closest,
            "sweep_occluded": sweep.sweep_occluded,
            "make_intersectors": render.make_intersectors}
    batches, cur = [], {"batch": None, "keep": False}

    def copies(args, per_chunk):    # clone the per-chunk tensors only
        return tuple(a.clone() if i in per_chunk else a
                     for i, a in enumerate(args))

    def rec_cull(name):
        def call(*a, **kw):
            b = cur["batch"]
            cur["keep"] = False
            if b is not None:
                b["chunks"] += 1
                cur["keep"] = ((b["chunks"] - 1) % stride == 0
                               and len(b[name]) < CMP_CHUNKS)
                if cur["keep"]:
                    b[name].append((copies(a, (2, 3, 4)), dict(kw)))
            return real[name](*a, **kw)
        return call

    def rec_sweep(name):
        def call(*a, **kw):
            if cur["keep"]:
                key = name + ("_blocker" if kw.get("want_blocker") else "")
                cur["batch"][key].append((copies(a, (0, 1, 2, 3)), dict(kw)))
            return real[name](*a, **kw)
        return call

    def traversal(fn):              # one call = one batch of rays
        def call(*a, **kw):
            i = len(batches)
            cur["batch"] = None
            if i < len(BATCH_NAMES):
                cur["batch"] = {"label": BATCH_NAMES[i], "chunks": 0,
                                **{k: [] for k in KERNELS}}
            batches.append(cur["batch"])
            return fn(*a, **kw)
        return call

    def make_intersectors(scene, cfg):
        intersect_fn, occluded_fn, hint_fn = real["make_intersectors"](
            scene, cfg)
        return traversal(intersect_fn), traversal(occluded_fn), hint_fn

    cull.tile_cull = rec_cull("tile_cull")
    sweep.sweep_closest = rec_sweep("sweep_closest")
    sweep.sweep_occluded = rec_sweep("sweep_occluded")
    render.make_intersectors = make_intersectors
    try:
        with knob_env(env):
            render.render_frame_with_stats(scene, cfg,
                                           cam.state(device=DEVICE),
                                           frame_idx, prime=prime)
    finally:
        cull.tile_cull = real["tile_cull"]
        sweep.sweep_closest = real["sweep_closest"]
        sweep.sweep_occluded = real["sweep_occluded"]
        render.make_intersectors = real["make_intersectors"]
    return [b for b in batches if b is not None]


def plain_args(args):
    """A recorded sweep call's arguments for its plain version: the
    accel's blocks_t in place of the accel."""
    return args[:4] + (args[4].blocks_t,) + args[5:]


def tail_split(kernel, args, kw, cols, n, time_ms):
    """A sweep chunk's time on its n longest-walking tiles alone and on
    the others (time_ms(fn) -> ms), and the share of the chunk's columns
    (cols [tiles], the plain walk's) those tiles walk."""
    import torch

    order = torch.argsort(cols, descending=True)

    def part(ix):
        return tuple(a[ix].contiguous() if i < 4 else a
                     for i, a in enumerate(args))

    top, rest = part(order[:n]), part(order[n:])
    return {f"longest{n}_ms": time_ms(lambda: kernel(*top, **kw)),
            f"others{n}_ms": time_ms(lambda: kernel(*rest, **kw)),
            f"longest{n}_column_share": float(cols[order[:n]].sum()
                                              / cols.sum())}


def k2_engagement(label, args, cols):
    """K2's two passes on one recorded chunk: the tiles pass B resumed,
    which must be those whose plain walk (cols [tiles]) passes
    RESUME_COLUMNS, the columns pass B tests (whole rounds of
    RESUME_CTAS) and those the walk visits past the budget."""
    import torch

    from pathtracer_torch.kernels import sweep

    *_, resumed = sweep.sweep_closest_resumed(*args)
    want = torch.nonzero(cols > sweep.RESUME_COLUMNS)[:, 0]
    if not torch.equal(resumed, want):
        raise PhaseError(f"K2 {label}: pass B resumed {resumed.numel()} "
                         f"tiles, the plain walk passes the budget in "
                         f"{want.numel()}")
    past = (cols - sweep.RESUME_COLUMNS).clamp(min=0)
    rounds = (past + sweep.RESUME_CTAS - 1) // sweep.RESUME_CTAS
    tested = ((sweep.RESUME_COLUMNS + rounds * sweep.RESUME_CTAS)
              .clamp(max=args[0].shape[1]) - sweep.RESUME_COLUMNS)
    return dict(resumed=int(resumed.numel()),
                pass_b_columns=int(tested.clamp(min=0).sum()),
                pass_b_needed=int(past.sum()))


def timed(fn):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound_ms(name, args, pair_tests, tile_rays=64):
    """Least time of one call on the card, as (operations ms, bytes ms):
    its FP32 instructions over PEAK_FP32_INSTR and its bytes (each input
    read once, each output written once) over PEAK_BYTES; the bound is
    the larger. Operations count what this call's data needs: K1 the
    (ray, cluster) pairs of unparked rays and real clusters; the sweeps
    the (ray, triangle) tests their plain versions count (pair_tests:
    live rays, real lanes, K3 up to the first blocking lane)."""
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)  # noqa
    if name in ("tile_cull", "tile_cull_skip"):
        lo, hi, o, inv_d, t_max = args
        tiles = t_max.numel() // tile_rays
        # K1: every unparked ray against every real cluster; K4: the
        # (ray, box) tests of its plain version (NB union boxes plus the
        # real clusters of kept blocks, per tile)
        pairs = (int(pair_tests) if name == "tile_cull_skip" else
                 int((o[:, 0] < 1e29).sum()) * int((lo[:, 0] < 1e29).sum()))
        ops = pairs * CULL_OPS
        moved = nbytes(lo, hi, o, inv_d, t_max) + tiles * lo.shape[0] * 4
    else:
        st, si, rays, per_ray, accel = args[:5]
        pairs = int(pair_tests)
        ops = pairs * BW_OPS[name]
        outs = {"sweep_closest": 4, "sweep_occluded": 1,
                "sweep_occluded_blocker": 2}[name]
        moved = (nbytes(st, si, rays, per_ray, accel.blocks_t)
                 + outs * per_ray.numel() * 4)
    return ops / PEAK_FP32_INSTR * 1e3, moved / PEAK_BYTES * 1e3, pairs


def exact_vs_plain(name, label, out, ref):
    """Raise PhaseError unless a cluster kernel's output is its plain
    version's bit for bit (K2: the hit triangle first, then t, u and v);
    returns the largest |out - ref| over the entries that hold a
    distance (0.0, as bit-exactness makes it)."""
    import torch

    tag = f"{KERNEL_IDS[name]} {label}"
    if name in ("tile_cull", "tile_cull_skip"):
        if not torch.equal(out, ref):
            raise PhaseError(f"{tag}: {int((out != ref).sum())} entries "
                             "differ")
        fin = torch.isfinite(out)
        return (float((out[fin] - ref[fin]).abs().max())
                if bool(fin.any()) else 0.0)
    if name == "sweep_closest":
        if not torch.equal(out[1], ref[1]):
            raise PhaseError(f"{tag}: {int((out[1] != ref[1]).sum())} rays "
                             "hit another triangle")
        for x, y, nm in zip(out[::2] + out[3:], ref[::2] + ref[3:],
                            ("t", "u", "v")):
            if not torch.equal(x, y):
                raise PhaseError(f"{tag}: {nm} not bit-exact "
                                 f"(max {float((x - y).abs().max())})")
        hit = out[1] >= 0
        return (float((out[0][hit] - ref[0][hit]).abs().max())
                if bool(hit.any()) else 0.0)
    if name == "sweep_occluded":
        if not torch.equal(out, ref):
            raise PhaseError(f"{tag}: {int((out != ref).sum())} rays differ")
        return 0.0
    for x, y, nm in zip(out, ref, ("blocked", "btri")):  # K3b
        if not torch.equal(x, y):
            raise PhaseError(f"{tag}: {nm} differs on "
                             f"{int((x != y).sum())} rays")
    return 0.0


def phase_kernels(scene, cfg, cam):
    import torch

    from pathtracer_torch.kernels import cull, sweep
    from pathtracer_torch.kernels.intersect import ray_triangle
    from pathtracer_torch.render import render_frame_with_stats
    from pathtracer_torch.utils import vmath

    def new_stats():
        return {"ms": [], "plain_ms": [], "ops_ms": [], "bytes_ms": [],
                "bound_ms": [], "pairs": [], "max_abs_err": 0.0, "calls": 0,
                "walk": [], "split": []}

    stats = {k: new_stats() for k in CLUSTER_KERNELS}
    skip_stats = {blk: dict(new_stats(), **{k: [] for k in (
        "kernel_tests", "pairs_all_rays", "skip", "exact_skip", "parked_kept",
        "label")}) for blk in SKIP_BLKS}
    cull_chunks = []     # every replayed K1 chunk, for K4

    def run_plain(name, args, kw, pair_tests):
        if name == "tile_cull":
            return cull.tile_cull_plain(*args, **kw)
        if name == "sweep_closest":
            return sweep.sweep_closest_plain(*plain_args(args),
                                             pair_tests=pair_tests)
        return sweep.sweep_occluded_plain(
            *plain_args(args), pair_tests=pair_tests,
            want_blocker=kw.get("want_blocker", False))

    def walk_counts(name, args, kw):
        """The plain version's column walk of one sweep call: (columns
        visited, lane tests the kernel runs, columns of each tile)."""
        tests = torch.zeros((), dtype=torch.int64, device=DEVICE)
        cols = torch.zeros(args[0].shape[0], dtype=torch.int64,
                           device=DEVICE)
        if name == "sweep_closest":
            sweep.sweep_closest_plain(*plain_args(args), kernel_tests=tests,
                                      tile_columns=cols)
        else:
            sweep.sweep_occluded_plain(
                *plain_args(args), want_blocker=kw.get("want_blocker", False),
                kernel_tests=tests, tile_columns=cols)
        return int(cols.sum()), int(tests), cols

    def k2_split(label, args, kw, ms, cols):
        """K2's two passes on one chunk (k2_engagement) and the chunk's
        time beside its 8 longest tiles' and the others'."""
        return dict(batch=label, **k2_engagement(label, args, cols), ms=ms,
                    **tail_split(sweep.sweep_closest, args, kw, cols, 8,
                                 lambda fn: timed(fn)[1]))

    def run_kernel(name, args, kw):
        if name == "tile_cull":
            return cull.tile_cull(*args, **kw)
        return getattr(sweep, name.replace("_blocker", ""))(*args, **kw)

    bw_rows = scene.clusters.bw_rows

    def check_blocker_hints(label, args, out):
        """Every hint is a front-facing triangle with 0 < t < t_max under
        Moller-Trumbore (intersect.ray_triangle); a hint on a triangle
        edge, where that test and the sweep's Baldwin-Weber test may
        round apart, must pass the Baldwin-Weber test. Returns (hints,
        hints only the Baldwin-Weber test accepts)."""
        _, _, rays, tm, _ = args
        blocked, btri = out
        if not torch.equal(btri >= 0, blocked > 0):
            raise PhaseError(f"K3b {label}: hint set != blocked set")
        sel = btri >= 0
        o = rays[:, 0:3].transpose(1, 2)[sel]
        d = rays[:, 3:6].transpose(1, 2)[sel]
        ids = btri[sel].long()
        v0, v1, v2 = scene.tri_vertices(ids)
        _, _, _, ok = ray_triangle(o, d, v0, v1, v2, 0.0, tm[sel])
        front = vmath.dot(d, vmath.cross(v1 - v0, v2 - v0)) < 0.0
        edge = ~(ok & front)
        if bool(edge.any()):
            _, _, _, ok_bw = sweep.bw_hit(bw_rows[ids[edge]], o[edge],
                                          d[edge], 0.0, tm[sel][edge],
                                          front_only=True)
            bad = int((~ok_bw).sum())
            if bad:
                raise PhaseError(f"K3b {label}: {bad} hints do not "
                                 "re-verify")
        return int(sel.sum()), int(edge.sum())

    def record_stats(s, name, args, ms, ms_p, pair_tests, err,
                     tile_rays=64):
        s["ms"].append(ms)
        s["plain_ms"].append(ms_p)
        ops_ms, bytes_ms, pairs = bound_ms(name, args, pair_tests, tile_rays)
        s["pairs"].append(pairs)
        s["ops_ms"].append(ops_ms)
        s["bytes_ms"].append(bytes_ms)
        s["bound_ms"].append(max(ops_ms, bytes_ms))
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["calls"] += 1

    def compare_skip(label, args, kw, blk):
        """K4 on a K1 chunk: bit-exact vs its plain version and vs K1,
        its mask equal to sc_mask_plain; with the shares of (tile, block)
        pairs it skips, that no ray enters at all, and that only parked
        rays keep."""
        lo, hi, o, inv_d, t_max = args
        n_tiles, c = kw["n_tiles"], lo.shape[0]
        k1 = cull.tile_cull(*args, **kw)
        nb = cull.n_blocks(c, blk)
        mask = torch.empty((n_tiles, nb), dtype=torch.int32, device=DEVICE)

        def kernel():
            return cull.tile_cull_skip(*args, **kw, blk=blk, mask_out=mask)

        kernel()                                              # warm-up
        out, ms = timed(kernel)
        pair_tests = torch.zeros((), dtype=torch.int64, device=DEVICE)
        kernel_tests = torch.zeros((), dtype=torch.int64, device=DEVICE)
        ref, ms_p = timed(lambda: cull.tile_cull_skip_plain(
            *args, **kw, blk=blk, pair_tests=pair_tests,
            kernel_tests=kernel_tests))
        for other, what in ((ref, "its plain version"), (k1, "K1")):
            if not torch.equal(out, other):
                raise PhaseError(f"K4 blk {blk} {label}: "
                                 f"{int((out != other).sum())} entries "
                                 f"differ from {what}")
        if not torch.equal(mask, cull.sc_mask_plain(*args, **kw, blk=blk)):
            raise PhaseError(f"K4 blk {blk} {label}: mask != sc_mask_plain")
        s = skip_stats[blk]
        record_stats(s, "tile_cull_skip", args, ms, ms_p, pair_tests, 0.0)
        kept = mask > 0
        pad = nb * blk - c
        entered = torch.nn.functional.pad(torch.isfinite(k1), (0, pad))
        unparked = o[:, 0] < 1e29
        by_live = cull.sc_mask_plain(lo, hi, o, inv_d, torch.where(
            unparked, t_max, torch.nan), **kw, blk=blk) > 0
        real = torch.nn.functional.pad(lo[:, 0] < 1e29, (0, pad))
        # the tests without per-block ray sets: every unparked ray
        # against the union boxes and the kept blocks' real clusters
        all_rays = (unparked.reshape(n_tiles, -1).sum(1) * (
            nb + (kept * real.reshape(nb, blk).sum(1)).sum(1))).sum()
        s["kernel_tests"].append(int(kernel_tests))
        s["pairs_all_rays"].append(int(all_rays))
        s["skip"].append(1.0 - float(kept.float().mean()))
        s["exact_skip"].append(1.0 - float(entered.reshape(
            n_tiles, nb, blk).any(dim=2).float().mean()))
        s["parked_kept"].append(float((kept & ~by_live).float().mean()))
        s["label"].append(label)
        return s["skip"][-1], ms

    def compare_traps():
        """K4 on tests/test_torch_cuda.py's adversarial chunks (parked
        tails, pad boxes, equal negative 1/d, t_min 0 and > 0, t_max
        finite and inf): bit-exact vs plain and K1, mask vs sc_mask_plain.
        """
        import importlib.util

        # by path: an installed package named `tests` would shadow the
        # checkout's tests/ directory
        spec = importlib.util.spec_from_file_location(
            "test_torch_cuda",
            os.path.join(ROOT, "tests", "test_torch_cuda.py"))
        traps = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(traps)
        for pads, t_min, t_max in traps.CULL_TRAPS:
            args = traps.cull_trap_case(pads, t_max, DEVICE)
            kw = dict(t_min=t_min, n_tiles=7, tile_rays=64)
            k1 = cull.tile_cull_plain(*args, **kw)
            for blk in SKIP_BLKS:
                mask = torch.empty((7, cull.n_blocks(args[0].shape[0], blk)),
                                   dtype=torch.int32, device=DEVICE)
                out = cull.tile_cull_skip(*args, **kw, blk=blk,
                                          mask_out=mask)
                ok = (torch.equal(out, cull.tile_cull_skip_plain(
                    *args, **kw, blk=blk)) and torch.equal(out, k1)
                    and torch.equal(mask, cull.sc_mask_plain(
                        *args, **kw, blk=blk)))
                if not ok:
                    raise PhaseError(f"K4 blk {blk} adversarial chunk "
                                     f"{(pads, t_min, t_max)} differs")
        log("k4_adversarial", cases=len(traps.CULL_TRAPS),
            blks=list(SKIP_BLKS), exact=True)

    def compare(name, label, args, kw, record=True, into=stats):
        run_kernel(name, args, kw)                            # warm-up
        out, ms = timed(lambda: run_kernel(name, args, kw))
        if name == "tile_cull" and into is stats:
            cull_chunks.append((label, args, kw, ms))
        pair_tests = torch.zeros((), dtype=torch.int64, device=DEVICE)
        ref, ms_p = timed(lambda: run_plain(name, args, kw, pair_tests))
        err = exact_vs_plain(name, label, out, ref)
        if name == "sweep_occluded_blocker":
            k3 = sweep.sweep_occluded(*args)
            if not torch.equal(k3, out[0]):
                raise PhaseError(f"K3b {label}: blocked != K3's")
            hints, edge = check_blocker_hints(label, args, out)
            log("k3b_chunk", batch=label, rays=out[0].numel(),
                blocked=int(out[0].sum()), hints_verified=hints,
                hints_on_edges=edge)
        if record:
            record_stats(into[name], name, args, ms, ms_p, pair_tests, err,
                         kw.get("tile_rays", 64))
            if name.startswith("sweep"):
                *walk, cols = walk_counts(name, args, kw)
                into[name]["walk"].append(walk)
                into[name]["shape"] = (args[2].shape[2],
                                       args[4].tris_per_cluster)
                if name == "sweep_closest":
                    into[name]["split"].append(
                        k2_split(label, args, kw, ms, cols))
        return out

    for b in capture_chunks(scene, cfg, cam):
        for args, kw in b["tile_cull"]:
            compare("tile_cull", b["label"], args, kw)
        for name in ("sweep_closest", "sweep_occluded"):
            for args, kw in b[name]:
                compare(name, b["label"], args, kw)
        log("kernels_batch", batch=b["label"], chunks=b["chunks"],
            compared=len(b["tile_cull"]))
    # a primed frame: frame 0 fills the hints, frame 1 is recorded
    cfg_p = dataclasses.replace(cfg, primary_priming=True)
    _, _, prime = render_frame_with_stats(scene, cfg_p,
                                          cam.state(device=DEVICE), 0,
                                          return_prime=True)
    for b in capture_chunks(scene, cfg_p, cam, 1, prime)[:2]:
        label = "primed_" + b["label"]
        for args, kw in b["tile_cull"]:
            compare("tile_cull", label, args, kw, record=False)
        for args, kw in b["sweep_closest"]:
            compare("sweep_closest", label, args, kw, record=False)
        for args, kw in b["sweep_occluded_blocker"]:
            compare("sweep_occluded_blocker", label, args, kw)
        log("kernels_batch", batch=label, chunks=b["chunks"],
            compared=len(b["tile_cull"]))
    # K4 on every replayed K1 chunk (unprimed primary, shadow0, bounce1;
    # primed primary), at each block width
    for label, args, kw, k1_ms in cull_chunks:
        for blk in SKIP_BLKS:
            if not cull.gated(args[0].shape[0], blk):
                raise PhaseError(f"K4: {args[0].shape[0]} clusters do not "
                                 f"gate at blk {blk}")
            skip, ms = compare_skip(label, args, kw, blk)
            log("k4_chunk", batch=label, blk=blk, skipped_blocks=skip,
                ms=ms, k1_ms=k1_ms)
    stats["tile_cull_skip"] = skip_stats[SKIP_BLKS[0]]

    wide = {w: phase_wide_tiles(scene, cfg, cam, w, compare, new_stats,
                                record_stats) for w in WIDE_TILES}

    def summarize(name, s, **extra):
        if not s["calls"]:
            raise PhaseError(f"{name}: never compared")
        mean = {k: sum(s[k]) / s["calls"]
                for k in ("ms", "plain_ms", "ops_ms", "bytes_ms",
                          "bound_ms", "pairs")}
        s.update(mean, bound_by=("operations" if mean["ops_ms"]
                                 >= mean["bytes_ms"] else "bytes"))
        log("kernel_vs_plain", kernel=name, chunks=s["calls"],
            max_abs_err=s["max_abs_err"], bound_by=s["bound_by"], **mean,
            **extra)

    for name, s in stats.items():
        summarize(name, s)
    for w, ws in wide.items():
        for name, s in ws.items():
            summarize(name, s, tile_rays=w, rays_per_chunk=s["rays"])
    for blk in SKIP_BLKS[1:]:
        summarize("tile_cull_skip", skip_stats[blk], blk=blk)
    for blk, s in skip_stats.items():
        log("k4_skip_rate", blk=blk, mean=sum(s["skip"]) / len(s["skip"]),
            per_chunk=s["skip"])
        for label in dict.fromkeys(s["label"]):
            at = [i for i, x in enumerate(s["label"]) if x == label]
            log("k4_skip_by_batch", blk=blk, batch=label, chunks=len(at),
                **{k: sum(s[k][i] for i in at) / len(at)
                   for k in ("skip", "exact_skip", "parked_kept")},
                jax_probe_skip=JAX_SKIP[blk].get(label))
        n = s["calls"]
        kernel = sum(s["kernel_tests"]) / n
        all_rays = sum(s["pairs_all_rays"]) / n
        log("k4_work", blk=blk, chunks=n, needed_tests=s["pairs"],
            kernel_tests=kernel, kernel_over_needed=kernel / s["pairs"],
            ms=s["ms"], bound_ms=s["bound_ms"],
            share_of_bound=s["bound_ms"] / s["ms"], pairs_all_rays=all_rays,
            bound_all_rays_ms=all_rays * CULL_OPS / PEAK_FP32_INSTR * 1e3,
            **cull.kernel_info(64, cull.n_blocks(scene.clusters.n_clusters,
                                                 blk)))
    compare_traps()

    def k2_passes(name, s, r, k):
        """K2's pass B on the sweep_work line: its registers, CTAs an SM
        and clusters, the budget and cluster size, and per chunk the
        tiles it resumed, the columns it tested and the times."""
        if name != "sweep_closest":
            return {}
        return dict(pass_b=sweep.kernel_info("sweep_resume", r, k),
                    resume_columns=sweep.RESUME_COLUMNS,
                    resume_ctas=sweep.RESUME_CTAS, per_chunk=s["split"])

    for name in ("sweep_closest", "sweep_occluded", "sweep_occluded_blocker"):
        s = stats[name]
        n = s["calls"]
        r, k = s["shape"]
        columns = sum(w[0] for w in s["walk"]) / n
        dense = columns * r * k
        kernel = sum(w[1] for w in s["walk"]) / n
        log("sweep_work", kernel=name, chunks=n, needed_tests=s["pairs"],
            dense_tests=dense, kernel_tests=kernel,
            dense_over_needed=dense / s["pairs"],
            kernel_over_needed=kernel / s["pairs"],
            columns=columns,
            **sweep.kernel_info(name, r, k), **k2_passes(name, s, r, k))
    for w, ws in wide.items():
        for name in ("sweep_closest", "sweep_occluded"):
            s = ws[name]
            r, k = s["shape"]
            log("sweep_work", kernel=name, tile_rays=w, chunks=s["calls"],
                needed_tests=s["pairs"],
                kernel_tests=sum(x[1] for x in s["walk"]) / s["calls"],
                columns=sum(x[0] for x in s["walk"]) / s["calls"],
                **sweep.kernel_info(name, r, k), **k2_passes(name, s, r, k))
    phase_tile_columns(scene, cfg, cam)
    return stats


def phase_wide_tiles(scene, cfg, cam, tile_rays, compare, new_stats,
                     record_stats):
    """K1-K3 at tile_rays rays a tile on the chunks of a headline frame
    traced under PT_TILE_RAYS=tile_rays (WIDE_CMP_CHUNKS a batch), each
    against its plain version as at 64 rays (K1 bit-exact, K2 hit-exact
    with t/u/v bit-exact, K3 exact); on each K1 chunk K4 at blk 128 (bit
    for bit its plain version and K1, its mask sc_mask_plain's). Returns
    {kernel: stats}."""
    import torch

    from pathtracer_torch.kernels import cull

    ws = {k: dict(new_stats(), rays=0) for k in (
        "tile_cull", "sweep_closest", "sweep_occluded", "tile_cull_skip")}
    env = {"PT_TILE_RAYS": str(tile_rays)}
    for b in capture_chunks(scene, cfg, cam, env=env):
        label = f"r{tile_rays}_{b['label']}"
        for name in ("tile_cull", "sweep_closest", "sweep_occluded"):
            for args, kw in b[name][:WIDE_CMP_CHUNKS]:
                width = (kw["tile_rays"] if name == "tile_cull"
                         else args[2].shape[2])
                if width != tile_rays:
                    raise PhaseError(f"{label}: {name} ran at {width} rays "
                                     "a tile")
                compare(name, label, args, kw, into=ws)
                ws[name]["rays"] = (args[2].shape[0] if name == "tile_cull"
                                    else args[2].shape[0] * tile_rays)
        for args, kw in b["tile_cull"][:WIDE_CMP_CHUNKS]:
            blk = SKIP_BLKS[0]
            mask = torch.empty((kw["n_tiles"], cull.n_blocks(args[0].shape[0],
                                                             blk)),
                               dtype=torch.int32, device=DEVICE)

            def k4():
                return cull.tile_cull_skip(*args, **kw, blk=blk,
                                           mask_out=mask)

            k4()
            got, ms = timed(k4)
            pair_tests = torch.zeros((), dtype=torch.int64, device=DEVICE)
            ref, ms_p = timed(lambda: cull.tile_cull_skip_plain(
                *args, **kw, blk=blk, pair_tests=pair_tests))
            if not (torch.equal(got, ref) and torch.equal(
                    got, cull.tile_cull_plain(*args, **kw))
                    and torch.equal(mask, cull.sc_mask_plain(
                        *args, **kw, blk=blk))):
                raise PhaseError(f"K4 {label}: differs from its plain "
                                 "version, K1 or sc_mask_plain")
            record_stats(ws["tile_cull_skip"], "tile_cull_skip", args, ms,
                         ms_p, pair_tests, 0.0, tile_rays)
            ws["tile_cull_skip"]["rays"] = args[2].shape[0]
    for name, s in ws.items():
        if not s["calls"]:
            raise PhaseError(f"{name} at {tile_rays} rays: never compared")
    return ws


def phase_tile_columns(scene, cfg, cam):
    """pair_metrics' bounce-1 columns at every tile width: per tile the
    columns its sweep visits, per ray those it needs, and the waste."""
    from pathtracer_torch.bench import pair_metrics

    for w in TILE_WIDTHS:
        with knob_env({"PT_TILE_RAYS": str(w)}):
            o2, d2 = pair_metrics.bounce1_batch(scene, cfg, cam,
                                                PAIR_CHECK_RAYS)
            pm = pair_metrics.pair_metrics(
                *pair_metrics.schedule_stats(scene.clusters, o2, d2),
                scene.clusters.tris_per_cluster)
        log("tile_width_columns", tile_rays=w,
            visited=pm["tile_visited_cols_mean"],
            needed=pm["ray_needed_cols_mean"], waste=pm["packet_waste"],
            rays=pm["rays_probed"])


# --- probes and bench -----------------------------------------------------

# the bench phase runs the entry with BENCH_FRAMES timed frames a leg (its
# default is 8; 4 warm-up frames a leg are the entry's own), and checks
# pair_metrics' counts against the plain cull on a batch of this many rays
BENCH_SMOKE_FRAMES = 2
PAIR_CHECK_RAYS = 1 << 17
# P1: FP32 instructions a chain step (2 sub, 4 mul, min, max, 2 add with
# -fmad=false); packed bf16x2 instructions issue at the FP32 instruction
# rate, two elements each: 133.8e12 bf16 FLOP/s outside the tensor cores
# (NVIDIA H100 Tensor Core GPU Architecture white paper, H100 SXM5), an
# FMA counted as two, is 33.45e12 bf16x2 instructions a second
CHAIN_OPS = 10
PEAK_BF16X2_INSTR = 133.8e12 / 2 / 2
# P2: per element and step the add and the min; per element and step
# that extracts the compare and the select
WALK_OPS, EXTRACT_OPS = 2, 2
# P3, FP32 instructions off csrc/sweep_column.cuh with -fmad=false (a
# division as one), by the branch a lane takes (test_closest): every lane
# tested the sign stage (denom 3 mul + 2 add, numerator 3 mul + 2 add +
# 1 sub, |denom| > eps, the two signs: 14); a lane past the signs the
# reciprocal, t's product and the two range compares (4); a lane in range
# the hit point, u and v (3 x 6) and their three compares and add (22); a
# hit the id's rounding (1). The plain version counts the branches on
# this run's data. Per thread and column: merge_closest's candidate
# compares (6), the tile maximum over 2 rays of 4 candidates (8) and the
# warp's 5 maxima, then the stop rule's 3 compares and acc's add (23)
P3_LANE_OPS = {"lanes": 14, "signs": 4, "in_range": 22, "hits": 1}
P3_COLUMN_OPS = 23
PROBE_KERNELS = ("chain_f32", "chain_bf16", "cond_walk", "cond_walk_gated",
                 "sweep_attrib")


def phase_rng():
    """K9 against its plain version (the eager int64 chain, on the card)
    at RNG_LANES lanes: the pool's int32 pixel ids (render._base_pixels,
    repeated a sample) and int64 sample ids, the depth/salt and seed
    words as immediates. Bit for bit, then each timed under CUDA events
    over RNG_REPEATS draws, beside its bytes bound."""
    import torch

    from pathtracer_torch import kernels
    from pathtracer_torch.render import _base_pixels
    from pathtracer_torch.sampling import rng

    dev = torch.device(DEVICE)
    m = HEADLINE_W * HEADLINE_H
    spp = RNG_LANES // m
    pix = _base_pixels(HEADLINE_W, HEADLINE_H, dev).repeat(spp)
    samp = (1000 * spp + torch.arange(spp, dtype=torch.int64, device=dev)
            ).repeat_interleave(m)
    words = (pix, samp, 5 * 12 + rng.SALT_BSDF_UV, 0xFFFFFFFF)

    def plain():
        return rng._to_unit(rng.pcg4d(rng._key(*words)))

    before = kernels.LAUNCHES["pcg4d"]
    out = rng.pcg4d_uniform(*words)
    ref = plain()
    if kernels.LAUNCHES["pcg4d"] != before + 1:
        raise PhaseError("K9: pcg4d_uniform did not launch the kernel")
    if not torch.equal(out, ref):
        raise PhaseError(f"K9: {int((out != ref).sum())} of {out.numel()} "
                         "draws differ from the plain version")

    def per_draw_ms(fn):
        def many():
            for _ in range(RNG_REPEATS):
                fn()
        many()
        torch.cuda.synchronize()
        return timed(many)[1] / RNG_REPEATS

    ms = per_draw_ms(lambda: rng.pcg4d_uniform(*words))
    plain_ms = per_draw_ms(plain)
    moved = sum(t.numel() * t.element_size() for t in (pix, samp, out))
    bound = moved / PEAK_BYTES * 1e3
    res = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
               max_abs_err=float((out - ref).abs().max()))
    log("k9_vs_plain", lanes=RNG_LANES, bytes=moved,
        share_of_bound=bound / ms, card=card_line(), **res)
    return {"pcg4d": res}


def ulps_apart(a, b):
    """|a - b| in units in the last place of float32, elementwise (a
    NaN on both sides is 0 apart)."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    gap = (ordered(a) - ordered(b)).abs()
    return torch.where(torch.isnan(a) & torch.isnan(b), 0, gap)


def rows_apart(a, b, ulps):
    """Rows whose values differ by more than `ulps` ulps of the row's
    largest magnitude (NaN equal to NaN)."""
    import torch

    a2, b2 = (x.reshape(x.shape[0], -1) for x in (a, b))
    scale = torch.maximum(a2.abs(), b2.abs()).amax(dim=1, keepdim=True)
    scale = torch.where(torch.isfinite(scale), scale, 0.0)
    same = (a2 == b2) | (torch.isnan(a2) & torch.isnan(b2))
    near = (a2 - b2).abs() <= ulps * 2.0 ** -23 * scale
    return ~(same | near).all(dim=1)


def phase_shade(scene, cfg, cam):
    """K10 and its resolve against the plain chain on a headline
    wavefront (1920 x 1080 x 4 spp-batched lanes): bounce 0 and the last
    segment of a depth-2 trace_paths. The traversal runs once; both paths
    then get its answers replayed, so each is the integrator alone. The
    traversal calls' parked lanes must be equal, their rays, the radiance
    and the ray count within SHADE_ULPS ulps / exact; each path timed
    under CUDA events (SHADE_REPEATS runs), K10's launches alone beside
    their bytes bound."""
    import torch

    from pathtracer_torch import tracing
    from pathtracer_torch.integrator import path, shade
    from pathtracer_torch.render import (_base_pixels, _primary_rays,
                                         make_intersectors)

    dev = torch.device(DEVICE)
    cfg2 = dataclasses.replace(cfg, max_depth=2)
    m = HEADLINE_W * HEADLINE_H
    pix = _base_pixels(HEADLINE_W, HEADLINE_H, dev).repeat(cfg.spp)
    samp = (4000 + torch.arange(cfg.spp, dtype=torch.int64, device=dev)
            ).repeat_interleave(m)
    o, d = _primary_rays(cfg2, cam.state(device=dev), pix, samp)
    i_fn, o_fn, _ = make_intersectors(scene, cfg2)
    answers = []

    def recorded(fn):
        def call(*a, **kw):
            answers.append(fn(*a, **kw))
            return answers[-1]
        return call

    path.trace_paths(scene, cfg2, o, d, pix, samp, recorded(i_fn),
                     recorded(o_fn), sample_window=cfg.spp)
    hits = answers[0].tri >= 0

    def replay(kernel, launch_ms=None):
        calls, it = [], iter(answers)

        def closest(o_, d_, *a, **kw):
            calls.append((o_, d_, None))
            return next(it)

        def occluded(o_, d_, t_max, **kw):
            calls.append((o_, d_, t_max))
            return next(it)

        plain, launch = shade.kernel_shades, shade.Shader._launch

        def timed_launch(self, p, lib):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(self, p, lib)
            end.record()
            launch_ms.append((start, end))

        try:
            if not kernel:
                shade.kernel_shades = lambda *a, **kw: False
            if launch_ms is not None:
                shade.Shader._launch = timed_launch
            rad, _, rays, _, _ = path.trace_paths(
                scene, cfg2, o, d, pix, samp, closest, occluded,
                sample_window=cfg.spp)
        finally:
            shade.kernel_shades, shade.Shader._launch = plain, launch
        return rad, int(rays), calls

    before = dict(tracing.COUNTERS), tracing.LAUNCHES["shade"]
    rk, nk, ck = replay(True)
    launched = tracing.LAUNCHES["shade"] - before[1]
    kernel_bounces = tracing.COUNTERS["shade_kernel"] \
        - before[0]["shade_kernel"]
    rp, np_, cp = replay(False)
    why = []
    if launched != 2 or kernel_bounces != 2:
        why.append(f"K10 launched {launched} times over {kernel_bounces} "
                   "kernel bounces, want 2 and 2")
    if nk != np_:
        why.append(f"ray count {nk} against the plain chain's {np_}")
    parked_apart = rays_far = 0
    for (ok_, dk, tk), (op, dp, tp) in zip(ck, cp):
        pk, pp = ok_[:, 0] >= 1e29, op[:, 0] >= 1e29
        parked_apart += int((pk != pp).sum())
        live = ~pk & ~pp
        for x, y in ((ok_, op), (dk, dp), (tk, tp)):
            if x is not None:
                rays_far += int(rows_apart(x[live], y[live],
                                           SHADE_ULPS).sum())
    if parked_apart or rays_far:
        why.append(f"traversal inputs: {parked_apart} lanes parked on one "
                   f"side, {rays_far} lanes' rays apart")
    rad_far = int(rows_apart(rk, rp, SHADE_ULPS).sum())
    if rad_far:
        why.append(f"radiance: {rad_far} lanes apart")
    gap = ulps_apart(rk, rp)

    def best_ms(kernel):
        runs = [timed(lambda: replay(kernel))[1]
                for _ in range(SHADE_REPEATS)]
        return min(runs), runs

    kernel_ms, kernel_runs = best_ms(True)
    plain_ms, plain_runs = best_ms(False)
    launch_ms = []
    replay(True, launch_ms)
    torch.cuda.synchronize()
    k10_ms = [s.elapsed_time(e) for s, e in launch_ms]
    n = pix.shape[0]
    n_hit = int(hits.sum())
    tris_hit = int(torch.unique(answers[0].tri[hits]).numel())
    tables = (tris_hit * 4 * path.pack_surface_rows(scene).shape[1]
              + scene.n_materials * 64
              + (0 if scene.tex_comp is None else scene.tex_comp.numel() * 8)
              + scene.light_cdf.numel() * 4 * 18)
    moved = n * (SHADE_LANE_IN + SHADE_LANE_OUT) + tables
    bound = moved / PEAK_BYTES * 1e3
    res = dict(ms=k10_ms[0], plain_ms=None, bound_ms=bound,
               bound_by="bytes",
               max_abs_err=float((rk - rp).abs().max()))
    log("k10_vs_plain", lanes=n, hit_lanes=n_hit, rays=nk,
        bounce0_k10_ms=k10_ms[0], last_segment_k10_ms=k10_ms[1],
        tris_hit=tris_hit, bounce0_bytes=moved, bounce0_table_bytes=tables,
        bounce0_bound_ms=bound, share_of_bound=bound / k10_ms[0],
        kernel_path_ms=kernel_ms, plain_path_ms=plain_ms,
        kernel_path_runs=kernel_runs, plain_path_runs=plain_runs,
        radiance_bits_differ=int((gap > 0).sum()),
        radiance_max_ulps=int(gap.max()), radiance_lanes_apart=rad_far,
        traversal_parked_apart=parked_apart, traversal_rays_apart=rays_far,
        card=card_line())
    if why:
        raise PhaseError("K10: " + "; ".join(why))
    res["plain_ms"] = plain_ms
    return {"shade": res}


def phase_shade_goldens(tmp_dir):
    """Configs 1-5's 64x64 golden gates (bench/configs.accuracy_probe),
    every bounce shaded by K10: the shade_kernel counter rises and
    shade_plain does not."""
    import torch

    from pathtracer_torch import tracing

    failed = []
    for idx, (name, scene_fn, cfg, cam) in enumerate(
            build_configs(1.0, tmp_dir=tmp_dir), start=1):
        t0 = time.perf_counter()
        scene = load_scene(scene_fn, DEVICE)
        before = dict(tracing.COUNTERS)
        rmse, ok = accuracy_probe(scene, cfg, cam, idx, DEVICE)
        torch.cuda.synchronize()
        rise = {k: tracing.COUNTERS[k] - before[k]
                for k in ("shade_kernel", "shade_plain")}
        log("k10_goldens", config=idx, name=name, inlier_rmse=rmse, ok=ok,
            seconds=time.perf_counter() - t0, **rise)
        if not ok or rise["shade_kernel"] == 0 or rise["shade_plain"]:
            failed.append(f"config {idx} (gate {ok}, rmse {rmse}, {rise})")
        del scene
        torch.cuda.empty_cache()
    if failed:
        raise PhaseError("K10 golden gates: " + "; ".join(failed))


def same_bits(a, b):
    import torch

    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(view), b.view(view)))


def phase_probes():
    """P1-P3 through their drivers (bench/bf16_probe, cond_probe,
    sweep_attrib at cpi 1 and 12) with the launch counts set to 0 just
    before and read just after; then each kernel against its plain
    version on the card (not counted): P1 f32 and bf16 and P2 gated and
    ungated bit-exact, P3's full variant hit-exact with t bit-exact and
    the other variants +inf; then P3 against K2 (p3_against_k2)."""
    import torch

    from pathtracer_torch import kernels
    from pathtracer_torch.bench import bf16_probe, cond_probe, sweep_attrib
    from pathtracer_torch.kernels import probes

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    p1 = bf16_probe.run(DEVICE)
    p2 = cond_probe.run(DEVICE)
    p3 = {cpi: sweep_attrib.attribution(DEVICE, cpi=cpi) for cpi in (1, 12)}
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    drive_s = time.perf_counter() - t0
    missing = [k for k in PROBE_KERNELS if launches[k] == 0]
    if missing:
        raise PhaseError(f"probes: the drivers launched no {missing}")
    log("probe_p1", **p1)
    log("probe_p2", **p2)
    for cpi, res in p3.items():
        log("probe_p3_attribution", **res)

    stats = {}
    # P1 at the probe's length (settled) and at 2 steps (input-dependent)
    xf, yf = bf16_probe.probe_inputs(DEVICE)
    n = xf.numel()
    for name, dt in (("chain_f32", torch.float32),
                     ("chain_bf16", torch.bfloat16)):
        x, y = xf.to(dt), yf.to(dt)
        for steps in (2, probes.CHAIN_STEPS):
            got = probes.chain(x, y, steps)
            ref = probes.chain_plain(x, y, steps)
            if not same_bits(got, ref):
                raise PhaseError(f"{name} at {steps} steps differs from its "
                                 "plain version")
        key = name.split("_")[1]
        if dt == torch.float32:
            ops_ms = n * (probes.CHAIN_STEPS * CHAIN_OPS + 1) \
                / PEAK_FP32_INSTR * 1e3
        else:
            ops_ms = n / 2 * (probes.CHAIN_STEPS * CHAIN_OPS + 1) \
                / PEAK_BF16X2_INSTR * 1e3
        bytes_ms = 3 * n * x.element_size() / PEAK_BYTES * 1e3
        stats[name] = dict(ms=p1[f"{key}_ms"], plain_ms=p1[f"plain_{key}_ms"],
                           max_abs_err=0.0, ops_ms=ops_ms, bytes_ms=bytes_ms)
    # P2 at the probe's shape, gated and ungated
    x = cond_probe.probe_input(DEVICE)
    for name, gate in (("cond_walk", False), ("cond_walk_gated", True)):
        ext = torch.zeros((), dtype=torch.int64, device=DEVICE)
        ref = probes.cond_walk_plain(x, cond_probe.N_ITER, gate, ext)
        got = probes.cond_walk(x, cond_probe.N_ITER, gate, cond_probe.GRID)
        if not same_bits(got, ref):
            raise PhaseError(f"{name} differs from its plain version")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        probes.cond_walk_plain(x, cond_probe.N_ITER, gate)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        label = "gated" if gate else "always"
        ops = cond_probe.GRID * x.numel() * (
            cond_probe.N_ITER * WALK_OPS + int(ext) * EXTRACT_OPS)
        stats[name] = dict(ms=p2[f"{label}_ms"], plain_ms=plain_ms,
                           max_abs_err=0.0, extractions=int(ext),
                           ops_ms=ops / PEAK_FP32_INSTR * 1e3,
                           bytes_ms=(x.numel() + 64) * 4 / PEAK_BYTES * 1e3)
    # P3: every variant at cpi 1 and 12 on 2048 tiles
    lm, rays = sweep_attrib.probe_inputs(sweep_attrib.TILES,
                                         device=DEVICE)
    for cpi, n_cols in ((1, 64), (12, 16)):
        st, si = sweep_attrib.schedule(sweep_attrib.TILES, n_cols, cpi,
                                       sweep_attrib.CLUSTERS, DEVICE)
        for v in probes.VARIANTS:
            got = probes.sweep_attrib(st, si, rays, lm, cpi, v)
            ref = probes.sweep_attrib_plain(st, si, rays, lm.transpose(1, 2),
                                            cpi, v)
            ok = (same_bits(got, ref) and bool(torch.isfinite(ref).any())
                  if v == "full" else bool(torch.isinf(got).all())
                  and bool(torch.isinf(ref).all()))
            if not ok:
                raise PhaseError(f"sweep_attrib {v} at cpi {cpi} differs "
                                 "from its plain version")
    for cpi in (1, 12):
        for v in probes.VARIANTS:
            log("probe_p3_kernel", variant=v, cpi=cpi,
                **probes.kernel_info(v, sweep_attrib.R, sweep_attrib.K, cpi))
    k2_us, p3_vs_k2 = p3_against_k2(lm, rays, p3[1]["full"])
    # P3's line: the full variant at cpi 1 and the longer length; its
    # operations are the branches the plain version counts on this data
    cols = p3[1]["cols"][1]
    st, si = sweep_attrib.schedule(sweep_attrib.TILES, cols, 1,
                                   sweep_attrib.CLUSTERS, DEVICE)
    _, plain_ms = timed(lambda: probes.sweep_attrib_plain(
        st, si, rays, lm.transpose(1, 2), 1, "full"))
    counts = {}
    probes.sweep_attrib_plain(st, si, rays, lm.transpose(1, 2), 1, "full",
                              counts=counts)
    ops = (sum(P3_LANE_OPS[k] * counts[k] for k in P3_LANE_OPS)
           + counts["columns"] * sweep_attrib.R * 4 * P3_COLUMN_OPS)
    stats["sweep_attrib"] = dict(
        ms=p3[1]["ms"]["full"][1], plain_ms=plain_ms, max_abs_err=0.0,
        **{f"lane_{k}": v for k, v in counts.items()},
        ops_per_lane=ops / counts["lanes"],
        ops_ms=ops / PEAK_FP32_INSTR * 1e3,
        bytes_ms=(st.numel() * 8 + rays.numel() * 4 + lm.numel() * 4
                  + sweep_attrib.TILES * sweep_attrib.R * 4)
        / PEAK_BYTES * 1e3)
    for name, s in stats.items():
        s["bound_ms"] = max(s["ops_ms"], s["bytes_ms"])
        s["bound_by"] = ("operations" if s["ops_ms"] >= s["bytes_ms"]
                         else "bytes")
        s["launches"] = launches[name]
        log("kernel_vs_plain", kernel=name, **s)
    walk = stats["cond_walk"]
    log("probe_p2_bounds", card=card_line(),
        always_ms=p2["always_ms"], gated_ms=p2["gated_ms"],
        bound_ms={k: stats[k]["bound_ms"] for k in ("cond_walk",
                                                    "cond_walk_gated")},
        # the 64 grid steps on 64 SMs (were a step one CTA) would take
        # at least 132 / 64 of the whole card's bound
        bound_64_sms_ms=walk["bound_ms"] * 132 / 64,
        extractions_gated=stats["cond_walk_gated"]["extractions"],
        sass=p2_sass())
    log("probes", drive_s=drive_s, seconds=time.perf_counter() - t0,
        bf16_speedup=p1["bf16_speedup"],
        gated_over_always=p2["gated_over_always"],
        us_per_col_cpi1=p3[1]["full"], us_per_col_cpi12=p3[12]["full"],
        k2_us_per_col=k2_us, p3_over_k2=p3_vs_k2)
    return stats


def p2_sass():
    """Per P2 kernel (csrc/probes.cu cond_walk_*) the count of each SASS
    instruction the extraction and the walk need - FADD (t = x + i), FMNMX
    (the row's min), FSETP and SEL (the argmin), ISETP and FSEL (the
    one-hot select) - from cuobjdump of the built library, so that a run
    shows the compiler folded neither part away. Raises without
    cuobjdump, or where a kernel lacks the argmin's or the select's
    compares."""
    import re

    from pathtracer_torch.kernels import cuda_build

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if not os.path.exists(tool):
        raise PhaseError(f"P2's SASS check needs {tool}")
    so = cuda_build.build("probes")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, timeout=120).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = None
            for kind in ("cond_walk_kernelILb0", "cond_walk_kernelILb1"):
                if kind in m.group(1):
                    cur = kind.replace("_kernelILb0", "_always").replace(
                        "_kernelILb1", "_gated")
                    counts[cur] = {}
            continue
        m = cur and re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?"
                              r"([A-Z][A-Z0-9]*)", line)
        if m and m.group(1) in ("FADD", "FMNMX", "FSETP", "SEL", "ISETP",
                                "FSEL"):
            c = counts[cur]
            c[m.group(1)] = c.get(m.group(1), 0) + 1
    if len(counts) != 2:
        raise PhaseError(f"P2's SASS holds {sorted(counts)}, not both legs")
    for kind, c in counts.items():
        per = 32   # columns a thread holds
        if c.get("FSETP", 0) < per or c.get("ISETP", 0) < per:
            raise PhaseError(f"P2 {kind}: the SASS lacks the argmin's or "
                             f"the one-hot select's compares ({c})")
    return counts


def p3_against_k2(lm, rays, p3_per_col):
    """K2 (sweep_closest) on P3's synthetic schedule at cpi 1 through
    bench/sweep_attrib.k2_columns (every lane a real triangle, t_cap
    +inf, P3's t_min), beside P3's full variant: K2's t + the column
    count must equal P3's output bit for bit at both of sweep_attrib's
    lengths. K2's cost a (tile, column), dt / dcols, is logged beside
    p3_per_col (P3 full's, from the attribution run) and their ratio:
    P3 stages its columns through its own ring, so the ratio has no
    limit. Returns (K2's us a column, P3 over K2)."""
    import torch

    from pathtracer_torch.bench import sweep_attrib
    from pathtracer_torch.kernels import probes

    tiles = sweep_attrib.TILES
    k2 = sweep_attrib.k2_columns(DEVICE, blocks_lm=lm, rays=rays)
    for n_cols, t in zip(sweep_attrib.COLS, k2["t"]):
        st, si = sweep_attrib.schedule(tiles, n_cols, 1,
                                       sweep_attrib.CLUSTERS, DEVICE)
        p3 = probes.sweep_attrib(st, si, rays, lm, 1, "full")
        if not same_bits(p3[:, 0], t + float(n_cols)):
            raise PhaseError(f"P3's full variant and K2 differ on P3's "
                             f"schedule of {n_cols} columns")
    ratio = p3_per_col / k2["per_col"]
    log("probe_p3_vs_k2", cols=list(sweep_attrib.COLS), tiles=tiles,
        k2_ms=k2["ms"], k2_us_per_col=k2["per_col"],
        p3_us_per_col=p3_per_col, p3_over_k2=ratio, card=card_line())
    return k2["per_col"], ratio


def phase_bench(scene, cfg, cam):
    """python -m pathtracer_torch.bench in this process at the headline
    (BENCH_SMOKE_FRAMES timed frames a leg), launch counts set to 0
    just before and read just after: its JSON line on a log line, a
    finite positive value, pair_metrics without error and with the rate
    K2 ran at in this run (sweep_attrib.k2_columns, recorded as the
    entry calls it, K2 launched there). Then pair_metrics'
    visited/needed counts on a PAIR_CHECK_RAYS bounce-1 batch against
    the plain cull's on the same batch, and K2's time on the entry's
    whole bounce-1 batch beside the model's sweep_model_ms."""
    import math

    import numpy as np
    import torch

    from pathtracer_torch import kernels
    from pathtracer_torch.bench import __main__ as entry
    from pathtracer_torch.bench import pair_metrics, sweep_attrib
    from pathtracer_torch.kernels import cull, sweep

    t0 = time.perf_counter()
    env = dict(os.environ, BENCH_FRAMES=str(BENCH_SMOKE_FRAMES))
    real_k2_columns = sweep_attrib.k2_columns
    k2_rates = []

    def k2_columns(*a, **kw):
        before = kernels.LAUNCHES["sweep_closest"]
        res = real_k2_columns(*a, **kw)
        k2_rates.append((res["per_col"],
                         kernels.LAUNCHES["sweep_closest"] - before))
        return res

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    sweep_attrib.k2_columns = k2_columns
    try:
        rec = entry.run(env)
    finally:
        sweep_attrib.k2_columns = real_k2_columns
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    run_s = time.perf_counter() - t0
    log("bench", line=rec, launches=launches, seconds=run_s,
        k2_rate_runs=k2_rates)
    pm = rec["detail"].get("pair_metrics", {})
    if not (math.isfinite(rec["value"]) and rec["value"] > 0):
        raise PhaseError(f"bench: value {rec['value']}")
    if "error" in pm or not pm:
        raise PhaseError(f"bench: pair_metrics failed: {pm}")
    if pm.get("sweep_us_per_iter") is None:
        raise PhaseError("bench: pair_metrics' rate was not measured on "
                         "the card")
    if not (len(k2_rates) == 1 and k2_rates[0][1] > 0
            and pm["sweep_us_per_iter"] == k2_rates[0][0]):
        raise PhaseError(f"bench: pair_metrics' rate "
                         f"{pm['sweep_us_per_iter']} is not K2's cost a "
                         f"column measured in this run ({k2_rates}: "
                         "us, K2 launches)")
    missing = [k for k in UNPRIMED_KERNELS if launches[k] == 0]
    if missing:
        raise PhaseError(f"bench: the path launched no {missing}")

    # counts on the card against the plain cull on the same batch
    o2, d2 = pair_metrics.bounce1_batch(scene, cfg, cam, PAIR_CHECK_RAYS)
    card = pair_metrics.schedule_stats(scene.clusters, o2, d2)
    real = cull.tile_cull
    cull.tile_cull = cull.tile_cull_plain
    try:
        plain = pair_metrics.schedule_stats(scene.clusters, o2, d2)
    finally:
        cull.tile_cull = real
    same = all(np.array_equal(a, b) for a, b in zip(card, plain))
    log("bench_counts_vs_plain_cull", rays=PAIR_CHECK_RAYS, equal=same,
        visited=int(card[0].sum()), needed=int(card[1].sum()))
    if not same:
        raise PhaseError("bench: pair_metrics' counts differ between K1 "
                         "and the plain cull")

    # K2 on the entry's bounce-1 batch: its measured time beside the model
    o2, d2 = pair_metrics.bounce1_batch(scene, cfg, cam)
    real_k2 = sweep.sweep_closest
    k2_ms = []

    def timed_k2(*a, **kw):
        out, ms = timed(lambda: real_k2(*a, **kw))
        k2_ms.append(ms)
        return out

    sweep.sweep_closest = timed_k2
    try:
        vis = pair_metrics.schedule_stats(scene.clusters, o2, d2)[0]
    finally:
        sweep.sweep_closest = real_k2
    model_ms = float(vis.sum()) * pm["sweep_us_per_iter"] * 1e-3
    log("bench_model_vs_k2", sweep_model_ms=pm["sweep_model_ms"],
        model_ms_here=model_ms, k2_ms=sum(k2_ms), k2_launches=len(k2_ms),
        model_over_k2=model_ms / sum(k2_ms),
        us_per_col=pm["sweep_us_per_iter"],
        visited_cols=int(vis.sum()), seconds=time.perf_counter() - t0)
    return rec, launches


def phase_goldens(tmp_dir, mesh, label):
    """The config 1-5 golden gates, each 64x64 probe frame rendered across
    `mesh` (render_frame_sharded). Returns {config: image}."""
    from pathtracer_torch.parallel import sharding

    failed, images = [], {}
    for idx, (_, scene_fn, cfg, cam) in enumerate(
            build_configs(1.0, tmp_dir=tmp_dir), start=1):
        t0 = time.perf_counter()
        scene = load_scene(scene_fn, DEVICE)
        img = sharding.render_frame_sharded(
            scene, probe_cfg(cfg), cam.state(device=DEVICE), 0, mesh)[0]
        img = images[idx] = img.cpu().numpy()
        res = robust_gate(img, load_golden(idx))
        log(label, config=idx, tris=scene.n_tris,
            seconds=time.perf_counter() - t0, **res)
        if not res["ok"]:
            failed.append(idx)
    if failed:
        raise PhaseError(f"{label} gate failed for configs {failed}")
    return images


# K1-K4 launches logged per config run of the configs phase
CULL_SWEEP_KERNELS = ("tile_cull", "tile_cull_skip", "sweep_closest",
                      "sweep_occluded")
# the module entry itself, once, as a user runs it: config 1 at 64x64
CONFIGS_CLI = ("-m", "pathtracer_torch.bench.configs", "--configs", "1",
               "--scale", "0.25", "--frames", "1", "--no-check")


def hold_chunks(label, scene, cfg, cam, env):
    """One frame of a config at its full size, traced (capture_chunks),
    and its recorded K1-K3 chunks held against their plain versions bit
    for bit; where env sets PT_CULL_SKIP=1 and the clusters gate, K4 on
    the K1 chunks in K1's place, held against its plain version and
    K1's. Returns {kernel: chunks held}. Its launches are not the
    path's: the configs phase reads the counts before."""
    from pathtracer_torch.kernels import cull, packet, sweep

    blk = SKIP_BLKS[0]
    k4 = (env.get("PT_CULL_SKIP", "0") != "0"
          and cull.gated(scene.clusters.n_clusters, blk))
    # the CMP_CHUNKS recorded chunks spread over a primary batch of
    # width x height x spp rays (chunks of CHUNK_TILES 64-ray tiles)
    stride = max(1, cfg.width * cfg.height * cfg.spp
                 // (CMP_CHUNKS * packet.CHUNK_TILES * 64))
    held = dict.fromkeys(CULL_SWEEP_KERNELS, 0)
    for b in capture_chunks(scene, cfg, cam, env=env, stride=stride):
        where = f"{label} {b['label']}"
        for args, kw in b["tile_cull"]:
            k1 = cull.tile_cull_plain(*args, **kw)
            if k4:
                out = cull.tile_cull_skip(*args, **kw, blk=blk)
                exact_vs_plain("tile_cull_skip", where, out,
                               cull.tile_cull_skip_plain(*args, **kw,
                                                         blk=blk))
                exact_vs_plain("tile_cull_skip", where + " vs K1", out, k1)
                held["tile_cull_skip"] += 1
            else:
                exact_vs_plain("tile_cull", where,
                               cull.tile_cull(*args, **kw), k1)
                held["tile_cull"] += 1
        for args, kw in b["sweep_closest"]:
            exact_vs_plain("sweep_closest", where,
                           sweep.sweep_closest(*args, **kw),
                           sweep.sweep_closest_plain(*plain_args(args)))
            held["sweep_closest"] += 1
        for args, kw in b["sweep_occluded"]:
            exact_vs_plain("sweep_occluded", where,
                           sweep.sweep_occluded(*args, **kw),
                           sweep.sweep_occluded_plain(*plain_args(args)))
            held["sweep_occluded"] += 1
    return held


def phase_configs(tmp_dir, frames):
    """The config sweep (bench/configs.py) at BASELINE's sizes: configs
    1-5 through run_config (3 warm-up steps, `frames` timed steps, the
    64x64 golden probe), then config 4 on its scene again under
    PT_CULL_SKIP=1, the launch counts set to 0 just before each run and
    read just after. After each run of configs 2-5, one full-size frame's
    K1-K3 (K4) chunks are held against their plain versions
    (hold_chunks), and config 4's frame 0 under PT_CULL_SKIP=1 against
    its frame 0 on K1, with its ray counts. Then the module entry once in
    a subprocess. Configs 2-5 take the cluster route (K1-K3; K4 in place
    of K1 where PT_CULL_SKIP=1 gates), config 1 (12 triangles) the brute
    route. Returns (the records, config 4's (scene, cfg, camera))."""
    import math

    import torch

    from pathtracer_torch import kernels
    from pathtracer_torch.kernels import cull
    from pathtracer_torch.render import render_frame

    t_phase = time.perf_counter()
    entries = build_configs(1.0, tmp_dir=tmp_dir)
    runs = [(i, entry, {}) for i, entry in enumerate(entries, start=1)]
    runs.append((4, entries[3], {"PT_CULL_SKIP": "1"}))
    records, failed, frame0, scene4 = [], [], {}, None
    for idx, (name, scene_fn, cfg, cam), env in runs:
        t0 = time.perf_counter()
        scene = scene4 if env else load_scene(scene_fn, DEVICE)
        k4_gates = cull.gated(scene.clusters.n_clusters, SKIP_BLKS[0])
        with knob_env(env):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            rec = run_config(idx, name, scene, cfg, cam, frames=frames)
            torch.cuda.synchronize()
            counts = dict(kernels.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            if idx == 4:     # frame 0 of each cull, for the A/B below
                frame0[bool(env)] = (render_frame(
                    scene, cfg, cam.state(device=DEVICE), 0).cpu().numpy(),
                    rec["rays_per_frame"])
        launches = {k: counts[k] for k in CULL_SWEEP_KERNELS}
        held = (hold_chunks(f"config {idx}", scene, cfg, cam, env)
                if idx > 1 else {})
        log("configs", index=idx, env=env, **rec, launches=launches,
            chunks_held=held, clusters=scene.clusters.n_clusters,
            k4_gates=k4_gates, peak_mem_bytes=peak,
            seconds=time.perf_counter() - t0)
        records.append(dict(rec, env=env, launches=launches))
        why = []
        if rec["accuracy_ok"] is not True:
            why.append(f"golden gate {rec['inlier_rmse_vs_golden']}")
        if not (math.isfinite(rec["ms_per_frame"])
                and rec["ms_per_frame"] > 0):
            why.append(f"ms_per_frame {rec['ms_per_frame']}")
        if idx > 1:
            need = ("tile_cull_skip" if env and k4_gates else "tile_cull",
                    "sweep_closest", "sweep_occluded")
            why += [f"launched no {k}" for k in need if launches[k] == 0]
            why += [f"held no {k} chunk" for k in need if held[k] == 0]
        if env and k4_gates and launches["tile_cull"]:
            why.append(f"launched K1 {launches['tile_cull']} times")
        if why:
            failed.append(f"config {idx} {env}: {', '.join(why)}")
        if idx == 4:
            scene4 = scene
        del scene
        torch.cuda.empty_cache()

    (k1_img, k1_rays), (k4_img, k4_rays) = frame0[False], frame0[True]
    gate = robust_gate(k4_img, k1_img)
    log("configs_cull_skip_ab", rays=k4_rays, k1_rays=k1_rays, **gate)
    if not gate["ok"] or k4_rays != k1_rays:
        failed.append(f"config 4 under PT_CULL_SKIP=1 renders otherwise "
                      f"than on K1: {gate}, rays {k4_rays} vs {k1_rays}")

    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, *CONFIGS_CLI], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    lines = cli.stdout.strip().splitlines()
    log("configs_cli", argv=list(CONFIGS_CLI), rc=cli.returncode,
        lines=lines, seconds=time.perf_counter() - t0)
    try:
        line = json.loads(lines[0]) if len(lines) == 1 else {}
    except ValueError:
        line = {}
    if cli.returncode != 0 or line.get("config") != entries[0][0]:
        failed.append(f"the entry exited {cli.returncode} with "
                      f"{lines}: {cli.stderr[-2000:]}")
    log("configs_phase", runs=len(runs),
        seconds=time.perf_counter() - t_phase)
    if failed:
        raise PhaseError("configs: " + "; ".join(failed))
    return records, (scene4,) + entries[3][2:]


def drive(label, scene, cfg, cam, frames, need, env=None, mesh=None):
    """One warm-up step and `frames` timed steps through Renderer (on
    `mesh` when given), with the launch counts set to 0 just before and
    read just after; `env` sets environment variables for the run. A
    step folds cfg.frame_batch frames, so ms per frame is step time /
    frame_batch. Returns (result dict, the Renderer)."""
    import torch

    from pathtracer_torch import kernels
    from pathtracer_torch.render import Renderer

    with knob_env(env):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        r = Renderer(scene, cfg, cam, device=DEVICE, mesh=mesh)
        t0 = time.perf_counter()
        r.step()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        times, rays = [], []
        for _ in range(frames):
            t0 = time.perf_counter()
            r.step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            rays.append(int(r.last_rays))
        counts = dict(kernels.LAUNCHES)
    f = cfg.frame_batch
    img = r.film.accum
    res = dict(mesh=list(mesh.shape) if mesh else None,
               width=cfg.width, height=cfg.height, spp=cfg.spp,
               max_depth=cfg.max_depth, frame_batch=f, tris=scene.n_tris,
               priming=cfg.primary_priming, env=env or {}, warmup_s=warm_s,
               step_ms=[t * 1e3 for t in times],
               ms_per_frame=sum(times) / len(times) / f * 1e3,
               rays_per_step=rays,
               mrays_per_s=sum(rays) / sum(times) / 1e6,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               launches=counts, frames_folded=r.film.frame,
               image_mean=float(img.mean()),
               image_finite=bool(torch.isfinite(img).all()))
    if r._prime is not None:
        res["hinted_pixels"] = [int((r._prime[:, i] >= 0).sum())
                                for i in range(3)]
    log(label, **res)
    if not res["image_finite"] or not res["image_mean"] > 0.0:
        raise PhaseError(f"{label}: image bad: finite={res['image_finite']}"
                         f" mean={res['image_mean']}")
    missing = [k for k in need if counts[k] == 0]
    if missing:
        raise PhaseError(f"{label}: the path launched no {missing}")
    return res, r


def same_render(what, res, r, ref_res, ref_r):
    """The film passes the gate against the reference run's and the ray
    counts are equal step for step."""
    gate = robust_gate(r.film.accum.cpu().numpy(),
                       ref_r.film.accum.cpu().numpy())
    log(what, ms=res["ms_per_frame"], ref_ms=ref_res["ms_per_frame"],
        rays=res["rays_per_step"], ref_rays=ref_res["rays_per_step"],
        **gate)
    if not gate["ok"]:
        raise PhaseError(f"{what}: film differs: {gate}")
    if res["rays_per_step"] != ref_res["rays_per_step"]:
        raise PhaseError(f"{what}: ray counts differ: "
                         f"{res['rays_per_step']} vs "
                         f"{ref_res['rays_per_step']}")


def phase_headline(scene, cfg, cam, frames):
    """K1, then K4 (PT_CULL_SKIP=1), then primed."""
    base, r_b = drive("headline", scene, cfg, cam, frames,
                      UNPRIMED_KERNELS + ("pcg4d",))
    skip, r_s = drive("headline_cull_skip", scene, cfg, cam, frames,
                      SKIP_KERNELS, env={"PT_CULL_SKIP": "1"})
    if skip["launches"]["tile_cull"]:
        raise PhaseError("PT_CULL_SKIP=1 headline launched K1 "
                         f"{skip['launches']['tile_cull']} times")
    same_render("cull_skip_ab", skip, r_s, base, r_b)
    primed, r_p = drive("headline_primed", scene,
                        dataclasses.replace(cfg, primary_priming=True), cam,
                        frames, PRIMED_KERNELS)
    same_render("priming_ab", primed, r_p, base, r_b)
    return base, skip, primed, r_b


# the variants phase: the cluster route's default-off alternatives, each
# held hit for hit to the default route on its first three calls, then a
# headline run (one warm-up and VARIANT_FRAMES timed frames) beside the
# default route's run of the same frames, and config 5's 64x64 golden
# under the same knobs. (label, environment, RenderConfig fields)
VARIANT_FRAMES = 1
VARIANT_RAY_TOL = 1e-5
VARIANTS = [
    ("split_median_morton", {"PT_FINE_METHOD": "median",
                             "PT_COARSE_METHOD": "morton"}, {}),
    ("build_sah", {"PT_FINE_METHOD": "sah", "PT_COARSE_METHOD": "sah"}, {}),
    ("build_sahleaf", {"PT_FINE_METHOD": "sahleaf",
                       "PT_COARSE_METHOD": "sahleaf"}, {}),
    ("build_sahdeep", {"PT_FINE_METHOD": "sahdeep",
                       "PT_COARSE_METHOD": "sahdeep"}, {}),
    ("wavefront_sort", {}, {"wavefront_sort": True}),
    ("tile_rays32", {"PT_TILE_RAYS": "32"}, {}),
    ("tile_rays128", {"PT_TILE_RAYS": "128"}, {}),
    ("tile_rays256", {"PT_TILE_RAYS": "256"}, {}),
    ("skip_nee", {}, {"skip_nee": True}),
]
BUILD_KNOBS = ("PT_FINE_METHOD", "PT_COARSE_METHOD")


def capture_calls(scene, cfg, cam):
    """The whole traversal calls (kind, args, kwargs) of an unprimed
    headline frame's primary, bounce-0 shadow and bounce-1 batches."""
    from pathtracer_torch import render

    real = render.make_intersectors
    calls = []

    def rec(kind, fn):
        def call(*a, **kw):
            if len(calls) < len(BATCH_NAMES):
                calls.append((kind, tuple(x.clone() if hasattr(x, "clone")
                                          else x for x in a), dict(kw)))
            return fn(*a, **kw)
        return call

    def make_intersectors(scene, cfg):
        fi, fo, fh = real(scene, cfg)
        return rec("closest", fi), rec("occluded", fo), fh

    render.make_intersectors = make_intersectors
    try:
        render.render_frame_with_stats(scene, cfg, cam.state(device=DEVICE),
                                       0)
    finally:
        render.make_intersectors = real
    return calls


def replay_calls(scene, cfg, calls, env):
    """The calls through the intersectors of (scene, cfg) under env."""
    from pathtracer_torch import render

    with knob_env(env):
        fi, fo, _ = render.make_intersectors(scene, cfg)
        return [(fi if kind == "closest" else fo)(*a, **kw)
                for kind, a, kw in calls]


def same_hits(label, got, ref):
    """Per batch: the closest hits and occlusion against the default
    route's. A closest hit must have the same t bit for bit, its triangle
    may differ only at an equal t (an exact tie, which the traversal
    order decides). The box tests are conservative in exact arithmetic,
    not under rounding: a ray grazing a box face can lose (or keep) a hit
    on the face in another build, so at most VARIANT_RAY_TOL of a batch
    may hit elsewhere or block otherwise. Returns (ties, rays that
    differ) per batch."""
    import torch

    ties, moved = [], []
    for name, g, r in zip(BATCH_NAMES, got, ref):
        if isinstance(r, torch.Tensor):
            n, bad, tie = r.numel(), int((g != r).sum()), 0
        else:
            n = r.t.numel()
            same = ((g.tri >= 0) == (r.tri >= 0)) & (
                (g.t == r.t) | (r.tri < 0))
            bad = int((~same).sum())
            tie = int((same & (g.tri != r.tri)).sum())
        if bad > VARIANT_RAY_TOL * n:
            raise PhaseError(f"variant {label} {name}: {bad} of {n} rays "
                             "hit or block otherwise than on the default "
                             "route")
        ties.append(tie)
        moved.append(bad)
    return ties, moved


def phase_variants(scene, cfg, cam, tmp_dir):
    """Each of VARIANTS on the headline: ms/frame, Mrays/s, the ratio to
    the default route's run in this phase, build seconds and peak memory.
    A variant fails the phase unless (1) on the default
    route's primary, bounce-0 shadow and bounce-1 calls it finds the
    hits and occlusion of the default route (same_hits: t bit for bit,
    the triangle free only at an exact tie - two triangles at one t,
    which the order of a traversal decides; coplanar overlaps make ties
    common in this scene - and at most VARIANT_RAY_TOL of a batch
    elsewhere, rays grazing a box face), (2) config 5 at 64x64 under it
    passes its golden (skip_nee, another estimator: a finite image), and
    (3) where (1) found every ray as on the default route, its ray count
    is within VARIANT_RAY_TOL of the default route's run and its film
    passes the gate against it (skip_nee: fewer rays and a finite
    display); where a tie or a grazing ray went another way, the paths
    from there differ, and the film and rays are measured beside the
    default's."""
    import numpy as np
    import torch

    from pathtracer_torch.accel.cluster import build_scene_clusters
    from pathtracer_torch.render import render_frame

    t_phase = time.perf_counter()
    calls = capture_calls(scene, cfg, cam)
    ref_hits = replay_calls(scene, cfg, calls, {})
    base, r_b = drive("variant_default", scene, cfg, cam, VARIANT_FRAMES,
                      UNPRIMED_KERNELS)
    base_film = r_b.film.accum.cpu().numpy()
    base_rays = base["rays_per_step"]
    del r_b
    _, g_scene_fn, g_cfg, g_cam = baseline(5)
    g_cfg = probe_cfg(g_cfg)
    golden = load_golden(5)
    g_host = g_scene_fn()
    g_default = build_scene_clusters(g_host).to(DEVICE)
    for label, env, fields in VARIANTS:
        t0 = time.perf_counter()
        build_env = {k: v for k, v in env.items() if k in BUILD_KNOBS}
        vscene, g_scene, build_s = scene, g_default, None
        if build_env:
            with knob_env(build_env):
                vscene = build_scene_clusters(scene)
                build_s = time.perf_counter() - t0
                g_scene = build_scene_clusters(g_host).to(DEVICE)
        vcfg = dataclasses.replace(cfg, **fields)
        ties, moved = same_hits(label, replay_calls(vscene, vcfg, calls,
                                                    env), ref_hits)
        need = ("tile_cull", "sweep_closest")
        if not vcfg.skip_nee:
            need += ("sweep_occluded",)
        res, r = drive("variant_" + label, vscene, vcfg, cam,
                       VARIANT_FRAMES, need, env=env)
        with knob_env(env):
            g_img = render_frame(
                g_scene, dataclasses.replace(g_cfg, **fields),
                g_cam.state(device=DEVICE), 0).cpu().numpy()
        rays = res["rays_per_step"]
        rel = max(abs(a - b) / b for a, b in zip(rays, base_rays))
        film = r.film.accum.cpu().numpy()
        if vcfg.skip_nee:
            shown = r.display()
            ok_film = bool(np.isfinite(shown).all()) and all(
                a < b for a, b in zip(rays, base_rays))
            gate, g_gate = {}, {"ok": bool(np.isfinite(g_img).all())}
        else:
            gate = robust_gate(film, base_film)
            ok_film = (gate["ok"] and rel <= VARIANT_RAY_TOL) or any(
                ties) or any(moved)
            g_gate = robust_gate(g_img, golden)
        cv = dict(variant=label, env=env, fields=fields,
                  ms_per_frame=res["ms_per_frame"],
                  default_ms_per_frame=base["ms_per_frame"],
                  ms_ratio=res["ms_per_frame"] / base["ms_per_frame"],
                  mrays_per_s=res["mrays_per_s"],
                  default_mrays_per_s=base["mrays_per_s"],
                  rays=rays, default_rays=base_rays, rays_rel_diff=rel,
                  ties_by_batch=ties, other_hits_by_batch=moved,
                  replayed_rays=[int(a[0].shape[0]) for _, a, _ in calls],
                  build_s=build_s, peak_mem_bytes=res["peak_mem_bytes"],
                  launches={k: res["launches"][k]
                            for k in UNPRIMED_KERNELS},
                  film_gate=gate, golden_gate=g_gate,
                  clusters=[vscene.clusters.n_clusters,
                            (vscene.clusters_fine or vscene.clusters)
                            .n_clusters],
                  seconds=time.perf_counter() - t0)
        log("variant", **cv)
        if not ok_film or not g_gate["ok"]:
            raise PhaseError(f"variant {label}: film or rays differ from the "
                             f"default route or config 5 fails its golden: "
                             f"{cv}")
        del r, vscene, g_scene
        torch.cuda.empty_cache()
    del calls, ref_hits
    log("variants", count=len(VARIANTS),
        seconds=time.perf_counter() - t_phase)


# the composed CLI scene: the .glb turned a quarter and halved so that
# the file camera ((0, 1, 4) looking at the origin) stands in its hall,
# an OBJ quad with a map_Kd PNG, and an LDR PNG sky
GLB_SPEC = "@-3,-1,5,0.5,90"
ASSET_OBJ = """mtllib floor.mtl
v -1 0 -3
v 1 0 -3
v 1 0 -1
v -1 0 -1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
usemtl checker
f 1/1 2/2 3/3 4/4
"""
ASSET_MTL = "newmtl checker\nKd 1 1 1\nNs 100\nmap_Kd checker.png\n"


# what the .glb must reproduce: geometry and light tables bit for bit,
# material fields per face (the loader numbers materials by first use),
# texels per texture pair
EXACT_FIELDS = ("positions", "normals", "uvs", "tangents", "indices",
                "light_cdf", "light_pdf", "light_v0", "light_emission",
                "tri_light_pdf_area")
FACE_FIELDS = ("mat_albedo", "mat_emission", "mat_roughness",
               "mat_metallic", "mat_ior", "mat_alpha", "mat_type")
TEXTURE_FIELDS = ("mat_albedo_tex", "mat_mr_tex", "mat_normal_tex")


def same_tables(loaded, built):
    """Names of the fields in which the .glb's host tables differ from
    the procedural build's, held as tests/test_export.py holds them."""
    import numpy as np

    fm_l, fm_b = loaded["face_material"], built["face_material"]
    bad = [n for n in EXACT_FIELDS if not np.array_equal(loaded[n],
                                                         built[n])]
    bad += [n for n in FACE_FIELDS
            if not np.array_equal(loaded[n][fm_l], built[n][fm_b])]
    for n in TEXTURE_FIELDS:
        for o, b in set(zip(built[n][fm_b].tolist(),
                            loaded[n][fm_l].tolist())):
            if (o >= 0) != (b >= 0) or o >= 0 and not (
                    np.array_equal(built["tex_wh"][o], loaded["tex_wh"][b])
                    and np.array_equal(built["textures"][o],
                                       loaded["textures"][b])):
                bad.append(n)
                break
    return bad


def run_cli(argv):
    """app.main(argv) with its standard output captured: (return code,
    the output, the JSON step lines, the launch counts, seconds)."""
    import contextlib
    import io

    import torch

    from pathtracer_torch import app, kernels

    buf = io.StringIO()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = app.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out = buf.getvalue()
    steps = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    return rc, out, steps, dict(kernels.LAUNCHES), secs


def phase_assets(scene, cfg, cam, frames, base, r_b, tmp_dir):
    """The headline scene through a .glb: export (the same procedural
    builder phase 4's scene came from), load back, host tables
    and blocks_t against the procedural build, the 1080p headline from
    the file (equal rays, film within the gate of phase 4's), then a
    composed scene through app.main on the card."""
    import numpy as np
    import torch

    from pathtracer_torch.accel.cluster import build_scene_clusters
    from pathtracer_torch.scene.export import export_glb
    from pathtracer_torch.scene.gltf import load_gltf
    from pathtracer_torch.scene.procedural import sponza_like
    from pathtracer_torch.utils import native

    t_phase = time.perf_counter()
    builder = sponza_like(target_tris=HEADLINE_TRIS, textured=True)
    glb = os.path.join(tmp_dir, "headline.glb")
    t0 = time.perf_counter()
    export_glb(builder, glb)
    t1 = time.perf_counter()
    loaded = load_gltf(glb)
    t2 = time.perf_counter()
    tables = loaded.finalize_numpy()
    t3 = time.perf_counter()
    lscene = build_scene_clusters(loaded.finalize(device="cpu"))
    t4 = time.perf_counter()
    built = {n: getattr(scene, n).cpu().numpy() for n in (
        EXACT_FIELDS + FACE_FIELDS + TEXTURE_FIELDS
        + ("face_material", "textures", "tex_wh"))}
    bad = same_tables(tables, built)
    blocks_equal = bool(torch.equal(lscene.clusters.blocks_t,
                                    scene.clusters.blocks_t.cpu()))
    info = dict(glb_bytes=os.path.getsize(glb), export_s=t1 - t0,
                load_s=t2 - t1, finalize_s=t3 - t2, accel_s=t4 - t3,
                tris=lscene.n_tris, clusters=lscene.clusters.n_clusters,
                textures=len(loaded.textures),
                materials=len(loaded.materials), tables_differ=bad,
                blocks_t_equal=blocks_equal)
    log("assets_load", **info)
    if bad or not blocks_equal:
        raise PhaseError(f"assets: the .glb's tables differ from the "
                         f"build's: {bad}, blocks_t equal: {blocks_equal}")
    lscene = lscene.to(DEVICE)
    res, r = drive("assets_glb_headline", lscene, cfg, cam, frames,
                   UNPRIMED_KERNELS)
    same_render("assets_glb_vs_build", res, r, base, r_b)
    del r

    # composed: the .glb under a transform, an OBJ/MTL with a map_Kd PNG
    # and an LDR PNG env map, all files written by the port
    rng = np.random.default_rng(0)
    checker = ((np.indices((32, 32)).sum(0) // 4) % 2 * 180 + 40).astype(
        np.uint8)
    sky = np.concatenate([np.linspace(60, 250, 64)[:, None, None]
                          * np.ones((64, 128, 1)),
                          rng.integers(0, 40, (64, 128, 2))], -1)
    for name, img in (("checker.png", np.stack([checker] * 3, -1)),
                      ("sky.png", sky.astype(np.uint8))):
        with open(os.path.join(tmp_dir, name), "wb") as f:
            f.write(native.png_encode(img))
    for name, text in (("floor.obj", ASSET_OBJ), ("floor.mtl", ASSET_MTL)):
        with open(os.path.join(tmp_dir, name), "w") as f:
            f.write(text)
    argv = ["--scene", glb + GLB_SPEC,
            "--scene", os.path.join(tmp_dir, "floor.obj"),
            "--sky", "envmap", "--envmap", os.path.join(tmp_dir, "sky.png"),
            "--width", "512", "--height", "288", "--spp", "2",
            "--spp-batch", "--frames", "2", "--device", "cuda",
            "--out", os.path.join(tmp_dir, "composed.png")]
    rc, _, steps, counts, secs = run_cli(argv)
    log("assets_cli", argv=argv[:-1], rc=rc, steps=steps, launches=counts,
        seconds=secs)
    if rc != 0 or len(steps) != 2 or not all(
            s["mean_radiance"] > 0 and np.isfinite(s["mean_radiance"])
            for s in steps):
        raise PhaseError(f"assets: composed CLI run failed: rc {rc}, "
                         f"steps {steps}")
    missing = [k for k in UNPRIMED_KERNELS if counts[k] == 0]
    if missing:
        raise PhaseError(f"assets: the composed CLI run launched no "
                         f"{missing}")
    log("assets", **info, glb_ms_per_frame=res["ms_per_frame"],
        glb_mrays_per_s=res["mrays_per_s"],
        build_ms_per_frame=base["ms_per_frame"],
        build_mrays_per_s=base["mrays_per_s"],
        launches={k: res["launches"][k] for k in UNPRIMED_KERNELS},
        cli_steps=steps, seconds=time.perf_counter() - t_phase)
    return res, lscene, glb


def load_image_codecs():
    """tests/image_codecs.py by path (an installed package named `tests`
    shadows the checkout's)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "image_codecs", os.path.join(ROOT, "tests", "image_codecs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def decode_seconds_per_mp(raw, what):
    """Median seconds per megapixel of IMAGE_REPEATS native decodes to
    RGB, and the last decode."""
    import numpy as np

    from pathtracer_torch.utils import native

    times = []
    for _ in range(IMAGE_REPEATS):
        t0 = time.perf_counter()
        img = native.image_rgb(raw, what)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) / (img.shape[0] * img.shape[1] / 1e6), img


def phase_images(cfg, cam, frames, tmp_dir):
    """The port's image decoders beside the card (no PIL needed, and
    nothing falls back to the plain numpy decoder): every committed
    fixture of tests/data/images decoded to RGBA and RGB and held bit
    for bit to the committed PIL arrays; decode seconds per megapixel
    of 8-bit and 16-bit PNG and 4:2:0 baseline and progressive JPEG
    (each checked:
    the PNGs against their source samples, the JPEGs against the sha256
    of PIL's decode); then a .glb whose textures are JPEG and 16-bit PNG
    bytes, loaded (its tables equal to those of the same scene built
    from the decoded arrays directly) and rendered at IMAGE_RENDER^2 and
    the headline's spp on the cluster route (K1-K3), its film and ray
    counts bit for bit the direct scene's."""
    import numpy as np

    from pathtracer_torch.accel.cluster import build_scene_clusters
    from pathtracer_torch.scene.gltf import load_gltf
    from pathtracer_torch.utils import native

    t_phase = time.perf_counter()
    ic = load_image_codecs()
    files, ref = ic.load_fixtures()
    bad = [f"{name}:{ch}" for name, raw in sorted(files.items())
           for k, ch in enumerate((4, 3))
           if not np.array_equal(native.image_decode(raw, name, ch),
                                 ref[name][k])]
    tb_files, tb_ref = ic.load_fixtures("tga_bmp.npz")
    bad += [f"{name}:{ch}" for name, raw in sorted(tb_files.items())
            for k, ch in enumerate((4, 3))
            if not np.array_equal(native.image_decode(raw, name, ch),
                                  tb_ref[name][k])]
    log("images_fixtures", files=len(files) + len(tb_files),
        tga_bmp=len(tb_files), mismatched=bad)
    if bad:
        raise PhaseError(f"images: the native decode differs from PIL's "
                         f"on {bad}")

    rng = np.random.default_rng(0)
    n = IMAGE_BENCH_PX
    y, x = np.mgrid[0:n, 0:n]
    base = np.stack([np.sin(x / 17.0), np.cos(y / 23.0),
                     np.sin((x + y) / 31.0)], -1)
    src8 = np.clip(128 + 100 * base + rng.normal(0, 6, base.shape), 0,
                   255).astype(np.uint8)
    src16 = np.clip(32768 + 30000 * base + rng.normal(0, 1500, base.shape),
                    0, 65535).astype(np.int64)
    with open(os.path.join(ic.DATA_DIR, "bench_sha256.json")) as f:
        digests = json.load(f)
    bench = {"png8_rgb": (native.png_encode(src8), src8),
             "png16_rgb": (ic.png_file(src16, 2, 16), src16 >> 8)}
    bench.update(tga_bmp_bench(ic, src8, rng))
    for name in sorted(k.split(":")[0] for k in digests):
        with open(os.path.join(ic.DATA_DIR, name), "rb") as f:
            bench[name] = (f.read(), digests[f"{name}:RGB"])
    per_mp, wrong = {}, []
    for name, (raw, want) in bench.items():
        per_mp[name], img = decode_seconds_per_mp(raw, name)
        ok = (ic.digest(img) == want if isinstance(want, str)
              else np.array_equal(img, want))
        if not ok:
            wrong.append(name)
    card = card_line()
    log("images_decode", card=card, seconds_per_mp=per_mp,
        megapixels={k: n * n / 1e6 for k in bench},
        file_bytes={k: len(v[0]) for k, v in bench.items()}, wrong=wrong)
    print(f"images decode s/MP on {card}: "
          + ", ".join(f"{k} {v:.6f}" for k, v in per_mp.items()),
          flush=True)
    if wrong:
        raise PhaseError(f"images: wrong decode of {wrong}")

    glb = os.path.join(tmp_dir, "images.glb")
    ic.write_textured_glb(glb, files)
    t0 = time.perf_counter()
    loaded = load_gltf(glb)
    load_s = time.perf_counter() - t0
    with ic.decoded_by_pil(files, ref):
        direct = load_gltf(glb)
    tables, direct_tables = loaded.finalize_numpy(), direct.finalize_numpy()
    differ = [k for k, v in tables.items() if not (
        np.array_equal(v, direct_tables[k]) if isinstance(v, np.ndarray)
        else v == direct_tables[k])]
    if differ:
        raise PhaseError(f"images: the .glb's tables differ from the "
                         f"scene built from the decoded arrays: {differ}")
    icfg = dataclasses.replace(cfg, width=IMAGE_RENDER, height=IMAGE_RENDER)
    runs = []
    for label, builder in (("images_glb", loaded), ("images_direct",
                                                    direct)):
        scene = build_scene_clusters(builder.finalize(device="cpu")).to(
            DEVICE)
        res, r = drive(label, scene, icfg, cam, frames, UNPRIMED_KERNELS)
        runs.append((res, r.film.accum.cpu().numpy()))
        del r, scene
    (res_g, film_g), (res_d, film_d) = runs
    same_film = film_g.tobytes() == film_d.tobytes()
    log("images", textures=list(ic.IMAGE_TEXTURES), load_s=load_s,
        spp=icfg.spp,
        glb_bytes=os.path.getsize(glb), same_film=same_film,
        rays=res_g["rays_per_step"], direct_rays=res_d["rays_per_step"],
        launches={k: res_g["launches"][k] for k in UNPRIMED_KERNELS},
        seconds=time.perf_counter() - t_phase)
    if not same_film or res_g["rays_per_step"] != res_d["rays_per_step"]:
        raise PhaseError("images: the .glb's render differs from the scene "
                         "built from the decoded arrays directly")
    obj_tga_bmp(ic, tb_files, tb_ref, cfg, frames, tmp_dir)


def tga_bmp_bench(ic, src8, rng):
    """name -> (bytes, the RGB decode it must give) of 1024x1024 TGA and
    BMP made by tests/image_codecs.py's writers (no PIL on the card): raw
    24-bit and RLE 32-bit TGA, 24-bit and RLE8 BMP, top-down rows."""
    import numpy as np

    n = src8.shape[0]
    blocky = np.repeat(src8[::4, ::4], 4, 0)[:n].repeat(4, 1)[:, :n]
    alpha = np.full((n, n, 1), 200, np.uint8)
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    idx = np.repeat(np.arange(n) // 4 % 256, n).reshape(n, n).T.astype(
        np.uint8)
    return {
        "tga24_rgb": (ic.tga_file(src8[..., ::-1].reshape(n, -1), 2, 24,
                                  flags=0x20), src8),
        "tga32rle_rgb": (ic.tga_file(np.concatenate(
            [blocky[..., ::-1], alpha], -1).reshape(n, -1), 10, 32,
            flags=0x20), blocky),
        "bmp24_rgb": (ic.bmp_file(src8[..., ::-1].reshape(n, -1), n, n, 24,
                                  top_down=True), src8),
        "bmp_rle8_rgb": (ic.bmp_file(idx, n, n, 8, comp=1, palette=pal,
                                     top_down=True, deltas=False),
                         pal[idx]),
    }


# an OBJ/MTL scene with TGA and BMP textures: a floor (RLE TGA with a
# 16-bit colour map) and a back wall (RLE4 BMP), each a grid of quads so
# that the scene takes the cluster route (more than 256 triangles), and a
# lamp
def tga_bmp_obj(cells=12):
    """The OBJ text of the floor, wall and lamp grids."""
    lines = ["mtllib tb.mtl"]
    n = cells + 1

    def grid(corner, du, dv, mtl, base):
        for j in range(n):
            for i in range(n):
                p = [corner[k] + du[k] * i / cells + dv[k] * j / cells
                     for k in range(3)]
                lines.append("v %.6f %.6f %.6f" % tuple(p))
                lines.append(f"vt {i / cells:.6f} {j / cells:.6f}")
        lines.append(f"usemtl {mtl}")
        for j in range(cells):
            for i in range(cells):
                a = base + j * n + i + 1
                q = (a, a + 1, a + n + 1, a + n)
                lines.append("f " + " ".join(f"{x}/{x}" for x in q))
        return base + n * n

    base = grid((-2, 0, 0), (4, 0, 0), (0, 0, -4), "floor", 0)
    base = grid((-2, 0, -4.01), (4, 0, 0), (0, 3, 0), "wall", base)
    lines += ["v -0.5 2.9 -2.5", "v 0.5 2.9 -2.5", "v 0.5 2.9 -1.5",
              "v -0.5 2.9 -1.5", "vt 0 0", "usemtl lamp",
              "f " + " ".join(f"{base + k}/1" for k in (1, 2, 3, 4))]
    return "\n".join(lines) + "\n"


TGA_BMP_MTL = """newmtl floor
Kd 1 1 1
map_Kd {tga}
newmtl wall
Kd 1 1 1
Ns 10
map_Kd {bmp}
newmtl lamp
Kd 1 1 1
Ke 6 6 5
"""
TGA_BMP_TEXTURES = ("p_cmap16_rle.tga", "rle4.bmp")
TGA_BMP_CAM = ((0.0, 1.4, 2.5), (0.0, 1.0, -3.0))


def obj_tga_bmp(ic, files, ref, cfg, frames, tmp_dir):
    """The OBJ/MTL of TGA_BMP_TEXTURES loaded by the port (its tables
    equal to the same scene built from the committed PIL arrays) and
    rendered at IMAGE_RENDER^2 on the cluster route (K1-K3): film and ray
    counts bit for bit the direct scene's."""
    import numpy as np

    from pathtracer_torch.accel.cluster import build_scene_clusters
    from pathtracer_torch.scene.objload import load_obj

    tga, bmp = TGA_BMP_TEXTURES
    for name in TGA_BMP_TEXTURES:
        with open(os.path.join(tmp_dir, name), "wb") as f:
            f.write(files[name])
    with open(os.path.join(tmp_dir, "tb.mtl"), "w") as f:
        f.write(TGA_BMP_MTL.format(tga=tga, bmp=bmp))
    path = os.path.join(tmp_dir, "tb.obj")
    with open(path, "w") as f:
        f.write(tga_bmp_obj())
    loaded = load_obj(path)
    with ic.decoded_by_pil(files, ref):
        direct = load_obj(path)
    tables, direct_tables = loaded.finalize_numpy(), direct.finalize_numpy()
    differ = [k for k, v in tables.items() if not (
        np.array_equal(v, direct_tables[k]) if isinstance(v, np.ndarray)
        else v == direct_tables[k])]
    if differ or not tables["has_textures"] or len(tables["indices"]) <= 256:
        raise PhaseError(f"images: the TGA/BMP OBJ's tables differ from "
                         f"the scene built from PIL's arrays: {differ}")
    icfg = dataclasses.replace(cfg, width=IMAGE_RENDER, height=IMAGE_RENDER)
    runs = []
    for label, builder in (("images_obj", loaded), ("images_obj_direct",
                                                    direct)):
        scene = build_scene_clusters(builder.finalize(device="cpu")).to(
            DEVICE)
        res, r = drive(label, scene, icfg, camera(TGA_BMP_CAM), frames,
                       UNPRIMED_KERNELS)
        runs.append((res, r.film.accum.cpu().numpy()))
        del r, scene
    (res_o, film_o), (res_d, film_d) = runs
    same = (film_o.tobytes() == film_d.tobytes()
            and res_o["rays_per_step"] == res_d["rays_per_step"])
    log("images_obj", textures=list(TGA_BMP_TEXTURES), same_film=same,
        film_mean=float(film_o.mean()), finite=bool(
            np.isfinite(film_o).all()), rays=res_o["rays_per_step"])
    if not same or not np.isfinite(film_o).all() or film_o.mean() <= 0:
        raise PhaseError("images: the TGA/BMP OBJ renders otherwise than "
                         "the scene built from PIL's arrays")


def phase_viewer(lscene, cfg, glb, tmp_dir):
    """viewer.run_interactive on the .glb headline at 4 spp (auto frame
    batch 8, motion preview 2), stdin piped and stdout captured: three
    steps (the preview of a fresh camera, a single frame, an 8-frame
    batch), a camera move, three more of the same kinds; every display
    finite and in [0, 1], every ANSI body rows - 1 lines, K1-K3 launched.
    Then app.main --orbit --quiet at 256x256 on the .glb: four PNGs and
    no output."""
    import contextlib
    import io

    import numpy as np
    import torch

    from pathtracer_torch import kernels, viewer
    from pathtracer_torch.render import Renderer

    t_phase = time.perf_counter()
    r = Renderer(lscene, cfg, camera(SPONZA_CAM), device=DEVICE,
                 auto_frame_batch=8, motion_preview=2)
    steps, shown = [], []
    step, display = r.step, r.display

    def timed_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film = step()
        torch.cuda.synchronize()
        steps.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                          preview=r._preview is not None, frame=film.frame))
        return film

    def checked_display():
        img = display()
        shown.append(bool(np.isfinite(img).all() and img.min() >= 0.0
                          and img.max() <= 1.0))
        return img

    r.step, r.display = timed_step, checked_display
    rows = 40
    out = io.StringIO()
    rd, wr = os.pipe()
    os.close(wr)
    saved_stdin = sys.stdin
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with os.fdopen(rd) as stdin, contextlib.redirect_stdout(out):
            sys.stdin = stdin
            n = viewer.run_interactive(r, rows=rows, max_frames=3)
            r.camera.process_keyboard("forward", 0.05)
            n += viewer.run_interactive(r, rows=rows, max_frames=3)
    finally:
        sys.stdin = saved_stdin
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    bodies = [fr.split("\x1b[0m\nframe")[0]
              for fr in out.getvalue().split("\x1b[H")[1:]]
    want = [(True, 0), (False, 1), (False, 9)] * 2
    got = [(s["preview"], s["frame"]) for s in steps]
    res = dict(frames=n, steps=got, step_ms=[s["ms"] for s in steps],
               wall_s=wall, displays_ok=shown,
               body_lines=[len(b.split("\n")) for b in bodies],
               launches=counts,
               preview_ms=[s["ms"] for s in steps if s["preview"]],
               single_frame_ms=[s["ms"] for s in steps
                                if not s["preview"] and s["frame"] == 1],
               batched_ms_per_frame=[s["ms"] / 8 for s in steps
                                     if s["frame"] == 9])
    log("viewer", **res)
    if n != 6 or got != want:
        raise PhaseError(f"viewer: steps {got}, want {want}")
    if len(shown) != 6 or not all(shown):
        raise PhaseError(f"viewer: displays bad: {shown}")
    lines = min(rows - 1, cfg.height // 2)   # two pixel rows a line
    if len(bodies) != 6 or any(x != lines for x in res["body_lines"]):
        raise PhaseError(f"viewer: ANSI bodies {res['body_lines']}")
    missing = [k for k in UNPRIMED_KERNELS if counts[k] == 0]
    if missing:
        raise PhaseError(f"viewer: launched no {missing}")
    del r

    orbit_dir = os.path.join(tmp_dir, "orbit")
    rc, text, _, counts, secs = run_cli(
        ["--scene", glb + GLB_SPEC, "--orbit", "--frames", "4", "--quiet",
         "--width", "256", "--height", "256", "--device", "cuda",
         "--out", orbit_dir])
    pngs = sorted(os.listdir(orbit_dir)) if os.path.isdir(orbit_dir) else []
    log("viewer_orbit", rc=rc, output_chars=len(text), pngs=pngs,
        launches=counts, seconds=secs,
        phase_seconds=time.perf_counter() - t_phase)
    if rc != 0 or text or pngs != [f"frame_{i:04d}.png" for i in range(4)]:
        raise PhaseError(f"viewer: --orbit --quiet gave rc {rc}, "
                         f"{len(text)} characters of output, {pngs}")
    return res


def phase_config4(scene, cfg, cam, frames):
    """BASELINE config 4 (1024x1024, 1 spp, frame_batch 8) on the configs
    phase's scene, whose runs drove it on K1 and on K4: primed, and one
    8-frame step against 8 single-frame steps."""
    import torch

    from pathtracer_torch.render import Renderer

    f = cfg.frame_batch
    if (cfg.width, cfg.height, cfg.spp, f) != (1024, 1024, 1, 8):
        raise PhaseError(f"config 4 is not BASELINE's: {cfg}")
    primed, _ = drive("config4_primed", scene,
                      dataclasses.replace(cfg, primary_priming=True), cam,
                      frames, PRIMED_KERNELS)
    if not primed["hinted_pixels"][2] > 0:
        raise PhaseError("config 4 primed: no env-NEE blocker hint")
    # one F-frame step against F single-frame steps: the same samples
    single = Renderer(scene, dataclasses.replace(cfg, frame_batch=1), cam,
                      device=DEVICE)
    rays_single = 0
    t0 = time.perf_counter()
    for _ in range(f):
        single.step()
        rays_single += int(single.last_rays)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    batched = Renderer(scene, cfg, cam, device=DEVICE)
    batched.step()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    gate = robust_gate(batched.film.accum.cpu().numpy(),
                       single.film.accum.cpu().numpy())
    log("config4_batch_vs_single", frames=f, rays_batched=int(
        batched.last_rays), rays_single=rays_single,
        ms_per_frame_single=(t1 - t0) / f * 1e3,
        ms_per_frame_batched=(t2 - t1) / f * 1e3, **gate)
    if not gate["ok"] or int(batched.last_rays) != rays_single:
        raise PhaseError(f"config 4: one {f}-frame step differs from {f} "
                         f"single steps: {gate}, rays "
                         f"{int(batched.last_rays)} vs {rays_single}")
    return primed


def config3_denoise_setup():
    """BASELINE config 3 with the denoiser: (scene, cfg, camera)."""
    _, scene_fn, cfg, cam = baseline(3)
    if (cfg.width, cfg.height, cfg.spp, cfg.frame_batch) != (512, 512, 4, 8):
        raise PhaseError(f"config 3 is not BASELINE's: {cfg}")
    return (load_scene(scene_fn, DEVICE),
            dataclasses.replace(cfg, denoise=True), cam)


def phase_config3():
    """BASELINE config 3 with the denoiser: 512x512, 4 spp, frame_batch
    8; two steps = 64 spp. Returns (result, the denoised display)."""
    import numpy as np
    import torch

    scene, cfg, cam = config3_denoise_setup()
    res, r = drive("config3_denoise", scene, cfg, cam, 1, UNPRIMED_KERNELS)
    r.denoised()                                               # warm-up
    _, dn_ms = timed(r.denoised)
    disp = r.display()
    aovs = r.aovs()
    ok = (bool(np.isfinite(disp).all()) and disp.min() >= 0.0
          and disp.max() <= 1.0 and sorted(aovs) == ["albedo", "depth",
                                                      "normal"]
          and all(a.shape == (cfg.height, cfg.width, 3)
                  and np.isfinite(a).all()
                  for a in aovs.values()))
    log("config3_display", spp_accumulated=r.film.frame * cfg.spp,
        denoise_ms=dn_ms, display_min=float(disp.min()),
        display_max=float(disp.max()), display_mean=float(disp.mean()),
        aovs=sorted(aovs), ok=ok)
    if not ok or r.film.frame != 2 * cfg.frame_batch:
        raise PhaseError("config 3: denoised display or AOVs bad")
    del scene, r
    torch.cuda.empty_cache()
    return res, disp


def config2_setup(**kw):
    """BASELINE config 2's cfg (512x512, 1 spp, frame_batch 8) with kw,
    and its camera."""
    _, _, cfg, cam = baseline(2)
    return dataclasses.replace(cfg, **kw), cam


def bvh_bound_ms(name, args, node_visits, leaf_tests):
    """Least time of one K5/K6 call: (operations ms, bytes ms, visit
    bytes ms). Operations: the node visits and leaf tests this call's
    data needs (the plain version's walk) x SLAB_OPS / LEAF_OPS over
    PEAK_FP32_INSTR. Bytes: each input read once (the node and triangle
    tables, o, d, t_max) and each output written once, over PEAK_BYTES.
    Visit bytes (logged, not the bound): the 32-byte node row and 36-byte
    triangle row every visit reads."""
    packed, o, d, _, tm = args
    nbytes = sum(t.numel() * t.element_size()
                 for t in (packed.nodes, packed.tris, o, d))
    n = o.shape[0]
    nbytes += n * 4 + n * (16 if name == "bvh_closest" else 1)
    ops = node_visits * SLAB_OPS + leaf_tests * LEAF_OPS[name]
    visit_bytes = node_visits * NODE_BYTES + leaf_tests * TRI_BYTES
    return (ops / PEAK_FP32_INSTR * 1e3, nbytes / PEAK_BYTES * 1e3,
            visit_bytes / PEAK_BYTES * 1e3)


def capture_bvh_calls(scene, cfg, cam):
    """Arguments of every K5/K6 call of one Renderer step on the bvh
    route (cfg.frame_batch frames), recorded at the wrappers:
    [(name, (packed, o, d, t_min, t_max))]."""
    import torch

    from pathtracer_torch.kernels import traverse
    from pathtracer_torch.render import Renderer

    real = {"bvh_closest": traverse.intersect_bvh,
            "bvh_occluded": traverse.occluded_bvh}
    calls = []

    def rec(name):
        def call(packed, o, d, *rest):
            if name == "bvh_closest":
                t_min, t_max = rest
            else:
                t_min, (t_max,) = None, rest
            if isinstance(t_max, torch.Tensor):
                t_max = t_max.clone()
            calls.append((name, (packed, o.clone(), d.clone(), t_min,
                                 t_max)))
            return real[name](packed, o, d, *rest)
        return call

    traverse.intersect_bvh = rec("bvh_closest")
    traverse.occluded_bvh = rec("bvh_occluded")
    try:
        Renderer(scene, cfg, cam, device=DEVICE).step()
    finally:
        traverse.intersect_bvh = real["bvh_closest"]
        traverse.occluded_bvh = real["bvh_occluded"]
    return calls


def phase_lbvh():
    """Config 2's scene and its LBVH on the card (bit for bit the CPU
    build), then K5/K6 against their plain versions on one bvh-route
    step's calls. Returns (scene with bvh on the card, the CPU scene with
    its bvh, stats per kernel)."""
    import torch

    from pathtracer_torch.accel import lbvh
    from pathtracer_torch.kernels import traverse

    t0 = time.perf_counter()
    cpu_scene = baseline(2)[1]()
    scene = cpu_scene.to(DEVICE)
    t1 = time.perf_counter()
    v = scene.tri_vertices(torch.arange(scene.n_tris, device=DEVICE))
    lbvh.build_lbvh(*v)                                      # warm-up
    build_ms = []
    for _ in range(3):
        bvh, ms = timed(lambda: lbvh.build_lbvh(*v))
        build_ms.append(ms)
    t2 = time.perf_counter()
    cpu_bvh = lbvh.build_lbvh(*cpu_scene.tri_vertices(
        torch.arange(cpu_scene.n_tris)))
    cpu_s = time.perf_counter() - t2
    fields = ("aabb_min", "aabb_max", "hit_link", "miss_link", "tri_id")
    diff = [f for f in fields
            if not torch.equal(getattr(bvh, f).cpu(), getattr(cpu_bvh, f))]
    log("lbvh_build", tris=scene.n_tris, nodes=int(bvh.tri_id.numel()),
        scene_s=t1 - t0, build_ms=build_ms, cpu_build_s=cpu_s,
        bit_exact=not diff)
    if diff:
        raise PhaseError(f"LBVH on the card differs from the CPU build in "
                         f"{diff}")
    scene = scene.with_bvh(bvh)
    cpu_scene = cpu_scene.with_bvh(cpu_bvh)
    cfg, cam = config2_setup(intersector="bvh")
    calls = capture_bvh_calls(scene, cfg, cam)
    stats = {k: {"ms": [], "plain_ms": [], "ops_ms": [], "bytes_ms": [],
                 "visit_bytes_ms": [], "bound_ms": [], "node_visits": [],
                 "leaf_tests": [], "calls": 0, "max_abs_err": 0.0}
             for k in BVH_KERNELS}
    for i, (name, args) in enumerate(calls):
        packed, o, d, t_min, t_max = args
        if name == "bvh_closest":
            def kernel():
                return traverse.intersect_bvh(packed, o, d, t_min, t_max)
        else:
            def kernel():
                return traverse.occluded_bvh(packed, o, d, t_max)
        kernel()                                             # warm-up
        out, ms = timed(kernel)
        visits = torch.zeros((), dtype=torch.int64, device=DEVICE)
        leaves = torch.zeros((), dtype=torch.int64, device=DEVICE)
        if name == "bvh_closest":
            ref, ms_p = timed(lambda: traverse.intersect_bvh_plain(
                packed, o, d, t_min, t_max, node_visits=visits,
                leaf_tests=leaves))
            for x, y, nm in zip(out, ref, ("t", "tri", "u", "v")):
                if not torch.equal(x, y):
                    raise PhaseError(f"K5 call {i}: {nm} differs on "
                                     f"{int((x != y).sum())} rays")
            hits = int((out.tri >= 0).sum())
        else:
            ref, ms_p = timed(lambda: traverse.occluded_bvh_plain(
                packed, o, d, t_max, node_visits=visits, leaf_tests=leaves))
            if not torch.equal(out, ref):
                raise PhaseError(f"K6 call {i}: blocked differs on "
                                 f"{int((out != ref).sum())} rays")
            hits = int(out.sum())
        ops_ms, bytes_ms, visit_ms = bvh_bound_ms(name, args, int(visits),
                                                  int(leaves))
        s = stats[name]
        for k, x in (("ms", ms), ("plain_ms", ms_p), ("ops_ms", ops_ms),
                     ("bytes_ms", bytes_ms), ("visit_bytes_ms", visit_ms),
                     ("bound_ms", max(ops_ms, bytes_ms)),
                     ("node_visits", int(visits)),
                     ("leaf_tests", int(leaves))):
            s[k].append(x)
        s["calls"] += 1
        live = int((o[:, 0] < 1e29).sum())
        # a parked ray (origin 1e30) visits the root only
        log("bvh_call", kernel=name, call=i, rays=o.shape[0], live=live,
            hits=hits, node_visits=int(visits), leaf_tests=int(leaves),
            visits_per_live_ray=(int(visits) - (o.shape[0] - live))
            / max(live, 1), ms=ms,
            plain_ms=ms_p, ops_ms=ops_ms, bytes_ms=bytes_ms,
            visit_bytes_ms=visit_ms)
    for name, s in stats.items():
        if not s["calls"]:
            raise PhaseError(f"{name}: never called on the bvh route")
        n = s["calls"]
        mean = {k: sum(s[k]) / n for k in ("ms", "plain_ms", "ops_ms",
                                            "bytes_ms", "visit_bytes_ms",
                                            "bound_ms", "node_visits",
                                            "leaf_tests")}
        s.update(mean, bound_by=("operations" if mean["ops_ms"]
                                 >= mean["bytes_ms"] else "bytes"),
                 calls_per_frame=n / cfg.frame_batch)
        log("kernel_vs_plain", kernel=name, calls=n, max_abs_err=0.0,
            bound_by=s["bound_by"], calls_per_frame=s["calls_per_frame"],
            **mean)
    return scene, cpu_scene, stats


def phase_config2(scene, frames):
    """BASELINE config 2 on the bvh route against the cluster route, and
    config 2's 64x64 golden gate on the bvh route."""
    import torch

    from pathtracer_torch.accel.cluster import build_scene_clusters
    from pathtracer_torch.render import render_frame

    cfg, cam = config2_setup(intersector="bvh")
    bvh, r_b = drive("config2_bvh", scene, cfg, cam, frames, BVH_KERNELS)
    stray = {k: bvh["launches"][k] for k in CLUSTER_KERNELS
             if bvh["launches"][k]}
    if stray:
        raise PhaseError(f"config 2 on the bvh route launched {stray}")
    t0 = time.perf_counter()
    scene_cl = build_scene_clusters(dataclasses.replace(
        scene.to("cpu"), bvh=None)).to(DEVICE)
    log("config2_clusters", clusters=scene_cl.clusters.n_clusters,
        seconds=time.perf_counter() - t0)
    cl, r_c = drive("config2_cluster", scene_cl,
                    dataclasses.replace(cfg, intersector="cluster"), cam,
                    frames, UNPRIMED_KERNELS)
    gate = robust_gate(r_b.film.accum.cpu().numpy(),
                       r_c.film.accum.cpu().numpy())
    log("config2_bvh_vs_cluster", ms_bvh=bvh["ms_per_frame"],
        ms_cluster=cl["ms_per_frame"], mrays_bvh=bvh["mrays_per_s"],
        mrays_cluster=cl["mrays_per_s"], rays_bvh=bvh["rays_per_step"],
        rays_cluster=cl["rays_per_step"], **gate)
    if not gate["ok"]:
        raise PhaseError(f"config 2: bvh film differs from cluster: {gate}")
    del scene_cl, r_c
    img = render_frame(scene, probe_cfg(cfg), cam.state(device=DEVICE), 0)
    res = robust_gate(img.cpu().numpy(), load_golden(2))
    log("golden", config=2, route="bvh", tris=scene.n_tris, **res)
    if not res["ok"]:
        raise PhaseError(f"config 2 golden gate failed on the bvh route: "
                         f"{res}")
    torch.cuda.empty_cache()
    return bvh


def finite_gate(img, ref):
    """robust_gate on the pixels finite in both; a pixel finite in only
    one counts as flipped (the Hosek formula overflows for directions
    with cos(theta) in about (-0.0123, -0.0100), in both packages)."""
    import numpy as np

    fin_i = np.isfinite(img).all(-1)
    fin_r = np.isfinite(ref).all(-1)
    both = fin_i & fin_r
    res = robust_gate(img[both], ref[both])
    res["flip_frac"] = float((res["flip_frac"] * both.sum()
                              + (fin_i != fin_r).sum()) / both.size)
    res["nonfinite"] = [int((~fin_i).sum()), int((~fin_r).sum())]
    res["ok"] = (res["inlier_rmse"] <= RMSE_TOL
                 and res["flip_frac"] <= OUTLIER_TOL
                 and res["mean_rel"] <= MEAN_TOL)
    return res


def quirks_golden_gate(img, golden):
    """The reference_quirks golden gate (also tests/test_torch_estimators.
    py's): RMSE <= 1e-4 (the JAX test's bound, tests/test_golden.py:
    47-63) over the pixels whose paths made the same decisions, and at
    most 0.5% of pixels apart by more than 1e-2 (NEE visibility decided
    on an ulp by the quirk shadow ray, raygen.rgen:199-204)."""
    import numpy as np

    d = np.abs(img - golden).max(-1)
    flip = d > 1e-2
    rmse_all = float(np.sqrt(np.mean((img - golden) ** 2)))
    rmse = float(np.sqrt(np.mean((img[~flip] - golden[~flip]) ** 2)))
    return dict(rmse_all=rmse_all, rmse_same_paths=rmse,
                flip_frac=float(flip.mean()),
                ok=rmse <= 1e-4 and float(flip.mean()) <= 0.005)


def phase_estimators(cpu_scene2, frames):
    """Sobol on the card vs the CPU; config 3 sobol vs pcg; the config-1
    quirks golden; Hosek on config 2's scene, card vs CPU."""
    import numpy as np
    import torch

    from pathtracer_torch.config import RenderConfig
    from pathtracer_torch.render import render_frame
    from pathtracer_torch.sampling import rng

    g = np.random.default_rng(0)
    pix = torch.from_numpy(g.integers(0, 1 << 22, SOBOL_LANES))
    samp = torch.from_numpy(g.integers(0, 1 << 32, SOBOL_LANES))
    samp[:4] = torch.tensor([0, (1 << 31) - 1, 1 << 31, (1 << 32) - 1])
    for depth, salt in ((0, rng.SALT_JITTER), (5, rng.SALT_BSDF_UV)):
        cpu = rng.uniform4(pix, samp, depth, salt, 3, sampler="sobol")
        gpu = rng.uniform4(pix.to(DEVICE), samp.to(DEVICE), depth, salt, 3,
                           sampler="sobol")
        same = torch.equal(gpu.cpu(), cpu)
        log("sobol_draws", lanes=SOBOL_LANES, depth=depth, salt=salt,
            samples_at_or_above_2_31=int((samp >= 1 << 31).sum()),
            bit_exact=same)
        if not same:
            raise PhaseError("Sobol draws on the card differ from the CPU")

    _, scene_fn3, cfg3, cam3 = baseline(3)
    scene3 = load_scene(scene_fn3, DEVICE)
    runs = {}
    for sampler in ("pcg", "sobol", "sobol", "pcg"):
        res, _ = drive(f"config3_{sampler}", scene3,
                       dataclasses.replace(cfg3, sampler=sampler), cam3,
                       frames, UNPRIMED_KERNELS)
        runs.setdefault(sampler, []).append(res["ms_per_frame"])
    log("config3_sobol_vs_pcg", ms_sobol=runs["sobol"], ms_pcg=runs["pcg"])
    del scene3

    # BASELINE config 1 (256x256, 4 spp) with the reference's quirks
    _, scene_fn1, cfg1, cam1 = baseline(1)
    scene1 = load_scene(scene_fn1, DEVICE)
    cfg1 = dataclasses.replace(cfg1, reference_quirks=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render_frame(scene1, cfg1, cam1.state(device=DEVICE),
                       0).cpu().numpy()
    golden = np.load(os.path.join(ROOT, "tests",
                                  "golden_cornell_quirks_256.npy"))
    res = quirks_golden_gate(img, golden)
    log("quirks_golden", config=1, size=cfg1.width,
        seconds=time.perf_counter() - t0, **res)
    if not res["ok"]:
        raise PhaseError(f"config 1 quirks golden failed: {res}")

    cfg_h = RenderConfig(width=64, height=64, spp=4, max_depth=6,
                         spp_batch=True, intersector="bvh", sky="hosek")
    cam = baseline(2)[3]
    t0 = time.perf_counter()
    card = render_frame(cpu_scene2.to(DEVICE), cfg_h,
                        cam.state(device=DEVICE), 0).cpu().numpy()
    t1 = time.perf_counter()
    cpu = render_frame(cpu_scene2, cfg_h, cam.state(device="cpu"),
                       0).numpy()
    res = finite_gate(card, cpu)
    log("hosek_card_vs_cpu", tris=cpu_scene2.n_tris, card_s=t1 - t0,
        cpu_s=time.perf_counter() - t1, **res)
    if not res["ok"]:
        raise PhaseError(f"Hosek render on the card differs from the CPU: "
                         f"{res}")
    return runs


class CollectiveLog:
    """Times sharding.all_reduce (one call a step: every buffer of a
    contribution) with CUDA events and counts the bytes it reduces."""

    def __enter__(self):
        from pathtracer_torch.parallel import sharding

        self.ms, self.bytes, self.real = [], [], sharding.all_reduce

        def all_reduce(c, group=None):
            self.bytes.append(sum(t.numel() * t.element_size()
                                  for t, _ in c.buffers()))
            out, ms = timed(lambda: self.real(c, group))
            self.ms.append(ms)
            return out

        sharding.all_reduce = all_reduce
        return self

    def __exit__(self, *exc):
        from pathtracer_torch.parallel import sharding

        sharding.all_reduce = self.real

    def summary(self):
        return dict(all_reduce_ms=self.ms, all_reduce_bytes=self.bytes)


def rays_match(what, rays, ref_rays):
    """Ray counts step for step: any difference is logged, and one above
    1e-5 relative fails."""
    rel = max(abs(a - b) / max(b, 1) for a, b in zip(rays, ref_rays))
    if rays != ref_rays:
        log("ray_count_difference", run=what, rays=rays, ref_rays=ref_rays,
            max_rel=rel)
    if rel > 1e-5 or len(rays) != len(ref_rays):
        raise PhaseError(f"{what}: ray counts {rays} vs {ref_rays}")


def film_checksum(a):
    import hashlib

    return hashlib.sha256(a.tobytes()).hexdigest()


def sharded_headline_nccl(scene, cfg, cam, frames, ref, ref_film, tmp_dir):
    """(a) The headline through Renderer(mesh=...) over NCCL at world size
    1 in this process: the film within the gate of the single-device
    headline's, the ray counts equal."""
    import torch
    import torch.distributed as dist

    from pathtracer_torch.parallel import sharding

    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_dir}/nccl",
                            world_size=1, rank=0)
    try:
        mesh = sharding.make_mesh()
        with CollectiveLog() as coll:
            res, r = drive("sharded_headline_nccl", scene, cfg, cam, frames,
                           UNPRIMED_KERNELS, mesh=mesh)
        gate = robust_gate(r.film.accum.cpu().numpy(), ref_film)
    finally:
        dist.destroy_process_group()
    log("sharded_nccl", backend="nccl", world=1, mesh=list(mesh.shape),
        ms_per_frame=res["ms_per_frame"],
        single_device_ms_per_frame=ref["ms_per_frame"],
        rays=res["rays_per_step"], ref_rays=ref["rays_per_step"],
        peak_mem_bytes=res["peak_mem_bytes"],
        seconds=time.perf_counter() - t0, **coll.summary(), **gate)
    if not gate["ok"]:
        raise PhaseError(f"sharded headline (NCCL) differs: {gate}")
    rays_match("sharded headline (NCCL)", res["rays_per_step"],
               ref["rays_per_step"])
    return res


def _sharded_rank(rank, world, store, out_dir, frames):
    """One gloo rank of the sharded phase, on cuda:0 beside the others:
    the collectives' check, the headline on mesh (1, world) unprimed and
    primed, goldens 1-5 and config 3 with the denoiser on mesh (world,
    1). Writes its results to out_dir/rank<r>.json (rank 0 also its
    images as .npy); raises on any failed check, so the rank exits
    non-zero."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pathtracer_torch.parallel import sharding

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    out, seconds, t0 = {"rank": rank}, {}, time.perf_counter()

    def save(name, a):
        out[name + "_sha256"] = film_checksum(a)
        if rank == 0:
            np.save(os.path.join(out_dir, name + ".npy"), a)

    try:
        # the reductions the path makes, on CUDA tensors through gloo
        f = torch.full((3,), rank + 1.0, device=DEVICE)
        n = torch.tensor([(1 << 40) + rank], dtype=torch.int64,
                         device=DEVICE)
        h = torch.tensor([rank, -1, 7 * rank], dtype=torch.int32,
                         device=DEVICE)
        dist.all_reduce(f)
        dist.all_reduce(n)
        dist.all_reduce(h, op=dist.ReduceOp.MAX)
        top = world - 1
        ok = (f.tolist() == [world * (world + 1) / 2] * 3
              and n.tolist() == [world * (1 << 40) + world * top // 2]
              and h.tolist() == [top, -1, 7 * top])
        log("gloo_cuda_collectives", rank=rank, sum_f32=f.tolist(),
            sum_i64=n.tolist(), max_i32=h.tolist(), ok=ok)
        if not ok:
            raise PhaseError("gloo all_reduce on CUDA tensors is wrong")
        seconds["collectives"] = time.perf_counter() - t0

        t1 = time.perf_counter()
        scene, cfg, cam = headline_setup()
        tile_mesh = sharding.make_mesh(world, 1)
        sample_mesh = sharding.make_mesh(1, world)
        for label, c, need in (
                ("headline", cfg, UNPRIMED_KERNELS),
                ("headline_primed",
                 dataclasses.replace(cfg, primary_priming=True),
                 PRIMED_KERNELS)):
            with CollectiveLog() as coll:
                res, r = drive(f"sharded_{label}_rank{rank}", scene, c, cam,
                               frames, need, mesh=sample_mesh)
            out[label] = dict(res, **coll.summary())
            save(label, r.film.accum.cpu().numpy())
            del r
        del scene
        torch.cuda.empty_cache()
        seconds["headline"] = time.perf_counter() - t1

        t1 = time.perf_counter()
        rank_dir = os.path.join(out_dir, f"rank{rank}")
        os.makedirs(rank_dir, exist_ok=True)
        for idx, img in phase_goldens(rank_dir, tile_mesh,
                                      f"sharded_golden_rank{rank}").items():
            save(f"golden{idx}", img)
        seconds["goldens"] = time.perf_counter() - t1

        t1 = time.perf_counter()
        scene3, cfg3, cam3 = config3_denoise_setup()
        with CollectiveLog() as coll:
            res, r = drive(f"sharded_config3_denoise_rank{rank}", scene3,
                           cfg3, cam3, 1, UNPRIMED_KERNELS,
                           mesh=tile_mesh)
        disp = r.display()
        out["config3"] = dict(res, **coll.summary(),
                              display_finite=bool(np.isfinite(disp).all()),
                              display_min=float(disp.min()),
                              display_max=float(disp.max()))
        save("config3_display", disp)
        seconds["config3"] = time.perf_counter() - t1
        out["seconds"] = seconds
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()


def sharded_gloo_ranks(frames, tmp_dir, ref, ref_film, ref_display):
    """(b) SHARD_RANKS gloo ranks on cuda:0, spawned, each with its own
    scenes: the headline (unprimed and primed) on mesh (1, ranks),
    goldens 1-5 and config 3 with the denoiser on mesh (ranks, 1). Every
    rank must exit 0 within SHARD_TIMEOUT_S; the parent holds the ranks'
    films to one another (checksums) and to the single-device runs."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    out_dir = os.path.join(tmp_dir, "sharded")
    os.makedirs(out_dir)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        _sharded_rank, args=(SHARD_RANKS, os.path.join(out_dir, "store"),
                             out_dir, frames),
        nprocs=SHARD_RANKS, join=False, start_method="spawn")
    deadline = t0 + SHARD_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.perf_counter())):
            if time.perf_counter() > deadline:
                raise PhaseError(f"sharded ranks still running after "
                                 f"{SHARD_TIMEOUT_S} s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        raise PhaseError(f"sharded rank {e.error_index} failed: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks_s = time.perf_counter() - t0
    ranks = []
    for r in range(SHARD_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    files = {k[:-len("_sha256")] for k in ranks[0] if k.endswith("_sha256")}
    images = {k: np.load(os.path.join(out_dir, k + ".npy")) for k in files}
    for k, a in images.items():
        sums = {res[k + "_sha256"] for res in ranks} | {film_checksum(a)}
        if len(sums) != 1:
            raise PhaseError(f"sharded ranks hold different {k}")
    for res in ranks:
        for label, need in (("headline", UNPRIMED_KERNELS),
                            ("headline_primed", PRIMED_KERNELS),
                            ("config3", UNPRIMED_KERNELS)):
            missing = [k for k in need if not res[label]["launches"][k]]
            if missing:
                raise PhaseError(f"rank {res['rank']} {label}: launched no "
                                 f"{missing}")
        if not min(res["headline_primed"]["hinted_pixels"][:2]) > 0:
            raise PhaseError(f"rank {res['rank']}: no hints recorded")
    r0 = ranks[0]
    checks = {
        "headline_vs_single_device": robust_gate(images["headline"],
                                                 ref_film),
        "primed_vs_single_device": robust_gate(images["headline_primed"],
                                               ref_film),
        "primed_vs_unprimed": robust_gate(images["headline_primed"],
                                          images["headline"]),
        "config3_display_vs_single_device": robust_gate(
            images["config3_display"], ref_display)}
    disp = images["config3_display"]
    display_ok = bool(np.isfinite(disp).all() and 0.0 <= disp.min()
                      and disp.max() <= 1.0)
    log("sharded_gloo", backend="gloo", ranks=SHARD_RANKS, device="cuda:0",
        shared_card=True, seconds=ranks_s,
        rank_seconds=[res["seconds"] for res in ranks],
        checksums_agree=True, display_ok=display_ok,
        **{k: v for k, v in checks.items()})
    for label in ("headline", "headline_primed", "config3"):
        log("sharded_gloo_run", run=label, mesh=r0[label]["mesh"],
            ms_per_frame=[res[label]["ms_per_frame"] for res in ranks],
            step_ms=[res[label]["step_ms"] for res in ranks],
            all_reduce_ms=[res[label]["all_reduce_ms"] for res in ranks],
            all_reduce_bytes=r0[label]["all_reduce_bytes"],
            peak_mem_bytes=[res[label]["peak_mem_bytes"] for res in ranks],
            rays_per_step=r0[label]["rays_per_step"],
            launches=[res[label]["launches"] for res in ranks],
            hinted_pixels=r0[label].get("hinted_pixels"))
    bad = [k for k, v in checks.items() if not v["ok"]]
    if bad or not display_ok:
        raise PhaseError(f"sharded gloo ranks: {bad} outside the gate "
                         f"(display ok: {display_ok})")
    rays_match("sharded headline (gloo)", r0["headline"]["rays_per_step"],
               ref["rays_per_step"])
    rays_match("sharded primed headline (gloo)",
               r0["headline_primed"]["rays_per_step"],
               r0["headline"]["rays_per_step"])
    return ranks


def phase_sharded(scene, cfg, cam, frames, tmp_dir, ref, ref_film,
                  ref_display):
    """Multi-device rendering on the one card: (a) NCCL at world size 1,
    (b) SHARD_RANKS gloo ranks sharing cuda:0. Two ranks on one card
    share its SMs: their times measure correctness, not scaling."""
    t0 = time.perf_counter()
    nccl = sharded_headline_nccl(scene, cfg, cam, frames, ref, ref_film,
                                 tmp_dir)
    t1 = time.perf_counter()
    ranks = sharded_gloo_ranks(frames, tmp_dir, ref, ref_film, ref_display)
    log("sharded", nccl_s=t1 - t0, gloo_s=time.perf_counter() - t1)
    return nccl, ranks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=2,
                    help="timed frames after one warm-up frame, per run")
    ap.add_argument("--only", choices=("shade", "kernels"),
                    help="run the device phase and these phases alone: "
                         "shade = K10 against the plain chain and the "
                         "config 1-5 golden gates through K10; kernels = "
                         "K1-K4 against their plain versions on the "
                         "headline's chunks at every tile width")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(dir=ROOT) as tmp_dir:
            phase_device()
            scene, cfg, cam = headline_setup()
            if args.only == "shade":
                shade_stats = phase_shade(scene, cfg, cam)
                phase_shade_goldens(tmp_dir)
                log("done", seconds=time.perf_counter() - t_start)
                print(json.dumps({"shade": shade_stats["shade"]}),
                      flush=True)
                return 0
            if args.only == "kernels":
                phase_kernels(scene, cfg, cam)
                log("done", seconds=time.perf_counter() - t_start)
                return 0
            stats = phase_kernels(scene, cfg, cam)
            stats.update(phase_rng())
            stats.update(phase_shade(scene, cfg, cam))
            phase_shade_goldens(tmp_dir)
            stats.update(phase_probes())
            _, config4 = phase_configs(tmp_dir, args.frames)
            base, skip, primed, r_b = phase_headline(scene, cfg, cam,
                                                     args.frames)
            phase_variants(scene, cfg, cam, tmp_dir)
            phase_bench(scene, cfg, cam)
            glb_res, lscene, glb = phase_assets(scene, cfg, cam,
                                                args.frames, base, r_b,
                                                tmp_dir)
            phase_viewer(lscene, cfg, glb, tmp_dir)
            phase_images(cfg, cam, args.frames, tmp_dir)
            ref_film = r_b.film.accum.cpu().numpy()
            del lscene, r_b
            phase_config4(*config4, args.frames)
            del config4
            _, ref_display = phase_config3()
            scene2, cpu_scene2, bvh_stats = phase_lbvh()
            stats.update(bvh_stats)
            config2 = phase_config2(scene2, args.frames)
            del scene2
            phase_estimators(cpu_scene2, args.frames)
            phase_sharded(scene, cfg, cam, args.frames, tmp_dir, base,
                          ref_film, ref_display)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kern = []
    runs = {"sweep_occluded_blocker": primed, "tile_cull_skip": skip,
            "bvh_closest": config2, "bvh_occluded": config2}
    for name, (src, replaces) in KERNELS.items():
        s = stats[name]
        if name in PROBE_KERNELS:      # on the probe drivers' path
            launches = s["launches"]
        else:
            launches = runs.get(name, glb_res)["launches"][name]
        kern.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                     "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                     "bound_by": s["bound_by"], "library_ms": None})
    log("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kern}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
