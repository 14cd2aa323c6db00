"""Headline benchmark of the port (counterpart of bench.py).

    python -m pathtracer_torch.bench

Textured sponza_like (~262k triangles) at 1920x1080, 4 spp, depth 6,
spp-batched, on one card (BASELINE.json config 5), with an untextured
companion leg whose windows interleave with it. Prints ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "detail"}; vs_baseline is the
ratio to BASELINE.json's north-star target of 300 Mrays/s a chip.

bench.py's environment variables, with its defaults: BENCH_WIDTH,
BENCH_HEIGHT, BENCH_TRIS, BENCH_FRAMES (8), BENCH_SPP (4),
BENCH_TEXTURED (1), BENCH_SCENE (a .glb/.gltf/.obj path, or "export" to
round-trip the headline through a .glb), BENCH_PRIMING (0),
BENCH_SAMPLER (pcg), BENCH_SPP_BATCH (1), BENCH_FRAME_BATCH (1),
BENCH_UNTEXTURED_REF (1), BENCH_PAIR_METRICS (1). It runs on the card
and raises without one; PT_PLATFORM=cpu runs it on the CPU (the kernels'
plain versions: tiny sizes only). Unlike bench.py's, a failure of the
pair metrics on the card raises instead of landing in the detail.

As bench.py attaches run_configs.py's file, the detail carries the
config sweep as `configs_sweep` when bench_out/configs_latest.json (the
file `python -m pathtracer_torch.bench.configs --out
bench_out/configs_latest.json` writes, see bench/configs.py) is there,
was written on a card and names this tree's sources (harness.source_hash);
a card's file from other sources goes in as `configs_sweep_stale`, and a
file written on the CPU is left out. Left
out against bench.py, because it is a TPU figure:
vs_design_ceiling_18mrays (a v5e ceiling).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

from pathtracer_torch.accel.cluster import build_scene_clusters
from pathtracer_torch.bench.harness import (bench_device, bench_interleaved,
                                           bench_scene, device_record,
                                           source_hash)
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.integrator.camera import Camera
from pathtracer_torch.scene.procedural import sponza_like

# Mrays/s a chip: the north-star TARGET of BASELINE.json, not a
# measurement of anything
NORTH_STAR_MRAYS = 300.0
# the config sweep's results file (bench/configs.py --out), in the checkout
CONFIGS_SWEEP = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "bench_out",
    "configs_latest.json")


def configs_sweep():
    """(key, the config sweep's results file) if there is one and a card
    wrote it: key "configs_sweep" when the file names this tree's
    source_hash, else "configs_sweep_stale"; None for no file or a file
    written on the CPU (bench.py:158-167 attaches its file whatever
    wrote it, and whenever)."""
    try:
        with open(CONFIGS_SWEEP) as f:
            sweep = json.load(f)
    except (OSError, ValueError):
        return None
    if sweep.get("device", {}).get("platform") != "gpu":
        return None
    if sweep.get("source") != source_hash():
        return "configs_sweep_stale", sweep
    return "configs_sweep", sweep


def _scene(env, tris, textured, device):
    scene_file = env.get("BENCH_SCENE")
    if scene_file == "export":
        from pathtracer_torch.scene.export import export_glb
        from pathtracer_torch.scene.gltf import load_gltf

        path = os.path.join(tempfile.gettempdir(),
                            f"bench_sponza_{tris}_{int(textured)}.glb")
        if not os.path.exists(path):
            export_glb(sponza_like(target_tris=tris, textured=textured),
                       path)
        builder = load_gltf(path)
    elif scene_file:
        from pathtracer_torch.app import load_scene

        builder = load_scene([scene_file])
    else:
        builder = sponza_like(target_tris=tris, textured=textured)
    scene = builder.finalize(device="cpu")
    return build_scene_clusters(scene).to(device)


def run(env=os.environ):
    """The bench's record (the dict main prints)."""
    device = bench_device(env)
    width = int(env.get("BENCH_WIDTH", 1920))
    height = int(env.get("BENCH_HEIGHT", 1080))
    tris = int(env.get("BENCH_TRIS", 262_000))
    frames = int(env.get("BENCH_FRAMES", 8))
    # 4 spp a frame: the reference's per-frame workload
    spp = int(env.get("BENCH_SPP", 4))
    textured = env.get("BENCH_TEXTURED", "1") != "0"

    scene = _scene(env, tris, textured, device)
    cfg = RenderConfig(width=width, height=height, spp=spp, max_depth=6,
                       intersector="cluster",
                       sampler=env.get("BENCH_SAMPLER", "pcg"),
                       primary_priming=env.get("BENCH_PRIMING", "0") != "0",
                       spp_batch=env.get("BENCH_SPP_BATCH", "1") != "0",
                       frame_batch=int(env.get("BENCH_FRAME_BATCH", "1")))
    cam = Camera(position=(3.0, 4.5, 6.0))
    cam.look_at((14.0, 3.0, 6.0))

    untex_ref = textured and env.get("BENCH_UNTEXTURED_REF", "1") != "0"
    detail = {
        "tris": tris,
        "textured": textured,
        "resolution": [width, height],
        "spp": cfg.spp,
        "max_depth": cfg.max_depth,
        "device": device_record(device),
    }
    if untex_ref:
        # the untextured companion, its windows interleaved with the
        # textured leg's so that both see the same conditions
        plain = sponza_like(target_tris=tris, textured=False)
        plain = build_scene_clusters(plain.finalize(device="cpu")).to(device)
        both = bench_interleaved({"tex": scene, "untex": plain}, cfg, cam,
                                 warmup=4, frames=frames)
        result, ref = both["tex"], both["untex"]
        detail["untextured_mrays_per_sec"] = round(ref.mrays_per_sec, 3)
        detail["untextured_ms_per_frame"] = round(ref.ms_per_frame, 3)
        # texture fetches add work: an untextured leg slower than the
        # textured one means the run is internally inconsistent
        if ref.ms_per_frame > result.ms_per_frame * 1.05:
            detail["anomaly"] = "untextured_slower_than_textured"
            print("BENCH ANOMALY: untextured leg slower than textured "
                  f"({ref.ms_per_frame:.0f} vs {result.ms_per_frame:.0f} "
                  "ms/frame) - run is suspect", file=sys.stderr)
    else:
        result = bench_scene(scene, cfg, cam, warmup=4, frames=frames)
    detail["ms_per_frame"] = round(result.ms_per_frame, 3)
    detail["rays_per_frame"] = result.rays_per_frame
    detail["window_ms"] = [round(w, 1) for w in result.window_ms]
    detail["ms_std"] = round(result.ms_std, 1)

    if env.get("BENCH_PAIR_METRICS", "1") != "0":
        try:
            from pathtracer_torch.bench.pair_metrics import \
                bounce1_pair_metrics

            detail["pair_metrics"] = bounce1_pair_metrics(scene, cfg, cam)
        except Exception as e:
            # metrics never kill a CPU run; on the card a kernel that
            # fails to build or launch (K2 measures the rate) must
            if device.type == "cuda":
                raise
            detail["pair_metrics"] = {"error": repr(e)}

    sweep = configs_sweep()
    if sweep is not None:
        detail[sweep[0]] = sweep[1]

    return {
        "metric": "sponza_1080p_mrays_per_sec_per_chip",
        "value": round(result.mrays_per_sec, 3),
        "unit": "Mrays/s",
        "vs_baseline": round(result.mrays_per_sec / NORTH_STAR_MRAYS, 4),
        "detail": detail,
    }


def main():
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
