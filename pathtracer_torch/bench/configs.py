"""The five BASELINE configs, benched (counterpart of benchmarks/run_configs.py).

  1. Cornell box 256x256 @ 4 spp        (golden-image config)
  2. bunny-class mesh (~81k tris) 512^2 (1 spp, frame-batched)
  3. materials suite 512^2 @ 4 spp      (GGX metal + dielectric + MIS)
  4. env-map + textured scene 1024^2    (HDR importance sampling)
  5. Sponza-class (~262k tris) 1080p    (untextured, 1 spp)

    python -m pathtracer_torch.bench.configs [--scale 0.25] [--frames 2]
        [--configs 1,3] [--no-check] [--out bench_out/configs_latest.json]

prints one JSON line a config with run_configs.py's keys, plus the
frame batch and the device. Each config is timed through the harness
(bench_scene: 3 warm-up steps, then --frames steps) and, unless
--no-check, rendered once more at 64x64 and 4 spp, frame 0, and gated
against the committed tests/goldens/config_<i>_64.npz (robust_gate).
The entry never writes a golden: those are the JAX package's reference.
The exit code is 0 whatever the gate says, as run_configs.py's is;
chip_smoke.py holds the gate. It runs on the card and raises without
one; PT_PLATFORM=cpu runs it on the CPU (the kernels' plain versions:
tiny --scale only). PT_CFG_SPP_BATCH=0 and PT_CFG_FB=0 turn off the
spp batching and the frame batching as in run_configs.py; knobs the
port reads per call (PT_CULL_SKIP=1: K4 in place of K1) reach every
config unchanged.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import sys

import numpy as np

from pathtracer_torch.accel.cluster import build_scene_clusters
from pathtracer_torch.bench.harness import (bench_device, bench_scene,
                                           device_record, source_hash)
from pathtracer_torch.config import RenderConfig, saturating_frame_batch
from pathtracer_torch.integrator.camera import Camera
from pathtracer_torch.render import render_frame
from pathtracer_torch.scene import procedural
from pathtracer_torch.scene.build import MaterialDesc
from pathtracer_torch.scene.hdr import read_hdr, write_hdr

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "goldens")
PROBE_RES = 64          # fixed accuracy-probe resolution (every config)
PROBE_SPP = 4
RMSE_TOL = 5e-3         # inlier same-seed cross-platform float budget
OUTLIER_TOL = 0.02      # fraction of pixels allowed to flip a winner
MEAN_TOL = 1e-3         # relative mean-radiance agreement

# (position, target) of each config's camera
BOX_CAM = ((0.5, 0.5, 2.2), (0.5, 0.5, 0.0))
BUNNY_CAM = ((0.0, 2.0, 5.0), (0.0, 1.2, 0.0))
ENV_CAM = ((0.0, 2.5, 5.5), (0.0, 1.2, 0.0))
SPONZA_CAM = ((3.0, 4.5, 6.0), (14.0, 3.0, 6.0))


def camera(spec):
    c = Camera(position=spec[0])
    c.look_at(spec[1])
    return c


def envmap_scene(tmp_dir):
    """Config 4's scene: bunny_like(5) with a 256^2 checker on the body
    and a 512x1024 sky with a hot sun disc, written to tmp_dir as a
    Radiance .hdr and read back through the RGBE codec (the goldens saw
    the quantised map)."""
    b = procedural.bunny_like(subdivisions=5)
    tex = np.indices((256, 256)).sum(axis=0) % 2
    tex = (np.stack([tex] * 3, -1) * 0.6 + 0.2).astype(np.float32)
    tid = b.add_texture(tex)
    b.materials[1] = MaterialDesc(albedo=(1, 1, 1), albedo_tex=tid,
                                  roughness=0.4)
    eh, ew = 512, 1024
    theta = np.linspace(0, np.pi, eh)[:, None]
    env = np.zeros((eh, ew, 3), np.float32)
    horizon = np.clip(np.sin(theta), 0, 1) ** 3
    env[..., 0] = 0.25 + 0.5 * horizon
    env[..., 1] = 0.35 + 0.45 * horizon
    env[..., 2] = 0.6 + 0.25 * horizon
    env[60:76, 220:236] = 800.0  # sun disc
    path = os.path.join(tmp_dir, "bench_env.hdr")
    write_hdr(path, env)
    b.set_envmap(read_hdr(path))
    return b.finalize(device="cpu")


def build_configs(scale, env=os.environ, tmp_dir=None):
    """[(name, scene_fn, cfg, camera)] of configs 1-5, in order.

    Resolutions scale by `scale` (multiples of 8, at least 16). Every
    config but config 1 (the brute route, where batching loses) is
    spp-batched unless PT_CFG_SPP_BATCH=0, and frame-batched toward the
    pool-saturation point (saturating_frame_batch) unless PT_CFG_FB is
    set to anything but "auto". scene_fn() returns the finalized host
    scene; config 4's writes its .hdr sky under tmp_dir (default
    $TMPDIR, else /tmp).
    """
    spp_batch = env.get("PT_CFG_SPP_BATCH", "1") != "0"
    fb_auto = env.get("PT_CFG_FB", "auto") == "auto"
    tmp_dir = tmp_dir or env.get("TMPDIR", "/tmp")

    def r(x):
        return max(16, int(x * scale) // 8 * 8)

    def cfg(**kw):
        c = RenderConfig(**dict(dict(max_depth=6, spp_batch=spp_batch),
                                **kw))
        if not (fb_auto and c.spp_batch):
            return c
        return dataclasses.replace(c, frame_batch=saturating_frame_batch(
            c.width, c.height, c.spp))

    return [
        ("cornell_256_4spp",
         lambda: procedural.cornell_box().finalize(device="cpu"),
         cfg(width=r(256), height=r(256), spp=4, spp_batch=False),
         camera(BOX_CAM)),
        ("bunny_512_lbvh",
         lambda: procedural.bunny_like().finalize(device="cpu"),
         cfg(width=r(512), height=r(512), spp=1),
         camera(BUNNY_CAM)),
        ("materials_512_64spp",       # 64 spp = 16 frames x 4
         lambda: procedural.cornell_box(
             materials_suite=True).finalize(device="cpu"),
         cfg(width=r(512), height=r(512), spp=4),
         camera(BOX_CAM)),
        ("envmap_textured_1024",
         lambda: envmap_scene(tmp_dir),
         cfg(width=r(1024), height=r(1024), spp=1, sky="envmap",
             env_importance_sampling=True, emission_gain=1.0),
         camera(ENV_CAM)),
        ("sponza_1080p",
         lambda: procedural.sponza_like().finalize(device="cpu"),
         cfg(width=r(1920), height=r(1080), spp=1),
         camera(SPONZA_CAM)),
    ]


def probe_cfg(cfg):
    """The accuracy probe's cfg: the config at 64x64 and 4 spp (its
    frame_batch kept; render_frame renders one frame either way)."""
    return dataclasses.replace(cfg, width=PROBE_RES, height=PROBE_RES,
                               spp=PROBE_SPP)


def load_golden(idx):
    """tests/goldens/config_<idx>_64.npz's image, or None."""
    path = os.path.join(GOLDEN_DIR, f"config_{idx}_{PROBE_RES}.npz")
    if not os.path.exists(path):
        return None
    return np.load(path)["img"]


def robust_gate(img, golden):
    """img against golden ([..., C] arrays): inlier RMSE (|diff| at or
    below its 98th percentile) <= RMSE_TOL, winner-flip pixels (|diff|
    > 0.01) <= OUTLIER_TOL and relative mean shift <= MEAN_TOL.

    Same-seed renders differ only by float arithmetic, which flips
    nearest-hit winners at silhouettes: real drift moves all pixels
    (inlier RMSE, mean) or many (flips)."""
    img, golden = np.asarray(img), np.asarray(golden)
    d = img - golden
    ad = np.abs(d).max(-1)
    inl = ad <= np.percentile(ad, 98.0)
    rmse = float(np.sqrt(np.mean(d[inl] ** 2)))
    flips = float((ad > 0.01).mean())
    mean_rel = abs(float(img.mean()) - float(golden.mean())) / max(
        abs(float(golden.mean())), 1e-6)
    ok = rmse <= RMSE_TOL and flips <= OUTLIER_TOL and mean_rel <= MEAN_TOL
    return dict(inlier_rmse=rmse, flip_frac=flips, mean_rel=mean_rel, ok=ok)


def accuracy_probe(scene, cfg, camera, idx, device):
    """Config idx's 64x64 / 4 spp frame 0 against its golden:
    (inlier_rmse | None, ok); a missing golden gives (None, False)."""
    img = render_frame(scene, probe_cfg(cfg), camera.state(device=device), 0)
    golden = load_golden(idx)
    if golden is None:
        return None, False
    gate = robust_gate(img.cpu().numpy().astype(np.float32), golden)
    return gate["inlier_rmse"], gate["ok"]


def load_scene(scene_fn, device):
    """The config's scene with its cluster accel, on `device`."""
    return build_scene_clusters(scene_fn()).to(device)


def run_config(idx, name, scene, cfg, camera, frames=4, check=True):
    """Bench config idx on its built scene: run_configs.py's record, with
    frame_batch and device."""
    res = bench_scene(scene, cfg, camera, warmup=3, frames=frames)
    out = {
        "config": name,
        "mrays_per_sec": round(res.mrays_per_sec, 3),
        "ms_per_frame": round(res.ms_per_frame, 3),
        "rays_per_frame": res.rays_per_frame,
        "tris": int(scene.n_tris),
        "resolution": [cfg.width, cfg.height],
        "spp": cfg.spp,
        "frame_batch": cfg.frame_batch,
        "device": device_record(scene.device),
    }
    if check:
        rmse, ok = accuracy_probe(scene, cfg, camera, idx, scene.device)
        out["inlier_rmse_vs_golden"] = (None if rmse is None
                                        else round(rmse, 6))
        out["accuracy_ok"] = ok
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_torch.bench.configs",
        description="Bench the five BASELINE configs; one JSON line each.")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the 64x64 accuracy probe per config")
    ap.add_argument("--out", default=None, metavar="JSON",
                    help="also write the results as one JSON file "
                         "(python -m pathtracer_torch.bench attaches "
                         "bench_out/configs_latest.json from a card)")
    args = ap.parse_args(argv)

    device = bench_device(os.environ)
    wanted = {int(x) for x in args.configs.split(",")}
    results = []
    for i, (name, scene_fn, cfg, cam) in enumerate(
            build_configs(args.scale), start=1):
        if i not in wanted:
            continue
        out = run_config(i, name, load_scene(scene_fn, device), cfg, cam,
                         frames=args.frames, check=not args.no_check)
        print(json.dumps(out), flush=True)
        results.append(out)
    if args.out and results:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"date": datetime.date.today().isoformat(),
                       "scale": args.scale, "frames": args.frames,
                       "device": device_record(device),
                       "source": source_hash(),
                       "configs": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
