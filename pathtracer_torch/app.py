"""Command-line driver (counterpart of pathtracer/app.py).

    python -m pathtracer_torch.app --scene sponza --textured --width 1920 \
        --height 1080 --spp 4 --out sponza.png
    python -m pathtracer_torch.app --scene bunny --sky envmap \
        --envmap sky.hdr --env-nee --priming --spp 1 --frame-batch auto \
        --out bunny.png
    python -m pathtracer_torch.app --scene materials --denoise --aov \
        --tonemap aces --checkpoint film.npz --out m.png
    python -m pathtracer_torch.app --scene bunny --intersector bvh \
        --sampler sobol --sky hosek --spp 1 --frame-batch auto --out b.png
    python -m pathtracer_torch.app --scene cornell --width 32 --height 32 \
        --device cpu --out c.png

Renders progressively on --device (default cuda; it is an error when no
CUDA device is present - the CPU runs only on --device cpu) and writes
one JSON line per step (ms, Mrays/s, mean radiance) and a PNG. The JAX
CLI's scene files, --mesh, --orbit and the interactive viewer are not
ported yet (ROADMAP.md Queue 1, items 7-9).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from pathtracer_torch.config import RenderConfig, saturating_frame_batch
from pathtracer_torch.film import film as film_mod
from pathtracer_torch.integrator.camera import Camera
from pathtracer_torch.render import Renderer
from pathtracer_torch.scene import procedural
from pathtracer_torch.scene.hdr import read_hdr

_CAMERAS = {
    "cornell": ((0.5, 0.5, 2.2), (0.5, 0.5, 0.0)),
    "materials": ((0.5, 0.5, 2.2), (0.5, 0.5, 0.0)),
    "bunny": ((0.0, 2.0, 5.0), (0.0, 1.0, 0.0)),
    "sponza": ((3.0, 4.5, 6.0), (14.0, 3.0, 6.0)),
}


def build_scene(name: str, tris: int, textured: bool):
    if name == "cornell":
        return procedural.cornell_box()
    if name == "materials":
        return procedural.cornell_box(materials_suite=True)
    if name == "bunny":
        return procedural.bunny_like()
    return procedural.sponza_like(target_tris=tris, textured=textured)


def default_camera(name: str) -> Camera:
    pos, tgt = _CAMERAS[name]
    cam = Camera(position=pos)
    cam.look_at(tgt)
    return cam


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--scene", default="cornell",
                    choices=["cornell", "materials", "bunny", "sponza"])
    ap.add_argument("--tris", type=int, default=262_000,
                    help="sponza target triangle count")
    ap.add_argument("--textured", action="store_true",
                    help="sponza with the procedural texture set")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--max-depth", type=int, default=6)
    ap.add_argument("--frames", type=int, default=8,
                    help="progressive frames; with --frame-batch F (or "
                         "auto) rounded up to whole F-frame steps")
    ap.add_argument("--frame-batch", default="1", metavar="F",
                    help="fold F frames' samples into one wavefront per "
                         "step (same sample set); 'auto' grows the pool "
                         "toward the saturation point, at most 8")
    ap.add_argument("--sky", default="gradient",
                    choices=["gradient", "black", "hosek", "envmap"],
                    help="hosek = Hosek-Wilkie sky (turbidity 3, albedo 1)")
    ap.add_argument("--envmap", default=None, metavar="PATH",
                    help="equirect Radiance .hdr environment - required "
                         "with --sky envmap")
    ap.add_argument("--env-nee", action="store_true",
                    help="importance-sample the env map with MIS (one "
                         "extra shadow ray per bounce)")
    ap.add_argument("--env-cell", type=int, default=8, metavar="N",
                    help="pixels in an NxN screen cell share one env "
                         "direction per (sample, depth); 1 = per pixel")
    ap.add_argument("--env-rr", type=float, default=0.0, metavar="M",
                    help="Russian roulette on env shadow rays with "
                         "q = clip(M*lum(throughput), 1/8, 1); 0 = off")
    ap.add_argument("--priming", action="store_true",
                    help="verified priming: per-pixel primary-hit and "
                         "bounce-0 shadow-blocker hints chained across "
                         "samples and frames (exact)")
    ap.add_argument("--aperture", type=float, default=0.0,
                    help="thin-lens depth of field: lens diameter in world "
                         "units (0 = pinhole)")
    ap.add_argument("--focus-dist", type=float, default=0.0,
                    help="focal-plane distance along the view axis "
                         "(required with --aperture)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sampler", default="pcg", choices=["pcg", "sobol"],
                    help="pcg = independent uniforms (reference class); "
                         "sobol = Owen-scrambled Sobol (lower variance)")
    ap.add_argument("--intersector", default="cluster",
                    choices=["cluster", "bvh", "brute"],
                    help="cluster = packet traversal (K1-K4); bvh = the "
                         "threaded LBVH walk (K5/K6); brute = every ray "
                         "against every triangle")
    ap.add_argument("--denoise", action="store_true",
                    help="edge-aware a-trous denoiser at display time "
                         "(the film stays raw)")
    ap.add_argument("--clamp", type=float, default=0.0, metavar="C",
                    help="firefly clamp: bound each path sample's radiance "
                         "at C (biased; 0 = off)")
    ap.add_argument("--tonemap", default="gamma",
                    choices=["gamma", "reinhard", "aces"])
    ap.add_argument("--aov", action="store_true",
                    help="also write <out>_normal/_depth/_albedo.png")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="film checkpoint (.npz) to resume from if it "
                         "exists, written at the end")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default="out.png")
    args, unknown = ap.parse_known_args(argv)
    if unknown:
        ap.error(f"not ported to pathtracer_torch yet: {' '.join(unknown)} "
                 "(ROADMAP.md Queue 1, item 8 lists the full CLI)")
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(torch.cuda.is_available() is False); pass "
                         "--device cpu to render on the CPU")
    if args.sky == "envmap" and not args.envmap:
        raise SystemExit("--sky envmap requires --envmap PATH "
                         "(a zero envmap would render black)")

    builder = build_scene(args.scene, args.tris, args.textured)
    if args.envmap:
        if not args.envmap.lower().endswith(".hdr"):
            raise SystemExit("--envmap: only Radiance .hdr files are "
                             "ported (ROADMAP.md Queue 1, item 9)")
        builder.set_envmap(read_hdr(args.envmap))
    frame_batch = (saturating_frame_batch(args.width, args.height, args.spp)
                   if args.frame_batch == "auto" else int(args.frame_batch))
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.max_depth,
                       spp_batch=args.spp <= 4 or frame_batch > 1,
                       frame_batch=frame_batch, sky=args.sky,
                       env_importance_sampling=args.env_nee,
                       env_nee_cell=args.env_cell,
                       env_shadow_rr=args.env_rr,
                       primary_priming=args.priming,
                       aperture=args.aperture, focus_dist=args.focus_dist,
                       seed=args.seed, sampler=args.sampler,
                       intersector=args.intersector,
                       denoise=args.denoise,
                       clamp_radiance=args.clamp, tonemap=args.tonemap,
                       capture_gbuffer=args.aov)
    r = Renderer(builder.finalize(device="cpu"), cfg,
                 default_camera(args.scene), device=args.device)
    if args.checkpoint and os.path.exists(args.checkpoint):
        r.film = film_mod.load_checkpoint(args.checkpoint, device=r.device)
        r.camera.moved = False
        print(f"resumed at frame {r.film.frame}")
    for _ in range(max(1, -(-args.frames // frame_batch))):
        t0 = time.perf_counter()
        film = r.step()
        mean = float(film.accum.mean())          # syncs the device
        dt = time.perf_counter() - t0
        print(json.dumps({
            "frame": film.frame, "ms": round(dt * 1e3, 2),
            "mrays_per_sec": round(int(r.last_rays) / dt / 1e6, 3),
            "spp_accumulated": film.frame * cfg.spp,
            "mean_radiance": round(mean, 5), "device": str(r.device)}))
    r.save_png(args.out)
    print(f"wrote {args.out}")
    if args.aov:
        stem = os.path.splitext(args.out)[0]
        for name, img in r.aovs().items():
            film_mod.write_png(f"{stem}_{name}.png", img)
            print(f"wrote {stem}_{name}.png")
    if args.checkpoint:
        film_mod.save_checkpoint(args.checkpoint, r.film)
    return 0


if __name__ == "__main__":
    sys.exit(main())
