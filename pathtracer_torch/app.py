"""Command-line driver (counterpart of pathtracer/app.py).

    python -m pathtracer_torch.app --scene sponza --textured --width 1920 \
        --height 1080 --spp 4 --out sponza.png
    python -m pathtracer_torch.app --scene bunny --sky envmap \
        --envmap sky.hdr --env-nee --priming --spp 1 --out bunny.png
    python -m pathtracer_torch.app --scene cornell --width 32 --height 32 \
        --device cpu --out c.png

Renders progressively on --device (default cuda; it is an error when no
CUDA device is present - the CPU runs only on --device cpu) and writes
one JSON line per frame (ms, Mrays/s, mean radiance) and a PNG. The JAX
CLI's other flags (denoiser, meshes, viewer, ...) are not ported yet:
see ROADMAP.md Queue 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from pathtracer_torch.config import RenderConfig
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
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--sky", default="gradient",
                    choices=["gradient", "envmap"])
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
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.max_depth, spp_batch=args.spp <= 4,
                       sky=args.sky, env_importance_sampling=args.env_nee,
                       env_nee_cell=args.env_cell,
                       env_shadow_rr=args.env_rr,
                       primary_priming=args.priming)
    r = Renderer(builder.finalize(device="cpu"), cfg,
                 default_camera(args.scene), device=args.device)
    for _ in range(args.frames):
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
