"""Minimal command-line driver (counterpart of pathtracer/app.py).

    python -m pathtracer_torch.app --scene cornell --frames 4 --out c.png
    python -m pathtracer_torch.app --scene sponza --textured --width 1920 \
        --height 1080 --spp 4 --device cuda --out sponza.png

Renders progressively and writes one JSON line per frame (ms, Mrays/s,
mean radiance) and a PNG. The JAX CLI's other flags (env maps, priming,
denoiser, meshes, viewer, ...) are not ported yet: see ROADMAP.md
Queue 1.
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

_CAMERAS = {
    "cornell": ((0.5, 0.5, 2.2), (0.5, 0.5, 0.0)),
    "materials": ((0.5, 0.5, 2.2), (0.5, 0.5, 0.0)),
    "sponza": ((3.0, 4.5, 6.0), (14.0, 3.0, 6.0)),
}


def build_scene(name: str, tris: int, textured: bool):
    if name == "cornell":
        return procedural.cornell_box()
    if name == "materials":
        return procedural.cornell_box(materials_suite=True)
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
                    choices=["cornell", "materials", "sponza"])
    ap.add_argument("--tris", type=int, default=262_000,
                    help="sponza target triangle count")
    ap.add_argument("--textured", action="store_true",
                    help="sponza with the procedural texture set")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--max-depth", type=int, default=6)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available()
                    else "cpu")
    ap.add_argument("--out", default="out.png")
    args, unknown = ap.parse_known_args(argv)
    if unknown:
        ap.error(f"not ported to pathtracer_torch yet: {' '.join(unknown)} "
                 "(ROADMAP.md Queue 1, item 8 lists the full CLI)")

    builder = build_scene(args.scene, args.tris, args.textured)
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.max_depth, spp_batch=args.spp <= 4)
    r = Renderer(builder.finalize(), cfg, default_camera(args.scene),
                 device=args.device)
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
