"""Command-line driver (counterpart of pathtracer/app.py).

    python -m pathtracer_torch.app --scene sponza-textured --width 1920 \
        --height 1080 --spp 4 --spp-batch --out sponza.png
    python -m pathtracer_torch.app --scene model.glb \
        --scene props.obj@2,0,1,0.5,90 --sky envmap --envmap sky.png \
        --out composed.png
    python -m pathtracer_torch.app --scene bunny --sky envmap \
        --envmap sky.hdr --env-nee --priming --spp 1 --frame-batch auto \
        --out bunny.png
    python -m pathtracer_torch.app --scene materials --denoise --aov \
        --tonemap aces --checkpoint film.npz --out m.png
    python -m pathtracer_torch.app --scene model.glb --orbit --frames 60 \
        --out frames/
    python -m pathtracer_torch.app --scene sponza-textured --interactive \
        --width 480 --height 272 --spp 1
    python -m pathtracer_torch.app --scene cornell --width 32 --height 32 \
        --device cpu --out c.png
    torchrun --nproc-per-node 4 -m pathtracer_torch.app --mesh auto \
        --scene sponza-textured --width 1920 --height 1080 --out s.png

--scene takes one procedural preset (cornell, cornell-spheres, materials,
bunny, sponza, sponza-textured), or any number of .gltf/.glb/.obj files,
each with an optional '@tx,ty,tz[,scale[,ry_deg]]' transform, composed
into one scene.
Renders progressively on --device (default cuda; it is an error when no
CUDA device is present - the CPU runs only on --device cpu) and writes
one JSON line per step (ms, Mrays/s, mean radiance) and a PNG, or with
--orbit one PNG per step into the --out directory; --interactive opens
the terminal viewer (viewer.py). With --mesh, one process per rank under
torchrun: rank r renders its shard on cuda:{LOCAL_RANK} (NCCL; gloo with
--device cpu), every rank holds the film, and rank 0 alone prints and
writes files.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from pathtracer_torch.config import RenderConfig, saturating_frame_batch
from pathtracer_torch.film import film as film_mod
from pathtracer_torch.integrator.camera import Camera
from pathtracer_torch.render import Renderer
from pathtracer_torch.scene import procedural
from pathtracer_torch.scene.build import SceneBuilder
from pathtracer_torch.scene.gltf import load_gltf
from pathtracer_torch.scene.hdr import read_hdr
from pathtracer_torch.scene.objload import load_obj
from pathtracer_torch.utils import native

_PRESETS = {
    "cornell": lambda: procedural.cornell_box(),
    "cornell-spheres": lambda: procedural.cornell_box(spheres=True),
    "materials": lambda: procedural.cornell_box(materials_suite=True),
    "bunny": lambda: procedural.bunny_like(),
    "sponza": lambda: procedural.sponza_like(),
    "sponza-textured": lambda: procedural.sponza_like(textured=True),
}
_CAMERAS = {
    "cornell": ((0.5, 0.5, 2.2), (0.5, 0.5, 0.0)),
    "cornell-spheres": ((0.5, 0.5, 2.2), (0.5, 0.5, 0.0)),
    "materials": ((0.5, 0.5, 2.2), (0.5, 0.5, 0.0)),
    "bunny": ((0.0, 2.0, 5.0), (0.0, 1.0, 0.0)),
    "sponza": ((3.0, 4.5, 6.0), (14.0, 3.0, 6.0)),
    "sponza-textured": ((3.0, 4.5, 6.0), (14.0, 3.0, 6.0)),
}
_FILE_CAMERA = ((0, 1, 4), (0, 0, 0))


def _parse_spec(spec: str):
    """'path[@tx,ty,tz[,scale[,ry_deg]]]' -> (path, f32 4x4 or None)."""
    if "@" not in spec:
        return spec, None
    path, params = spec.rsplit("@", 1)
    vals = [float(x) for x in params.split(",")]
    if len(vals) < 3:
        raise SystemExit(f"bad transform in scene spec: {spec!r} "
                         "(want tx,ty,tz[,scale[,ry_deg]])")
    tx, ty, tz = vals[0:3]
    s = vals[3] if len(vals) > 3 else 1.0
    ry = math.radians(vals[4]) if len(vals) > 4 else 0.0
    c, sn = math.cos(ry), math.sin(ry)
    m = np.array([[s * c, 0, s * sn, tx],
                  [0, s, 0, ty],
                  [-s * sn, 0, s * c, tz],
                  [0, 0, 0, 1]], np.float32)
    return path, m


def load_scene(specs) -> SceneBuilder:
    """SceneBuilder from ONE procedural preset name, or from any number of
    .gltf/.glb/.obj paths (each with an optional transform) composed into
    one scene."""
    if isinstance(specs, str):
        specs = [specs]
    if len(specs) == 1 and specs[0] in _PRESETS:
        return _PRESETS[specs[0]]()

    builder = SceneBuilder()
    for spec in specs:
        path, transform = _parse_spec(spec)
        if path in _PRESETS:
            raise SystemExit(
                f"procedural preset {path!r} cannot be composed with other "
                "models; compose .gltf/.glb/.obj files")
        ext = os.path.splitext(path)[1].lower()
        if ext in (".gltf", ".glb"):
            load_gltf(path, builder=builder, transform=transform)
        elif ext == ".obj":
            load_obj(path, builder=builder, transform=transform)
        else:
            raise SystemExit(f"unknown scene: {spec}")
    return builder


def load_envmap(path: str) -> np.ndarray:
    """Equirect radiance f32 [H, W, 3] from a Radiance .hdr, or from an
    8-bit PNG decoded natively and linearised as (u8 / 255) ** 2.2."""
    if os.path.splitext(path)[1].lower() == ".hdr":
        return read_hdr(path)
    with open(path, "rb") as f:
        arr = native.png_rgba(f.read(), path)
    return (arr[..., :3].astype(np.float32) / 255.0) ** 2.2


def default_camera(spec: str) -> Camera:
    pos, tgt = _CAMERAS.get(spec, _FILE_CAMERA)
    cam = Camera(position=pos)
    cam.look_at(tgt)
    return cam


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--scene", action="append", default=None,
                    help="procedural preset, or a .gltf/.glb/.obj path "
                         "with an optional '@tx,ty,tz[,scale[,ry_deg]]' "
                         "transform; repeat to compose several files "
                         "(default cornell)")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--max-depth", type=int, default=6)
    ap.add_argument("--frames", type=int, default=8,
                    help="progressive frames; with --frame-batch F (or "
                         "auto) rounded up to whole F-frame steps")
    ap.add_argument("--spp-batch", action="store_true",
                    help="trace all spp samples of a frame as one "
                         "wavefront (cfg.spp_batch)")
    ap.add_argument("--frame-batch", default="1", metavar="F",
                    help="fold F frames' samples into one wavefront per "
                         "step (implies --spp-batch; same sample set); "
                         "'auto' grows the pool toward the saturation "
                         "point, at most 8")
    ap.add_argument("--sky", default="gradient",
                    choices=["gradient", "black", "hosek", "envmap"],
                    help="hosek = Hosek-Wilkie sky (turbidity 3, albedo 1)")
    ap.add_argument("--envmap", default=None, metavar="PATH",
                    help="equirect environment: Radiance .hdr or 8-bit "
                         "PNG - required with --sky envmap")
    ap.add_argument("--env-nee", action="store_true",
                    help="importance-sample the env map with MIS (one "
                         "extra shadow ray per bounce)")
    ap.add_argument("--env-cell", type=int, default=8, metavar="N",
                    help="pixels in an NxN screen cell share one env "
                         "direction per (sample, depth); 1 = per pixel")
    ap.add_argument("--env-rr", type=float, default=0.0, metavar="M",
                    help="Russian roulette on env shadow rays with "
                         "q = clip(M*lum(throughput), 1/8, 1); 0 = off")
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
    ap.add_argument("--traversal-backend", default="pallas",
                    choices=["pallas", "xla"],
                    help="pallas = the traversal kernels; the JAX "
                         "package's xla sweep is not part of the port "
                         "(RenderConfig refuses it)")
    ap.add_argument("--interactive", action="store_true",
                    help="terminal viewer: ANSI truecolor preview, "
                         "WASD + arrow camera, accumulation resets on "
                         "movement")
    ap.add_argument("--auto-frame-batch", type=int, default=8, metavar="F",
                    help="--interactive: while the camera is static, each "
                         "step after the first renders F frames as one "
                         "wavefront; the step after a move stays single-"
                         "frame (0/1 disables)")
    ap.add_argument("--motion-preview", type=int, default=2, metavar="S",
                    help="--interactive: the step after a camera move "
                         "renders a 1-spp preview at 1/S resolution, "
                         "upscaled for display; the film never sees it "
                         "(0/1 disables)")
    ap.add_argument("--orbit", action="store_true",
                    help="orbit the camera around the origin, one step a "
                         "position (accumulation resets), writing "
                         "frame_NNNN.png into the --out directory")
    ap.add_argument("--priming", action="store_true",
                    help="verified priming: per-pixel primary-hit and "
                         "bounce-0 shadow-blocker hints chained across "
                         "samples and frames (exact)")
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
    ap.add_argument("--mesh", default=None, metavar="TILE,SAMPLE",
                    help="render across a (tile, sample) mesh of ranks "
                         "(parallel/sharding.py), one process per rank "
                         "under torchrun; e.g. '2,2' on 4 ranks, 'auto' "
                         "factorizes the world size")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default="out.png",
                    help="output PNG (a directory with --orbit)")
    ap.add_argument("--quiet", action="store_true",
                    help="print nothing")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(torch.cuda.is_available() is False); pass "
                         "--device cpu to render on the CPU")
    if args.sky == "envmap" and not args.envmap:
        raise SystemExit("--sky envmap requires --envmap PATH "
                         "(a zero envmap would render black)")

    device, mesh, own_group = torch.device(args.device), None, False
    if args.mesh:
        device, mesh, own_group = _join_mesh(args.mesh, device)
    try:
        return _render(args, device, mesh)
    finally:
        if own_group:
            dist.destroy_process_group()


def _join_mesh(spec: str, device):
    """Initialise this rank's process group from torchrun's environment
    (unless the caller already did) and build the mesh. Returns (this
    rank's device: cuda:{LOCAL_RANK} on CUDA, the mesh, whether the group
    is ours to destroy)."""
    from pathtracer_torch.parallel import sharding

    own = not dist.is_initialized()
    if own and "WORLD_SIZE" not in os.environ:
        raise SystemExit("--mesh renders one process per rank: launch with "
                         "torchrun --nproc-per-node N -m pathtracer_torch.app "
                         "--mesh ... (no process group and no WORLD_SIZE in "
                         "the environment)")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if own:
        dist.init_process_group(
            backend="nccl" if device.type == "cuda" else "gloo")
    try:
        if spec == "auto":
            return device, sharding.make_mesh(), own
        tile, sample = (int(x) for x in spec.split(","))
        return device, sharding.make_mesh(tile, sample), own
    except ValueError:
        if own:
            dist.destroy_process_group()
        raise


def _render(args, device, mesh):
    lead = mesh is None or mesh.rank == 0      # rank 0 prints and writes
    say = lead and not args.quiet
    specs = args.scene or ["cornell"]
    builder = load_scene(specs)
    if args.envmap:
        builder.set_envmap(load_envmap(args.envmap))
    if args.frame_batch == "auto":
        # the viewer's adaptive policy (--auto-frame-batch) owns batching
        # there: a fixed F > 1 would batch every post-move step too
        frame_batch = (1 if args.interactive else saturating_frame_batch(
            args.width, args.height, args.spp))
    else:
        frame_batch = int(args.frame_batch)
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.max_depth, sky=args.sky,
                       env_importance_sampling=args.env_nee,
                       env_nee_cell=args.env_cell,
                       env_shadow_rr=args.env_rr,
                       aperture=args.aperture, focus_dist=args.focus_dist,
                       seed=args.seed, sampler=args.sampler,
                       intersector=args.intersector,
                       traversal_backend=args.traversal_backend,
                       primary_priming=args.priming,
                       denoise=args.denoise, tonemap=args.tonemap,
                       clamp_radiance=args.clamp,
                       capture_gbuffer=args.aov,
                       spp_batch=args.spp_batch or frame_batch > 1,
                       frame_batch=frame_batch)
    cam = default_camera(specs[0])
    r = Renderer(builder.finalize(device="cpu"), cfg, cam, device=device,
                 mesh=mesh,
                 auto_frame_batch=(args.auto_frame_batch
                                   if args.interactive and frame_batch == 1
                                   else 0),
                 motion_preview=(args.motion_preview
                                 if args.interactive else 0))
    if args.checkpoint and os.path.exists(args.checkpoint):
        r.film = film_mod.load_checkpoint(args.checkpoint, device=r.device)
        r.camera.moved = False
        if say:
            print(f"resumed at frame {r.film.frame}")

    if args.interactive:
        from pathtracer_torch import viewer

        n = viewer.run_interactive(r)
        if say:
            print(f"rendered {n} frames")
    else:
        if args.orbit and lead:
            os.makedirs(args.out, exist_ok=True)
        radius = float(np.linalg.norm(cam.position))
        height = float(cam.position[1])
        steps = max(1, -(-args.frames // frame_batch))
        for i in range(steps):
            if args.orbit:          # around the origin, one step a position
                ang = 2 * math.pi * i / steps
                r.camera.position = np.array(
                    [radius * math.cos(ang), height, radius * math.sin(ang)],
                    np.float32)
                r.camera.look_at((0.0, 0.0, 0.0))
            t0 = time.perf_counter()
            film = r.step()
            mean = float(film.accum.mean())          # syncs the device
            dt = time.perf_counter() - t0
            if say:
                print(json.dumps({
                    "frame": film.frame, "ms": round(dt * 1e3, 2),
                    "mrays_per_sec": round(int(r.last_rays) / dt / 1e6, 3),
                    "spp_accumulated": film.frame * cfg.spp,
                    "mean_radiance": round(mean, 5),
                    "device": str(r.device)}))
            if args.orbit and lead:
                film_mod.write_png(
                    os.path.join(args.out, f"frame_{i:04d}.png"),
                    r.display())
    if not lead:
        return 0
    if not args.orbit or args.interactive:
        r.save_png(args.out)
        if say and not args.interactive:
            print(f"wrote {args.out}")
    if args.aov:
        stem = os.path.splitext(args.out)[0]
        for name, img in r.aovs().items():
            film_mod.write_png(f"{stem}_{name}.png", img)
            if say and not args.interactive:
                print(f"wrote {stem}_{name}.png")
    if args.checkpoint:
        film_mod.save_checkpoint(args.checkpoint, r.film)
    return 0


if __name__ == "__main__":
    sys.exit(main())
