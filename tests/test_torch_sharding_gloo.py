"""Sharded rendering across real processes: torch.distributed over gloo.

Each test spawns its ranks with torch.multiprocessing (one CPU thread
each), joined through a FileStore under the test's tmp_path, and holds
what every rank ends with to the in-process mesh (every rank in one
process, parallel/sharding.py) on the same scene: the films agree to
rtol 1e-6 / atol 1e-7 (only the order of the sample sums differs), the
ray counts and hints exactly. This file imports neither jax nor the JAX
package: the spawned ranks import it to find their bodies.

    python -m pytest tests/test_torch_sharding_gloo.py -q -p no:randomly
"""

import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pathtracer_torch.accel.cluster import build_scene_clusters
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.integrator.camera import Camera
from pathtracer_torch.parallel import sharding
from pathtracer_torch.render import Renderer
from pathtracer_torch.scene import procedural
from pathtracer_torch.scene.build import MaterialDesc

RANK_TIMEOUT_S = 240
FILM_TOL = dict(rtol=1e-6, atol=1e-7)
# 1280-triangle sphere in the box: the cluster route (K1-K3 on a card)
GLOO_CFG = dict(width=16, height=16, max_depth=3, intersector="cluster")


def box_scene(device="cpu", envmap=None):
    """The Cornell box with an icosphere (cluster route), as
    tests/test_sharding.py builds it; envmap: an equirect image, or
    None."""
    b = procedural.cornell_box()
    sv, sf = procedural.icosphere(0.25, (0.5, 0.35, 0.2), 3)
    b.add_mesh(sv, sf, b.add_material(MaterialDesc(albedo=(0.7, 0.6, 0.2),
                                                   roughness=0.4)))
    if envmap is not None:
        b.set_envmap(envmap)
    return build_scene_clusters(b.finalize(device=device))


def box_camera():
    c = Camera(position=(0.5, 0.5, 2.2))
    c.look_at((0.5, 0.5, 0.0))
    c.moved = False
    return c


def run_steps(mesh, cfg, steps):
    """`steps` Renderer steps on the mesh: (film, ray counts, hints or
    None, G-buffer or None) as numpy."""
    r = Renderer(box_scene(), cfg, box_camera(), device="cpu", mesh=mesh)
    rays = []
    for _ in range(steps):
        r.step()
        rays.append(int(r.last_rays))
    prime = None if r._prime is None else r._prime.numpy()
    gbuf = None if r._gbuf is None else {k: v.numpy()
                                         for k, v in r._gbuf.items()}
    return r.film.accum.numpy(), rays, prime, gbuf


def _rank_main(rank, world, store, body, *args):
    assert "jax" not in sys.modules, "a rank imported jax"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        body(rank, *args)
    finally:
        dist.destroy_process_group()


def _render_rank(rank, out_dir, mesh_shape, cfg_kw, steps):
    mesh = sharding.make_mesh(*mesh_shape)
    film, rays, prime, gbuf = run_steps(mesh, RenderConfig(**cfg_kw), steps)
    out = dict(film=film, rays=np.asarray(rays))
    if prime is not None:
        out["prime"] = prime
    for k, v in (gbuf or {}).items():
        out["gbuf_" + k] = v
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def spawn_ranks(tmp_path, world, body, *args):
    """Run body(rank, *args) on `world` spawned gloo ranks; every rank
    must exit 0 within RANK_TIMEOUT_S."""
    ctx = mp.start_processes(
        _rank_main, args=(world, str(tmp_path / "store"), body) + args,
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                pytest.fail(f"ranks still running after {RANK_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()


def spawn_renders(tmp_path, world, mesh_shape, cfg_kw, steps):
    """Each rank's run_steps results, from `world` spawned ranks."""
    spawn_ranks(tmp_path, world, _render_rank, str(tmp_path), mesh_shape,
                cfg_kw, steps)
    return [dict(np.load(str(tmp_path / f"rank{r}.npz")))
            for r in range(world)]


def test_gloo_world4_every_rank_holds_the_emulated_film(tmp_path):
    """Mesh (2, 2) over four gloo ranks, spp 4 spp-batched (each shard a
    2-sample wavefront) with the G-buffer: every rank ends with the same
    film, rays and G-buffer as the in-process mesh."""
    cfg_kw = dict(GLOO_CFG, spp=4, spp_batch=True, denoise=True)
    ranks = spawn_renders(tmp_path, 4, (2, 2), cfg_kw, 1)
    film, rays, _, gbuf = run_steps(
        sharding.make_mesh(2, 2, world_size=4), RenderConfig(**cfg_kw), 1)
    assert film.mean() > 0.0
    for res in ranks:
        assert np.array_equal(res["film"], ranks[0]["film"])
        np.testing.assert_allclose(res["film"], film, **FILM_TOL)
        assert res["rays"].tolist() == rays
        for k, v in gbuf.items():
            np.testing.assert_allclose(res["gbuf_" + k], v, err_msg=k,
                                       **FILM_TOL)


def test_gloo_priming_merges_hints_by_max(tmp_path):
    """Mesh (1, 2) over two gloo ranks, primed, two steps: the hints the
    ranks merge with ReduceOp.MAX equal the in-process mesh's, and so do
    the film and the ray counts."""
    cfg_kw = dict(GLOO_CFG, spp=2, primary_priming=True)
    ranks = spawn_renders(tmp_path, 2, (1, 2), cfg_kw, 2)
    film, rays, prime, _ = run_steps(
        sharding.make_mesh(1, 2, world_size=2), RenderConfig(**cfg_kw), 2)
    assert (prime[:, 0] >= 0).any() and (prime[:, 1] >= 0).any()
    for res in ranks:
        assert np.array_equal(res["prime"], prime)
        np.testing.assert_allclose(res["film"], film, **FILM_TOL)
        assert res["rays"].tolist() == rays


def _app_rank(rank, out_dir):
    from pathtracer_torch import app

    stem = os.path.join(out_dir, f"r{rank}")
    app.main(["--scene", "materials", "--width", "16", "--height", "16",
              "--spp", "2", "--max-depth", "2", "--frames", "2", "--aov",
              "--mesh", "1,2", "--device", "cpu", "--out", stem + ".png",
              "--checkpoint", stem + ".npz"])


def test_gloo_app_mesh_writes_on_rank_0_only(tmp_path):
    """app.main --mesh inside a process group the caller initialised:
    both ranks render, only rank 0 writes the PNG, AOVs and checkpoint
    (each rank is given its own paths here to tell them apart)."""
    from pathtracer_torch.film import film as film_mod

    spawn_ranks(tmp_path, 2, _app_rank, str(tmp_path))
    written = sorted(p.name for p in tmp_path.iterdir()
                     if p.suffix in (".png", ".npz"))
    assert written == ["r0.npz", "r0.png", "r0_albedo.png", "r0_depth.png",
                       "r0_normal.png"]
    ck = film_mod.load_checkpoint(str(tmp_path / "r0.npz"), device="cpu")
    assert ck.frame == 2 and float(ck.accum.mean()) > 0.0


# rank 0's scripted keys per viewer step: a move forward, a look to the
# right, then still frames; rank 1 would walk backward if it read keys
SCRIPT = {0: [[], ["w", "w"], ["l"], [], []], 1: [["s"]] * 5}


def _viewer_rank(rank, out_dir):
    import io

    from pathtracer_torch import viewer

    script = iter(SCRIPT[rank])
    r = Renderer(box_scene(), RenderConfig(**GLOO_CFG, spp=2), box_camera(),
                 device="cpu", mesh=sharding.make_mesh(1, 2))
    start = r.camera.position.copy()
    out = io.StringIO()
    stdout, sys.stdout = sys.stdout, out
    try:
        n = viewer.run_interactive(r, cols=16, rows=9, max_frames=5,
                                   read_keys=lambda t: next(script))
    finally:
        sys.stdout = stdout
    cam = r.camera
    np.savez(os.path.join(out_dir, f"view{rank}.npz"), film=r.film.accum,
             frame=r.film.frame, n=n, start=start, pos=cam.position,
             angles=np.array([cam.yaw, cam.pitch]), drawn=len(out.getvalue()))


def test_gloo_interactive_mesh_ranks_follow_rank0(tmp_path):
    """run_interactive over a (1, 2) mesh on two gloo ranks: rank 0 reads
    a scripted move and look, broadcasts its view each step, and both
    ranks end with the same camera and the same film; only rank 0
    draws."""
    spawn_ranks(tmp_path, 2, _viewer_rank, str(tmp_path))
    res = [dict(np.load(str(tmp_path / f"view{r}.npz"))) for r in range(2)]
    for res_r in res:
        assert int(res_r["n"]) == 5
        # the look at step 3 reset the film: steps 3-5 folded since
        assert int(res_r["frame"]) == 3
        assert np.array_equal(res_r["pos"], res[0]["pos"])
        assert np.array_equal(res_r["angles"], res[0]["angles"])
        assert np.array_equal(res_r["film"], res[0]["film"])
    assert not np.array_equal(res[0]["pos"], res[0]["start"])
    assert res[0]["film"].mean() > 0.0
    assert int(res[0]["drawn"]) > 0 and int(res[1]["drawn"]) == 0
