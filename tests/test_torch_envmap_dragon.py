"""The envmap_dragon configuration: its generator (ptbench/scenes/
envmap_dragon.py) makes a closed, outward-facing tube of exactly the
triangles asked for, the configuration states what the generator gives,
and the port renders a small version of the cell as the benchmark's
plain reference does.

The file imports neither jax nor the JAX package.
"""

from __future__ import annotations

import copy
import io
import json

import numpy as np
import pytest

from ptbench import spec
from ptbench.scenes import envmap_dragon, procedural

CELL = "envmap_dragon.accum_1024_dragon"
SEED = 2**31 + 4099


@pytest.fixture(autouse=True)
def _one_thread():
    """The small render on one thread: the suite runs several workers at
    once, and torch ops spread over every core by each of them
    oversubscribe the machine."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def published():
    """The mesh at its published size."""
    return envmap_dragon.mesh()


def directed_edges(faces):
    return np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                           faces[:, [2, 0]]])


def assert_closed_and_consistent(positions, faces):
    """Every edge is shared by exactly two faces, which run it in
    opposite directions."""
    e = directed_edges(faces)
    n = positions.shape[0]
    key = e[:, 0] * n + e[:, 1]
    assert np.unique(key).shape[0] == key.shape[0]   # each direction once
    assert bool(np.isin(e[:, 1] * n + e[:, 0], key).all())
    assert faces.min() == 0 and faces.max() == n - 1


def crossings(origins, direction, positions, faces):
    """Crossings of rays from `origins` [P, 3] along one direction with
    the faces (Moller-Trumbore in float64)."""
    v0, v1, v2 = (positions[faces[:, k]].astype(np.float64)
                  for k in range(3))
    e1, e2 = v1 - v0, v2 - v0
    p = np.cross(direction, e2)
    det = (e1 * p).sum(1)
    out = []
    for o in origins:
        s = o - v0
        u = (s * p).sum(1) / det
        q = np.cross(s, e1)
        v = (direction * q).sum(1) / det
        t = (e2 * q).sum(1) / det
        out.append(int(((u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)).sum()))
    return np.array(out)


def test_published_size_is_the_dragons(published):
    positions, faces, uvs = published
    assert faces.shape == (871_414, 3)
    assert positions.shape == (871_414 // 2 + 2, 3) == uvs.shape[:1] + (3,)
    assert positions.dtype == np.float32 and faces.dtype == np.int64


def test_published_mesh_is_closed_and_consistent(published):
    positions, faces, _ = published
    assert_closed_and_consistent(positions, faces)
    v0, v1, v2 = (positions[faces[:, k]].astype(np.float64)
                  for k in range(3))
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    assert area.min() > 0.0


def test_published_normals_face_outward(published):
    """The enclosed volume is positive, and for faces drawn across the
    body a point just in front of a face lies outside (an even number
    of crossings along a ray) and one just behind it inside (odd)."""
    positions, faces, _ = published
    v0, v1, v2 = (positions[faces[:, k]].astype(np.float64)
                  for k in range(3))
    assert (v0 * np.cross(v1, v2)).sum() / 6.0 > 0.5
    pick = np.random.default_rng(5).choice(faces.shape[0], 12,
                                           replace=False)
    n = np.cross(v1[pick] - v0[pick], v2[pick] - v0[pick])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    centre = (v0[pick] + v1[pick] + v2[pick]) / 3.0
    direction = np.array([0.3141, 0.8017, -0.5083])
    eps = 1e-4
    front = crossings(centre + eps * n, direction, positions, faces)
    back = crossings(centre - eps * n, direction, positions, faces)
    assert (front % 2 == 0).all() and (back % 2 == 1).all()


def test_published_mesh_is_the_same_every_call(published):
    again = envmap_dragon.mesh()
    for a, b in zip(published, again):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_placed_as_the_bunny_body(published):
    positions, _, uvs = published
    lo, hi = positions.min(0), positions.max(0)
    assert 2.2 < (hi - lo)[[0, 2]].max() < 2.6
    assert np.abs((lo + hi)[[0, 2]] / 2).max() < 0.1
    assert 1.0 < (lo[1] + hi[1]) / 2 < 1.4 and lo[1] > 0.0
    assert uvs.min() >= 0.0 and uvs.max() <= 1.0


def test_far_parts_of_the_coil_stay_apart():
    """The body passes close to itself but never through: centre-line
    points more than 1.5 apart along it are farther apart than their
    radii with the largest displacement."""
    s = np.linspace(0.0, 1.0, 3000)
    c = envmap_dragon.centre_line(s)
    arc = np.concatenate([[0.0], np.cumsum(
        np.linalg.norm(np.diff(c, axis=0), axis=1))])
    r = envmap_dragon.radius_at(arc / arc[-1]) * (
        1.0 + envmap_dragon.NOISE_DEPTH)
    d = np.linalg.norm(c[:, None] - c[None], axis=-1)
    far = np.abs(arc[:, None] - arc[None]) > 1.5
    gap = (d - r[:, None] - r[None])[far]
    assert 0.0 < gap.min() < 0.15


@pytest.mark.parametrize("triangles", [32, 2_000, 5_002, 12_346])
def test_small_sizes_give_the_count_asked_for(triangles):
    """mesh(n) has n faces and n / 2 + 2 vertices (a closed mesh of one
    piece: F = 2V - 4), closed and consistent at any size."""
    positions, faces, uvs = envmap_dragon.mesh(triangles)
    assert faces.shape == (triangles, 3)
    assert positions.shape[0] == uvs.shape[0] == triangles // 2 + 2
    assert_closed_and_consistent(positions, faces)


@pytest.mark.parametrize("triangles", [31, 871_413, 30])
def test_counts_no_closed_tube_has_are_refused(triangles):
    with pytest.raises(ValueError, match="closed tube"):
        envmap_dragon.mesh(triangles)


def test_scene_is_envmap_scenes_but_the_body():
    """Ground, body, light in envmap_scene's order and materials, its
    checker and its sky; the configuration's triangles are the scene's."""
    got = envmap_dragon.generate(2_000, tex_size=32, env_h=32, env_w=64)
    want = procedural.envmap_scene(2, tex_size=32, env_h=32, env_w=64)
    assert got.materials == want.materials
    assert len(got.textures) == 1
    assert np.array_equal(got.textures[0], want.textures[0])
    assert np.array_equal(got.envmap, want.envmap)
    for k in (0, 2):
        for key in ("positions", "indices"):
            assert np.array_equal(got.meshes[k][key], want.meshes[k][key])
        assert got.meshes[k]["material"] == want.meshes[k]["material"]
    assert got.meshes[1]["material"] == 1 and got.meshes[1]["uvs"] is not None
    assert got.n_tris == 2_000 + 4
    cfg = spec.cell(CELL).config
    assert cfg["scene"]["generator"] == "envmap_dragon"
    assert cfg["triangles"] == cfg["scene"]["args"]["triangles"] + 4


def small_cell(triangles=3_000):
    """The cell at 32x32, 2 frames a step, on a mesh of `triangles`,
    every lane of every traversal call captured."""
    c = copy.deepcopy(spec.cell(CELL))
    c.config["scene"]["args"] = dict(triangles=triangles, tex_size=32,
                                     env_h=32, env_w=64)
    c.traffic.update(width=32, height=32, frame_batch=2, warmup_steps=0,
                     film_pixels=64, hit_rays_per_call=4096, trace_steps=1)
    return c


def test_port_agrees_with_the_reference_on_a_small_dragon(capsys,
                                                          monkeypatch):
    """One 2-frame step of a 3,000-triangle dragon at 32x32 on the CPU
    through ptbench: every closest-hit lane equals the brute-force hit,
    every shadow lane the brute-force flag, and the film is within the
    image limit."""
    from ptbench import run

    # this suite's conftest loads the JAX package for other files; the
    # port's own imports are held jax-free by ptbench's import tests
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    out = io.StringIO()
    res = run.run(small_cell(), SEED, 0.0, 0, "cpu", out=out)
    assert res is not None
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    checks = line["checks"]
    assert line["correct"] is True, checks
    assert checks["closest_bad_pct"]["value"] == 0.0
    assert checks["occluded_bad_pct"]["value"] == 0.0
    assert checks["image_bad_pct"]["value"] <= 10.0
    # every lane of the step: 2,048 primary lanes at least
    assert checks["closest_lanes_per_step"]["value"] >= 2 * 32 * 32
    assert checks["occluded_lanes_per_step"]["value"] > 0
    capsys.readouterr()
