"""Frozen numpy copies of the scene generators the cells run, and their
helpers: a configuration reaches each generator through a module of its
own (ptbench/scenes/<generator>.py, ptbench.scenes).

Each generator returns a SceneSpec: the meshes, materials, textures and
env map exactly as pathtracer_torch.scene.procedural hands them to its
SceneBuilder (same calls, same order, same arrays), so the program gets
its scene through its own builder while the reference builds its tables
from the same raw arrays. Copied from pathtracer_torch/scene/procedural.py
(sponza_like, bunny_like, icosphere, the texture set) and
pathtracer_torch/bench/configs.py (envmap_scene); numpy only.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ptbench.scenes import rgbe

MAT_DEFAULTS = dict(albedo=(0.8, 0.8, 0.8), emission=(0.0, 0.0, 0.0),
                    roughness=1.0, metallic=0.0, ior=1.5, alpha=1.0,
                    material_type=0, albedo_tex=-1, mr_tex=-1,
                    normal_tex=-1)


@dataclasses.dataclass
class SceneSpec:
    """What a generator hands to a scene builder, in call order.

    materials: dicts of MAT_DEFAULTS' keys; textures: the arrays given to
    add_texture; meshes: dicts of add_mesh's keyword arguments
    (positions, indices, material, uvs, tangents; normals left to the
    builder); envmap: f32 [h, w, 3] or None.
    """

    materials: List[dict] = dataclasses.field(default_factory=list)
    textures: List[np.ndarray] = dataclasses.field(default_factory=list)
    meshes: List[dict] = dataclasses.field(default_factory=list)
    envmap: Optional[np.ndarray] = None

    def add_material(self, **kw) -> int:
        self.materials.append(dict(MAT_DEFAULTS, **kw))
        return len(self.materials) - 1

    def add_texture(self, data) -> int:
        self.textures.append(data)
        return len(self.textures) - 1

    def add_mesh(self, positions, indices, material, uvs=None,
                 tangents=None):
        self.meshes.append(dict(positions=positions, indices=indices,
                                material=material, uvs=uvs,
                                tangents=tangents))

    @property
    def n_tris(self) -> int:
        return sum(len(m["indices"]) for m in self.meshes)


def resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize [h0,w0,c] -> [h,w,c] (numpy only)."""
    h0, w0 = img.shape[:2]
    y = (np.arange(h) + 0.5) * h0 / h - 0.5
    x = (np.arange(w) + 0.5) * w0 / w - 0.5
    y0 = np.clip(np.floor(y).astype(int), 0, h0 - 1)
    x0 = np.clip(np.floor(x).astype(int), 0, w0 - 1)
    y1 = np.minimum(y0 + 1, h0 - 1)
    x1 = np.minimum(x0 + 1, w0 - 1)
    fy = np.clip(y - y0, 0, 1)[:, None, None]
    fx = np.clip(x - x0, 0, 1)[None, :, None]
    a = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    b = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return (a * (1 - fy) + b * fy).astype(np.float32)


def _quad(p0, p1, p2, p3):
    verts = np.array([p0, p1, p2, p3], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    return verts, idx


def icosphere(radius=1.0, center=(0, 0, 0), subdivisions=3):
    """Geodesic sphere: (verts [V,3], faces [F,3])."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts_list[a] + verts_list[b]
                m = m / np.linalg.norm(m)
                edge_mid[key] = len(verts_list)
                verts_list.append(m)
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.array(verts_list)
        faces = np.array(new_faces, np.int64)
    verts = verts * radius + np.asarray(center, np.float64)
    return verts.astype(np.float32), faces


def bunny_like(subdivisions=6) -> SceneSpec:
    """Perturbed icosphere on a ground plane under a ceiling light."""
    b = SceneSpec()
    grey = b.add_material(albedo=(0.7, 0.7, 0.7))
    body = b.add_material(albedo=(0.65, 0.55, 0.45))
    light = b.add_material(albedo=(1, 1, 1), emission=(8, 8, 8))
    v, i = _quad([-4, 0, -4], [-4, 0, 4], [4, 0, 4], [4, 0, -4])
    b.add_mesh(v, i, grey)
    sv, sf = icosphere(1.0, (0, 0, 0), subdivisions)
    d = (1.0
         + 0.15 * np.sin(3.0 * sv[:, 0]) * np.cos(2.0 * sv[:, 1])
         + 0.1 * np.sin(5.0 * sv[:, 2] + 1.0))
    sv = sv * d[:, None]
    sv[:, 1] += 1.2
    b.add_mesh(sv, sf, body)
    v, i = _quad([-1, 3.5, -1], [1, 3.5, -1], [1, 3.5, 1], [-1, 3.5, 1])
    b.add_mesh(v, i, light)
    return b


def envmap_scene(subdivisions=5, tex_size=256, env_h=512,
                 env_w=1024) -> SceneSpec:
    """bunny_like(5) with a checker on the body and an HDR sky with a hot
    sun disc, quantised through RGBE as a Radiance file would hold it
    (in memory: nothing is written)."""
    b = bunny_like(subdivisions)
    tex = np.indices((tex_size, tex_size)).sum(axis=0) % 2
    tex = (np.stack([tex] * 3, -1) * 0.6 + 0.2).astype(np.float32)
    tid = b.add_texture(tex)
    b.materials[1] = dict(MAT_DEFAULTS, albedo=(1, 1, 1), albedo_tex=tid,
                          roughness=0.4)
    theta = np.linspace(0, np.pi, env_h)[:, None]
    env = np.zeros((env_h, env_w, 3), np.float32)
    horizon = np.clip(np.sin(theta), 0, 1) ** 3
    env[..., 0] = 0.25 + 0.5 * horizon
    env[..., 1] = 0.35 + 0.45 * horizon
    env[..., 2] = 0.6 + 0.25 * horizon
    env[60:76, 220:236] = 800.0  # sun disc
    b.envmap = rgbe.decode(rgbe.encode(env))
    return b


def _value_noise(n, seed, octaves=4):
    rng = np.random.default_rng(seed)
    out = np.zeros((n, n, 1), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        g = rng.random((4 << o, 4 << o, 1)).astype(np.float32)
        out += amp * resize_bilinear(g, n, n)
        total += amp
        amp *= 0.5
    return (out / total)[..., 0]


def _sponza_textures(b: SceneSpec):
    n = 256
    noise = _value_noise(n, 11)
    y = np.linspace(0, 16, n, endpoint=False)[:, None] % 1.0
    mortar = (0.75 + 0.25 * np.clip(np.abs(y - 0.5) * 8, 0, 1)
              ).astype(np.float32)
    stone_rgb = (np.array([0.62, 0.57, 0.5], np.float32)
                 * (0.8 + 0.4 * noise)[..., None] * mortar[..., None])
    stone_tex = b.add_texture(np.clip(stone_rgb, 0, 1))
    yy, xx = np.mgrid[0:n, 0:n]
    check = (((xx * 8 // n) + (yy * 8 // n)) % 2).astype(np.float32)
    floor_rgb = (np.array([0.55, 0.52, 0.5], np.float32) * (0.6 + 0.4 * check)
                 [..., None] * (0.85 + 0.3 * noise)[..., None])
    floor_tex = b.add_texture(np.clip(floor_rgb, 0, 1))
    m = 128
    mr_noise = _value_noise(m, 23)
    mr = np.zeros((m, m, 4), np.float32)
    mr[..., 1] = 0.5 + 0.5 * mr_noise
    mr[..., 3] = 1.0
    mr_tex = b.add_texture(mr)
    hgt = _value_noise(m, 37, octaves=5)
    dx = np.roll(hgt, -1, 1) - np.roll(hgt, 1, 1)
    dy = np.roll(hgt, -1, 0) - np.roll(hgt, 1, 0)
    nrm = np.stack([-dx * 2.0, -dy * 2.0, np.ones_like(hgt)], axis=-1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    normal_tex = b.add_texture(nrm * 0.5 + 0.5)
    stripes = ((yy * 6 // n) % 2).astype(np.float32)
    banner = np.zeros((n, n, 4), np.float32)
    banner[..., 0] = 0.45 + 0.3 * stripes
    banner[..., 1] = 0.08 + 0.25 * stripes
    banner[..., 2] = 0.08
    frac_y = yy / n
    banner[..., 3] = np.where(frac_y + 0.35 * noise > 0.9, 0.0, 1.0)
    banner_tex = b.add_texture(banner)
    return stone_tex, floor_tex, mr_tex, normal_tex, banner_tex


def sponza_like(target_tris=262_000, seed=0, textured=False) -> SceneSpec:
    """Colonnaded atrium (24 x 10 x 12) at ~target_tris triangles: floor,
    walls, two rows of subdivided columns, a ceiling aperture light and
    scattered crates; with `textured`, sRGB albedo, metal-rough and
    normal maps on every surface and alpha-cutout banners."""
    rng = np.random.default_rng(seed)
    b = SceneSpec()
    if textured:
        stone_tex, floor_tex, mr_tex, normal_tex, banner_tex = \
            _sponza_textures(b)
        stone = b.add_material(albedo=(1, 1, 1), albedo_tex=stone_tex,
                               mr_tex=mr_tex, normal_tex=normal_tex)
        floor_m = b.add_material(albedo=(1, 1, 1), roughness=0.6,
                                 albedo_tex=floor_tex, normal_tex=normal_tex)
        fabric = b.add_material(albedo=(1, 1, 1), albedo_tex=banner_tex)
    else:
        stone = b.add_material(albedo=(0.55, 0.5, 0.45))
        floor_m = b.add_material(albedo=(0.4, 0.38, 0.35), roughness=0.6)
        fabric = b.add_material(albedo=(0.5, 0.1, 0.1))
    light = b.add_material(albedo=(1, 1, 1), emission=(12, 12, 12))

    def add_box(lo, hi, mat, sub=1, uv_scale=0.25):
        lo = np.asarray(lo, np.float32)
        hi = np.asarray(hi, np.float32)
        for axis in range(3):
            for side in (0, 1):
                a1, a2 = [(1, 2), (0, 2), (0, 1)][axis]
                u = np.linspace(lo[a1], hi[a1], sub + 1)
                v = np.linspace(lo[a2], hi[a2], sub + 1)
                uu, vv = np.meshgrid(u, v, indexing="ij")
                pts = np.zeros(uu.shape + (3,), np.float32)
                pts[..., a1] = uu
                pts[..., a2] = vv
                pts[..., axis] = hi[axis] if side else lo[axis]
                verts = pts.reshape(-1, 3)
                uvs = np.stack([uu, vv], axis=-1).reshape(-1, 2) * uv_scale
                tang = np.zeros_like(verts)
                tang[:, a1] = 1.0
                idx = []
                for ii in range(sub):
                    for jj in range(sub):
                        k = ii * (sub + 1) + jj
                        if side != (axis != 1):
                            idx += [[k, k + 1, k + sub + 2],
                                    [k, k + sub + 2, k + sub + 1]]
                        else:
                            idx += [[k, k + sub + 2, k + 1],
                                    [k, k + sub + 1, k + sub + 2]]
                b.add_mesh(verts, np.array(idx, np.int64), mat,
                           uvs=uvs, tangents=tang)

    def add_cylinder(center, radius, height, mat, segments, stacks):
        cx, cy, cz = center
        theta = np.linspace(0, 2 * np.pi, segments, endpoint=False)
        ys = np.linspace(0, height, stacks + 1)
        ring = np.stack([np.cos(theta), np.sin(theta)], axis=-1) * radius
        verts, uvs, tang = [], [], []
        for y in ys:
            for j, (rx, rz) in enumerate(ring):
                verts.append([cx + rx, cy + y, cz + rz])
                uvs.append([2.0 * j / segments, y * 0.25])
                tang.append([-ring[j][1] / radius, 0.0, ring[j][0] / radius])
        verts = np.array(verts, np.float32)
        idx = []
        for s in range(stacks):
            for k in range(segments):
                a = s * segments + k
                bb = s * segments + (k + 1) % segments
                c = a + segments
                dd = bb + segments
                idx += [[a, dd, bb], [a, c, dd]]
        b.add_mesh(verts, np.array(idx, np.int64), mat,
                   uvs=np.array(uvs, np.float32),
                   tangents=np.array(tang, np.float32))

    W, H, D = 24.0, 10.0, 12.0
    add_box([0, -0.5, 0], [W, 0, D], floor_m, sub=12)
    add_box([0, 0, -0.5], [W, H, 0], stone, sub=10)
    add_box([0, 0, D], [W, H, D + 0.5], stone, sub=10)
    add_box([-0.5, 0, 0], [0, H, D], stone, sub=8)
    add_box([W, 0, 0], [W + 0.5, H, D], stone, sub=8)
    add_box([0, H, 0], [W, H + 0.5, 3], stone, sub=6)
    add_box([0, H, D - 3], [W, H + 0.5, D], stone, sub=6)
    add_box([0, H, 3], [6, H + 0.5, D - 3], stone, sub=6)
    add_box([W - 6, H, 3], [W, H + 0.5, D - 3], stone, sub=6)
    v, i = _quad([6, H - 0.02, 3], [W - 6, H - 0.02, 3],
                 [W - 6, H - 0.02, D - 3], [6, H - 0.02, D - 3])
    b.add_mesh(v, i, light)

    n_cols = 12
    current = b.n_tris
    remaining = max(target_tris - current - 20_000, 40_000)
    seg_budget = remaining // (n_cols * 2)
    segments = max(12, int(np.sqrt(seg_budget / 2 * (64 / 24))))
    stacks = max(6, seg_budget // (2 * segments))
    for r, z in ((0, 3.0), (1, D - 3.0)):
        for k in range(n_cols):
            x = W * (k + 0.5) / n_cols
            add_cylinder((x, 0, z), 0.45, H - 1.0, stone, segments, stacks)
            add_box([x - 0.6, H - 1.0, z - 0.6], [x + 0.6, H, z + 0.6],
                    stone, sub=2)

    for _ in range(40):
        x = rng.uniform(2, W - 2)
        z = rng.uniform(1, D - 1)
        s = rng.uniform(0.3, 0.9)
        add_box([x - s, 0, z - s], [x + s, rng.uniform(0.5, 1.8), z + s],
                stone if rng.random() < 0.5 else fabric, sub=3)
    return b
