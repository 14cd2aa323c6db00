"""Procedural scene generators (counterpart of pathtracer/scene/procedural.py).

The same numpy generators as the JAX package, re-homed onto the port's
SceneBuilder, so both packages build identical arrays:

- `cornell_box`: config 1 (and the config 3 materials suite);
- `icosphere`: geodesic sphere used by the Cornell variants;
- `bunny_like`: the perturbed-icosphere blob of configs 2 and 4;
- `sponza_like`: the colonnaded atrium of the headline (config 5), with
  the optional procedural texture set.
"""

from __future__ import annotations

import numpy as np

from pathtracer_torch.scene.build import MaterialDesc, SceneBuilder, \
    _resize_bilinear
from pathtracer_torch.scene.types import MAT_DIELECTRIC


def _quad(p0, p1, p2, p3):
    """Two triangles for quad corners (CCW). Returns (verts[4,3], idx[2,3])."""
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


def cornell_box(light_emission=15.0, spheres=False, materials_suite=False):
    """The Cornell box (BASELINE config 1 / config 3 variant).

    Box spans [0,1]^3 (open +z face toward the camera): white floor/ceiling/
    back, red left wall, green right wall, area light on the ceiling.
    With `spheres`, two diffuse icospheres; with `materials_suite`, a GGX
    metal sphere + a dielectric glass sphere (config 3).
    """
    b = SceneBuilder()
    white = b.add_material(MaterialDesc(albedo=(0.73, 0.73, 0.73)))
    red = b.add_material(MaterialDesc(albedo=(0.65, 0.05, 0.05)))
    green = b.add_material(MaterialDesc(albedo=(0.12, 0.45, 0.15)))
    light = b.add_material(MaterialDesc(
        albedo=(1.0, 1.0, 1.0),
        emission=(light_emission,) * 3))

    # floor (y=0, normal +y)
    v, i = _quad([0, 0, 0], [0, 0, 1], [1, 0, 1], [1, 0, 0])
    b.add_mesh(v, i, white)
    # ceiling (y=1, normal -y)
    v, i = _quad([0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1])
    b.add_mesh(v, i, white)
    # back wall (z=0, normal +z)
    v, i = _quad([0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0])
    b.add_mesh(v, i, white)
    # left wall (x=0, normal +x)
    v, i = _quad([0, 0, 0], [0, 1, 0], [0, 1, 1], [0, 0, 1])
    b.add_mesh(v, i, red)
    # right wall (x=1, normal -x)
    v, i = _quad([1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0])
    b.add_mesh(v, i, green)
    # ceiling light: small quad slightly below ceiling, normal -y
    e = 0.002
    v, i = _quad([0.35, 1 - e, 0.35], [0.65, 1 - e, 0.35],
                 [0.65, 1 - e, 0.65], [0.35, 1 - e, 0.65])
    b.add_mesh(v, i, light)

    if spheres or materials_suite:
        if materials_suite:
            m1 = b.add_material(MaterialDesc(
                albedo=(0.95, 0.93, 0.88), metallic=1.0, roughness=0.15))
            m2 = b.add_material(MaterialDesc(
                albedo=(1.0, 1.0, 1.0), material_type=MAT_DIELECTRIC,
                ior=1.5, roughness=0.05))
        else:
            m1 = b.add_material(MaterialDesc(albedo=(0.85, 0.85, 0.85)))
            m2 = b.add_material(MaterialDesc(albedo=(0.3, 0.3, 0.7)))
        sv, sf = icosphere(0.16, (0.33, 0.16, 0.4), 3)
        b.add_mesh(sv, sf, m1)
        sv, sf = icosphere(0.16, (0.67, 0.16, 0.65), 3)
        b.add_mesh(sv, sf, m2)

    return b


def bunny_like(subdivisions=6):
    """~80k-tri smooth blob on a ground plane (BASELINE config 2 stand-in).

    A perturbed icosphere: the Stanford bunny's triangle-count class
    without the asset.
    """
    b = SceneBuilder()
    grey = b.add_material(MaterialDesc(albedo=(0.7, 0.7, 0.7)))
    body = b.add_material(MaterialDesc(albedo=(0.65, 0.55, 0.45)))
    light = b.add_material(MaterialDesc(albedo=(1, 1, 1),
                                        emission=(8, 8, 8)))

    v, i = _quad([-4, 0, -4], [-4, 0, 4], [4, 0, 4], [4, 0, -4])
    b.add_mesh(v, i, grey)

    sv, sf = icosphere(1.0, (0, 0, 0), subdivisions)
    # deterministic lumpy displacement breaks the perfect sphere
    d = (1.0
         + 0.15 * np.sin(3.0 * sv[:, 0]) * np.cos(2.0 * sv[:, 1])
         + 0.1 * np.sin(5.0 * sv[:, 2] + 1.0))
    sv = sv * d[:, None]
    sv[:, 1] += 1.2
    b.add_mesh(sv, sf, body)

    v, i = _quad([-1, 3.5, -1], [1, 3.5, -1], [1, 3.5, 1], [-1, 3.5, 1])
    b.add_mesh(v, i, light)
    return b


def _value_noise(n, seed, octaves=4):
    """Tileable-ish value noise in [0, 1]: summed bilinear-upsampled grids."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, n, 1), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        g = rng.random((4 << o, 4 << o, 1)).astype(np.float32)
        out += amp * _resize_bilinear(g, n, n)
        total += amp
        amp *= 0.5
    return (out / total)[..., 0]


def _sponza_textures(b: SceneBuilder):
    """Procedural texture set exercising the full closesthit.rchit:88-112
    path at benchmark scale: sRGB albedo, metal-rough (G/B), tangent-space
    normal maps, and an alpha-cutout banner."""
    n = 256
    noise = _value_noise(n, 11)
    # stone: warm base, mortar-line darkening + noise mottle (sRGB-encoded)
    y = np.linspace(0, 16, n, endpoint=False)[:, None] % 1.0
    mortar = (0.75 + 0.25 * np.clip(np.abs(y - 0.5) * 8, 0, 1)
              ).astype(np.float32)
    stone_rgb = (np.array([0.62, 0.57, 0.5], np.float32)
                 * (0.8 + 0.4 * noise)[..., None] * mortar[..., None])
    stone_tex = b.add_texture(np.clip(stone_rgb, 0, 1))
    # floor: checker
    yy, xx = np.mgrid[0:n, 0:n]
    check = (((xx * 8 // n) + (yy * 8 // n)) % 2).astype(np.float32)
    floor_rgb = (np.array([0.55, 0.52, 0.5], np.float32) * (0.6 + 0.4 * check)
                 [..., None] * (0.85 + 0.3 * noise)[..., None])
    floor_tex = b.add_texture(np.clip(floor_rgb, 0, 1))
    # metal-rough: roughness in G, metallic in B (closesthit.rchit:97-101)
    m = 128
    mr_noise = _value_noise(m, 23)
    mr = np.zeros((m, m, 4), np.float32)
    mr[..., 1] = 0.5 + 0.5 * mr_noise
    mr[..., 3] = 1.0
    mr_tex = b.add_texture(mr)
    # normal map from a height field (finite differences, +z up)
    hgt = _value_noise(m, 37, octaves=5)
    dx = np.roll(hgt, -1, 1) - np.roll(hgt, 1, 1)
    dy = np.roll(hgt, -1, 0) - np.roll(hgt, 1, 0)
    nrm = np.stack([-dx * 2.0, -dy * 2.0, np.ones_like(hgt)], axis=-1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    normal_tex = b.add_texture(nrm * 0.5 + 0.5)
    # banner: striped cloth with ragged alpha-cutout bottom (exercises the
    # stochastic alpha path, raygen.rgen:143-146)
    stripes = ((yy * 6 // n) % 2).astype(np.float32)
    banner = np.zeros((n, n, 4), np.float32)
    banner[..., 0] = 0.45 + 0.3 * stripes
    banner[..., 1] = 0.08 + 0.25 * stripes
    banner[..., 2] = 0.08
    frac_y = yy / n
    banner[..., 3] = np.where(frac_y + 0.35 * noise > 0.9, 0.0, 1.0)
    banner_tex = b.add_texture(banner)
    return stone_tex, floor_tex, mr_tex, normal_tex, banner_tex


def sponza_like(target_tris=262_000, seed=0, textured=False):
    """Colonnaded atrium at ~target_tris triangles (BASELINE config 5).

    Floor + walls + two rows of columns (subdivided cylinders) + a ceiling
    aperture light + scattered boxes: a closed, multi-bounce-heavy interior
    in the Crytek Sponza triangle-count class. With `textured`, the full
    texture path runs at benchmark scale: sRGB albedo + metal-rough +
    normal maps on every surface and hanging alpha-cutout banners
    (closesthit.rchit:88-112 + raygen.rgen:143-146 workload class).
    """
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    if textured:
        stone_tex, floor_tex, mr_tex, normal_tex, banner_tex = \
            _sponza_textures(b)
        stone = b.add_material(MaterialDesc(
            albedo=(1, 1, 1), albedo_tex=stone_tex, mr_tex=mr_tex,
            normal_tex=normal_tex))
        floor_m = b.add_material(MaterialDesc(
            albedo=(1, 1, 1), roughness=0.6, albedo_tex=floor_tex,
            normal_tex=normal_tex))
        fabric = b.add_material(MaterialDesc(
            albedo=(1, 1, 1), albedo_tex=banner_tex))
    else:
        stone = b.add_material(MaterialDesc(albedo=(0.55, 0.5, 0.45)))
        floor_m = b.add_material(MaterialDesc(albedo=(0.4, 0.38, 0.35),
                                              roughness=0.6))
        fabric = b.add_material(MaterialDesc(albedo=(0.5, 0.1, 0.1)))
    light = b.add_material(MaterialDesc(albedo=(1, 1, 1), emission=(12, 12, 12)))

    def add_box(lo, hi, mat, sub=1, uv_scale=0.25):
        lo = np.asarray(lo, np.float32)
        hi = np.asarray(hi, np.float32)
        # subdivided box faces
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
                # planar face UVs in world units; tangent along the a1 axis
                uvs = np.stack([uu, vv], axis=-1).reshape(-1, 2) * uv_scale
                tang = np.zeros_like(verts)
                tang[:, a1] = 1.0
                idx = []
                for ii in range(sub):
                    for jj in range(sub):
                        k = ii * (sub + 1) + jj
                        # Outward winding. Triangle [k, k+1, k+sub+2] has
                        # geometric normal -(e_a1 x e_a2), i.e. -x/-z for
                        # axes 0/2 but +y for axis 1 (the (a1, a2) pairs
                        # differ in handedness) -> use it on the LO side
                        # for axes 0/2 and the HI side for axis 1. Round-2
                        # fix: this rule was inverted, turning every box
                        # inside-out (normals into the solid), which
                        # silently killed all paths at bounce 1 (n.v <= 0
                        # zeroes the BRDF) and zeroed NEE scene-wide.
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
        verts = []
        uvs = []
        tang = []
        for y in ys:
            for j, (rx, rz) in enumerate(ring):
                verts.append([cx + rx, cy + y, cz + rz])
                uvs.append([2.0 * j / segments, y * 0.25])
                # tangent = d/dtheta direction
                tang.append([-ring[j][1] / radius, 0.0, ring[j][0] / radius])
        verts = np.array(verts, np.float32)
        idx = []
        for s in range(stacks):
            for k in range(segments):
                a = s * segments + k
                bb = s * segments + (k + 1) % segments
                c = a + segments
                dd = bb + segments
                # outward winding (t_theta x y_hat points INTO the
                # cylinder, so [a, bb, dd] was inside-out - see add_box)
                idx += [[a, dd, bb], [a, c, dd]]
        b.add_mesh(verts, np.array(idx, np.int64), mat,
                   uvs=np.array(uvs, np.float32),
                   tangents=np.array(tang, np.float32))

    # atrium shell: 24 x 10 x 12
    W, H, D = 24.0, 10.0, 12.0
    add_box([0, -0.5, 0], [W, 0, D], floor_m, sub=12)          # floor slab
    add_box([0, 0, -0.5], [W, H, 0], stone, sub=10)            # back wall
    add_box([0, 0, D], [W, H, D + 0.5], stone, sub=10)         # front wall
    add_box([-0.5, 0, 0], [0, H, D], stone, sub=8)             # left wall
    add_box([W, 0, 0], [W + 0.5, H, D], stone, sub=8)          # right wall
    # ceiling with central aperture (4 slabs)
    add_box([0, H, 0], [W, H + 0.5, 3], stone, sub=6)
    add_box([0, H, D - 3], [W, H + 0.5, D], stone, sub=6)
    add_box([0, H, 3], [6, H + 0.5, D - 3], stone, sub=6)
    add_box([W - 6, H, 3], [W, H + 0.5, D - 3], stone, sub=6)
    # light panel across the aperture
    v, i = _quad([6, H - 0.02, 3], [W - 6, H - 0.02, 3],
                 [W - 6, H - 0.02, D - 3], [6, H - 0.02, D - 3])
    b.add_mesh(v, i, light)

    # columns: two rows; tessellation tuned to reach the target tri count.
    n_cols = 12
    current = sum(len(ix) for ix in b._indices)
    remaining = max(target_tris - current - 20_000, 40_000)
    seg_budget = remaining // (n_cols * 2)  # tris per column ~= 2*seg*stacks
    segments = max(12, int(np.sqrt(seg_budget / 2 * (64 / 24))))
    stacks = max(6, seg_budget // (2 * segments))
    for r, z in ((0, 3.0), (1, D - 3.0)):
        for k in range(n_cols):
            x = W * (k + 0.5) / n_cols
            add_cylinder((x, 0, z), 0.45, H - 1.0, stone, segments, stacks)
            add_box([x - 0.6, H - 1.0, z - 0.6], [x + 0.6, H, z + 0.6],
                    stone, sub=2)

    # scattered crates + hanging fabric strips
    for _ in range(40):
        x = rng.uniform(2, W - 2)
        z = rng.uniform(1, D - 1)
        s = rng.uniform(0.3, 0.9)
        add_box([x - s, 0, z - s], [x + s, rng.uniform(0.5, 1.8), z + s],
                stone if rng.random() < 0.5 else fabric, sub=3)

    return b
