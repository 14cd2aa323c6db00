"""envmap_dragon: a dense, closed, textured mesh in the Stanford dragon's
place (871,414 triangles by default) under envmap_scene's HDR sky.

The mesh is a tube swept along a coiled space curve: two and a quarter
turns of a rising helix whose loops pass within about a tenth of a unit
of each other, a thin tail, a body, a narrow neck and a head that rises
and curls in. Its radius varies along the body (a profile and ribs, so
there are thin parts), and each vertex is pushed out along its ring's
radius by multi-octave value noise whose finest octave spans a few
triangles: concavities and self-shadowing that bunny_like's perturbed
sphere lacks. Rings hold as many vertices as their circumference asks
for, consecutive rings are joined by strips that merge the two rings by
angle, and each end is closed by a fan about a centre vertex, so the
mesh is closed and outward-facing with exactly `triangles` faces (even:
a closed mesh of one piece has 2V - 4). UVs come from the sweep: u along
the body, v around it, mirrored so there is no seam.

Placed as bunny_like(5)'s body: centred near (0, 1.2, 0), about 2.4
units across, on envmap_scene's ground quad under its ceiling light,
with the 256x256 checker on the body and the RGBE sky with a sun disc.
Vectorised numpy: no loop over faces or vertices (one over rings, for
the frames).
"""

from __future__ import annotations

import numpy as np

from ptbench.scenes.procedural import SceneSpec, envmap_scene

TRIANGLES = 871_414     # Stanford dragon_vrip
MIN_RING = 8            # vertices of the thinnest ring
TURNS = 2.25            # turns of the coil
CURVE_SAMPLES = 20_000  # samples of the centre line before resampling
# radius profile along the body (arc-length fraction -> share of R_MAX):
# tail, body, neck, head, snout
PROFILE_S = (0.0, 0.08, 0.3, 0.7, 0.85, 0.93, 1.0)
PROFILE_R = (0.1, 0.35, 1.0, 0.95, 0.5, 0.75, 0.25)
R_MAX = 0.25
RIBS = 60               # thick-thin cycles along the body
RIB_DEPTH = 0.12
NOISE_DEPTH = 0.14      # displacement, a share of the local radius
NOISE_WAVELENGTHS = (0.32, 0.16, 0.08, 0.04, 0.02)
NOISE_GAIN = 0.6        # amplitude ratio of successive octaves


def centre_line(s):
    """Points [N, 3] of the coil at parameter s in [0, 1]."""
    theta = 2.0 * np.pi * TURNS * s
    head = np.clip((s - 0.85) / 0.15, 0.0, 1.0) ** 2
    radius = 1.05 - 0.4 * s + 0.05 * np.sin(6.0 * np.pi * s) - 0.3 * head
    y = 0.12 + 1.5 * s + 0.5 * head
    return np.stack([radius * np.cos(theta), y, radius * np.sin(theta)],
                    axis=-1)


def radius_at(s):
    """Tube radius along the body at arc-length fraction s."""
    base = np.interp(s, PROFILE_S, PROFILE_R)
    return R_MAX * base * (1.0 + RIB_DEPTH * np.sin(2.0 * np.pi * RIBS * s))


def _frames(points):
    """Unit tangents and rotation-minimising normals of a polyline (the
    tangent's change carried along, one ring at a time)."""
    tang = np.gradient(points, axis=0)
    tang /= np.linalg.norm(tang, axis=1, keepdims=True)
    normal = np.empty_like(tang)
    n = np.cross(tang[0], [0.0, 1.0, 0.0])
    normal[0] = n / np.linalg.norm(n)
    for i in range(1, len(points)):
        n = normal[i - 1] - tang[i] * np.dot(normal[i - 1], tang[i])
        normal[i] = n / np.linalg.norm(n)
    return tang, normal, np.cross(tang, normal)


def _hash01(ix, iy, iz, octave):
    """A value in [0, 1) for each integer lattice point (splitmix64 of
    the packed coordinates)."""
    m = np.uint64(0xFFFFF)
    x = ((ix.astype(np.uint64) & m) | ((iy.astype(np.uint64) & m) << 20)
         | ((iz.astype(np.uint64) & m) << 40)
         | (np.uint64(octave) << np.uint64(60)))
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x >> np.uint64(11)).astype(np.float64) / float(1 << 53)


def value_noise(p):
    """Multi-octave 3-D value noise in [-1, 1] at points p [N, 3]."""
    total = np.zeros(p.shape[0])
    amp, norm = 1.0, 0.0
    for octave, wavelength in enumerate(NOISE_WAVELENGTHS):
        q = p / wavelength
        base = np.floor(q)
        f = q - base
        w = f * f * (3.0 - 2.0 * f)
        i = base.astype(np.int64)
        acc = np.zeros(p.shape[0])
        for corner in range(8):
            c = [(corner >> a) & 1 for a in range(3)]
            weight = np.prod([w[:, a] if c[a] else 1.0 - w[:, a]
                              for a in range(3)], axis=0)
            acc += weight * _hash01(i[:, 0] + c[0], i[:, 1] + c[1],
                                    i[:, 2] + c[2], octave)
        total += amp * (2.0 * acc - 1.0)
        norm += amp
        amp *= NOISE_GAIN
    return total / norm


def ring_sizes(radii, total):
    """Vertices a ring, at least MIN_RING each and `total` in all, the
    rest shared in proportion to the ring's radius (largest
    remainders)."""
    spare = total - MIN_RING * radii.shape[0]
    if spare < 0:
        raise ValueError(f"{total} ring vertices cannot make "
                         f"{radii.shape[0]} rings of {MIN_RING}")
    share = radii / radii.sum() * spare
    extra = np.floor(share).astype(np.int64)
    left = spare - int(extra.sum())
    extra[np.argsort(-(share - extra), kind="stable")[:left]] += 1
    return MIN_RING + extra


def _strips(sizes, offsets):
    """Faces [F, 3] joining each ring to the next: ring a's and ring b's
    vertices are walked by angle together, each step advancing one ring
    and making one triangle (sizes[i] + sizes[i + 1] a strip)."""
    na, nb = sizes[:-1], sizes[1:]
    strip = np.arange(na.shape[0])

    def events(n, strip_ids):
        sid = np.repeat(strip_ids, n)
        start = np.repeat(np.cumsum(n) - n, n)
        j = np.arange(sid.shape[0]) - start
        return sid, j

    sa, ja = events(na, strip)
    sb, jb = events(nb, strip)
    sid = np.concatenate([sa, sb])
    step = np.concatenate([ja, jb])
    is_b = np.concatenate([np.zeros(sa.shape[0], bool),
                           np.ones(sb.shape[0], bool)])
    # advance times (j + 1) / n: equal fractions round to one double, so
    # ties fall to ring a first
    time = (step + 1) / np.where(is_b, nb[sid], na[sid])
    order = np.lexsort((is_b, time, sid))
    sid, is_b = sid[order], is_b[order]
    group = np.cumsum(na + nb) - (na + nb)
    ca = np.cumsum(~is_b) - ~is_b
    cb = np.cumsum(is_b) - is_b
    ja = ca - ca[group][sid]          # ring-a steps taken before this one
    jb = cb - cb[group][sid]
    a0, b0 = offsets[:-1][sid], offsets[1:][sid]
    n_a, n_b = na[sid], nb[sid]
    a_here = a0 + ja % n_a
    b_here = b0 + jb % n_b
    third = np.where(is_b, b0 + (jb + 1) % n_b, a0 + (ja + 1) % n_a)
    # outward (the rings run counter-clockwise about the tangent):
    # (a_j, a_j+1, b_k) and (a_j, b_k+1, b_k)
    return np.stack([a_here, third, b_here], 1)


def mesh(triangles=TRIANGLES):
    """(positions f32 [V, 3], faces i64 [triangles, 3], uvs f32 [V, 2])
    of the swept tube; V = triangles / 2 + 2."""
    if triangles % 2 or triangles < 4 * MIN_RING:
        raise ValueError(f"triangles={triangles}: a closed tube needs an "
                         f"even count of at least {4 * MIN_RING}")
    ring_total = triangles // 2
    # the centre line resampled at equal arc length
    s = np.linspace(0.0, 1.0, CURVE_SAMPLES)
    pts = centre_line(s)
    arc = np.concatenate([[0.0], np.cumsum(
        np.linalg.norm(np.diff(pts, axis=0), axis=1))])
    length = arc[-1]
    mean_r = radius_at(arc / length).mean()
    # near-square cells: ring spacing h, and 2 pi r / h vertices a ring
    h = np.sqrt(2.0 * np.pi * mean_r * length / ring_total)
    rings = int(np.clip(round(length / h), 3, ring_total // MIN_RING))
    a = np.linspace(0.0, 1.0, rings)
    centre = np.stack([np.interp(a * length, arc, pts[:, k])
                       for k in range(3)], axis=1)
    radii = radius_at(a)
    sizes = ring_sizes(radii, ring_total)
    tang, normal, binormal = _frames(centre)

    ring = np.repeat(np.arange(rings), sizes)
    offsets = np.cumsum(sizes) - sizes
    k = np.arange(ring_total) - offsets[ring]
    phi = 2.0 * np.pi * k / sizes[ring]
    radial = (normal[ring] * np.cos(phi)[:, None]
              + binormal[ring] * np.sin(phi)[:, None])
    smooth = centre[ring] + radial * radii[ring, None]
    bump = 1.0 + NOISE_DEPTH * value_noise(smooth)
    side = centre[ring] + radial * (radii[ring] * bump)[:, None]
    # end caps: a centre vertex half a radius past each end ring
    ends = np.stack([centre[0] - tang[0] * 0.5 * radii[0],
                     centre[-1] + tang[-1] * 0.5 * radii[-1]])
    positions = np.concatenate([side, ends]).astype(np.float32)
    v = 1.0 - np.abs(2.0 * k / sizes[ring] - 1.0)
    uvs = np.concatenate([np.stack([a[ring], v], 1),
                          [[0.0, 0.5], [1.0, 0.5]]]).astype(np.float32)

    faces = [_strips(sizes, offsets)]
    first = np.arange(sizes[0])
    last = offsets[-1] + np.arange(sizes[-1])
    start, end = ring_total, ring_total + 1
    faces.append(np.stack([np.full_like(first, start),
                           np.roll(first, -1), first], 1))
    faces.append(np.stack([np.full_like(last, end), last,
                           offsets[-1] + (np.arange(sizes[-1]) + 1)
                           % sizes[-1]], 1))
    return positions, np.concatenate(faces).astype(np.int64), uvs


def generate(triangles=TRIANGLES, tex_size=256, env_h=512,
             env_w=1024) -> SceneSpec:
    """envmap_scene with the tube in the body's place: its ground quad,
    ceiling light, checker material (roughness 0.4) and sky, in its call
    order."""
    b = envmap_scene(0, tex_size, env_h, env_w)
    positions, faces, uvs = mesh(triangles)
    b.meshes[1] = dict(b.meshes[1], positions=positions, indices=faces,
                       uvs=uvs)
    return b
