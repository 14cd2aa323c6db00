"""Wavefront path integrator (counterpart of pathtracer/integrator/path.py).

The JAX `trace_paths`: a flat SoA ray batch [N] runs through the bounce
loop with active masks. Per bounce (raygen.rgen:128-292): trace ->
emission (MIS-weighted against light sampling) and sky on misses (MIS-
weighted against env NEE) -> alpha passthrough -> dielectric branch ->
NEE to emissive triangles and to the env map, with MIS -> BSDF sample ->
Russian roulette. Bounce 0 is peeled so primary rays keep their
swizzled order (no coherence sort); the loop is a Python `for`.

Verified priming (cfg.primary_priming): per-pixel hints from the previous
sample - the primary hit triangle and the bounce-0 NEE and env-NEE shadow
blockers - are re-tested exactly against this sample's rays and never
trusted, so the estimate and the ray count do not change.

The estimator is the JAX package's default one, or with
cfg.reference_quirks the reference's exact one (path.py:301, 515, 566,
778, 913): emission not scaled by the albedo factor, the shadow ray
aimed behind the light, NEE without the emission gain, unweighted
emitter hits and the conditional-lobe BSDF pdf.
Every random number is keyed on (pixel, sample, depth, salt) by the
counter-based PCG4D (sampling/rng.py). The ray counter is exact: path
rays traced plus NEE visibility queries resolved (int64).

On CUDA tensors each bounce's shading - everything between its
closest-hit call and its shadow queries, and the NEE terms after them -
is one hand-written kernel, K10 (integrator/shade.py, csrc/shade.cu),
except for the variants shade.kernel_shades leaves to the plain chain
here; CPU tensors always take the plain chain. The two agree on every
discrete choice and the ray count, and on floats to a few ulps.
tracing.COUNTERS counts the bounces each shaded ("shade_kernel",
"shade_plain").

cfg.wavefront_sort re-orders the carried state once per bounce after
bounce 0 (_wavefront_order: dead lanes last, then direction octant and
origin Morton), with the pixel and sample ids riding along; radiance
comes back in the last bounce's order beside those pixel ids.
cfg.skip_nee drops both NEE stages (a cost-attribution knob: a
different estimator).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from pathtracer_torch import tracing
from pathtracer_torch.accel import morton as morton_mod
from pathtracer_torch.bsdf import microfacet as mf
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.integrator import shade as shade_mod
from pathtracer_torch.integrator import sky as sky_mod
from pathtracer_torch.kernels import intersect as isect
from pathtracer_torch.sampling import rng
from pathtracer_torch.scene import envlight
from pathtracer_torch.scene.types import MAT_DIELECTRIC, Scene
from pathtracer_torch.utils import vmath


class Surface(NamedTuple):
    """Interpolated + textured shading point (HitPayload, common.glsl:9-21)."""

    position: torch.Tensor     # [N,3]
    normal: torch.Tensor       # [N,3] shading normal (normal-mapped)
    geom_normal: torch.Tensor  # [N,3]
    albedo: torch.Tensor       # [N,3] linear
    emission: torch.Tensor     # [N,3]
    roughness: torch.Tensor    # [N]
    metallic: torch.Tensor     # [N]
    ior: torch.Tensor          # [N]
    alpha: torch.Tensor        # [N]
    mat_type: torch.Tensor     # [N] int
    light_pdf_area: torch.Tensor  # [N]


def _floor_int(x):
    return torch.floor(x).to(torch.int64)


def _sample_texture(textures, tex_wh, tex_id, u, v, tex_u=None):
    """Bilinear repeat-wrap fetch from the u8 stack (texture.cpp:57-66).

    tex_u = (ux, uy) selects the stochastic filter: jitter the texel
    coordinate by the uniforms and take ONE nearest tap, whose
    expectation is the bilinear blend. Wrapping is floor-mod
    (torch.remainder), as jnp.mod.
    """
    tid = tex_id.clamp(min=0).long()
    wh = tex_wh.long()[tid]
    twi = wh[:, 0]
    thi = wh[:, 1]
    x = u * twi.to(torch.float32) - 0.5
    y = v * thi.to(torch.float32) - 0.5

    def texel(yy, xx):
        return textures[tid, yy, xx].to(torch.float32) * (1.0 / 255.0)

    if tex_u is not None:
        ux, uy = tex_u
        xi = torch.remainder(_floor_int(x + ux), twi)
        yi = torch.remainder(_floor_int(y + uy), thi)
        return texel(yi, xi)

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), twi)
    y0i = torch.remainder(y0.to(torch.int64), thi)
    x1i = torch.remainder(x0i + 1, twi)
    y1i = torch.remainder(y0i + 1, thi)
    a = texel(y0i, x0i) * (1 - fx) + texel(y0i, x1i) * fx
    b = texel(y1i, x0i) * (1 - fx) + texel(y1i, x1i) * fx
    return a * (1 - fy) + b * fy


def _pad_cols(rows):
    pad = (-rows.shape[1]) % 8
    if pad:
        rows = torch.cat([rows, rows.new_zeros((rows.shape[0], pad))], dim=1)
    return rows


def pack_material_rows(scene: Scene):
    """Per-material properties as one f32 [M, 16] row (ints as value + 1)."""
    f = lambda a: (a.to(torch.int64) + 1).to(torch.float32)[:, None]  # noqa
    return _pad_cols(torch.cat(
        [scene.mat_albedo, scene.mat_emission,
         scene.mat_roughness[:, None], scene.mat_metallic[:, None],
         scene.mat_ior[:, None], scene.mat_alpha[:, None],
         f(scene.mat_type), f(scene.mat_albedo_tex), f(scene.mat_mr_tex),
         f(scene.mat_normal_tex)], dim=1))


def pack_surface_rows(scene: Scene):
    """Per-triangle shading attributes as one f32 row.

    n0 n1 n2 (9) | uv0 uv1 uv2 (6) | geom_normal (3) | mid + 1 (1) |
    light_pdf_area (1) | [tangents t0 t1 t2 (9)] | pad to 8.
    """
    idx = scene.indices.long()
    i0, i1, i2 = idx[:, 0], idx[:, 1], idx[:, 2]
    p0, p1, p2 = (scene.positions[i] for i in (i0, i1, i2))
    gn = vmath.normalize(vmath.cross(p1 - p0, p2 - p0))
    mid_val = (scene.face_material.to(torch.int64) + 1).to(torch.float32)
    cols = [scene.normals[i0], scene.normals[i1], scene.normals[i2],
            scene.uvs[i0], scene.uvs[i1], scene.uvs[i2],
            gn, mid_val[:, None], scene.tri_light_pdf_area[:, None]]
    if scene.has_textures:
        cols += [scene.tangents[i0], scene.tangents[i1], scene.tangents[i2]]
    return _pad_cols(torch.cat(cols, dim=1))


def _normal_map(row, w0, w1, w2, normal, nm, ntex):
    """Tangent-space normal map via Gram-Schmidt TBN (closesthit.rchit:104-112)."""
    t0, t1, t2 = row[:, 20:23], row[:, 23:26], row[:, 26:29]
    tangent = vmath.normalize(t0 * w0 + t1 * w1 + t2 * w2)
    t_ortho = vmath.normalize(tangent - normal * vmath.dotk(normal, tangent))
    b = vmath.cross(normal, t_ortho)
    mapped = vmath.normalize(t_ortho * nm[..., 0:1] + b * nm[..., 1:2]
                             + normal * nm[..., 2:3])
    return torch.where((ntex >= 0)[..., None], mapped, normal)


def fetch_surface(scene: Scene, surf_rows, hit, o, d, tex_u, mat_rows,
                  quirks: bool = False) -> Surface:
    """Closest-hit stage (closesthit.rchit:68-125) as one wide row gather.

    Miss lanes gather triangle 0; callers mask them out. quirks
    (cfg.reference_quirks): the emission is the material's as it stands
    (closesthit.rchit:116), not scaled by the albedo factor as the light
    list's Le is (main.cpp:282-284).
    """
    tri = hit.tri.clamp(min=0).long()
    row = surf_rows[tri]
    w1 = hit.u[..., None]
    w2 = hit.v[..., None]
    w0 = 1.0 - w1 - w2
    t_safe = torch.where(torch.isfinite(hit.t), hit.t, 1.0)[..., None]
    position = o + d * t_safe
    normal = vmath.normalize(row[:, 0:3] * w0 + row[:, 3:6] * w1
                             + row[:, 6:9] * w2)
    uv = row[:, 9:11] * w0 + row[:, 11:13] * w1 + row[:, 13:15] * w2
    geom_normal = row[:, 15:18]
    mid = torch.round(row[:, 18]).to(torch.int64) - 1
    mrow = mat_rows[mid]
    albedo = mrow[:, 0:3]
    emission = mrow[:, 3:6]
    roughness = mrow[:, 6]
    metallic = mrow[:, 7]
    ior = mrow[:, 8]
    alpha = mrow[:, 9]
    mat_type = torch.round(mrow[:, 10]).to(torch.int64) - 1
    atex = torch.round(mrow[:, 11]).to(torch.int64) - 1
    mrtex = torch.round(mrow[:, 12]).to(torch.int64) - 1
    ntex = torch.round(mrow[:, 13]).to(torch.int64) - 1
    albedo_factor = albedo

    if scene.has_textures and tex_u is not None \
            and scene.tex_comp is not None:
        # composite path: one gather of three packed u32 texels
        u, v = uv[..., 0], uv[..., 1]
        wh = scene.tex_comp_wh.long()[mid]
        twi = wh[:, 0]
        thi = wh[:, 1]
        ux, uy = tex_u
        x = u * twi.to(torch.float32) - 0.5
        y = v * thi.to(torch.float32) - 0.5
        xi = torch.remainder(_floor_int(x + ux), twi)
        yi = torch.remainder(_floor_int(y + uy), thi)
        rows = scene.tex_comp[mid, yi, xi]               # [N, 3] u32 words

        def unpack(p):
            return [((p >> (8 * i)) & 0xFF).to(torch.float32) * (1.0 / 255.0)
                    for i in range(4)]

        ar, ag, ab_, aa = unpack(rows[:, 0])
        has_at = atex >= 0
        tex_rgb = torch.stack([ar, ag, ab_], dim=1)
        albedo = torch.where(has_at[..., None], tex_rgb ** 2.2, albedo)
        alpha = torch.where(has_at, alpha * aa, alpha)
        _, mg, mb, _ = unpack(rows[:, 1])
        has_mr = mrtex >= 0
        roughness = torch.where(has_mr, roughness * mg, roughness)
        metallic = torch.where(has_mr, metallic * mb, metallic)
        nr, ng, nb2, _ = unpack(rows[:, 2])
        nm = torch.stack([nr, ng, nb2], dim=1) * 2.0 - 1.0
        normal = _normal_map(row, w0, w1, w2, normal, nm, ntex)
    elif scene.has_textures:
        u, v = uv[..., 0], uv[..., 1]
        tex = _sample_texture(scene.textures, scene.tex_wh, atex, u, v,
                              tex_u)
        has_at = atex >= 0
        albedo = torch.where(has_at[..., None],
                             torch.clamp(tex[..., :3], min=0.0) ** 2.2,
                             albedo)
        alpha = torch.where(has_at, alpha * tex[..., 3], alpha)
        mr = _sample_texture(scene.textures, scene.tex_wh, mrtex, u, v,
                             tex_u)
        has_mr = mrtex >= 0
        roughness = torch.where(has_mr, roughness * mr[..., 1], roughness)
        metallic = torch.where(has_mr, metallic * mr[..., 2], metallic)
        nm = _sample_texture(scene.textures, scene.tex_wh, ntex, u, v,
                             tex_u)[..., :3] * 2.0 - 1.0
        normal = _normal_map(row, w0, w1, w2, normal, nm, ntex)

    return Surface(
        position=position, normal=normal, geom_normal=geom_normal,
        albedo=albedo,
        emission=emission if quirks else emission * albedo_factor,
        roughness=torch.clamp(roughness, 0.01, 1.0),
        metallic=torch.clamp(metallic, 0.0, 1.0), ior=ior,
        alpha=torch.clamp(alpha, 0.0, 1.0), mat_type=mat_type,
        light_pdf_area=row[:, 19])


def _power_heuristic(pdf_a, pdf_b):
    """Power heuristic beta=2 (raygen.rgen:247)."""
    a2 = pdf_a * pdf_a
    return a2 / torch.clamp(a2 + pdf_b * pdf_b, min=1e-20)


def _verify_blocker(prime_blk, hint_fn, s_orig, s_dir, s_tmax, valid,
                    occluded_fn, primary):
    """Shadow query through a blocker hint (path.py:526-552).

    The hinted triangle is re-tested against THIS segment by hint_fn, the
    intersector's own arithmetic, under the traversal's policy
    (front-facing, 0 < t < s_tmax), so a hint verifies exactly where the
    traversal would find that triangle blocking; a verified block is
    conclusive and the lane parks out of the traversal. Failed hints are
    kept (a new light sample may re-verify them); the traversal's own
    blocker replaces a hint where it finds one. Returns (blocked,
    new_blk).
    """
    _, _, _, okb = hint_fn(prime_blk, s_orig, s_dir, 0.0, s_tmax,
                           front_only=True)
    ver = okb & (prime_blk >= 0) & valid
    need = valid & ~ver
    o_t = torch.where(need[..., None], s_orig, 1e30)     # park resolved
    d_t = torch.where(need[..., None], s_dir, 1.0)
    blocked_tr, btri = occluded_fn(o_t, d_t, s_tmax, primary=primary,
                                   want_blocker=True)
    new_blk = torch.where(need & blocked_tr, btri, prime_blk)
    return ver | blocked_tr, new_blk


def _nee(scene: Scene, cfg: RenderConfig, surf: Surface, view, pixel,
         sample, depth, occluded_fn, shade, primary=False, prime_blk=None,
         hint_fn=None):
    """Next-event estimation to emissive triangles (raygen.rgen:168-261).

    Returns contrib/T [N,3]; with prime_blk (i32[N] blocker hints, -1 =
    none) and hint_fn, (contrib, new_blk) with this sample's hints.
    """
    u_sel = rng.uniform1(pixel, sample, depth, rng.SALT_LIGHT_SELECT,
                         cfg.seed, cfg.sampler)
    n_l = scene.light_cdf.shape[0]
    li = torch.searchsorted(scene.light_cdf, u_sel.contiguous(), right=False) \
        .clamp(0, n_l - 1)
    v0 = scene.light_v0[li]
    v1 = scene.light_v1[li]
    v2 = scene.light_v2[li]
    light_n = scene.light_normal[li]
    le = scene.light_emission[li]
    area = scene.light_area[li]
    p_tri = scene.light_pdf[li]

    r1, r2 = rng.uniform2(pixel, sample, depth, rng.SALT_LIGHT_UV, cfg.seed,
                          cfg.sampler)
    sr1 = torch.sqrt(r1)
    b0 = (1.0 - sr1)[..., None]
    b1 = (r2 * sr1)[..., None]
    p_on_light = v0 * b0 + v1 * b1 + v2 * (1.0 - b0 - b1)
    p_a = p_tri / torch.clamp(area, min=vmath.EPS)

    to_light = p_on_light - surf.position
    dist2 = torch.clamp(vmath.dot(to_light, to_light), min=vmath.EPS)
    l_dir = to_light * torch.rsqrt(dist2)[..., None]
    n_dot_l = torch.clamp(vmath.dot(surf.normal, l_dir), min=0.0)
    nl_dot = torch.clamp(vmath.dot(light_n, -l_dir), min=0.0)
    geo_ok = (n_dot_l > 0.0) & (nl_dot > 0.0)

    # shadow ray: origin offset along the shading normal, aimed at the
    # sampled point, t_max pulled back by a relative margin. The
    # reference's scheme (reference_quirks, raygen.rgen:199-204) aims
    # behind the emitter with t_max = dist - eps, so off-axis receivers
    # can self-occlude on the emitter.
    eps = cfg.shadow_eps
    s_orig = surf.position + surf.normal * eps
    if cfg.reference_quirks:
        s_dir = vmath.normalize(p_on_light - light_n * eps - s_orig)
        s_tmax = torch.clamp(torch.sqrt(dist2) - eps, min=0.0)
    else:
        seg = p_on_light - s_orig
        seg_len = torch.sqrt(torch.clamp(vmath.dot(seg, seg), min=1e-20))
        s_dir = seg / seg_len[..., None]
        s_tmax = seg_len * (1.0 - 1e-3)
    valid = geo_ok & shade
    new_blk = None
    if prime_blk is not None:
        blocked, new_blk = _verify_blocker(prime_blk, hint_fn, s_orig,
                                           s_dir, s_tmax, valid,
                                           occluded_fn, primary)
    else:
        s_orig = torch.where(valid[..., None], s_orig, 1e30)   # park dead
        s_dir = torch.where(valid[..., None], s_dir, 1.0)
        blocked = occluded_fn(s_orig, s_dir, s_tmax, primary=primary)

    f = mf.eval_brdf(surf.normal, view, l_dir, surf.albedo, surf.metallic,
                     surf.roughness)
    p_omega_light = p_a * dist2 / torch.clamp(nl_dot, min=vmath.EPS)
    pdf_b = mf.pdf_bsdf(surf.normal, view, l_dir, surf.metallic,
                        surf.roughness)
    w = _power_heuristic(p_omega_light, pdf_b)
    g = n_dot_l * nl_dot / dist2
    gain = 1.0 if cfg.reference_quirks else cfg.emission_gain
    contrib = f * (le * gain) \
        * (g / torch.clamp(p_a, min=1e-12))[..., None] * w[..., None]
    out = torch.where((geo_ok & ~blocked)[..., None], contrib, 0.0)
    return (out, new_blk) if prime_blk is not None else out


def _env_sample(scene: Scene, u):
    """Env-NEE direction, pdf and radiance from four uniforms u [M, 4]."""
    l_dir, _, _ = envlight.sample_env(
        scene.env_marginal_cdf, scene.env_cond_cdf,
        u[..., 0], u[..., 1], u[..., 2], u[..., 3])
    p_env = envlight.env_pdf(scene.env_pdf, l_dir)
    le = sky_mod.envmap_radiance(scene.envmap, l_dir)
    return l_dir, p_env, le


def _env_table(scene: Scene, cfg: RenderConfig, sample, depth,
               sample_window: int):
    """The env-NEE draws of every (screen cell, sample) with
    cfg.env_nee_cell > 1: (table f32[n_cells * S, 7] of l_dir | p_env |
    le, s0), rows cell-major, S = max(1, sample_window) sample ids from
    s0 = min(sample), an int64 scalar kept on the device."""
    cell = cfg.env_nee_cell
    n_cells = -(-cfg.width // cell) * -(-cfg.height // cell)
    s_win = max(1, sample_window)
    s0 = sample.long().min()
    dev = sample.device
    grid = (n_cells, s_win)
    ck = torch.arange(n_cells, device=dev)[:, None].expand(grid).reshape(-1)
    sk = torch.arange(s_win, device=dev)[None, :].expand(grid).reshape(-1) \
        + s0
    u = rng.uniform4(ck, sk, depth, rng.SALT_ENV_SELECT, cfg.seed,
                     cfg.sampler)
    l_dir, p_env, le = _env_sample(scene, u)
    return torch.cat([l_dir, p_env[:, None], le], dim=1), s0


def _env_draw(scene: Scene, cfg: RenderConfig, pixel, sample, depth,
              sample_window: int):
    """Env-NEE direction, pdf and radiance per lane (path.py:349-401).

    With cfg.env_nee_cell = c > 1 the draw is keyed on the pixel's c x c
    screen cell instead of the pixel, so a cell's lanes share one
    direction per (sample, depth): the sampling runs once per (cell,
    sample) on _env_table's rows (S = sample_window, the wavefront's
    sample-id window starting at s0 = min(sample)) and reaches the lanes
    through one row gather - bit-identical to per-lane draws keyed on
    the cell. s0 stays on the device (no host sync).
    """
    cell = cfg.env_nee_cell
    if cell > 1:
        table, s0 = _env_table(scene, cfg, sample, depth, sample_window)
        pix = pixel.long()
        cells_x = -(-cfg.width // cell)
        cell_id = (torch.div(pix, cfg.width, rounding_mode="floor") // cell
                   * cells_x + torch.remainder(pix, cfg.width) // cell)
        s_win = max(1, sample_window)
        slot = torch.clamp(sample.long() - s0, max=s_win - 1)
        rows = table[cell_id * s_win + slot]
        return rows[:, 0:3], rows[:, 3], rows[:, 4:7]
    u = rng.uniform4(pixel, sample, depth, rng.SALT_ENV_SELECT, cfg.seed,
                     cfg.sampler)
    return _env_sample(scene, u)


def _nee_env(scene: Scene, cfg: RenderConfig, surf: Surface, view, pixel,
             sample, depth, occluded_fn, shade, throughput,
             sample_window: int = 1, primary=False, prime_blk=None,
             hint_fn=None):
    """Env-map NEE with MIS (path.py:328-456): one shadow ray toward a
    luminance-importance-sampled env direction.

    Returns (contrib/T [N,3], traced bool[N]); with prime_blk,
    (contrib, new_blk, traced). With cfg.env_shadow_rr = m > 0 the
    query is traced with probability q = clip(m * lum(T), 1/8, 1) and
    survivors are weighted 1/q (unbiased); `traced` marks the lanes that
    resolved a visibility query, which is what the exact ray counter adds.
    """
    l_dir, p_env, le = _env_draw(scene, cfg, pixel, sample, depth,
                                 sample_window)
    n_dot_l = torch.clamp(vmath.dot(surf.normal, l_dir), min=0.0)
    ok = (n_dot_l > 0.0) & (p_env > 0.0)

    s_orig = surf.position + surf.normal * cfg.shadow_eps
    valid = ok & shade
    inv_q = 1.0
    if cfg.env_shadow_rr > 0.0:
        # Rec.709 luminance, the measure the env CDF importance uses
        lum_t = (0.2126 * throughput[..., 0] + 0.7152 * throughput[..., 1]
                 + 0.0722 * throughput[..., 2])
        q = torch.clamp(cfg.env_shadow_rr * lum_t, 0.125, 1.0)
        u_rr = rng.uniform1(pixel, sample, depth, rng.SALT_ENV_RR,
                            cfg.seed, cfg.sampler)
        valid = valid & (u_rr < q)
        inv_q = 1.0 / q
    traced = valid
    s_tmax = torch.full(l_dir.shape[:-1], 1e18, dtype=torch.float32,
                        device=l_dir.device)
    new_blk = None
    if prime_blk is not None:
        blocked, new_blk = _verify_blocker(prime_blk, hint_fn, s_orig,
                                           l_dir, s_tmax, valid,
                                           occluded_fn, primary)
    else:
        s_orig = torch.where(valid[..., None], s_orig, 1e30)   # park dead
        l_dir_eff = torch.where(valid[..., None], l_dir, 1.0)
        blocked = occluded_fn(s_orig, l_dir_eff, s_tmax)

    f = mf.eval_brdf(surf.normal, view, l_dir, surf.albedo, surf.metallic,
                     surf.roughness)
    pdf_b = mf.pdf_bsdf(surf.normal, view, l_dir, surf.metallic,
                        surf.roughness)
    w = _power_heuristic(p_env, pdf_b)
    contrib = f * le * (n_dot_l * w * inv_q
                        / torch.clamp(p_env, min=1e-12))[..., None]
    # an RR-skipped lane resolved no query and contributes 0 (its
    # expectation rides in the survivors' 1/q weight)
    out = torch.where((traced & ~blocked)[..., None], contrib, 0.0)
    return (out, new_blk, traced) if prime_blk is not None \
        else (out, traced)


def _wavefront_order(scene: Scene, o, d, active):
    """Compaction + coherence permutation for one bounce (path.py:574):
    key = (dead?, direction octant, origin Morton over the scene's vertex
    box); stable, so lanes with equal keys keep their order."""
    lo = scene.positions.amin(dim=0)
    hi = scene.positions.amax(dim=0)
    octant = ((d[:, 0] > 0).to(torch.int64)
              + 2 * (d[:, 1] > 0).to(torch.int64)
              + 4 * (d[:, 2] > 0).to(torch.int64))
    m = morton_mod.morton_codes(o, lo=lo, hi=hi)      # 30-bit
    key = torch.where(active, (octant << 27) | (m >> 3), 0xFFFFFFFF)
    return torch.sort(key, stable=True).indices


def trace_paths(scene: Scene, cfg: RenderConfig, origins, directions,
                pixel_ids, sample_ids, intersect_fn: Callable,
                occluded_fn: Callable, prime=None, local_pix=None,
                sample_window: int = 0, hint_fn: Callable = None,
                want_gbuffer: bool = False, n_pixels: int = None):
    """Trace a batch of paths to completion.

    Returns (radiance f32[N,3], pixel ids [N], rays_traced int64 scalar,
    prime_out, gbuf): radiance lane i belongs to pixel id i of the
    second result. Lanes stay in input order unless cfg.wavefront_sort
    re-orders them (once per bounce after bounce 0); callers scatter by
    the returned pixel ids. With cfg.clamp_radiance > 0 each
    lane's radiance is clamped to it (the firefly clamp, path.py:997-1002).
    intersect_fn(o, d, t_min, t_max, primary=False) -> Hit, t_max a
        scalar or per-ray [N]
    occluded_fn(o, d, t_max, primary=False, want_blocker=False) -> bool[N]
        or, with want_blocker, (bool[N], blocker i32[N])

    prime: optional i32[P, 3] per-pixel hint rows (-1 = none), verified
    and never trusted (path.py:619-627): [:, 0] the primary hit triangle,
    re-tested by hint_fn, whose hit distance becomes the per-ray t_max of
    the primary traversal; [:, 1] / [:, 2] the bounce-0 NEE / env-NEE
    shadow blockers. prime_out holds this sample's hints in the same
    layout (None without prime). With several lanes per pixel (spp-
    batched wavefronts) a pixel keeps the largest of its lanes' hints
    (an order-free reduction, so a frame's hints do not depend on the
    scatter's order); any would do, because every hint is re-verified.
    local_pix: per-lane row of `prime` (default: pixel_ids).
    sample_window: distinct sample ids in the wavefront (sizes the
    env-NEE table; default spp * frame_batch).
    hint_fn(tri, o, d, t_min, t_max, front_only=False) -> (t, u, v, ok):
    the intersector's own ray-triangle test (render.make_intersectors),
    for primary hits and (front_only) shadow blockers alike; default
    Moller-Trumbore (intersect.hint_test).
    want_gbuffer: gbuf is the primary-hit G-buffer {normal f32[P, 3],
    depth f32[P], albedo f32[P, 3]} over n_pixels rows (default N) indexed
    like `prime` (path.py:808-831); sky rows hold depth inf, normal 0,
    albedo 1. Each row is written whole from ONE lane, the first of its
    row in lane order (in sample-major pools its lowest sample id), so a
    row's features always come from one sample and the winner does not
    depend on a scatter's order. gbuf is None without want_gbuffer or at
    max_depth 1.
    """
    n = origins.shape[0]
    dev = origins.device
    gain = cfg.emission_gain
    surf_rows = pack_surface_rows(scene)
    mat_rows = pack_material_rows(scene)
    use_tex_u = scene.has_textures and cfg.stochastic_texture_filtering
    sample_window = sample_window or max(1, cfg.spp * cfg.frame_batch)
    env_nee = (cfg.env_importance_sampling and cfg.sky == "envmap"
               and scene.has_envmap)
    rows_of = (pixel_ids if local_pix is None else local_pix).long()
    prime_out = None
    gbuf = {}
    if prime is not None:
        if hint_fn is None:
            hint_fn = isect.hint_test(*scene.tri_vertices(
                torch.arange(scene.n_tris, device=dev)))
        prime_out = torch.full_like(prime, -1)

    def record(col, values):
        prime_out[:, col].scatter_reduce_(0, rows_of, values, "amax")

    def trace(state, depth, primary=False):
        """The closest-hit call shared by every bounce -> (state, hit)."""
        if cfg.wavefront_sort and not primary:
            # bounce 0 keeps its swizzled pixel-block order; later ones
            # re-order every carried lane (path.py:655-675)
            order = _wavefront_order(scene, state[0], state[1], state[4])
            state = tuple(x[order] for x in state[:-1]) + state[-1:]
        o, d, active = state[0], state[1], state[4]
        o_eff = torch.where(active[..., None], o, 1e30)
        d_eff = torch.where(active[..., None], d, 1.0)
        if primary and prime is not None:
            # verified hit prediction (path.py:716-748): the hinted
            # triangle's hit distance bounds the traversal per ray, so
            # K1/K2 only visit clusters in front of it. The bound is the
            # next float above it: a triangle at exactly the same t (a
            # coplanar neighbour hit on their shared edge) is then chosen
            # by the traversal's own order, as without the hint. The
            # prediction stands where the traversal finds nothing.
            pt = prime[rows_of, 0]
            tp, up, vp, okp = hint_fn(pt, o_eff, d_eff, cfg.t_min,
                                      cfg.t_max)
            okp = okp & (pt >= 0)
            tp = torch.where(okp, tp, torch.inf)
            bound = torch.nextafter(tp, torch.full_like(tp, torch.inf))
            hit = intersect_fn(o_eff, d_eff, cfg.t_min,
                               torch.clamp(bound, max=cfg.t_max),
                               primary=primary)
            use_p = okp & ~hit.valid
            hit = isect.Hit(t=torch.where(use_p, tp, hit.t),
                            tri=torch.where(use_p, pt, hit.tri),
                            u=torch.where(use_p, up, hit.u),
                            v=torch.where(use_p, vp, hit.v))
            record(0, torch.where(hit.valid & active, hit.tri, -1))
        else:
            hit = intersect_fn(o_eff, d_eff, cfg.t_min, cfg.t_max,
                               primary=primary)
        return state, hit

    def segment(state, hit, depth):
        """Sky and emission collection shared by every bounce (the plain
        chain; K10 does the same in shade.Shader)."""
        o, d, throughput, radiance, active, prev_pdf, pix, samp, rays = state
        rays = rays + active.sum()
        hit_ok = hit.valid & active
        missed = active & ~hit.valid
        sky_rad = sky_mod.sky_radiance(cfg, d, scene.envmap,
                                       scene.envmap_blocks)
        if env_nee:
            # MIS against the env NEE strategy (delta segments weight 1)
            p_env = envlight.env_pdf(scene.env_pdf, d)
            w_sky = torch.where(torch.isinf(prev_pdf), 1.0,
                                _power_heuristic(prev_pdf, p_env))
            sky_rad = sky_rad * w_sky[..., None]
        radiance = radiance + torch.where(missed[..., None],
                                          throughput * sky_rad, 0.0)
        active = hit_ok
        tex_u = (rng.uniform2(pix, samp, depth, rng.SALT_TEX_FILTER,
                              cfg.seed, cfg.sampler) if use_tex_u else None)
        surf = fetch_surface(scene, surf_rows, hit, o, d, tex_u, mat_rows,
                             cfg.reference_quirks)
        # emitter hit, MIS-weighted against light sampling (unweighted
        # under reference_quirks: the reference double-counts)
        if cfg.reference_quirks:
            w_emit = torch.ones((n,), dtype=torch.float32, device=dev)
        else:
            cos_l = torch.clamp(vmath.dot(surf.geom_normal, -d), min=0.0)
            pdf_light = surf.light_pdf_area * hit.t * hit.t \
                / torch.clamp(cos_l, min=vmath.EPS)
            is_delta = torch.isinf(prev_pdf)
            w_emit = torch.where(is_delta | (surf.light_pdf_area <= 0.0),
                                 1.0, _power_heuristic(prev_pdf, pdf_light))
        radiance = radiance + torch.where(
            hit_ok[..., None],
            throughput * surf.emission * gain * w_emit[..., None], 0.0)
        return (o, d, throughput, radiance, active, prev_pdf, pix, samp,
                rays), surf

    def kernel_shades(primary, gbuffer=False):
        """Does K10 shade this bounce? (shade.kernel_shades; counted)"""
        primed = primary and prime is not None
        use = shader is not None and shade_mod.kernel_shades(
            dev, cfg, primed, gbuffer)
        tracing.COUNTERS["shade_kernel" if use else "shade_plain"] += 1
        return use

    def bounce(depth, state, primary=False):
        """One full bounce: trace + segment + NEE + BSDF continuation."""
        state, hit = trace(state, depth, primary)
        if kernel_shades(primary, primary and want_gbuffer):
            table = None
            if shader.env_nee and cfg.env_nee_cell > 1:
                table = _env_table(scene, cfg, state[7], depth,
                                   sample_window)
            return shader.bounce(state, hit, depth, occluded_fn, primary,
                                 table)
        state, surf = segment(state, hit, depth)
        o, d, throughput, radiance, active, prev_pdf, pix, samp, rays = state
        view = -d
        primed = primary and prime is not None
        if primary and want_gbuffer:
            gbuf.update(_gbuffer(surf, o, d, active, rows_of,
                                 n_pixels or n))

        # alpha stochastic transparency (raygen.rgen:143-146)
        u_alpha = rng.uniform1(pix, samp, depth, rng.SALT_ALPHA, cfg.seed,
                               cfg.sampler)
        passthrough = active & (surf.alpha < 0.99) & (u_alpha > surf.alpha)

        # dielectric (raygen.rgen:149-166)
        is_dielectric = active & ~passthrough \
            & (surf.mat_type == MAT_DIELECTRIC)
        cosi = vmath.dot(d, surf.normal)
        entering = cosi <= 0.0
        eta_ratio = torch.where(entering, torch.reciprocal(surf.ior),
                                surf.ior)
        n_eff = torch.where(entering[..., None], surf.normal, -surf.normal)
        refr, tir = vmath.refract(d, n_eff, eta_ratio)
        refl_prob = vmath.saturate(mf.schlick_scalar(cosi.abs(), 0.04))
        u_d = rng.uniform1(pix, samp, depth, rng.SALT_DIELECTRIC, cfg.seed,
                           cfg.sampler)
        take_refl = tir | (u_d < refl_prob)
        d_dielectric = torch.where(take_refl[..., None],
                                   vmath.reflect(d, surf.normal), refr)

        # NEE (raygen.rgen:168-261)
        shade = active & ~passthrough & ~is_dielectric
        if scene.has_lights and not cfg.skip_nee:
            if primed:
                nee, new_blk = _nee(scene, cfg, surf, view, pix, samp, depth,
                                    occluded_fn, shade, primary,
                                    prime_blk=prime[rows_of, 1],
                                    hint_fn=hint_fn)
                record(1, new_blk)
            else:
                nee = _nee(scene, cfg, surf, view, pix, samp, depth,
                           occluded_fn, shade, primary)
            radiance = radiance + torch.where(shade[..., None],
                                              throughput * nee, 0.0)
            rays = rays + shade.sum()
        if env_nee and not cfg.skip_nee:
            if primed:
                env_c, new_blk, traced = _nee_env(
                    scene, cfg, surf, view, pix, samp, depth, occluded_fn,
                    shade, throughput, sample_window, primary,
                    prime_blk=prime[rows_of, 2], hint_fn=hint_fn)
                record(2, new_blk)
            else:
                env_c, traced = _nee_env(
                    scene, cfg, surf, view, pix, samp, depth, occluded_fn,
                    shade, throughput, sample_window, primary)
            radiance = radiance + torch.where(shade[..., None],
                                              throughput * env_c, 0.0)
            rays = rays + traced.sum()   # only queries actually resolved

        # BSDF sampling (raygen.rgen:263-283)
        u_lobe = rng.uniform1(pix, samp, depth, rng.SALT_BSDF_LOBE,
                              cfg.seed, cfg.sampler)
        u1, u2 = rng.uniform2(pix, samp, depth, rng.SALT_BSDF_UV, cfg.seed,
                              cfg.sampler)
        p_spec = mf.lobe_select_prob(surf.metallic, surf.roughness)
        choose_spec = u_lobe < p_spec
        l_spec = mf.sample_ggx(surf.normal, view, surf.roughness, u1, u2)
        l_diff = mf.sample_cosine(surf.normal, u1, u2)
        l_new = torch.where(choose_spec[..., None], l_spec, l_diff)
        n_dot_l = torch.clamp(vmath.dot(surf.normal, l_new), min=0.0)
        mix_pdf = mf.pdf_bsdf(surf.normal, view, l_new, surf.metallic,
                              surf.roughness)
        if cfg.reference_quirks:
            # conditional-lobe pdf only (raygen.rgen:267-274)
            pdf = torch.where(
                choose_spec,
                torch.clamp(mf.pdf_ggx(surf.normal, view, l_new,
                                       surf.roughness), min=1e-6),
                torch.clamp(mf.pdf_cosine(n_dot_l), min=1e-6))
        else:
            pdf = mix_pdf
        f = mf.eval_brdf(surf.normal, view, l_new, surf.albedo,
                         surf.metallic, surf.roughness)
        bsdf_ok = n_dot_l > 0.0
        new_throughput = throughput * f * (n_dot_l / pdf)[..., None]

        # merge passthrough / dielectric / BSDF continuations
        new_d = torch.where(passthrough[..., None], d,
                            torch.where(is_dielectric[..., None],
                                        d_dielectric, l_new))
        new_o = surf.position + new_d * cfg.t_min
        o = torch.where(active[..., None], new_o, o)
        d = torch.where(active[..., None], new_d, d)
        throughput = torch.where(shade[..., None], new_throughput,
                                 throughput)
        prev_pdf = torch.where(shade, mix_pdf, torch.inf)
        active = active & (passthrough | is_dielectric | (shade & bsdf_ok))

        # Russian roulette (raygen.rgen:286-291)
        if depth > cfg.rr_start_depth:
            p = torch.clamp(vmath.maxc(throughput), cfg.rr_clamp_lo,
                            cfg.rr_clamp_hi)
            u_rr = rng.uniform1(pix, samp, depth, rng.SALT_RR, cfg.seed,
                                cfg.sampler)
            survive = u_rr <= p
            rr_applies = active & ~passthrough & ~is_dielectric
            active = active & (~rr_applies | survive)
            throughput = torch.where((rr_applies & survive)[..., None],
                                     throughput / p[..., None], throughput)
        active = active & (vmath.maxc(throughput) >= cfg.throughput_cutoff)
        return o, d, throughput, radiance, active, prev_pdf, pix, samp, rays

    shader = None
    if shade_mod.kernel_shades(dev, cfg):
        shader = shade_mod.Shader(scene, cfg, surf_rows, mat_rows, env_nee,
                                  sample_window, n)
        # K10 updates the state in place: no caller's tensor may be in it
        origins = origins.clone(memory_format=torch.contiguous_format)
        directions = directions.clone(memory_format=torch.contiguous_format)
        pixel_ids, sample_ids = pixel_ids.contiguous(), sample_ids.contiguous()
    state = (origins.contiguous(), directions.contiguous(),
             torch.ones((n, 3), dtype=torch.float32, device=dev),
             torch.zeros((n, 3), dtype=torch.float32, device=dev),
             torch.ones(n, dtype=torch.bool, device=dev),
             torch.full((n,), torch.inf, dtype=torch.float32, device=dev),
             pixel_ids, sample_ids,
             torch.zeros((), dtype=torch.int64, device=dev))
    if cfg.max_depth > 1:
        with tracing.span("pt.bounce", depth=0):
            state = bounce(0, state, primary=True)
        for depth in range(1, cfg.max_depth - 1):
            with tracing.span("pt.bounce", depth=depth):
                state = bounce(depth, state)
    with tracing.span("pt.bounce", depth=cfg.max_depth - 1):
        last, primary = cfg.max_depth - 1, cfg.max_depth == 1
        state, hit = trace(state, last, primary)
        if kernel_shades(primary):
            state = shader.last(state, hit, last)
        else:
            state, _ = segment(state, hit, last)
    radiance = state[3]
    if cfg.clamp_radiance > 0.0:
        radiance = torch.clamp(radiance, max=cfg.clamp_radiance)
    return radiance, state[6], state[8], prime_out, (gbuf or None)


def _gbuffer(surf: Surface, o, d, active, rows, n_rows: int):
    """Primary-hit G-buffer rows (normal | depth | albedo) of the first
    lane of each row; rows no lane writes keep the sky values."""
    n = o.shape[0]
    lane = torch.arange(n, device=o.device)
    first = torch.full((n_rows,), n, dtype=torch.int64, device=o.device)
    first.scatter_reduce_(0, rows, lane, "amin")
    depth = torch.where(active, vmath.dot(surf.position - o, d), torch.inf)
    grow = torch.cat([torch.where(active[..., None], surf.normal, 0.0),
                      depth[..., None],
                      torch.where(active[..., None], surf.albedo, 1.0)],
                     dim=1)
    g = torch.cat([torch.zeros((n_rows, 3), device=o.device),
                   torch.full((n_rows, 1), torch.inf, device=o.device),
                   torch.ones((n_rows, 3), device=o.device)], dim=1)
    has = first < n
    with tracing.host_sync("gbuffer"):  # a masked index reads its count
        g[has] = grow[first[has]]
    return {"normal": g[:, 0:3], "depth": g[:, 3], "albedo": g[:, 4:7]}
