"""Wavefront path integrator (counterpart of pathtracer/integrator/path.py).

The main path of the JAX `trace_paths`: a flat SoA ray batch [N] runs
through the bounce loop with active masks. Per bounce (raygen.rgen:128-292):
trace -> emission (MIS-weighted against light sampling) -> alpha
passthrough -> dielectric branch -> NEE with MIS -> BSDF sample ->
Russian roulette. Bounce 0 is peeled so primary rays keep their
swizzled order (no coherence sort); the loop is a Python `for`.

The estimator is the JAX package's default one (reference_quirks=False).
Every random number is keyed on (pixel, sample, depth, salt) by the
counter-based PCG4D (sampling/rng.py). The ray counter is exact: path
rays traced plus NEE visibility queries resolved (int64).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from pathtracer_torch.bsdf import microfacet as mf
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.integrator import sky as sky_mod
from pathtracer_torch.sampling import rng
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


def fetch_surface(scene: Scene, surf_rows, hit, o, d, tex_u, mat_rows
                  ) -> Surface:
    """Closest-hit stage (closesthit.rchit:68-125) as one wide row gather.

    Miss lanes gather triangle 0; callers mask them out.
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
        albedo=albedo, emission=emission * albedo_factor,
        roughness=torch.clamp(roughness, 0.01, 1.0),
        metallic=torch.clamp(metallic, 0.0, 1.0), ior=ior,
        alpha=torch.clamp(alpha, 0.0, 1.0), mat_type=mat_type,
        light_pdf_area=row[:, 19])


def _power_heuristic(pdf_a, pdf_b):
    """Power heuristic beta=2 (raygen.rgen:247)."""
    a2 = pdf_a * pdf_a
    return a2 / torch.clamp(a2 + pdf_b * pdf_b, min=1e-20)


def _nee(scene: Scene, cfg: RenderConfig, surf: Surface, view, pixel,
         sample, depth, occluded_fn, shade, primary=False):
    """Next-event estimation to emissive triangles (raygen.rgen:168-261)."""
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
    # sampled point, t_max pulled back by a relative margin
    s_orig = surf.position + surf.normal * cfg.shadow_eps
    seg = p_on_light - s_orig
    seg_len = torch.sqrt(torch.clamp(vmath.dot(seg, seg), min=1e-20))
    s_dir = seg / seg_len[..., None]
    s_tmax = seg_len * (1.0 - 1e-3)
    valid = geo_ok & shade
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
    contrib = f * (le * cfg.emission_gain) \
        * (g / torch.clamp(p_a, min=1e-12))[..., None] * w[..., None]
    return torch.where((geo_ok & ~blocked)[..., None], contrib, 0.0)


def trace_paths(scene: Scene, cfg: RenderConfig, origins, directions,
                pixel_ids, sample_ids, intersect_fn: Callable,
                occluded_fn: Callable):
    """Trace a batch of paths to completion.

    Returns (radiance f32[N,3], rays_traced int64 scalar); lanes stay in
    input order.
    intersect_fn(o, d, t_min, t_max, primary=False) -> Hit
    occluded_fn(o, d, t_max, primary=False) -> bool[N]
    """
    n = origins.shape[0]
    dev = origins.device
    gain = cfg.emission_gain
    surf_rows = pack_surface_rows(scene)
    mat_rows = pack_material_rows(scene)
    pix, samp = pixel_ids, sample_ids
    use_tex_u = scene.has_textures and cfg.stochastic_texture_filtering

    def segment(state, depth, primary=False):
        """Trace + emission collection shared by every bounce."""
        o, d, throughput, radiance, active, prev_pdf, rays = state
        rays = rays + active.sum()
        o_eff = torch.where(active[..., None], o, 1e30)
        d_eff = torch.where(active[..., None], d, 1.0)
        hit = intersect_fn(o_eff, d_eff, cfg.t_min, cfg.t_max,
                           primary=primary)
        hit_ok = hit.valid & active
        missed = active & ~hit.valid
        sky_rad = sky_mod.sky_radiance(cfg, d)
        radiance = radiance + torch.where(missed[..., None],
                                          throughput * sky_rad, 0.0)
        active = hit_ok
        tex_u = (rng.uniform2(pix, samp, depth, rng.SALT_TEX_FILTER,
                              cfg.seed, cfg.sampler) if use_tex_u else None)
        surf = fetch_surface(scene, surf_rows, hit, o, d, tex_u, mat_rows)
        # emitter hit, MIS-weighted against light sampling
        cos_l = torch.clamp(vmath.dot(surf.geom_normal, -d), min=0.0)
        pdf_light = surf.light_pdf_area * hit.t * hit.t \
            / torch.clamp(cos_l, min=vmath.EPS)
        is_delta = torch.isinf(prev_pdf)
        w_emit = torch.where(is_delta | (surf.light_pdf_area <= 0.0), 1.0,
                             _power_heuristic(prev_pdf, pdf_light))
        radiance = radiance + torch.where(
            hit_ok[..., None],
            throughput * surf.emission * gain * w_emit[..., None], 0.0)
        return (o, d, throughput, radiance, active, prev_pdf, rays), surf

    def bounce(depth, state, primary=False):
        """One full bounce: segment + NEE + BSDF continuation."""
        state, surf = segment(state, depth, primary)
        o, d, throughput, radiance, active, prev_pdf, rays = state
        view = -d

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
        if scene.has_lights:
            nee = _nee(scene, cfg, surf, view, pix, samp, depth,
                       occluded_fn, shade, primary)
            radiance = radiance + torch.where(shade[..., None],
                                              throughput * nee, 0.0)
            rays = rays + shade.sum()

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
        pdf = mf.pdf_bsdf(surf.normal, view, l_new, surf.metallic,
                          surf.roughness)
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
        prev_pdf = torch.where(shade, pdf, torch.inf)
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
        return o, d, throughput, radiance, active, prev_pdf, rays

    state = (origins.contiguous(), directions.contiguous(),
             torch.ones((n, 3), dtype=torch.float32, device=dev),
             torch.zeros((n, 3), dtype=torch.float32, device=dev),
             torch.ones(n, dtype=torch.bool, device=dev),
             torch.full((n,), torch.inf, dtype=torch.float32, device=dev),
             torch.zeros((), dtype=torch.int64, device=dev))
    if cfg.max_depth > 1:
        state = bounce(0, state, primary=True)
        for depth in range(1, cfg.max_depth - 1):
            state = bounce(depth, state)
    state, _ = segment(state, cfg.max_depth - 1,
                       primary=(cfg.max_depth == 1))
    return state[3], state[6]
