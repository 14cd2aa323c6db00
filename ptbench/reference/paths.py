"""The reference path tracer, one lane per (pixel, sample).

The estimator the configurations state: per segment, the closest hit
(brute force), sky radiance on a miss (MIS-weighted against env NEE
when that is on), emission on a hit (MIS-weighted against light
sampling), stochastic alpha passthrough, the dielectric branch, NEE to
one emissive triangle and one env-map direction with power-heuristic
MIS and a shadow query each, a BSDF continuation, and Russian roulette
after rr_start_depth. Every random number is PCG4D of (pixel, sample,
depth, salt) under the config's seed; the env-NEE draw is keyed on the
pixel's env_nee_cell-square screen cell. Textures are read one texel
per lookup, jittered by a draw (stochastic bilinear filtering), from
each material's resampled texels.
"""

from __future__ import annotations

import torch

from ptbench.reference import brute, bsdf, camera, envlight, rng, sky, vmath

MAT_DIELECTRIC = 2


def _power(a, b):
    a2 = a * a
    return a2 / torch.clamp(a2 + b * b, min=1e-20)


def _surface(tb, tri, u, v, t, o, d, tex_u):
    """Shading point of the hits (tri [N] >= 0 where used)."""
    tri = tri.clamp(min=0)
    idx = tb.indices[tri]
    w1 = u[:, None]
    w2 = v[:, None]
    w0 = 1.0 - w1 - w2
    t_safe = torch.where(torch.isfinite(t), t, 1.0)[:, None]
    position = o + d * t_safe
    n0, n1, n2 = (tb.normals[idx[:, k]] for k in range(3))
    normal = vmath.normalize(n0 * w0 + n1 * w1 + n2 * w2)
    uv0, uv1, uv2 = (tb.uvs[idx[:, k]] for k in range(3))
    uv = uv0 * w0 + uv1 * w1 + uv2 * w2
    p0, p1, p2 = (tb.positions[idx[:, k]] for k in range(3))
    geom_normal = vmath.normalize(vmath.cross(p1 - p0, p2 - p0))
    mid = tb.face_material[tri]
    m = {k: x[mid] for k, x in tb.mat.items()}
    albedo, alpha = m["albedo"], m["alpha"]
    roughness, metallic = m["roughness"], m["metallic"]
    if tb.has_textures and tex_u is not None:
        wh = tb.comp_wh[mid]
        tw, th = wh[:, 0], wh[:, 1]
        x = uv[:, 0] * tw.to(t.dtype) - 0.5
        y = uv[:, 1] * th.to(t.dtype) - 0.5
        xi = torch.remainder(torch.floor(x + tex_u[0]).long(), tw)
        yi = torch.remainder(torch.floor(y + tex_u[1]).long(), th)
        words = tb.comp[mid, yi, xi]

        def unpack(p):
            return [(((p >> (8 * i)) & 0xFF).to(torch.float32)
                     * (1.0 / 255.0)).to(t.dtype) for i in range(4)]

        ar, ag, ab, aa = unpack(words[:, 0])
        has_a = m["albedo_tex"] >= 0
        albedo = torch.where(has_a[:, None],
                             torch.stack([ar, ag, ab], 1) ** 2.2, albedo)
        alpha = torch.where(has_a, alpha * aa, alpha)
        _, mg, mb, _ = unpack(words[:, 1])
        has_mr = m["mr_tex"] >= 0
        roughness = torch.where(has_mr, roughness * mg, roughness)
        metallic = torch.where(has_mr, metallic * mb, metallic)
        nr, ng, nb, _ = unpack(words[:, 2])
        nm = torch.stack([nr, ng, nb], 1) * 2.0 - 1.0
        t0, t1, t2 = (tb.tangents[idx[:, k]] for k in range(3))
        tangent = vmath.normalize(t0 * w0 + t1 * w1 + t2 * w2)
        t_ortho = vmath.normalize(tangent - normal
                                  * vmath.dotk(normal, tangent))
        bt = vmath.cross(normal, t_ortho)
        mapped = vmath.normalize(t_ortho * nm[:, 0:1] + bt * nm[:, 1:2]
                                 + normal * nm[:, 2:3])
        normal = torch.where((m["normal_tex"] >= 0)[:, None], mapped, normal)
    return dict(position=position, normal=normal, geom_normal=geom_normal,
                albedo=albedo, emission=m["emission"] * m["albedo"],
                roughness=torch.clamp(roughness, 0.01, 1.0),
                metallic=torch.clamp(metallic, 0.0, 1.0), ior=m["ior"],
                alpha=torch.clamp(alpha, 0.0, 1.0), mat_type=m["type"],
                light_pdf_area=tb.tri_light_pdf_area[tri])


def _env_cell(rc, pixel):
    cell = rc["env_nee_cell"]
    if cell <= 1:
        return pixel
    cells_x = -(-rc["width"] // cell)
    return (torch.div(pixel, rc["width"], rounding_mode="floor") // cell
            * cells_x + torch.remainder(pixel, rc["width"]) // cell)


def trace(tb, rc, cam, pixel, sample):
    """Radiance [N, 3] of the paths of int64 pixel ids (row-major) and
    sample ids [N] under render config rc (a dict of RenderConfig
    fields) and camera cam."""
    dt = tb.dtype
    seed = rc["seed"]
    n = pixel.shape[0]
    dev = pixel.device
    gain = rc["emission_gain"]
    env_nee = (rc["env_importance_sampling"] and rc["sky"] == "envmap"
               and tb.has_envmap)
    use_tex_u = tb.has_textures and rc["stochastic_texture_filtering"]
    if rc["sampler"] != "pcg" or rc["reference_quirks"] \
            or rc["aperture"] > 0.0 or rc["env_shadow_rr"] > 0.0 \
            or rc["clamp_radiance"] > 0.0 or rc["skip_nee"] \
            or (tb.has_textures and not use_tex_u):
        raise NotImplementedError("reference: pcg sampler, pinhole camera "
                                  "and the default estimator, textures read "
                                  "through the stochastic filter")

    def u1(depth, salt):
        return rng.uniform4(pixel, sample, depth, salt, seed, dt)[:, 0]

    def u2(depth, salt):
        u = rng.uniform4(pixel, sample, depth, salt, seed, dt)
        return u[:, 0], u[:, 1]

    def closest(o, d, active):
        t = torch.full((n,), torch.inf, dtype=dt, device=dev)
        tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
        uu = torch.zeros((n,), dtype=dt, device=dev)
        vv = torch.zeros_like(uu)
        (live,) = torch.nonzero(active, as_tuple=True)
        if live.numel():
            r = brute.closest(tb.bw, o[live], d[live], rc["t_min"],
                              rc["t_max"])
            t[live], tri[live], uu[live], vv[live] = r
        return t, tri, uu, vv

    def occluded(o, d, t_max, valid):
        out = torch.zeros((n,), dtype=torch.bool, device=dev)
        (live,) = torch.nonzero(valid, as_tuple=True)
        if live.numel():
            tm = t_max if t_max.dim() == 0 else t_max[live]
            out[live] = brute.occluded(tb.bw, o[live], d[live], tm)
        return out

    o, d = camera.primary_rays(cam, rc["width"], rc["height"], rc["fov_deg"],
                               pixel, sample, seed, dt)
    throughput = torch.ones((n, 3), dtype=dt, device=dev)
    radiance = torch.zeros((n, 3), dtype=dt, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_pdf = torch.full((n,), torch.inf, dtype=dt, device=dev)
    max_depth = rc["max_depth"]
    for depth in range(max_depth):
        t, tri, hu, hv = closest(o, d, active)
        valid = tri >= 0
        hit_ok = valid & active
        missed = active & ~valid
        sky_rad = sky.radiance(rc, d, tb.envmap)
        if env_nee:
            p_env = envlight.pdf_of(tb.env_pdf, d)
            w_sky = torch.where(torch.isinf(prev_pdf), 1.0,
                                _power(prev_pdf, p_env))
            sky_rad = sky_rad * w_sky[:, None]
        radiance = radiance + torch.where(missed[:, None],
                                          throughput * sky_rad, 0.0)
        active = hit_ok
        tex_u = u2(depth, rng.SALT_TEX_FILTER) if use_tex_u else None
        s = _surface(tb, tri, hu, hv, t, o, d, tex_u)
        cos_l = torch.clamp(vmath.dot(s["geom_normal"], -d), min=0.0)
        pdf_light = s["light_pdf_area"] * t * t \
            / torch.clamp(cos_l, min=vmath.EPS)
        w_emit = torch.where(torch.isinf(prev_pdf)
                             | (s["light_pdf_area"] <= 0.0), 1.0,
                             _power(prev_pdf, pdf_light))
        radiance = radiance + torch.where(
            hit_ok[:, None], throughput * s["emission"] * gain
            * w_emit[:, None], 0.0)
        if depth == max_depth - 1:
            break

        view = -d
        passthrough = active & (s["alpha"] < 0.99) \
            & (u1(depth, rng.SALT_ALPHA) > s["alpha"])
        is_diel = active & ~passthrough & (s["mat_type"] == MAT_DIELECTRIC)
        cosi = vmath.dot(d, s["normal"])
        entering = cosi <= 0.0
        eta = torch.where(entering, torch.reciprocal(s["ior"]), s["ior"])
        n_eff = torch.where(entering[:, None], s["normal"], -s["normal"])
        refr, tir = vmath.refract(d, n_eff, eta)
        refl_prob = torch.clamp(bsdf.schlick_scalar(cosi.abs(), 0.04),
                                0.0, 1.0)
        take_refl = tir | (u1(depth, rng.SALT_DIELECTRIC) < refl_prob)
        d_diel = torch.where(take_refl[:, None],
                             vmath.reflect(d, s["normal"]), refr)
        shade = active & ~passthrough & ~is_diel
        eps = rc["shadow_eps"]

        if tb.has_lights:
            lt = tb.light
            u_sel = u1(depth, rng.SALT_LIGHT_SELECT)
            n_l = lt["cdf"].shape[0]
            li = torch.searchsorted(lt["cdf"], u_sel.contiguous(),
                                    right=False).clamp(0, n_l - 1)
            r1, r2 = u2(depth, rng.SALT_LIGHT_UV)
            sr1 = torch.sqrt(r1)
            b0 = (1.0 - sr1)[:, None]
            b1 = (r2 * sr1)[:, None]
            p_on = lt["v0"][li] * b0 + lt["v1"][li] * b1 \
                + lt["v2"][li] * (1.0 - b0 - b1)
            light_n = lt["normal"][li]
            area = lt["area"][li]
            p_a = lt["pdf"][li] / torch.clamp(area, min=vmath.EPS)
            to_light = p_on - s["position"]
            dist2 = torch.clamp(vmath.dot(to_light, to_light), min=vmath.EPS)
            l_dir = to_light * torch.rsqrt(dist2)[:, None]
            n_dot_l = torch.clamp(vmath.dot(s["normal"], l_dir), min=0.0)
            nl_dot = torch.clamp(vmath.dot(light_n, -l_dir), min=0.0)
            geo_ok = (n_dot_l > 0.0) & (nl_dot > 0.0)
            s_orig = s["position"] + s["normal"] * eps
            seg = p_on - s_orig
            seg_len = torch.sqrt(torch.clamp(vmath.dot(seg, seg), min=1e-20))
            s_dir = seg / seg_len[:, None]
            s_tmax = seg_len * (1.0 - 1e-3)
            blocked = occluded(s_orig, s_dir, s_tmax, geo_ok & shade)
            f = bsdf.eval_brdf(s["normal"], view, l_dir, s["albedo"],
                               s["metallic"], s["roughness"])
            p_omega = p_a * dist2 / torch.clamp(nl_dot, min=vmath.EPS)
            w = _power(p_omega, bsdf.pdf(s["normal"], view, l_dir,
                                         s["metallic"], s["roughness"]))
            g = n_dot_l * nl_dot / dist2
            contrib = f * (lt["emission"][li] * gain) \
                * (g / torch.clamp(p_a, min=1e-12))[:, None] * w[:, None]
            nee = torch.where((geo_ok & ~blocked)[:, None], contrib, 0.0)
            radiance = radiance + torch.where(shade[:, None],
                                              throughput * nee, 0.0)

        if env_nee:
            ue = rng.uniform4(_env_cell(rc, pixel), sample, depth,
                              rng.SALT_ENV_SELECT, seed, dt)
            l_dir = envlight.sample(tb.env_marginal, tb.env_cond, ue)
            p_env = envlight.pdf_of(tb.env_pdf, l_dir)
            le = sky.envmap(tb.envmap, l_dir)
            n_dot_l = torch.clamp(vmath.dot(s["normal"], l_dir), min=0.0)
            ok = (n_dot_l > 0.0) & (p_env > 0.0)
            s_orig = s["position"] + s["normal"] * eps
            traced = ok & shade
            blocked = occluded(s_orig, l_dir,
                               torch.tensor(1e18, dtype=dt, device=dev),
                               traced)
            f = bsdf.eval_brdf(s["normal"], view, l_dir, s["albedo"],
                               s["metallic"], s["roughness"])
            w = _power(p_env, bsdf.pdf(s["normal"], view, l_dir,
                                       s["metallic"], s["roughness"]))
            contrib = f * le * (n_dot_l * w
                                / torch.clamp(p_env, min=1e-12))[:, None]
            env_c = torch.where((traced & ~blocked)[:, None], contrib, 0.0)
            radiance = radiance + torch.where(shade[:, None],
                                              throughput * env_c, 0.0)

        u_lobe = u1(depth, rng.SALT_BSDF_LOBE)
        bu1, bu2 = u2(depth, rng.SALT_BSDF_UV)
        choose_spec = u_lobe < bsdf.lobe_prob(s["metallic"], s["roughness"])
        l_new = torch.where(
            choose_spec[:, None],
            bsdf.sample_ggx(s["normal"], view, s["roughness"], bu1, bu2),
            bsdf.sample_cosine(s["normal"], bu1, bu2))
        n_dot_l = torch.clamp(vmath.dot(s["normal"], l_new), min=0.0)
        mix_pdf = bsdf.pdf(s["normal"], view, l_new, s["metallic"],
                           s["roughness"])
        f = bsdf.eval_brdf(s["normal"], view, l_new, s["albedo"],
                           s["metallic"], s["roughness"])
        new_tp = throughput * f * (n_dot_l / mix_pdf)[:, None]
        new_d = torch.where(passthrough[:, None], d,
                            torch.where(is_diel[:, None], d_diel, l_new))
        new_o = s["position"] + new_d * rc["t_min"]
        o = torch.where(active[:, None], new_o, o)
        d = torch.where(active[:, None], new_d, d)
        throughput = torch.where(shade[:, None], new_tp, throughput)
        prev_pdf = torch.where(shade, mix_pdf, torch.inf)
        active = active & (passthrough | is_diel | (shade & (n_dot_l > 0.0)))
        if depth > rc["rr_start_depth"]:
            p = torch.clamp(throughput.amax(dim=-1), rc["rr_clamp_lo"],
                            rc["rr_clamp_hi"])
            survive = u1(depth, rng.SALT_RR) <= p
            rr = active & ~passthrough & ~is_diel
            active = active & (~rr | survive)
            throughput = torch.where((rr & survive)[:, None],
                                     throughput / p[:, None], throughput)
        active = active & (throughput.amax(dim=-1)
                           >= rc["throughput_cutoff"])
    return radiance

