"""GGX metallic-roughness BSDF (counterpart of pathtracer/bsdf/microfacet.py).

Eval / sample / pdf of the reference's BSDF library (common.glsl:60-166):
alpha = max(0.001, r^2), GGX NDF, Smith G with k = a^2/2, Schlick
Fresnel, GGX half-vector sampling, cosine hemisphere sampling, and
P(spec) = clamp(metallic + (1-roughness)*0.5).
"""

from __future__ import annotations

import torch

from pathtracer_torch.utils import vmath

M_PI = 3.14159265358979323846
EPS = 1e-5  # common.glsl:24


def roughness_to_alpha(roughness):
    return torch.clamp(roughness * roughness, min=0.001)


def ggx_d(n_dot_h, alpha):
    a2 = alpha * alpha
    ndh2 = n_dot_h * n_dot_h
    denom = ndh2 * (a2 - 1.0) + 1.0
    return a2 / (M_PI * denom * denom)


def smith_g1(n_dot_x, alpha):
    k = (alpha * alpha) / 2.0
    return n_dot_x / (n_dot_x * (1.0 - k) + k)


def smith_g(n_dot_v, n_dot_l, alpha):
    return smith_g1(n_dot_v, alpha) * smith_g1(n_dot_l, alpha)


def schlick_scalar(cos_theta, f0):
    return f0 + (1.0 - f0) * (1.0 - cos_theta) ** 5


def schlick_rgb(cos_theta, f0_rgb):
    return f0_rgb + (1.0 - f0_rgb) * ((1.0 - cos_theta) ** 5)[..., None]


def lobe_select_prob(metallic, roughness):
    """P(specular lobe) - raygen.rgen:241,268."""
    return torch.clamp(metallic + (1.0 - roughness) * 0.5, 0.0, 1.0)


def sample_ggx(n, v, roughness, u1, u2):
    """Sample L by GGX-NDF half-vector sampling (common.glsl:94-114)."""
    a = roughness_to_alpha(roughness)
    phi = 2.0 * M_PI * u1
    cos_t = torch.sqrt(torch.clamp((1.0 - u2) / (1.0 + (a * a - 1.0) * u2),
                                   min=0.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    hx = torch.cos(phi) * sin_t
    hy = torch.sin(phi) * sin_t
    t, b = vmath.onb(n)
    h = vmath.normalize(hx[..., None] * t + hy[..., None] * b
                        + cos_t[..., None] * n)
    return vmath.normalize(vmath.reflect(-v, h))


def sample_cosine(n, u1, u2):
    """Cosine-weighted hemisphere around n (common.glsl:117-128)."""
    phi = 2.0 * M_PI * u1
    r = torch.sqrt(u2)
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u2, min=0.0))
    t, b = vmath.onb(n)
    return vmath.normalize(x[..., None] * t + y[..., None] * b
                           + z[..., None] * n)


def pdf_cosine(n_dot_l):
    return n_dot_l / M_PI


def pdf_ggx(n, v, l, roughness):
    """Solid-angle pdf of sample_ggx (common.glsl:134-142)."""
    h = vmath.normalize(v + l)
    n_dot_h = torch.clamp(vmath.dot(n, h), min=0.0)
    v_dot_h = torch.clamp(vmath.dot(v, h), min=EPS)
    d = ggx_d(n_dot_h, roughness_to_alpha(roughness))
    return (d * n_dot_h) / (4.0 * v_dot_h)


def pdf_bsdf(n, v, l, metallic, roughness):
    """Mixture pdf of the lobe-select sampler (raygen.rgen:241-244)."""
    p_spec = lobe_select_prob(metallic, roughness)
    ps = pdf_ggx(n, v, l, roughness)
    pd = pdf_cosine(torch.clamp(vmath.dot(n, l), min=0.0))
    return torch.clamp(p_spec * ps + (1.0 - p_spec) * pd, min=1e-6)


def eval_brdf(n, v, l, albedo, metallic, roughness):
    """Diffuse + GGX specular (common.glsl:146-166) -> f [..., 3]."""
    n_dot_l = torch.clamp(vmath.dot(n, l), min=0.0)
    n_dot_v = torch.clamp(vmath.dot(n, v), min=0.0)
    valid = (n_dot_l > 0.0) & (n_dot_v > 0.0)
    h = vmath.normalize(v + l)
    n_dot_h = torch.clamp(vmath.dot(n, h), min=0.0)
    v_dot_h = torch.clamp(vmath.dot(v, h), min=0.0)
    f0 = 0.04 * (1.0 - metallic[..., None]) + albedo * metallic[..., None]
    fr = schlick_rgb(v_dot_h, f0)
    alpha = roughness_to_alpha(roughness)
    d = ggx_d(n_dot_h, alpha)
    g = smith_g(n_dot_v, n_dot_l, alpha)
    spec = fr * (d * g / (4.0 * n_dot_v * n_dot_l + 1e-6))[..., None]
    diff = (1.0 - metallic)[..., None] * albedo / M_PI
    return torch.where(valid[..., None], diff + spec, 0.0)
