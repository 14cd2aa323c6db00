"""GGX metallic-roughness BSDF: alpha = max(0.001, r^2), GGX NDF, Smith G
with k = a^2 / 2, Schlick Fresnel, half-vector and cosine sampling,
P(specular lobe) = clamp(metallic + (1 - roughness) / 2)."""

from __future__ import annotations

import torch

from ptbench.reference import vmath

M_PI = 3.14159265358979323846
EPS = 1e-5


def alpha_of(roughness):
    return torch.clamp(roughness * roughness, min=0.001)


def ggx_d(n_dot_h, alpha):
    a2 = alpha * alpha
    denom = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / (M_PI * denom * denom)


def smith_g1(n_dot_x, alpha):
    k = (alpha * alpha) / 2.0
    return n_dot_x / (n_dot_x * (1.0 - k) + k)


def schlick_scalar(cos_theta, f0):
    return f0 + (1.0 - f0) * (1.0 - cos_theta) ** 5


def lobe_prob(metallic, roughness):
    return torch.clamp(metallic + (1.0 - roughness) * 0.5, 0.0, 1.0)


def sample_ggx(n, v, roughness, u1, u2):
    a = alpha_of(roughness)
    phi = 2.0 * M_PI * u1
    cos_t = torch.sqrt(torch.clamp((1.0 - u2) / (1.0 + (a * a - 1.0) * u2),
                                   min=0.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    t, b = vmath.onb(n)
    h = vmath.normalize((torch.cos(phi) * sin_t)[..., None] * t
                        + (torch.sin(phi) * sin_t)[..., None] * b
                        + cos_t[..., None] * n)
    return vmath.normalize(vmath.reflect(-v, h))


def sample_cosine(n, u1, u2):
    phi = 2.0 * M_PI * u1
    r = torch.sqrt(u2)
    z = torch.sqrt(torch.clamp(1.0 - u2, min=0.0))
    t, b = vmath.onb(n)
    return vmath.normalize((r * torch.cos(phi))[..., None] * t
                           + (r * torch.sin(phi))[..., None] * b
                           + z[..., None] * n)


def pdf_ggx(n, v, l, roughness):
    h = vmath.normalize(v + l)
    n_dot_h = torch.clamp(vmath.dot(n, h), min=0.0)
    v_dot_h = torch.clamp(vmath.dot(v, h), min=EPS)
    return (ggx_d(n_dot_h, alpha_of(roughness)) * n_dot_h) / (4.0 * v_dot_h)


def pdf(n, v, l, metallic, roughness):
    """Mixture pdf of the lobe-select sampler."""
    p_spec = lobe_prob(metallic, roughness)
    pd = torch.clamp(vmath.dot(n, l), min=0.0) / M_PI
    return torch.clamp(p_spec * pdf_ggx(n, v, l, roughness)
                       + (1.0 - p_spec) * pd, min=1e-6)


def eval_brdf(n, v, l, albedo, metallic, roughness):
    """Lambert + GGX specular f [..., 3]."""
    n_dot_l = torch.clamp(vmath.dot(n, l), min=0.0)
    n_dot_v = torch.clamp(vmath.dot(n, v), min=0.0)
    valid = (n_dot_l > 0.0) & (n_dot_v > 0.0)
    h = vmath.normalize(v + l)
    n_dot_h = torch.clamp(vmath.dot(n, h), min=0.0)
    v_dot_h = torch.clamp(vmath.dot(v, h), min=0.0)
    f0 = 0.04 * (1.0 - metallic[..., None]) + albedo * metallic[..., None]
    fr = f0 + (1.0 - f0) * ((1.0 - v_dot_h) ** 5)[..., None]
    alpha = alpha_of(roughness)
    g = smith_g1(n_dot_v, alpha) * smith_g1(n_dot_l, alpha)
    spec = fr * (ggx_d(n_dot_h, alpha) * g
                 / (4.0 * n_dot_v * n_dot_l + 1e-6))[..., None]
    diff = (1.0 - metallic)[..., None] * albedo / M_PI
    return torch.where(valid[..., None], diff + spec, 0.0)
