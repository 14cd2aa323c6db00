"""The reference's scene tables, worked out from a SceneSpec.

Meshes are concatenated in call order (vertex normals area-weighted per
mesh where a mesh gives none), the emissive triangles get a CDF by
luminance x area, textures are quantised to 8 bits and, per material,
resampled bilinearly to the largest of its textures (the texel each
shading point reads), the env map gets its importance tables, and every
triangle its Baldwin-Weber rows (plane n = e1 x e2 with each component
fused, offset d, barycentric rows r1, r2 with offsets).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ptbench.reference import envlight
from ptbench.scenes.procedural import resize_bilinear

LUMINANCE = np.array([0.2126, 0.7152, 0.0722], np.float32)


def _normalize_rows(a):
    n = np.linalg.norm(a, axis=-1, keepdims=True)
    return (a / np.maximum(n, 1e-20)).astype(np.float32)


def _vertex_normals(positions, indices):
    fn = np.cross(positions[indices[:, 1]] - positions[indices[:, 0]],
                  positions[indices[:, 2]] - positions[indices[:, 0]])
    vn = np.zeros_like(positions)
    for k in range(3):
        np.add.at(vn, indices[:, k], fn)
    return _normalize_rows(vn)


def _texture_f32(data):
    data = np.asarray(data)
    if data.dtype == np.uint8:
        data = data.astype(np.float32) / 255.0
    data = data.astype(np.float32)
    if data.ndim == 2:
        data = data[..., None].repeat(3, axis=-1)
    if data.shape[-1] == 3:
        data = np.concatenate([data, np.ones_like(data[..., :1])], axis=-1)
    return data


def _bw_rows(v0, v1, v2):
    """Baldwin-Weber rows f32 [T, 12] (n, d, r1, c1, r2, c2), each cross
    product component fused as fma(a_i, b_j, -(a_j b_i)) in float64."""
    def cross_fma(a, b):
        def comp(i, j):
            p = (a[:, j] * b[:, i]).astype(np.float64)
            return (a[:, i].astype(np.float64) * b[:, j].astype(np.float64)
                    - p).astype(np.float32)
        return np.stack([comp(1, 2), comp(2, 0), comp(0, 1)], axis=1)

    def dot3(a, b):
        return ((a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1])
                + a[:, 2] * b[:, 2])[:, None]

    e1 = v1 - v0
    e2 = v2 - v0
    nrm = cross_fma(e1, e2)
    dpl = dot3(nrm, v0)
    det = dot3(nrm, nrm)
    inv = np.where(det > 0, np.float32(1.0) / np.where(det > 0, det, 1.0),
                   0.0).astype(np.float32)
    r1 = cross_fma(e2, nrm) * inv
    c1 = -dot3(r1, v0)
    r2 = cross_fma(nrm, e1) * inv
    c2 = -dot3(r2, v0)
    return np.concatenate([nrm, dpl, r1, c1, r2, c2], axis=1).astype(
        np.float32)


@dataclasses.dataclass
class Tables:
    """Device tensors of the reference (float ones in one dtype)."""

    positions: torch.Tensor
    normals: torch.Tensor
    uvs: torch.Tensor
    tangents: torch.Tensor
    indices: torch.Tensor          # int64 [T, 3]
    face_material: torch.Tensor    # int64 [T]
    bw: torch.Tensor               # [T, 12]
    mat: dict                      # albedo, emission, ... per material
    light: dict                    # v0, v1, v2, normal, emission, area,
                                   # cdf, pdf
    tri_light_pdf_area: torch.Tensor
    has_lights: bool
    has_textures: bool
    comp: torch.Tensor             # int64 [M, CH, CW, 3] packed u32 texels
    comp_wh: torch.Tensor          # int64 [M, 2]
    envmap: torch.Tensor
    env_marginal: torch.Tensor
    env_cond: torch.Tensor
    env_pdf: torch.Tensor
    has_envmap: bool

    @property
    def n_tris(self) -> int:
        return self.indices.shape[0]

    @property
    def dtype(self):
        return self.positions.dtype


def build(spec, *, device, dtype=torch.float32) -> Tables:
    """Tables of SceneSpec `spec` on `device`, floats in `dtype`."""
    pos, nrm, uvs, tan, idx, fmat = [], [], [], [], [], []
    offset = 0
    for m in spec.meshes:
        p = np.asarray(m["positions"], np.float32).reshape(-1, 3)
        ix = np.asarray(m["indices"], np.int64).reshape(-1, 3)
        n = len(p)
        nrm.append(_vertex_normals(p, ix))
        uvs.append(np.zeros((n, 2), np.float32) if m["uvs"] is None
                   else np.asarray(m["uvs"], np.float32).reshape(-1, 2))
        tan.append(np.tile(np.array([[1, 0, 0]], np.float32), (n, 1))
                   if m["tangents"] is None
                   else np.asarray(m["tangents"], np.float32)[..., :3]
                   .reshape(-1, 3))
        pos.append(p)
        idx.append(ix + offset)
        fmat.append(np.full(len(ix), m["material"], np.int64))
        offset += n
    positions = np.concatenate(pos)
    indices = np.concatenate(idx)
    face_material = np.concatenate(fmat)
    mats = spec.materials
    albedo = np.array([m["albedo"] for m in mats], np.float32)
    emission = np.array([m["emission"] for m in mats], np.float32)

    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    tri_em = emission[face_material] * albedo[face_material]
    lum = tri_em @ LUMINANCE
    cr = np.cross(v1 - v0, v2 - v0)
    cr_len = np.linalg.norm(cr, axis=-1)
    area = 0.5 * cr_len
    (lights,) = np.nonzero((lum > 1e-6) & (area > 1e-9))
    tri_pdf_area = np.zeros(len(indices), np.float32)
    if len(lights):
        w = np.maximum(1e-6, lum[lights]) * np.maximum(1e-9, area[lights])
        pdf_sel = (w / w.sum()).astype(np.float32)
        cdf = np.cumsum(pdf_sel).astype(np.float32)
        cdf[-1] = 1.0
        tri_pdf_area[lights] = pdf_sel / np.maximum(area[lights], 1e-9)
        light = dict(v0=v0[lights], v1=v1[lights], v2=v2[lights],
                     normal=cr[lights] / cr_len[lights][:, None],
                     emission=tri_em[lights], area=area[lights],
                     cdf=cdf, pdf=pdf_sel)
    else:
        light = dict(v0=np.zeros((1, 3)), v1=np.zeros((1, 3)),
                     v2=np.zeros((1, 3)), normal=np.array([[0, 1, 0]]),
                     emission=np.zeros((1, 3)), area=np.ones(1),
                     cdf=np.ones(1), pdf=np.ones(1))

    textures = [_texture_f32(t) for t in spec.textures]
    comp = np.zeros((1, 1, 1, 3), np.uint32)
    comp_wh = np.ones((1, 2), np.int64)
    if textures:
        dims = []
        for m in mats:
            mh = mw = 1
            for tid in (m["albedo_tex"], m["mr_tex"], m["normal_tex"]):
                if tid >= 0:
                    mh = max(mh, textures[tid].shape[0])
                    mw = max(mw, textures[tid].shape[1])
            dims.append((mh, mw))
        ch = max(d[0] for d in dims)
        cw = max(d[1] for d in dims)
        comp = np.zeros((len(mats), ch, cw, 3), np.uint32)
        comp_wh = np.ones((len(mats), 2), np.int64)

        def layer(tid, h, w, neutral):
            if tid < 0:
                img = np.broadcast_to(np.asarray(neutral, np.float32),
                                      (h, w, 4))
            else:
                t = np.clip(np.round(textures[tid] * 255.0), 0,
                            255).astype(np.float32) / 255.0
                img = t if t.shape[:2] == (h, w) else resize_bilinear(t, h, w)
            q = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint32)
            return q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) \
                | (q[..., 3] << 24)

        for mi, m in enumerate(mats):
            h, w = dims[mi]
            comp_wh[mi] = (w, h)
            comp[mi, :h, :w, 0] = layer(m["albedo_tex"], h, w, (1, 1, 1, 1))
            comp[mi, :h, :w, 1] = layer(m["mr_tex"], h, w, (1, 1, 1, 1))
            comp[mi, :h, :w, 2] = layer(m["normal_tex"], h, w,
                                        (0.5, 0.5, 1, 1))

    env = (np.asarray(spec.envmap, np.float32) if spec.envmap is not None
           else np.zeros((1, 1, 3), np.float32))
    marginal, cond, env_pdf = envlight.distribution(env)

    def f(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            device=device, dtype=dtype)

    def i64(a):
        return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)

    return Tables(
        positions=f(positions), normals=f(np.concatenate(nrm)),
        uvs=f(np.concatenate(uvs)), tangents=f(np.concatenate(tan)),
        indices=i64(indices), face_material=i64(face_material),
        bw=f(_bw_rows(v0, v1, v2)),
        mat=dict(albedo=f(albedo), emission=f(emission),
                 roughness=f([m["roughness"] for m in mats]),
                 metallic=f([m["metallic"] for m in mats]),
                 ior=f([m["ior"] for m in mats]),
                 alpha=f([m["alpha"] for m in mats]),
                 type=i64([m["material_type"] for m in mats]),
                 albedo_tex=i64([m["albedo_tex"] for m in mats]),
                 mr_tex=i64([m["mr_tex"] for m in mats]),
                 normal_tex=i64([m["normal_tex"] for m in mats])),
        light={k: f(v) for k, v in light.items()},
        tri_light_pdf_area=f(tri_pdf_area), has_lights=bool(len(lights)),
        has_textures=bool(textures), comp=i64(comp), comp_wh=i64(comp_wh),
        envmap=f(env), env_marginal=f(marginal), env_cond=f(cond),
        env_pdf=f(env_pdf), has_envmap=spec.envmap is not None)
