"""Host-side scene assembly -> Scene (counterpart of pathtracer/scene/build.py).

The same numpy pipeline as the JAX builder (mesh pool, materials SoA,
emissive-triangle light CDF, u8 texture stack, per-material composite
texels, env-map importance tables), ending in torch tensors on the
requested device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from pathtracer_torch.scene.envlight import build_env_distribution
from pathtracer_torch.scene.types import MAT_LAMBERTIAN, Scene, \
    scene_from_numpy

LUMINANCE = np.array([0.2126, 0.7152, 0.0722], np.float32)  # main.cpp:287


@dataclasses.dataclass
class MaterialDesc:
    """PBR metallic-roughness material (model_loader.h:26-39 fields)."""

    albedo: tuple = (0.8, 0.8, 0.8)
    emission: tuple = (0.0, 0.0, 0.0)
    roughness: float = 1.0
    metallic: float = 0.0
    ior: float = 1.5
    alpha: float = 1.0
    material_type: int = MAT_LAMBERTIAN
    albedo_tex: int = -1
    mr_tex: int = -1
    normal_tex: int = -1


class SceneBuilder:
    """Accumulates meshes/materials/textures, then finalizes to a Scene."""

    def __init__(self):
        self._positions: List[np.ndarray] = []
        self._normals: List[np.ndarray] = []
        self._uvs: List[np.ndarray] = []
        self._tangents: List[np.ndarray] = []
        # glTF tangent w (bitangent handedness, +-1) per vertex: the
        # renderer's TBN takes w = +1; export_glb writes the sign back
        self._tangent_w: List[np.ndarray] = []
        self._indices: List[np.ndarray] = []
        self._face_material: List[np.ndarray] = []
        self.materials: List[MaterialDesc] = []
        self.textures: List[np.ndarray] = []  # each f32 [h, w, 4] raw values
        self.envmap: Optional[np.ndarray] = None
        self._vertex_offset = 0

    def add_material(self, mat: MaterialDesc) -> int:
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_texture(self, data: np.ndarray) -> int:
        """Add a texture ([h,w,3|4] u8 or f32 raw/sRGB-encoded). Returns id."""
        data = np.asarray(data)
        if data.dtype == np.uint8:
            data = data.astype(np.float32) / 255.0
        data = data.astype(np.float32)
        if data.ndim == 2:
            data = data[..., None].repeat(3, axis=-1)
        if data.shape[-1] == 3:
            data = np.concatenate([data, np.ones_like(data[..., :1])], axis=-1)
        self.textures.append(data)
        return len(self.textures) - 1

    def set_envmap(self, data: np.ndarray):
        """Equirect HDR radiance map f32 [h, w, 3] (linear)."""
        self.envmap = np.asarray(data, np.float32)

    def add_mesh(self, positions, indices, material: int,
                 normals=None, uvs=None, tangents=None, transform=None):
        """Append a mesh, baking `transform` (4x4) into world space."""
        positions = np.asarray(positions, np.float32).reshape(-1, 3)
        indices = np.asarray(indices, np.int64).reshape(-1, 3)
        n = len(positions)

        if normals is None:
            normals = _vertex_normals(positions, indices)
        else:
            normals = np.asarray(normals, np.float32).reshape(-1, 3)
        if uvs is None:
            uvs = np.zeros((n, 2), np.float32)
        else:
            uvs = np.asarray(uvs, np.float32).reshape(-1, 2)
        tan_w = np.ones((n,), np.float32)
        if tangents is None:
            tangents = np.tile(np.array([[1, 0, 0]], np.float32), (n, 1))
        else:
            tangents = np.asarray(tangents, np.float32)
            if tangents.ndim == 2 and tangents.shape[-1] == 4:
                tan_w = tangents[..., 3].astype(np.float32).copy()
                tangents = tangents[..., :3]
            tangents = tangents.reshape(-1, 3)

        m = None
        if transform is not None:
            m = np.asarray(transform, np.float32).reshape(4, 4)
            if np.array_equal(m, np.eye(4, dtype=np.float32)):
                m = None
        if m is not None:
            positions = positions @ m[:3, :3].T + m[:3, 3]
            nmat = np.linalg.inv(m[:3, :3]).T
            normals = _normalize_rows(normals @ nmat.T)
            tangents = _normalize_rows(tangents @ m[:3, :3].T)

        self._positions.append(positions)
        self._normals.append(normals)
        self._uvs.append(uvs)
        self._tangents.append(tangents)
        self._tangent_w.append(tan_w)
        self._indices.append(indices + self._vertex_offset)
        self._face_material.append(
            np.full(len(indices), material, np.int64))
        self._vertex_offset += n

    def finalize_numpy(self) -> dict:
        """The scene tables as numpy arrays plus meta (JAX field names)."""
        if not self._positions:
            raise ValueError("empty scene")
        if not self.materials:
            self.materials.append(MaterialDesc())

        positions = np.concatenate(self._positions)
        normals = np.concatenate(self._normals)
        uvs = np.concatenate(self._uvs)
        tangents = np.concatenate(self._tangents)
        indices = np.concatenate(self._indices).astype(np.int32)
        face_material = np.concatenate(self._face_material).astype(np.int32)

        mats = self.materials
        m_albedo = np.array([m.albedo for m in mats], np.float32)
        m_emission = np.array([m.emission for m in mats], np.float32)

        # --- emissive scan + CDF (main.cpp:261-324) ---
        v0 = positions[indices[:, 0]]
        v1 = positions[indices[:, 1]]
        v2 = positions[indices[:, 2]]
        tri_em = (m_emission[face_material] * m_albedo[face_material])
        lum = tri_em @ LUMINANCE
        cr = np.cross(v1 - v0, v2 - v0)
        cr_len = np.linalg.norm(cr, axis=-1)
        area = 0.5 * cr_len
        is_light = (lum > 1e-6) & (area > 1e-9)

        (light_ids,) = np.nonzero(is_light)
        n_lights = len(light_ids)
        has_lights = n_lights > 0
        tri_light_pdf_area = np.zeros(len(indices), np.float32)
        if has_lights:
            l_em = tri_em[light_ids]
            l_area = area[light_ids]
            w = np.maximum(1e-6, lum[light_ids]) * np.maximum(1e-9, l_area)
            total = w.sum()
            pdf_sel = (w / total).astype(np.float32)
            cdf = np.cumsum(pdf_sel).astype(np.float32)
            cdf[-1] = 1.0
            light_v0 = v0[light_ids]
            light_v1 = v1[light_ids]
            light_v2 = v2[light_ids]
            light_n = cr[light_ids] / cr_len[light_ids][:, None]
            tri_light_pdf_area[light_ids] = pdf_sel / np.maximum(l_area, 1e-9)
        else:
            light_v0 = light_v1 = light_v2 = np.zeros((1, 3), np.float32)
            light_n = np.array([[0, 1, 0]], np.float32)
            l_em = np.zeros((1, 3), np.float32)
            l_area = np.ones(1, np.float32)
            pdf_sel = np.ones(1, np.float32)
            cdf = np.ones(1, np.float32)

        # --- texture stack: u8 at TRUE dims, zero-padded to the max ---
        has_textures = len(self.textures) > 0
        if has_textures:
            th = max(t.shape[0] for t in self.textures)
            tw = max(t.shape[1] for t in self.textures)
            stack = np.zeros((len(self.textures), th, tw, 4), np.uint8)
            tex_wh = np.ones((len(self.textures), 2), np.int32)
            for i, t in enumerate(self.textures):
                q = np.clip(np.round(t * 255.0), 0, 255).astype(np.uint8)
                stack[i, :t.shape[0], :t.shape[1]] = q
                tex_wh[i] = (t.shape[1], t.shape[0])
        else:
            stack = np.full((1, 1, 1, 4), 255, np.uint8)
            tex_wh = np.ones((1, 2), np.int32)

        # --- per-material composite texels (Scene.tex_comp) ---
        tex_comp = None
        tex_comp_wh = None
        if has_textures:
            dims = []
            for m in mats:
                mh = mw = 1
                for tid in (m.albedo_tex, m.mr_tex, m.normal_tex):
                    if tid >= 0:
                        t = self.textures[tid]
                        mh = max(mh, t.shape[0])
                        mw = max(mw, t.shape[1])
                dims.append((mh, mw))
            ch = max(d[0] for d in dims)
            cw = max(d[1] for d in dims)
            if len(mats) * ch * cw * 12 <= (512 << 20):
                comp = np.zeros((len(mats), ch, cw, 3), np.uint32)
                tex_comp_wh = np.ones((len(mats), 2), np.int32)

                def packed_layer(tid, h, w, neutral):
                    if tid < 0:
                        img = np.broadcast_to(
                            np.asarray(neutral, np.float32), (h, w, 4))
                    else:
                        t = np.clip(np.round(self.textures[tid] * 255.0),
                                    0, 255).astype(np.float32) / 255.0
                        img = (t if t.shape[:2] == (h, w)
                               else _resize_bilinear(t, h, w))
                    q = np.clip(np.round(img * 255.0), 0,
                                255).astype(np.uint32)
                    return (q[..., 0] | (q[..., 1] << 8)
                            | (q[..., 2] << 16) | (q[..., 3] << 24))

                for mi, m in enumerate(mats):
                    h, w = dims[mi]
                    tex_comp_wh[mi] = (w, h)
                    comp[mi, :h, :w, 0] = packed_layer(
                        m.albedo_tex, h, w, (1, 1, 1, 1))
                    comp[mi, :h, :w, 1] = packed_layer(
                        m.mr_tex, h, w, (1, 1, 1, 1))
                    comp[mi, :h, :w, 2] = packed_layer(
                        m.normal_tex, h, w, (0.5, 0.5, 1, 1))
                tex_comp = comp

        envmap = (self.envmap if self.envmap is not None
                  else np.zeros((1, 1, 3), np.float32))
        env_mcdf, env_ccdf, env_pdf = build_env_distribution(envmap)
        env_blocks = None
        if self.envmap is not None:
            # 2x2 bilinear-footprint rows: wrap x, clip y - the lookup's
            # own index rules, so the filtered result is bit-identical
            e = envmap
            ex = np.concatenate([e[:, 1:], e[:, :1]], axis=1)   # x+1 wrap
            ey = np.concatenate([e[1:], e[-1:]], axis=0)        # y+1 clip
            exy = np.concatenate([ey[:, 1:], ey[:, :1]], axis=1)
            env_blocks = np.concatenate([e, ex, ey, exy], axis=2)

        return dict(
            positions=positions, normals=normals, uvs=uvs,
            tangents=tangents, indices=indices, face_material=face_material,
            mat_albedo=m_albedo, mat_emission=m_emission,
            mat_roughness=np.array([m.roughness for m in mats], np.float32),
            mat_metallic=np.array([m.metallic for m in mats], np.float32),
            mat_ior=np.array([m.ior for m in mats], np.float32),
            mat_alpha=np.array([m.alpha for m in mats], np.float32),
            mat_type=np.array([m.material_type for m in mats], np.int32),
            mat_albedo_tex=np.array([m.albedo_tex for m in mats], np.int32),
            mat_mr_tex=np.array([m.mr_tex for m in mats], np.int32),
            mat_normal_tex=np.array([m.normal_tex for m in mats], np.int32),
            textures=stack, tex_wh=tex_wh,
            tex_comp=tex_comp, tex_comp_wh=tex_comp_wh,
            light_v0=light_v0.astype(np.float32),
            light_v1=light_v1.astype(np.float32),
            light_v2=light_v2.astype(np.float32),
            light_normal=light_n.astype(np.float32),
            light_emission=l_em.astype(np.float32),
            light_area=l_area.astype(np.float32),
            light_cdf=cdf, light_pdf=pdf_sel,
            tri_light_pdf_area=tri_light_pdf_area,
            envmap=envmap, envmap_blocks=env_blocks,
            env_marginal_cdf=env_mcdf, env_cond_cdf=env_ccdf,
            env_pdf=env_pdf,
            has_lights=has_lights,
            n_lights=int(n_lights) if has_lights else 0,
            has_textures=has_textures,
            has_envmap=self.envmap is not None,
        )

    def finalize(self, *, device) -> Scene:
        return scene_from_numpy(self.finalize_numpy(), device=device)


def _normalize_rows(a: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(a, axis=-1, keepdims=True)
    return (a / np.maximum(n, 1e-20)).astype(np.float32)


def _vertex_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals (for meshes without normals)."""
    fn = np.cross(positions[indices[:, 1]] - positions[indices[:, 0]],
                  positions[indices[:, 2]] - positions[indices[:, 0]])
    vn = np.zeros_like(positions)
    for k in range(3):
        np.add.at(vn, indices[:, k], fn)
    return _normalize_rows(vn)


def _resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
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
