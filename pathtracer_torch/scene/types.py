"""Device scene tables (counterpart of pathtracer/scene/types.py).

`Scene` is a plain dataclass of tensors on one device, with the JAX
`Scene`'s field names, env-map tables included. `Bvh` is the threaded
LBVH of accel/lbvh.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

MAT_LAMBERTIAN = 0  # model_loader.h:8
MAT_METAL = 1       # model_loader.h:9
MAT_DIELECTRIC = 2  # model_loader.h:10

# tensor fields carried across from the JAX Scene (scene_from_numpy)
TENSOR_FIELDS = (
    "positions", "normals", "uvs", "tangents", "indices", "face_material",
    "mat_albedo", "mat_emission", "mat_roughness", "mat_metallic",
    "mat_ior", "mat_alpha", "mat_type", "mat_albedo_tex", "mat_mr_tex",
    "mat_normal_tex", "textures", "tex_wh", "light_v0", "light_v1",
    "light_v2", "light_normal", "light_emission", "light_area",
    "light_cdf", "light_pdf", "tri_light_pdf_area", "envmap",
    "env_marginal_cdf", "env_cond_cdf", "env_pdf")
OPTIONAL_FIELDS = ("tex_comp", "tex_comp_wh", "envmap_blocks")
META_FIELDS = ("has_lights", "n_lights", "has_textures", "has_envmap")


@dataclasses.dataclass(frozen=True)
class Bvh:
    """Threaded (stackless) LBVH in flat tensors (accel/lbvh.py).

    n_nodes = 2 * n_tris - 1 in DFS preorder, root at 0. Traversal
    follows hit_link on a box hit and miss_link on a miss; leaves carry
    one triangle id. -1 terminates.
    """

    aabb_min: torch.Tensor   # f32 [n_nodes, 3]
    aabb_max: torch.Tensor   # f32 [n_nodes, 3]
    hit_link: torch.Tensor   # i32 [n_nodes] next node in DFS order (or -1)
    miss_link: torch.Tensor  # i32 [n_nodes] skip link (or -1)
    tri_id: torch.Tensor     # i32 [n_nodes] leaf triangle, -1 internal

    def to(self, device) -> "Bvh":
        return Bvh(**{f.name: getattr(self, f.name).to(device)
                      for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class Scene:
    """Scene tables on one device; meta fields are host values."""

    positions: torch.Tensor      # f32 [V, 3]
    normals: torch.Tensor        # f32 [V, 3]
    uvs: torch.Tensor            # f32 [V, 2]
    tangents: torch.Tensor       # f32 [V, 3]
    indices: torch.Tensor        # i32 [T, 3]
    face_material: torch.Tensor  # i32 [T]

    mat_albedo: torch.Tensor     # f32 [M, 3]
    mat_emission: torch.Tensor   # f32 [M, 3]
    mat_roughness: torch.Tensor  # f32 [M]
    mat_metallic: torch.Tensor   # f32 [M]
    mat_ior: torch.Tensor        # f32 [M]
    mat_alpha: torch.Tensor      # f32 [M]
    mat_type: torch.Tensor       # i32 [M]
    mat_albedo_tex: torch.Tensor  # i32 [M], -1 = none
    mat_mr_tex: torch.Tensor      # i32 [M]
    mat_normal_tex: torch.Tensor  # i32 [M]

    textures: torch.Tensor       # u8 [K, TH, TW, 4]
    tex_wh: torch.Tensor         # i32 [K, 2] true (width, height)

    light_v0: torch.Tensor       # f32 [L, 3]
    light_v1: torch.Tensor
    light_v2: torch.Tensor
    light_normal: torch.Tensor
    light_emission: torch.Tensor
    light_area: torch.Tensor     # f32 [L]
    light_cdf: torch.Tensor      # f32 [L]
    light_pdf: torch.Tensor      # f32 [L]
    tri_light_pdf_area: torch.Tensor  # f32 [T]

    # Equirect env map (zeros [1, 1, 3] without one) and its importance
    # tables (scene/envlight.build_env_distribution).
    envmap: torch.Tensor            # f32 [H, W, 3]
    env_marginal_cdf: torch.Tensor  # f32 [H]
    env_cond_cdf: torch.Tensor      # f32 [H, W]
    env_pdf: torch.Tensor           # f32 [H, W] solid-angle pdf

    # Threaded LBVH (accel/lbvh.py), the intersector="bvh" route.
    bvh: Optional[Bvh] = None
    # Packet-traversal accel (accel/cluster.py); one build serves both
    # the closest and the occlusion calls.
    clusters: Optional[object] = None
    # Per-material composite texels: u32 words held in int64 [M, CH, CW, 3]
    # (torch has no general uint32), true dims i32 [M, 2].
    tex_comp: Optional[torch.Tensor] = None
    tex_comp_wh: Optional[torch.Tensor] = None
    # 2x2 bilinear footprint of each env texel, f32 [H, W, 12] (x wraps,
    # y clips): one row gather per env lookup. None without an env map.
    envmap_blocks: Optional[torch.Tensor] = None

    has_lights: bool = False
    n_lights: int = 0
    has_textures: bool = False
    has_envmap: bool = False

    @property
    def device(self) -> torch.device:
        return self.positions.device

    @property
    def n_tris(self) -> int:
        return self.indices.shape[0]

    @property
    def n_vertices(self) -> int:
        return self.positions.shape[0]

    @property
    def n_materials(self) -> int:
        return self.mat_albedo.shape[0]

    def with_bvh(self, bvh: Bvh) -> "Scene":
        return dataclasses.replace(self, bvh=bvh)

    def with_clusters(self, accel) -> "Scene":
        return dataclasses.replace(self, clusters=accel)

    def to(self, device) -> "Scene":
        """Copy every tensor (and the accels) to `device`."""
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor) or hasattr(v, "to"):
                v = v.to(device)
            kw[f.name] = v
        return Scene(**kw)

    def tri_vertices(self, tri_ids):
        """Triangle corner positions ([...,3],)*3 for tri ids [...]."""
        idx = self.indices.long()[tri_ids]
        return (self.positions[idx[..., 0]], self.positions[idx[..., 1]],
                self.positions[idx[..., 2]])


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)   # u32 words ride in int64
    return torch.from_numpy(np.array(a)).to(device)


def scene_from_numpy(fields: dict, *, device) -> Scene:
    """Build a port Scene on `device` from the JAX Scene's arrays (as
    numpy) and meta.

    `fields` maps the JAX field names (TENSOR_FIELDS, OPTIONAL_FIELDS,
    META_FIELDS) to numpy arrays / host values. This is how a scene built
    by the JAX package is carried across for a comparison.
    """
    kw = {k: _tensor(fields[k], device) for k in TENSOR_FIELDS}
    for k in OPTIONAL_FIELDS:
        v = fields.get(k)
        kw[k] = None if v is None else _tensor(v, device)
    kw["has_lights"] = bool(fields["has_lights"])
    kw["n_lights"] = int(fields["n_lights"])
    kw["has_textures"] = bool(fields["has_textures"])
    kw["has_envmap"] = bool(fields["has_envmap"])
    return Scene(**kw)
