"""Wavefront OBJ loader with MTL materials (counterpart of
pathtracer/scene/objload.py).

v/vn/vt, faces triangulated as fans, negative (relative) indices,
usemtl/mtllib with Kd, Ke, Ns, Ni, d, Pm, illum 6/7 (the dielectric)
and map_Kd. Corners are deduplicated over (position, uv, normal) keys,
and each material's faces become one SceneBuilder mesh, as in the JAX
loader. map_Kd reads through the native PNG/JPEG decoders
(utils/native.image_rgba), to the pixels of PIL's convert("RGBA") the
JAX loader reads; a format they do not take raises ValueError naming
the file and its format.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from pathtracer_torch.scene.build import MaterialDesc, SceneBuilder
from pathtracer_torch.scene.types import MAT_DIELECTRIC
from pathtracer_torch.utils import native


def _parse_mtl(path: str, builder: SceneBuilder) -> Dict[str, int]:
    mats: Dict[str, int] = {}
    if not os.path.exists(path):
        return mats
    cur: Optional[MaterialDesc] = None
    cur_name = None
    base = os.path.dirname(path)

    def flush():
        if cur_name is not None and cur is not None:
            mats[cur_name] = builder.add_material(cur)

    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0]
            if key == "newmtl":
                flush()
                cur_name = tok[1] if len(tok) > 1 else "default"
                cur = MaterialDesc()
            elif cur is None:
                continue
            elif key == "Kd":
                cur.albedo = tuple(float(x) for x in tok[1:4])
            elif key == "Ke":
                cur.emission = tuple(float(x) for x in tok[1:4])
            elif key == "Ns":
                # Phong exponent -> roughness (Blinn-Phong heuristic)
                ns = float(tok[1])
                cur.roughness = float(np.clip(np.sqrt(2.0 / (ns + 2.0)),
                                              0.01, 1.0))
            elif key == "Ni":
                cur.ior = float(tok[1])
            elif key == "d":
                cur.alpha = float(tok[1])
            elif key == "Pm":
                cur.metallic = float(tok[1])
            elif key == "map_Kd":
                tex_path = os.path.join(base, tok[-1])
                if os.path.exists(tex_path):
                    with open(tex_path, "rb") as tf:
                        img = native.image_rgba(tf.read(), tex_path)
                    cur.albedo_tex = builder.add_texture(img)
                    cur.albedo = (1.0, 1.0, 1.0)
            elif key == "illum" and len(tok) > 1:
                if tok[1] in ("6", "7"):
                    cur.material_type = MAT_DIELECTRIC
    flush()
    return mats


def load_obj(path: str, builder: Optional[SceneBuilder] = None,
             material: Optional[int] = None,
             transform=None) -> SceneBuilder:
    """Load an OBJ file into a SceneBuilder (created if not given), under
    the 4x4 `transform` when given. A `material` id overrides every
    mtllib material."""
    b = builder or SceneBuilder()
    positions, normals, uvs = [], [], []
    mtl_map: Dict[str, int] = {}

    # per-material index buffers over (pos, uv, nrm) corner keys
    corner_cache: Dict[tuple, int] = {}
    out_pos, out_nrm, out_uv = [], [], []
    faces_by_mat: Dict[int, list] = {}
    cur_mat: Optional[int] = material

    def corner(spec: str) -> int:
        parts = (spec.split("/") + ["", ""])[:3]
        vi = int(parts[0])
        vti = int(parts[1]) if parts[1] else 0
        vni = int(parts[2]) if parts[2] else 0
        vi = vi - 1 if vi > 0 else len(positions) + vi
        vti = vti - 1 if vti > 0 else (len(uvs) + vti if vti else -1)
        vni = vni - 1 if vni > 0 else (len(normals) + vni if vni else -1)
        key = (vi, vti, vni)
        if key not in corner_cache:
            corner_cache[key] = len(out_pos)
            out_pos.append(positions[vi])
            out_uv.append(uvs[vti] if vti >= 0 else (0.0, 0.0))
            out_nrm.append(normals[vni] if vni >= 0 else None)
        return corner_cache[key]

    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0]
            if key == "v":
                positions.append(tuple(float(x) for x in tok[1:4]))
            elif key == "vn":
                normals.append(tuple(float(x) for x in tok[1:4]))
            elif key == "vt":
                uvs.append((float(tok[1]),
                            1.0 - float(tok[2]) if len(tok) > 2 else 0.0))
            elif key == "mtllib" and material is None:
                mtl_map.update(_parse_mtl(
                    os.path.join(os.path.dirname(path), tok[1]), b))
            elif key == "usemtl" and material is None:
                cur_mat = mtl_map.get(tok[1])
            elif key == "f":
                ids = [corner(s) for s in tok[1:]]
                for k in range(1, len(ids) - 1):  # polygon fan
                    faces_by_mat.setdefault(
                        cur_mat if cur_mat is not None else -1, []).append(
                        (ids[0], ids[k], ids[k + 1]))

    if not out_pos:
        raise ValueError(f"no geometry in OBJ file: {path}")

    pos_arr = np.asarray(out_pos, np.float32)
    uv_arr = np.asarray(out_uv, np.float32)
    nrm_arr = (np.asarray(out_nrm, np.float32)
               if all(n is not None for n in out_nrm) else None)

    for mat, faces in faces_by_mat.items():
        mat_id = mat if mat >= 0 else (
            material if material is not None
            else b.add_material(MaterialDesc()))
        b.add_mesh(pos_arr, np.asarray(faces, np.int64), mat_id,
                   normals=nrm_arr, uvs=uv_arr, transform=transform)
    return b
