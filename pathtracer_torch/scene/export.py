"""glTF 2.0 binary (.glb) exporter from a SceneBuilder (counterpart of
pathtracer/scene/export.py).

The inverse of scene/gltf.py, so the from-disk asset path can run at the
headline's size without binary fixtures in the repository:

    export_glb(sponza_like(textured=True), "sponza.glb")
    scene = load_gltf("sponza.glb").finalize(device="cpu")

It writes the JAX exporter's bytes for the same builder (the same JSON
key order and float formatting, the same native PNG encoder):
- one mesh, primitive and identity node per add_mesh call, world-space
  POSITION/NORMAL/TEXCOORD_0/TANGENT (w = the kept handedness) and
  uint32 indices;
- pbrMetallicRoughness materials (baseColorFactor + alpha, metallic and
  roughness factors, emissiveFactor, the three texture slots),
  KHR_materials_ior, KHR_materials_transmission for the dielectric and
  KHR_materials_emissive_strength for radiances above 1;
- textures as embedded PNG, alpha dropped where it is constant 1.
The env map is not representable in glTF; pass it with --envmap.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from pathtracer_torch.scene.build import SceneBuilder
from pathtracer_torch.scene.types import MAT_DIELECTRIC
from pathtracer_torch.utils import native

_COMP_F32 = 5126
_COMP_U32 = 5125


def _encode_png(tex_f32: np.ndarray) -> bytes:
    """f32 [h, w, 4] in 0..1 -> PNG bytes (u8, round to nearest); an
    alpha plane of constant 255 is dropped."""
    u8 = np.clip(np.rint(tex_f32 * 255.0), 0, 255).astype(np.uint8)
    if u8.shape[-1] == 4 and (u8[..., 3] == 255).all():
        u8 = u8[..., :3]
    return native.png_encode(np.ascontiguousarray(u8))


class _Bin:
    """4-byte-aligned binary-chunk accumulator -> bufferViews."""

    def __init__(self):
        self.parts = []
        self.views = []
        self.offset = 0

    def add(self, data: bytes) -> int:
        pad = (-len(data)) % 4
        self.views.append({"buffer": 0, "byteOffset": self.offset,
                           "byteLength": len(data)})
        self.parts.append(data + b"\x00" * pad)
        self.offset += len(data) + pad
        return len(self.views) - 1

    def blob(self) -> bytes:
        return b"".join(self.parts)


def _material_json(desc, used_exts: set) -> dict:
    m: dict = {"pbrMetallicRoughness": {}}
    pbr = m["pbrMetallicRoughness"]
    pbr["baseColorFactor"] = [float(c) for c in desc.albedo] + [
        float(desc.alpha)]
    pbr["metallicFactor"] = float(desc.metallic)
    pbr["roughnessFactor"] = float(desc.roughness)
    if desc.albedo_tex >= 0:
        pbr["baseColorTexture"] = {"index": int(desc.albedo_tex)}
    if desc.mr_tex >= 0:
        pbr["metallicRoughnessTexture"] = {"index": int(desc.mr_tex)}
    if desc.normal_tex >= 0:
        m["normalTexture"] = {"index": int(desc.normal_tex)}
    if desc.alpha < 1.0:
        m["alphaMode"] = "BLEND"

    emission = np.asarray(desc.emission, np.float64)
    if (emission != 0).any():
        peak = float(emission.max())
        if peak > 1.0:  # the spec caps emissiveFactor at 1; carry the scale
            m["emissiveFactor"] = (emission / peak).tolist()
            m.setdefault("extensions", {})[
                "KHR_materials_emissive_strength"] = {
                    "emissiveStrength": peak}
            used_exts.add("KHR_materials_emissive_strength")
        else:
            m["emissiveFactor"] = emission.tolist()

    if desc.ior != 1.5:
        m.setdefault("extensions", {})["KHR_materials_ior"] = {
            "ior": float(desc.ior)}
        used_exts.add("KHR_materials_ior")

    if desc.material_type == MAT_DIELECTRIC:
        m.setdefault("extensions", {})["KHR_materials_transmission"] = {
            "transmissionFactor": 1.0}
        used_exts.add("KHR_materials_transmission")
    return m


def export_glb(builder: SceneBuilder, path: str) -> None:
    """Write the builder's meshes, materials and textures as a binary
    glTF."""
    if not builder._positions:
        raise ValueError("export_glb: builder has no meshes")

    binchunk = _Bin()
    accessors = []
    meshes = []
    nodes = []

    def accessor(view: int, comp: int, count: int, atype: str,
                 bounds=None) -> int:
        acc = {"bufferView": view, "componentType": comp,
               "count": int(count), "type": atype}
        if bounds is not None:
            acc["min"] = [float(v) for v in bounds[0]]
            acc["max"] = [float(v) for v in bounds[1]]
        accessors.append(acc)
        return len(accessors) - 1

    offset = 0
    for i, pos in enumerate(builder._positions):
        n = len(pos)
        if n == 0 or len(builder._indices[i]) == 0:
            raise ValueError(
                f"export_glb: mesh {i} has no "
                f"{'vertices' if n == 0 else 'triangles'} - glTF requires "
                "non-empty primitives (drop it before export)")
        pos = np.ascontiguousarray(pos, np.float32)
        nrm = np.ascontiguousarray(builder._normals[i], np.float32)
        uv = np.ascontiguousarray(builder._uvs[i], np.float32)
        tan = np.ascontiguousarray(np.concatenate(   # VEC4, w = handedness
            [np.asarray(builder._tangents[i], np.float32),
             builder._tangent_w[i].reshape(n, 1)], axis=1))
        # the builder holds globally offset indices; export per mesh
        idx = np.ascontiguousarray(
            (builder._indices[i] - offset).reshape(-1).astype(np.uint32))
        offset += n

        attrs = {
            "POSITION": accessor(binchunk.add(pos.tobytes()), _COMP_F32, n,
                                 "VEC3", (pos.min(0), pos.max(0))),
            "NORMAL": accessor(binchunk.add(nrm.tobytes()), _COMP_F32, n,
                               "VEC3"),
            "TEXCOORD_0": accessor(binchunk.add(uv.tobytes()), _COMP_F32, n,
                                   "VEC2"),
            "TANGENT": accessor(binchunk.add(tan.tobytes()), _COMP_F32, n,
                                "VEC4"),
        }
        prim = {
            "attributes": attrs,
            "indices": accessor(binchunk.add(idx.tobytes()), _COMP_U32,
                                idx.size, "SCALAR"),
            "material": int(builder._face_material[i][0]),
        }
        meshes.append({"primitives": [prim]})
        nodes.append({"mesh": len(meshes) - 1, "name": f"mesh{i}"})

    images = []
    textures = []
    for t in builder.textures:
        images.append({"bufferView": binchunk.add(_encode_png(t)),
                       "mimeType": "image/png"})
        textures.append({"sampler": 0, "source": len(images) - 1})

    used_exts: set = set()
    materials = [_material_json(d, used_exts) for d in builder.materials]

    doc = {
        "asset": {"version": "2.0", "generator": "pathtracer-tpu"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": meshes,
        "materials": materials,
        "accessors": accessors,
        "bufferViews": binchunk.views,
        "buffers": [{"byteLength": binchunk.offset}],
    }
    if textures:
        doc["samplers"] = [{"wrapS": 10497, "wrapT": 10497}]  # REPEAT
        doc["images"] = images
        doc["textures"] = textures
    if used_exts:
        doc["extensionsUsed"] = sorted(used_exts)

    json_bytes = json.dumps(doc, separators=(",", ":")).encode()
    json_bytes += b" " * ((-len(json_bytes)) % 4)
    bin_bytes = binchunk.blob()

    total = 12 + 8 + len(json_bytes) + 8 + len(bin_bytes)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))       # glTF v2
        f.write(struct.pack("<II", len(json_bytes), 0x4E4F534A))  # JSON
        f.write(json_bytes)
        f.write(struct.pack("<II", len(bin_bytes), 0x004E4942))   # BIN
        f.write(bin_bytes)
