"""glTF 2.0 loader -> SceneBuilder (counterpart of pathtracer/scene/gltf.py).

The JAX loader's tables, bit for bit:

- ASCII .gltf and binary .glb; buffers and images embedded (base64 data
  URIs, the GLB binary chunk, buffer views) or external (URI-escaped
  paths beside the file);
- the recursive node walk from the selected scene, each node's `matrix`
  (column-major) or T * R * S composed in float32, baked into world
  space by SceneBuilder.add_mesh;
- POSITION/NORMAL/TANGENT/TEXCOORD_0, u8/u16/u32 indices and
  non-indexed primitives, normalized integer accessors and sparse
  accessors; mode != 4 primitives are skipped;
- PBR metallic-roughness materials numbered in first-use order, with
  KHR_materials_ior, _emissive_strength and _transmission (promoted to
  the dielectric at a factor >= 0.5), and textures deduplicated by
  source image, also in first-use order.

Images (PNG of any kind, baseline or progressive JPEG) decode through
the port's native decoders (utils/native.image_rgba) to the pixels the
JAX loader gets from PIL; a format they do not take (CMYK or
arithmetic-coded JPEG, WebP, KTX2, ...) raises ValueError naming the
image and its format, where the JAX loader tries PIL.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import Dict, Optional
from urllib.parse import unquote

import numpy as np

from pathtracer_torch.scene.build import MaterialDesc, SceneBuilder
from pathtracer_torch.scene.types import MAT_DIELECTRIC
from pathtracer_torch.utils import native

_COMPONENT_DTYPE = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNT = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
               "MAT3": 9, "MAT4": 16}


def _normalize_int(arr: np.ndarray) -> np.ndarray:
    """glTF integer normalization: x / max, clamped at -1 for signed
    types (as the native unpack does)."""
    info = np.iinfo(arr.dtype)
    out = arr.astype(np.float32) / float(info.max)
    if info.min < 0:
        out = np.maximum(out, -1.0)
    return out


class _Gltf:
    def __init__(self, path: str):
        self.path = path
        self.dir = os.path.dirname(os.path.abspath(path))
        self.glb_bin: Optional[bytes] = None
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] == b"glTF":  # GLB container: 12-byte header, chunks
            _, _, length = struct.unpack_from("<III", data, 0)
            off, doc = 12, None
            while off < length:
                clen, ctype = struct.unpack_from("<II", data, off)
                chunk = data[off + 8: off + 8 + clen]
                if ctype == 0x4E4F534A:  # 'JSON'
                    doc = json.loads(chunk)
                elif ctype == 0x004E4942:  # 'BIN'
                    self.glb_bin = chunk
                off += 8 + clen + (-clen) % 4   # 4-byte aligned chunks
            self.doc = doc
        else:
            self.doc = json.loads(data)
        self._buffers: Dict[int, bytes] = {}

    def _read_uri(self, uri: str) -> bytes:
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        with open(os.path.join(self.dir, unquote(uri)), "rb") as f:
            return f.read()

    def buffer(self, i: int) -> bytes:
        if i not in self._buffers:
            uri = self.doc["buffers"][i].get("uri")
            self._buffers[i] = (self.glb_bin if uri is None
                                else self._read_uri(uri))
        return self._buffers[i]

    def accessor(self, i: int) -> np.ndarray:
        acc = self.doc["accessors"][i]
        n = acc["count"]
        ncomp = _TYPE_COUNT[acc["type"]]
        ctype = acc["componentType"]
        dtype = _COMPONENT_DTYPE[ctype]
        itemsize = np.dtype(dtype).itemsize * ncomp
        normalized = bool(acc.get("normalized"))
        sparse = acc.get("sparse")
        if "bufferView" not in acc:
            out = np.zeros((n, ncomp), dtype)
        else:
            bv = self.doc["bufferViews"][acc["bufferView"]]
            data = self.buffer(bv["buffer"])
            start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = bv.get("byteStride") or itemsize
            packed = 0 if stride == itemsize else stride
            if not sparse and (normalized or dtype == np.float32):
                return native.accessor_to_f32(data, start, n, ncomp, ctype,
                                              packed, normalized)
            if stride == itemsize:
                out = np.frombuffer(
                    data, dtype, count=n * ncomp, offset=start
                ).reshape(n, ncomp).copy()
            else:
                raw = np.frombuffer(data, np.uint8)
                rows = np.stack([
                    raw[start + k * stride: start + k * stride + itemsize]
                    for k in range(n)])
                out = rows.view(dtype).reshape(n, ncomp)
        if normalized and np.issubdtype(dtype, np.integer):
            out = _normalize_int(out)
        if sparse:
            # substitution honours sparse.count; indices carry their own
            # componentType, values the accessor's
            sc = int(sparse["count"])
            idx = self._sparse_array(
                sparse["indices"], sc, 1,
                sparse["indices"]["componentType"]).reshape(-1).astype(
                    np.int64)
            vals = self._sparse_array(sparse["values"], sc, ncomp, ctype)
            if normalized and np.issubdtype(dtype, np.integer):
                vals = _normalize_int(vals)
            out = out.copy()
            out[idx] = vals
        return out

    def _sparse_array(self, ref, count, ncomp, component_type):
        bv = self.doc["bufferViews"][ref["bufferView"]]
        data = self.buffer(bv["buffer"])
        start = bv.get("byteOffset", 0) + ref.get("byteOffset", 0)
        dtype = _COMPONENT_DTYPE[component_type]
        arr = np.frombuffer(data, dtype, count=count * ncomp, offset=start)
        return arr.reshape(count, ncomp) if ncomp > 1 else arr.copy()

    def image_rgba(self, image_index: int) -> np.ndarray:
        """u8 [H, W, 4] of a PNG or JPEG image, the pixels the JAX loader
        gets from its native decoder or from PIL's convert("RGBA")."""
        img = self.doc["images"][image_index]
        if "uri" in img:
            raw = self._read_uri(img["uri"])
            what = (f"{self.path}: image {image_index}"
                    + ("" if img["uri"].startswith("data:")
                       else f" ({unquote(img['uri'])})"))
        else:
            bv = self.doc["bufferViews"][img["bufferView"]]
            start = bv.get("byteOffset", 0)
            raw = self.buffer(bv["buffer"])[start: start + bv["byteLength"]]
            what = f"{self.path}: image {image_index}"
        return native.image_rgba(raw, what)


def _node_matrix(node: dict) -> np.ndarray:
    """Local transform: `matrix`, or T * R * S composed in float32."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m = m @ np.diag(list(node["scale"]) + [1.0]).astype(np.float32)
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w), 0],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w), 0],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y), 0],
            [0, 0, 0, 1]], np.float32)
        m = r @ m
    if "translation" in node:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def load_gltf(path: str, builder: Optional[SceneBuilder] = None,
              transform=None) -> SceneBuilder:
    """Load a .gltf/.glb file into a SceneBuilder (created if not given),
    under the 4x4 `transform` when given."""
    g = _Gltf(path)
    b = builder or SceneBuilder()
    doc = g.doc

    tex_cache: Dict[int, int] = {}     # glTF image index -> builder tex id
    mat_cache: Dict[int, int] = {}     # glTF material index -> builder id

    def get_texture(tex_info) -> int:
        if tex_info is None or tex_info.get("index", -1) < 0:
            return -1
        src = doc["textures"][tex_info["index"]].get("source", -1)
        if src < 0:
            return -1
        if src not in tex_cache:
            tex_cache[src] = b.add_texture(g.image_rgba(src))
        return tex_cache[src]

    def get_material(mi: int) -> int:
        mi = max(mi, -1)                    # -1: the default material
        if mi not in mat_cache and mi < 0:
            mat_cache[mi] = b.add_material(MaterialDesc())
        if mi in mat_cache:
            return mat_cache[mi]
        m = doc["materials"][mi]
        pbr = m.get("pbrMetallicRoughness", {})
        desc = MaterialDesc()
        if "pbrMetallicRoughness" in m:
            bcf = pbr.get("baseColorFactor", [1, 1, 1, 1])
            desc.albedo = tuple(bcf[:3])
            if len(bcf) == 4:
                desc.alpha = float(bcf[3])
            desc.metallic = float(pbr.get("metallicFactor", 1.0))
            desc.roughness = float(pbr.get("roughnessFactor", 1.0))
        ef = m.get("emissiveFactor")
        if ef:
            desc.emission = tuple(ef)
        desc.albedo_tex = get_texture(pbr.get("baseColorTexture"))
        desc.mr_tex = get_texture(pbr.get("metallicRoughnessTexture"))
        desc.normal_tex = get_texture(m.get("normalTexture"))
        exts = m.get("extensions", {})
        ext = exts.get("KHR_materials_ior")
        if ext and "ior" in ext:
            desc.ior = float(ext["ior"])
        ext = exts.get("KHR_materials_emissive_strength")
        if ext and "emissiveStrength" in ext:
            # radiance > 1 rides the extension; emissiveFactor is its hue
            s = float(ext["emissiveStrength"])
            desc.emission = tuple(s * c for c in desc.emission)
        ext = exts.get("KHR_materials_transmission")
        if ext and float(ext.get("transmissionFactor", 0.0)) >= 0.5:
            # no partial-transmission blend: a mostly transmissive
            # material becomes the dielectric, a slightly translucent one
            # stays on the base PBR material
            desc.material_type = MAT_DIELECTRIC
        mat_cache[mi] = b.add_material(desc)
        return mat_cache[mi]

    def attribute(attrs, name):
        return (g.accessor(attrs[name]).astype(np.float32)
                if name in attrs else None)

    def process_node(ni: int, parent: np.ndarray):
        node = doc["nodes"][ni]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            for prim in doc["meshes"][node["mesh"]].get("primitives", []):
                if prim.get("mode", 4) != 4:     # triangles only
                    continue
                attrs = prim["attributes"]
                pos = attribute(attrs, "POSITION")
                if "indices" in prim:
                    idx = g.accessor(prim["indices"]).reshape(-1)
                else:
                    idx = np.arange(len(pos))
                mat = get_material(prim.get("material", -1))
                b.add_mesh(pos, idx.astype(np.int64).reshape(-1, 3), mat,
                           normals=attribute(attrs, "NORMAL"),
                           uvs=attribute(attrs, "TEXCOORD_0"),
                           tangents=attribute(attrs, "TANGENT"),
                           transform=world)
        for child in node.get("children", []):
            process_node(child, world)

    root = np.eye(4, dtype=np.float32)
    if transform is not None:
        root = np.asarray(transform, np.float32).reshape(4, 4)
    scenes = doc.get("scenes",
                     [{"nodes": list(range(len(doc.get("nodes", []))))}])
    for ni in scenes[doc.get("scene", 0)].get("nodes", []):
        process_node(ni, root)
    return b
