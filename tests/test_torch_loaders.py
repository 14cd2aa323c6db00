"""pathtracer_torch's glTF/GLB and OBJ/MTL loaders vs the JAX package's.

Every asset is written in tmp_path from a numpy seed and loaded by both
loaders; the port's SceneBuilder.finalize_numpy() must equal the JAX
builder's finalize() field for field, bit for bit: geometry, face
materials, every mat_* field, the texture stack and tex_wh, the light
tables and the CDF. PNG textures are made with PIL here, so the port's
native decoders are held to the image PIL gives the JAX loader. Images
the decoders leave out raise ValueError naming the file and the format;
nothing in the port imports PIL.
"""

import base64
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from pathtracer.scene.gltf import load_gltf as jload_gltf
from pathtracer.scene.objload import load_obj as jload_obj
from pathtracer_torch.scene.gltf import load_gltf as tload_gltf
from pathtracer_torch.scene.objload import load_obj as tload_obj
from pathtracer_torch.scene.types import (META_FIELDS, OPTIONAL_FIELDS,
                                          TENSOR_FIELDS)
from pathtracer_torch.utils import native as tnative
from tests.test_asset_e2e import _build_glb
from tests.test_loaders import MTL_SAMPLE, OBJ_SAMPLE, _tri_gltf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_same_tables(jbuilder, tbuilder):
    """The port builder's tables equal the JAX builder's, bit for bit."""
    js = jbuilder.finalize()
    tf = tbuilder.finalize_numpy()
    for f in TENSOR_FIELDS + OPTIONAL_FIELDS:
        a, b = getattr(js, f), tf[f]
        if a is None:
            assert b is None, f
            continue
        a = np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (f, a.shape, b.shape, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=f)
    for f in META_FIELDS:
        assert tf[f] == getattr(js, f), f
    return tf


def png_bytes(arr, mode=None, **save):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG", **save)
    return buf.getvalue()


def _rgb(rng, h, w, c=3):
    return rng.integers(0, 256, (h, w, c), dtype=np.uint8)


class _Asset:
    """A glTF document and its one binary buffer, written as .gltf (base64
    or an external .bin) or .glb."""

    def __init__(self):
        self.blob = bytearray()
        self.doc = {"asset": {"version": "2.0"}, "bufferViews": [],
                    "accessors": []}

    def view(self, data: bytes, stride=None) -> int:
        self.blob += b"\0" * ((-len(self.blob)) % 4)
        bv = {"buffer": 0, "byteOffset": len(self.blob),
              "byteLength": len(data)}
        if stride:
            bv["byteStride"] = stride
        self.blob += data
        self.doc["bufferViews"].append(bv)
        return len(self.doc["bufferViews"]) - 1

    def accessor(self, arr, ctype, atype, normalized=False, view=None,
                 offset=0, count=None, **extra) -> int:
        acc = {"componentType": ctype,
               "count": int(len(arr) if count is None else count),
               "type": atype, **extra}
        if arr is not None or view is not None:
            acc["bufferView"] = (self.view(np.ascontiguousarray(arr)
                                           .tobytes())
                                 if view is None else view)
        if offset:
            acc["byteOffset"] = offset
        if normalized:
            acc["normalized"] = True
        self.doc["accessors"].append(acc)
        return len(self.doc["accessors"]) - 1

    def write(self, path, kind="b64"):
        doc = dict(self.doc, buffers=[{"byteLength": len(self.blob)}])
        blob = bytes(self.blob)
        if kind == "glb":
            js = json.dumps(doc).encode()
            js += b" " * ((-len(js)) % 4)
            blob += b"\0" * ((-len(blob)) % 4)
            with open(path, "wb") as f:
                f.write(b"glTF" + struct.pack(
                    "<II", 2, 12 + 8 + len(js) + 8 + len(blob)))
                f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
                f.write(struct.pack("<II", len(blob), 0x004E4942) + blob)
            return path
        if kind == "b64":
            doc["buffers"][0]["uri"] = (
                "data:application/octet-stream;base64,"
                + base64.b64encode(blob).decode())
        else:                       # external, URI-escaped file name
            with open(os.path.join(os.path.dirname(path), "geo data.bin"),
                      "wb") as f:
                f.write(blob)
            doc["buffers"][0]["uri"] = "geo%20data.bin"
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


def _grid(rng, n=4):
    """An n x n vertex grid patch with jittered heights: positions, uv,
    normals, tangents (w = +-1) and u16 indices."""
    u, v = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n))
    pos = np.stack([u, rng.normal(0, 0.05, u.shape), v], -1).reshape(-1, 3)
    nrm = rng.normal(0, 1, pos.shape)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    tan = np.concatenate([rng.normal(0, 1, pos.shape),
                          rng.choice([-1.0, 1.0], (len(pos), 1))], -1)
    quads = [(r * n + c, r * n + c + 1, (r + 1) * n + c + 1, (r + 1) * n + c)
             for r in range(n - 1) for c in range(n - 1)]
    idx = np.array([(a, b, c) for a, b, c, d in quads]
                   + [(a, c, d) for a, b, c, d in quads], np.uint16)
    return (pos.astype(np.float32), np.stack([u, v], -1).reshape(-1, 2)
            .astype(np.float32), nrm.astype(np.float32),
            tan.astype(np.float32), idx.reshape(-1))


def _prim(a, rng, *, idx_type=5123, material=None, n=4, strided=False,
          normalized_uv=None, indexed=True):
    pos, uv, nrm, tan, idx = _grid(rng, n)
    if strided:          # interleaved POSITION + NORMAL, one byteStride
        inter = np.concatenate([pos, nrm], 1).astype(np.float32)
        vi = a.view(inter.tobytes(), stride=24)
        attrs = {"POSITION": a.accessor(pos, 5126, "VEC3", view=vi),
                 "NORMAL": a.accessor(nrm, 5126, "VEC3", view=vi,
                                      offset=12)}
    else:
        attrs = {"POSITION": a.accessor(pos, 5126, "VEC3"),
                 "NORMAL": a.accessor(nrm, 5126, "VEC3")}
    attrs["TANGENT"] = a.accessor(tan, 5126, "VEC4")
    if normalized_uv is None:
        attrs["TEXCOORD_0"] = a.accessor(uv, 5126, "VEC2")
    else:
        info = np.iinfo(normalized_uv)
        q = np.round(uv * info.max).astype(normalized_uv)
        ctype = {np.uint8: 5121, np.uint16: 5123, np.int8: 5120,
                 np.int16: 5122}[normalized_uv]
        attrs["TEXCOORD_0"] = a.accessor(q, ctype, "VEC2", normalized=True)
    prim = {"attributes": attrs}
    if indexed:
        dt = {5121: np.uint8, 5123: np.uint16, 5125: np.uint32}[idx_type]
        prim["indices"] = a.accessor(idx.astype(dt), idx_type, "SCALAR")
    else:                # non-indexed: the accessor order is the triangles
        for k in ("POSITION", "NORMAL", "TANGENT", "TEXCOORD_0"):
            acc = a.doc["accessors"][attrs[k]]
            src = {"POSITION": pos, "NORMAL": nrm, "TANGENT": tan,
                   "TEXCOORD_0": uv}[k][idx]
            acc["count"] = len(idx)
            acc["bufferView"] = a.view(src.astype(np.float32).tobytes())
            acc.pop("byteOffset", None)
            acc.pop("normalized", None)
            acc["componentType"] = 5126
    if material is not None:
        prim["material"] = material
    return prim


def _scene_doc(a, prims_per_node, nodes, scene_roots, materials=None,
               scene=0, extra_scenes=()):
    a.doc["meshes"] = [{"primitives": p} for p in prims_per_node]
    a.doc["nodes"] = nodes
    a.doc["scenes"] = list(extra_scenes) + [{"nodes": scene_roots}]
    a.doc["scene"] = scene
    if materials is not None:
        a.doc["materials"] = materials


def _load_both(path, transform=None):
    jb = jload_gltf(path, transform=transform)
    tb = tload_gltf(path, transform=transform)
    return assert_same_tables(jb, tb)


@pytest.mark.parametrize("kind", ["ascii", "glb", "matrix", "trs",
                                  "trs_glb"])
def test_tri_gltf_matches_jax(tmp_path, kind):
    """tests/test_loaders.py's one-triangle asset: ASCII (base64), GLB,
    a matrix node and a TRS node, with a material."""
    mat = {"pbrMetallicRoughness": {"baseColorFactor": [0.9, 0.1, 0.2, 0.8],
                                    "metallicFactor": 0.7,
                                    "roughnessFactor": 0.3},
           "emissiveFactor": [1.0, 2.0, 3.0]}
    kw = dict(material=mat, binary=kind.endswith("glb"))
    if kind == "matrix":
        kw["matrix"] = [0.5, 0.2, 0, 0, -0.2, 0.5, 0, 0, 0, 0, 2, 0,
                        5, 1, -3, 1]
    if kind.startswith("trs"):
        kw["trs"] = {"translation": [0.3, -1.0, 2.0],
                     "rotation": [0.1, 0.7, -0.2, 0.6782],
                     "scale": [2.0, 0.5, 1.5]}
    _load_both(_tri_gltf(str(tmp_path), **kw))


@pytest.mark.parametrize("kind", ["b64", "bin", "glb"])
def test_node_tree_and_extensions_match_jax(tmp_path, kind):
    """A node tree (matrix and TRS parents, children, a root transform
    argument, two scenes with the second selected) over strided,
    normalized, u8/u32-indexed and non-indexed primitives, a mode-1
    primitive skipped, materials with all three extensions, a factor
    below the transmission promotion, one without material and a
    material referenced twice."""
    rng = np.random.default_rng(7)
    a = _Asset()
    prims = [
        [_prim(a, rng, material=0, strided=True),
         _prim(a, rng, idx_type=5121, material=1,
               normalized_uv=np.uint8)],
        [_prim(a, rng, idx_type=5125, material=2, normalized_uv=np.int16),
         _prim(a, rng, indexed=False, material=3),
         dict(_prim(a, rng), mode=1)],
        [_prim(a, rng, normalized_uv=np.uint16),
         _prim(a, rng, material=1, normalized_uv=np.int8)],
    ]
    materials = [
        {"pbrMetallicRoughness": {"baseColorFactor": [0.2, 0.4, 0.6, 1.0],
                                  "roughnessFactor": 0.25},
         "extensions": {"KHR_materials_ior": {"ior": 1.33},
                        "KHR_materials_transmission": {
                            "transmissionFactor": 0.9}}},
        {"emissiveFactor": [1.0, 0.5, 0.25],
         "extensions": {"KHR_materials_emissive_strength": {
             "emissiveStrength": 7.5}}},
        {"pbrMetallicRoughness": {"baseColorFactor": [0.9, 0.9, 0.1],
                                  "metallicFactor": 0.0},
         "extensions": {"KHR_materials_transmission": {
             "transmissionFactor": 0.2}}},
        {"pbrMetallicRoughness": {}},
    ]
    nodes = [
        {"children": [1, 2], "matrix": [1, 0, 0, 0, 0, 0.8, 0.6, 0,
                                        0, -0.6, 0.8, 0, 1, 2, 3, 1]},
        {"mesh": 0, "translation": [0.5, 0, -1], "scale": [1, 2, 1]},
        {"children": [3], "rotation": [0.0, 0.3826834, 0.0, 0.9238795]},
        {"mesh": 1, "scale": [0.5, 0.5, 0.5]},
        {"mesh": 2},                        # only in the unselected scene
        {"mesh": 2, "translation": [-2, 0, 0]},
    ]
    _scene_doc(a, prims, nodes, [0, 5], materials, scene=1,
               extra_scenes=[{"nodes": [4]}])
    path = a.write(str(tmp_path / ("s.glb" if kind == "glb" else "s.gltf")),
                   kind)
    tf = _load_both(path)
    assert tf["mat_type"].tolist().count(2) == 1      # factor 0.9 only
    m = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    m[:3, 3] = (1, -1, 0.5)
    _load_both(path, transform=m)


def test_sparse_accessors_match_jax(tmp_path):
    """Sparse substitution into a buffer-backed f32 accessor (u16 sparse
    indices, trailing garbage after the values) and into a zero-filled
    normalized u8 accessor without a bufferView (u8 sparse indices)."""
    rng = np.random.default_rng(3)
    a = _Asset()
    pos, uv, nrm, _, idx = _grid(rng)
    sp_idx = np.array([2, 5, 9], np.uint16)
    sp_val = rng.normal(0, 1, (3, 3)).astype(np.float32)
    junk = np.full(6, 7.5, np.float32)
    sp_i = a.view(sp_idx.tobytes())
    sp_v = a.view(sp_val.tobytes() + junk.tobytes())
    uv_idx = np.array([0, 3, 4, 15], np.uint8)
    uv_val = rng.integers(0, 256, (4, 2), dtype=np.uint8)
    attrs = {
        "POSITION": a.accessor(pos, 5126, "VEC3", sparse={
            "count": 3, "indices": {"bufferView": sp_i,
                                    "componentType": 5123},
            "values": {"bufferView": sp_v}}),
        "NORMAL": a.accessor(nrm, 5126, "VEC3"),
        "TEXCOORD_0": a.accessor(None, 5121, "VEC2", normalized=True,
                                 count=len(pos), sparse={
            "count": 4, "indices": {"bufferView": a.view(uv_idx.tobytes()),
                                    "componentType": 5121},
            "values": {"bufferView": a.view(uv_val.tobytes())}}),
    }
    prim = {"attributes": attrs, "indices": a.accessor(idx, 5123, "SCALAR")}
    _scene_doc(a, [[prim]], [{"mesh": 0}], [0])
    tf = _load_both(a.write(str(tmp_path / "sparse.gltf")))
    np.testing.assert_array_equal(tf["positions"][[2, 5, 9]], sp_val)


def _textured(tmp_path, kind, images, slots):
    """A patch per material; `images` are image entries (built against
    the asset), `slots` per material (albedo, mr, normal) texture ids."""
    rng = np.random.default_rng(11)
    a = _Asset()
    imgs = images(a)
    a.doc["images"] = imgs
    # two textures per image: deduplication is by source image
    a.doc["textures"] = [{"source": i // 2} for i in range(2 * len(imgs))]
    mats, prims = [], []
    for k, (alb, mr, nm) in enumerate(slots):
        pbr = {"baseColorFactor": [1, 1, 1, 1]}
        if alb is not None:
            pbr["baseColorTexture"] = {"index": alb}
        if mr is not None:
            pbr["metallicRoughnessTexture"] = {"index": mr}
        m = {"pbrMetallicRoughness": pbr}
        if nm is not None:
            m["normalTexture"] = {"index": nm}
        mats.append(m)
        prims.append(_prim(a, rng, material=k))
    _scene_doc(a, [prims], [{"mesh": 0}], [0], mats)
    return a.write(str(tmp_path / f"tex.{'glb' if kind == 'glb' else 'gltf'}"),
                   "glb" if kind == "glb" else "b64")


@pytest.mark.parametrize("kind", ["gltf", "glb"])
def test_textures_match_jax(tmp_path, kind):
    """Images in a buffer view, as a base64 data URI and as an external
    URI-escaped file; RGB, RGBA, gray, gray + alpha and palette (with and
    without tRNS) PNGs padded to RGBA as the JAX loader pads them;
    textures deduplicated by source image in first-use order."""
    rng = np.random.default_rng(5)
    pal = Image.fromarray(_rgb(rng, 6, 9)).quantize(32)     # 8-bit index
    pal_t = pal.copy()
    pal_t.info["transparency"] = bytes(range(0, 256, 8))
    pngs = [png_bytes(_rgb(rng, 8, 8)), png_bytes(_rgb(rng, 4, 16, 4)),
            png_bytes(_rgb(rng, 16, 4, 1)[..., 0]),
            png_bytes(_rgb(rng, 5, 7, 2), "LA")]
    for im in (pal, pal_t):
        buf = io.BytesIO()
        im.save(buf, format="PNG", **({"transparency": im.info[
            "transparency"]} if "transparency" in im.info else {}))
        pngs.append(buf.getvalue())
    with open(tmp_path / "my tex.png", "wb") as f:
        f.write(pngs[1])

    def images(a):
        return [{"bufferView": a.view(pngs[0]), "mimeType": "image/png"},
                {"uri": "my%20tex.png"},
                {"uri": "data:image/png;base64,"
                        + base64.b64encode(pngs[2]).decode()},
                {"bufferView": a.view(pngs[3]), "mimeType": "image/png"},
                {"bufferView": a.view(pngs[4]), "mimeType": "image/png"},
                {"bufferView": a.view(pngs[5]), "mimeType": "image/png"}]

    slots = [(5, 0, None), (1, 2, 4), (None, None, 7), (3, 8, 10),
             (11, None, 6)]
    tf = _load_both(_textured(tmp_path, kind, images, slots))
    assert tf["textures"].shape[0] == 6 and tf["has_textures"]


@pytest.mark.parametrize("fmt", ["jpeg", "png16", "png4", "interlaced"])
def test_undecodable_texture_raises(tmp_path, fmt):
    """A JPEG, a 16-bit PNG, a 4-bit palette PNG and an interlaced PNG
    texture (which the JAX loader decodes through PIL) now load with the
    JAX loader's tables; their neighbours the decoders leave out - a CMYK
    JPEG, a 16-bit palette PNG, a 4-bit RGB PNG and interlace method 2 -
    raise ValueError naming the file, the image and its format."""
    from pathtracer.utils import native as jnative

    rng = np.random.default_rng(1)
    if fmt == "jpeg":
        buf = io.BytesIO()
        Image.fromarray(_rgb(rng, 8, 8)).save(buf, format="JPEG")
        raw = buf.getvalue()
        buf = io.BytesIO()
        Image.fromarray(_rgb(rng, 8, 8, 4), "CMYK").save(buf, format="JPEG")
        bad, name = buf.getvalue(), "CMYK JPEG"
    elif fmt == "png16":
        raw = png_bytes(rng.integers(0, 65535, (8, 8)).astype(np.uint16))
        bad = _with_ihdr(png_bytes(_rgb(rng, 8, 8)), depth=16, color=3)
        name = "PNG of bit depth 16 and colour type 3"
    elif fmt == "png4":
        buf = io.BytesIO()
        Image.fromarray(_rgb(rng, 8, 8)).quantize(16).save(buf, format="PNG")
        raw = buf.getvalue()
        bad = _with_ihdr(raw, depth=4, color=2)
        name = "PNG of bit depth 4 and colour type 2"
    else:
        raw = png_bytes(_rgb(rng, 8, 8))
        bad, name = _with_ihdr(raw, interlace=2), "interlace method 2"
        raw = _interlaced(raw)
    assert jnative.png_decode(raw) is None    # JAX's loader takes PIL's path
    with open(tmp_path / "bad.img", "wb") as f:
        f.write(raw)
    path = _textured(tmp_path, "gltf",
                     lambda a: [{"uri": "bad.img"}], [(0, None, None)])
    assert _load_both(path)["has_textures"]
    with open(tmp_path / "bad.img", "wb") as f:
        f.write(bad)
    with pytest.raises(ValueError, match=rf"tex\.gltf: image 0 \(bad\.img\)"
                                         rf".*{name}"):
        tload_gltf(path)


def _with_ihdr(png: bytes, depth=None, color=None, interlace=None) -> bytes:
    """The PNG with IHDR fields replaced (CRC recomputed)."""
    raw = bytearray(png)
    for at, v in ((24, depth), (25, color), (28, interlace)):
        if v is not None:
            raw[at] = v
    raw[29:33] = struct.pack(">I", zlib.crc32(bytes(raw[12:29])))
    return bytes(raw)


def _interlaced(png: bytes) -> bytes:
    """The PNG re-encoded with Adam7 (every pass filtered by
    image_codecs.png_file): the JAX package's native decoder declines it
    at the probe."""
    import image_codecs

    arr = np.asarray(Image.open(io.BytesIO(png)))
    return image_codecs.png_file(arr, 2, 8, interlace=True)


def test_build_glb_asset_matches_jax(tmp_path):
    """tests/test_asset_e2e.py's exporter-shaped .glb (nested TRS nodes,
    u16 indices, an embedded PNG texture, an emissive panel)."""
    p = str(tmp_path / "scene.glb")
    _build_glb(p)
    tf = _load_both(p)
    assert tf["has_lights"] and tf["has_textures"]


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


OBJ_TEXTURED = """
mtllib tex.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1
v 2 0 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 1 0
usemtl wood
f 1/1/1 2/2/1 3/3/1 4/4/1
f -6/-4/-2 -5/-3/-2 -2/-1/-1
usemtl lamp
f 2/2/2 6/3/2 3/4/2 5/1/2
usemtl nowhere
f 1/1/1 5/2/1 6/3/1
"""

MTL_TEXTURED = """
# materials
newmtl wood
Kd 0.5 0.5 0.5
Ns 30
Pm 0.25
d 0.75
map_Kd {tex}
newmtl lamp
Kd 1 1 1
Ke 4 3 2
newmtl glass
Ni 1.45
illum 6
"""


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_obj_mtl_map_kd_matches_jax(tmp_path, mode):
    """OBJ with quads (fans), negative indices, a usemtl naming no
    material and MTL Kd/Ke/Ns/Pm/d/map_Kd; the map_Kd PNG in each 8-bit
    mode, decoded natively by the port and by PIL's convert("RGBA") in
    the JAX loader."""
    rng = np.random.default_rng(2)
    img = Image.fromarray(_rgb(rng, 6, 10)).convert(mode) if mode != "P" \
        else Image.fromarray(_rgb(rng, 6, 10)).quantize(32)
    img.save(tmp_path / "wood.png")
    _write(tmp_path / "tex.mtl", MTL_TEXTURED.format(tex="wood.png"))
    p = _write(tmp_path / "m.obj", OBJ_TEXTURED)
    tf = assert_same_tables(jload_obj(p), tload_obj(p))
    assert tf["has_textures"]
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (0, 1, 0)
    m[:3, :3] *= 1.5
    assert_same_tables(jload_obj(p, transform=m), tload_obj(p, transform=m))


@pytest.mark.parametrize("case", ["sample", "negative", "quad", "override",
                                  "no_normals"])
def test_obj_cases_match_jax(tmp_path, case):
    """tests/test_loaders.py's OBJ cases (two materials incl. illum 7,
    negative indices, a quad fan), a material override that skips the
    mtllib, and corners without normals (smooth normals computed)."""
    if case == "sample":
        _write(tmp_path / "mats.mtl", MTL_SAMPLE)
        text = OBJ_SAMPLE
    elif case == "negative":
        text = "v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n"
    elif case == "quad":
        text = "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n"
    elif case == "override":
        _write(tmp_path / "mats.mtl", MTL_SAMPLE)
        text = OBJ_SAMPLE
    else:
        text = ("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 1\nvn 0 0 1\n"
                "f 1//1 2//1 3//1\nf 1 3 4\n")
    p = _write(tmp_path / "s.obj", text)
    if case == "override":
        from pathtracer.scene.build import MaterialDesc as JMat
        from pathtracer.scene.build import SceneBuilder as JB
        from pathtracer_torch.scene.build import MaterialDesc as TMat
        from pathtracer_torch.scene.build import SceneBuilder as TB

        jb, tb = JB(), TB()
        jm = jb.add_material(JMat(albedo=(0.1, 0.2, 0.3)))
        tm = tb.add_material(TMat(albedo=(0.1, 0.2, 0.3)))
        assert_same_tables(jload_obj(p, jb, material=jm),
                           tload_obj(p, tb, material=tm))
    else:
        assert_same_tables(jload_obj(p), tload_obj(p))


def test_obj_undecodable_map_kd_raises(tmp_path):
    """A CMYK JPEG map_Kd (misnamed .png) raises naming the file and the
    format; a YCbCr JPEG so misnamed loads (tests/test_torch_images.py)."""
    buf = io.BytesIO()
    Image.fromarray(_rgb(np.random.default_rng(0), 8, 8, 4), "CMYK").save(
        buf, format="JPEG")
    with open(tmp_path / "wood.png", "wb") as f:       # a JPEG, misnamed
        f.write(buf.getvalue())
    _write(tmp_path / "tex.mtl", MTL_TEXTURED.format(tex="wood.png"))
    p = _write(tmp_path / "m.obj", OBJ_TEXTURED)
    with pytest.raises(ValueError,
                       match=r"wood\.png: cannot decode a CMYK JPEG"):
        tload_obj(p)


def test_obj_without_geometry_raises(tmp_path):
    p = _write(tmp_path / "e.obj", "# nothing\n")
    with pytest.raises(ValueError, match="no geometry"):
        tload_obj(p)


@pytest.mark.parametrize("ctype,dtype", [(5120, np.int8), (5121, np.uint8),
                                         (5122, np.int16),
                                         (5123, np.uint16)])
@pytest.mark.parametrize("stride", [0, 12])
def test_native_accessor_unpack_matches_numpy(ctype, dtype, stride):
    """accessor_to_f32 (normalized and not) and accessor_to_i32 against
    numpy and the JAX package's own normalization rule."""
    from pathtracer.scene.gltf import _normalize_int

    rng = np.random.default_rng(ctype + stride)
    info = np.iinfo(dtype)
    vals = rng.integers(info.min, info.max + 1, (9, 2)).astype(dtype)
    vals[0, 0] = info.min
    item = vals.itemsize * 2
    step = stride or item
    buf = bytearray(8 + step * 9)
    for k in range(9):
        buf[8 + k * step: 8 + k * step + item] = vals[k].tobytes()
    buf = bytes(buf)
    np.testing.assert_array_equal(
        tnative.accessor_to_f32(buf, 8, 9, 2, ctype, stride, False),
        vals.astype(np.float32))
    np.testing.assert_array_equal(
        tnative.accessor_to_f32(buf, 8, 9, 2, ctype, stride, True),
        _normalize_int(vals))
    if ctype in (5121, 5123):       # index types: first component each
        np.testing.assert_array_equal(
            tnative.accessor_to_i32(buf, 8, 9, ctype, stride or item),
            vals[:, 0])
    with pytest.raises(ValueError, match="does not fit"):
        tnative.accessor_to_f32(buf, 8, 10, 2, ctype, stride, False)


def test_port_imports_no_jax_pil_or_jax_package():
    """No module of pathtracer_torch and no line of chip_smoke.py imports
    jax, PIL or the JAX package."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "pathtracer_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        for line in open(path):
            s = line.strip()
            if not s.startswith(("import ", "from ")):
                continue
            mod = s.split()[1]
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "PIL"), (path, s)
            assert top != "pathtracer", (path, s)
