"""pathtracer_torch's export_glb vs the JAX package's, and its round trip.

The same builder, exported by both packages, gives identical bytes (the
same JSON, accessors and PNG encoder). Exported and loaded back through
the port, a scene keeps its tables as tests/test_export.py requires of
the JAX pair: geometry bit-exact, material fields per face, texels per
texture pair, the light tables; a 16x16 render of the loaded asset on
the CPU equals the in-memory build's film.
"""

import json
import struct

import numpy as np
import pytest
import torch

from pathtracer.scene.build import MaterialDesc as JMat
from pathtracer.scene.build import SceneBuilder as JBuilder
from pathtracer.scene.export import export_glb as jexport
from pathtracer.scene.gltf import load_gltf as jload
from pathtracer.scene.procedural import sponza_like as jsponza
from pathtracer_torch.scene.build import MaterialDesc as TMat
from pathtracer_torch.scene.build import SceneBuilder as TBuilder
from pathtracer_torch.scene.export import export_glb as texport
from pathtracer_torch.scene.gltf import load_gltf as tload
from pathtracer_torch.scene.procedural import sponza_like as tsponza
from pathtracer_torch.scene.types import MAT_DIELECTRIC
from tests.test_torch_loaders import assert_same_tables


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Small renders: two intra-op threads keep test files that run side
    by side from oversubscribing the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _extension_materials(builder_cls, mat_cls):
    """tests/test_export.py's builder: a dielectric with ior 1.33, a
    metallic alpha-blended material and an emitter above 1, plus a mesh
    with w = -1 tangents."""
    b = builder_cls()
    glass = b.add_material(mat_cls(
        albedo=(1.0, 0.9, 0.9), material_type=MAT_DIELECTRIC, ior=1.33,
        roughness=0.05))
    shiny = b.add_material(mat_cls(
        albedo=(0.9, 0.6, 0.2), metallic=0.7, roughness=0.3, alpha=0.5))
    lamp = b.add_material(mat_cls(
        albedo=(1, 1, 1), emission=(12.0, 6.0, 3.0)))
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    tri = np.array([[0, 1, 2]], np.int64)
    b.add_mesh(v[:3], tri, glass)
    b.add_mesh(v[1:], tri, shiny)
    b.add_mesh(v[[0, 2, 3]], tri, lamp)
    b.add_mesh(v[:3], tri, shiny, tangents=np.array(
        [[1, 0, 0, -1], [1, 0, 0, -1], [0, 1, 0, 1]], np.float32))
    return b


BUILDERS = {
    "sponza_textured": (lambda: jsponza(target_tris=3_000, textured=True),
                        lambda: tsponza(target_tris=3_000, textured=True)),
    "extension_materials": (lambda: _extension_materials(JBuilder, JMat),
                            lambda: _extension_materials(TBuilder, TMat)),
}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_export_bytes_equal_jax(tmp_path, name):
    jb, tb = (f() for f in BUILDERS[name])
    jexport(jb, str(tmp_path / "j.glb"))
    texport(tb, str(tmp_path / "t.glb"))
    a = (tmp_path / "j.glb").read_bytes()
    b = (tmp_path / "t.glb").read_bytes()
    assert len(a) == len(b) and a == b
    # and either package loads the other's file to the same tables
    assert_same_tables(jload(str(tmp_path / "t.glb")),
                       tload(str(tmp_path / "j.glb")))


def _per_face(tables, name):
    """A material field per face: invariant to the loader's first-use
    material numbering."""
    return tables[name][tables["face_material"]]


def _roundtrip(builder, tmp_path):
    path = str(tmp_path / "rt.glb")
    texport(builder, path)
    return tload(path)


def test_sponza_textured_roundtrip(tmp_path):
    orig = tsponza(target_tris=3_000, textured=True).finalize_numpy()
    back = _roundtrip(tsponza(target_tris=3_000, textured=True),
                      tmp_path).finalize_numpy()
    for name in ("positions", "normals", "uvs", "tangents", "indices"):
        np.testing.assert_array_equal(orig[name], back[name], err_msg=name)
    for name in ("mat_albedo", "mat_roughness", "mat_metallic", "mat_ior",
                 "mat_alpha", "mat_type", "mat_emission"):
        np.testing.assert_array_equal(_per_face(orig, name),
                                      _per_face(back, name), err_msg=name)
    for field in ("mat_albedo_tex", "mat_mr_tex", "mat_normal_tex"):
        of, bf = _per_face(orig, field), _per_face(back, field)
        for o, b in set(zip(of.tolist(), bf.tolist())):
            assert (o >= 0) == (b >= 0), field
            if o >= 0:
                np.testing.assert_array_equal(orig["tex_wh"][o],
                                              back["tex_wh"][b])
                np.testing.assert_array_equal(orig["textures"][o],
                                              back["textures"][b],
                                              err_msg=f"{field} texels")
    assert orig["n_lights"] == back["n_lights"]
    for name in ("light_cdf", "light_pdf", "light_emission", "light_v0"):
        np.testing.assert_array_equal(orig[name], back[name], err_msg=name)


def test_extension_materials_roundtrip(tmp_path):
    back = _roundtrip(_extension_materials(TBuilder, TMat), tmp_path)
    t = back.finalize_numpy()
    assert _per_face(t, "mat_type").tolist() == [MAT_DIELECTRIC, 0, 0, 0]
    np.testing.assert_array_equal(_per_face(t, "mat_ior"),
                                  np.float32([1.33, 1.5, 1.5, 1.5]))
    np.testing.assert_array_equal(_per_face(t, "mat_metallic"),
                                  np.float32([0.0, 0.7, 0.0, 0.7]))
    np.testing.assert_array_equal(_per_face(t, "mat_alpha"),
                                  np.float32([1.0, 0.5, 1.0, 0.5]))
    np.testing.assert_allclose(_per_face(t, "mat_emission")[2],
                               [12.0, 6.0, 3.0], rtol=1e-6)
    # the tangent handedness survives the round trip
    np.testing.assert_array_equal(back._tangent_w[3], [-1, -1, 1])
    np.testing.assert_array_equal(back._tangents[3],
                                  np.float32([[1, 0, 0], [1, 0, 0],
                                              [0, 1, 0]]))


def test_partial_transmission_not_promoted(tmp_path):
    """transmissionFactor below 0.5 keeps the base material."""
    b = TBuilder()
    mat = b.add_material(TMat(material_type=MAT_DIELECTRIC))
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    b.add_mesh(v, np.array([[0, 1, 2]], np.int64), mat)
    path = str(tmp_path / "t.glb")
    texport(b, path)
    raw = bytearray(open(path, "rb").read())
    jlen = struct.unpack_from("<I", raw, 12)[0]
    js = json.loads(raw[20:20 + jlen])
    ext = js["materials"][0]["extensions"]["KHR_materials_transmission"]
    assert ext["transmissionFactor"] == 1.0
    ext["transmissionFactor"] = 0.1
    enc = json.dumps(js, separators=(",", ":")).encode()
    enc += b" " * ((-len(enc)) % 4)
    body = bytes(raw[20 + jlen:])
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(enc)
                            + len(body)))
        f.write(struct.pack("<II", len(enc), 0x4E4F534A) + enc)
        f.write(body)
    assert _per_face(tload(path).finalize_numpy(), "mat_type").tolist() \
        == [0]


@pytest.mark.parametrize("what", ["triangles", "meshes"])
def test_export_rejects_empty(tmp_path, what):
    b = TBuilder()
    mat = b.add_material(TMat())
    if what == "triangles":
        v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
        n = np.tile(np.array([[0, 0, 1]], np.float32), (3, 1))
        b.add_mesh(v, np.zeros((0, 3), np.int64), mat, normals=n)
    with pytest.raises(ValueError, match=f"no {what}"):
        texport(b, str(tmp_path / "x.glb"))


def test_exported_asset_renders_identically(tmp_path):
    """export -> disk -> load -> accel -> render on the CPU equals the
    in-memory build's film."""
    from pathtracer_torch.accel.cluster import build_scene_clusters
    from pathtracer_torch.config import RenderConfig
    from pathtracer_torch.integrator.camera import Camera
    from pathtracer_torch.render import render_frame_with_stats

    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=3,
                       spp_batch=True)
    cam = Camera(position=(3.0, 4.5, 6.0))
    cam.look_at((14.0, 3.0, 6.0))

    def render(builder):
        scene = build_scene_clusters(builder.finalize(device="cpu"))
        img, rays = render_frame_with_stats(scene, cfg,
                                            cam.state(device="cpu"), 0)[:2]
        return img, int(rays)

    direct, rays_d = render(tsponza(target_tris=2_000, textured=True))
    viadisk, rays_v = render(_roundtrip(
        tsponza(target_tris=2_000, textured=True), tmp_path))
    assert rays_d == rays_v
    torch.testing.assert_close(viadisk, direct, rtol=0, atol=0)
