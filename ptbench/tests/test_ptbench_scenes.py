"""The frozen scene generators give the program's own arrays at seed 0,
and a configuration's generator is found by name from a module of its
own."""

from __future__ import annotations

import hashlib
import sys

import numpy as np
import pytest

from ptbench import scenes
from ptbench.scenes import procedural, rgbe


def port_builder(spec):
    from pathtracer_torch.scene.build import MaterialDesc, SceneBuilder

    b = SceneBuilder()
    for m in spec.materials:
        b.add_material(MaterialDesc(**m))
    for t in spec.textures:
        b.add_texture(t)
    if spec.envmap is not None:
        b.set_envmap(spec.envmap)
    for m in spec.meshes:
        b.add_mesh(**m)
    return b


def same_tables(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("textured", [True, False])
def test_sponza_like_matches_the_program(textured):
    from pathtracer_torch.scene import procedural as pp

    same_tables(port_builder(procedural.sponza_like(262_000, 0, textured))
                .finalize_numpy(),
                pp.sponza_like(262_000, seed=0, textured=textured)
                .finalize_numpy())


@pytest.mark.parametrize("subdivisions", [2, 5])
def test_bunny_like_matches_the_program(subdivisions):
    from pathtracer_torch.scene import procedural as pp

    same_tables(port_builder(procedural.bunny_like(subdivisions))
                .finalize_numpy(),
                pp.bunny_like(subdivisions).finalize_numpy())


def test_envmap_scene_matches_the_configs_sweep(tmp_path):
    from pathtracer_torch.bench import configs

    want = configs.envmap_scene(str(tmp_path))
    got = port_builder(procedural.envmap_scene()).finalize(device="cpu")
    for k in ("positions", "indices", "normals", "uvs", "textures",
              "mat_albedo", "mat_albedo_tex", "envmap", "env_pdf",
              "env_cond_cdf", "light_cdf"):
        assert np.array_equal(getattr(got, k).numpy(),
                              getattr(want, k).numpy()), k


def test_rgbe_round_trip_is_the_files(tmp_path):
    from pathtracer_torch.scene import hdr

    img = np.random.default_rng(0).random((16, 40, 3)).astype(
        np.float32) * np.float32(50.0)
    img[3, 5] = 0.0
    path = str(tmp_path / "x.hdr")
    hdr.write_hdr(path, img)
    assert np.array_equal(rgbe.decode(rgbe.encode(img)), hdr.read_hdr(path))


def test_unknown_generator_is_refused():
    with pytest.raises(ValueError, match="sponza_like") as e:
        scenes.generate("cornell", {})
    for name in ("bunny_like", "envmap_scene"):
        assert name in str(e.value)
    assert {"bunny_like", "envmap_scene", "sponza_like"} <= set(
        scenes.names())
    assert not {"procedural", "rgbe"} & set(scenes.names())


@pytest.mark.parametrize("name", ["procedural", "rgbe", "procedural.icosphere",
                                  "..scenes", ""])
def test_helper_module_is_refused(name):
    """A module of helpers, or a name that is no module here, is no
    generator."""
    with pytest.raises(ValueError, match="unknown scene generator"):
        scenes.module(name)


def spec_digest(spec) -> str:
    """sha256 over a SceneSpec's materials and every array, in order."""
    h = hashlib.sha256()

    def arr(a):
        if a is None:
            h.update(b"none")
            return
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())

    for m in spec.materials:
        h.update(repr(sorted(m.items())).encode())
    for t in spec.textures:
        arr(t)
    for m in spec.meshes:
        for k in ("positions", "indices", "uvs", "tangents"):
            arr(m[k])
        h.update(str(m["material"]).encode())
    arr(spec.envmap)
    return h.hexdigest()


# digests of the two cells' scenes as the generators gave them when each
# configuration's scene was still looked up in one closed table
PINNED = {
    "sponza_like": (dict(target_tris=262000, seed=0, textured=True),
                    "c7d47ae6aaab6568b273b40cb61a3d23"
                    "bbe1d4563a5f1f4437dda847cc84a0fc"),
    "envmap_scene": (dict(subdivisions=5, tex_size=256, env_h=512,
                          env_w=1024),
                     "82bb92ccf6f72f8269941ed7036270631"
                     "723a7e8330d9a9ae576c45b7e73d577"),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_generator_by_name_gives_the_cells_arrays(name):
    args, digest = PINNED[name]
    assert scenes.module(name).generate is getattr(procedural, name)
    assert spec_digest(scenes.generate(name, args)) == digest


NEW_GENERATOR = """
from ptbench.scenes import procedural


def generate(size=1.0):
    b = procedural.SceneSpec()
    m = b.add_material(albedo=(0.5, 0.5, 0.5))
    v, i = procedural._quad([0, 0, 0], [size, 0, 0], [size, 0, size],
                            [0, 0, size])
    b.add_mesh(v, i, m)
    return b
"""


def test_new_generator_is_found_from_a_new_file(tmp_path, monkeypatch):
    """A new scene is a new module under ptbench/scenes/ with a
    `generate`: a configuration naming it needs no edit elsewhere."""
    (tmp_path / "one_quad.py").write_text(NEW_GENERATOR)
    monkeypatch.setattr(scenes, "__path__",
                        list(scenes.__path__) + [str(tmp_path)])
    monkeypatch.delitem(sys.modules, "ptbench.scenes.one_quad",
                        raising=False)
    assert scenes.module("one_quad").__file__ == str(tmp_path / "one_quad.py")
    assert "one_quad" in scenes.names()
    spec = scenes.generate("one_quad", {"size": 2.0})
    assert spec.n_tris == 2 and spec.meshes[0]["positions"].max() == 2.0


@pytest.mark.parametrize("config", ["sponza_textured", "envmap_textured"])
def test_config_states_the_triangles_it_renders(config):
    """`triangles` (listed in `reduced` where it falls short of the
    source) is the count the configuration's generator gives."""
    import os

    from ptbench import spec

    cfg = spec.load_json(os.path.join(spec.PKG_DIR, "configs",
                                      f"{config}.json"))
    sc = cfg["scene"]
    assert scenes.generate(sc["generator"], sc["args"]).n_tris \
        == cfg["triangles"]
    assert "triangles" in cfg["reduced"]
