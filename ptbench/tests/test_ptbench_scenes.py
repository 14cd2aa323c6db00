"""The frozen scene generators give the program's own arrays at seed 0."""

from __future__ import annotations

import numpy as np
import pytest

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
    with pytest.raises(ValueError):
        procedural.generate("cornell", {})


@pytest.mark.parametrize("config", ["sponza_textured", "envmap_textured"])
def test_config_states_the_triangles_it_renders(config):
    """`triangles` (listed in `reduced` where it falls short of the
    source) is the count the configuration's generator gives."""
    import os

    from ptbench import spec

    cfg = spec.load_json(os.path.join(spec.PKG_DIR, "configs",
                                      f"{config}.json"))
    sc = cfg["scene"]
    assert procedural.generate(sc["generator"], sc["args"]).n_tris \
        == cfg["triangles"]
    assert "triangles" in cfg["reduced"]
