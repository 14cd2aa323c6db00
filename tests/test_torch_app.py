"""pathtracer_torch's CLI and terminal viewer vs the JAX package's.

For each argv the port's CLI builds the same RenderConfig, field by
field, as the JAX CLI, with the same camera and the same viewer knobs
(each package's Renderer is replaced by a recorder in the test). Scene
specs, composed scenes, presets and LDR env maps give the JAX tables
bit for bit. The viewer's ANSI frames and key parsing equal JAX's, and
the interactive loop, --orbit and --quiet run on the CPU.
"""

import dataclasses
import inspect
import io
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from pathtracer import app as japp
from pathtracer import viewer as jviewer
from pathtracer_torch import app as tapp
from pathtracer_torch import viewer as tviewer
from tests.test_asset_e2e import _build_glb
from tests.test_torch_loaders import (MTL_TEXTURED, OBJ_TEXTURED,
                                      assert_same_tables)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Small renders: two intra-op threads keep test files that run side
    by side from oversubscribing the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


class _Stop(Exception):
    pass


def _recorder(store):
    class Recorder:
        def __init__(self, scene, cfg, camera=None, **kw):
            store.update(cfg=cfg, camera=camera,
                         auto_frame_batch=kw.get("auto_frame_batch", 0),
                         motion_preview=kw.get("motion_preview", 0))
            raise _Stop

    return Recorder


def _captured(monkeypatch, mod, argv):
    store = {}
    monkeypatch.setattr(mod, "Renderer", _recorder(store))
    with pytest.raises(_Stop):
        mod.main(argv)
    return store


def _hdr(tmp_path):
    from pathtracer_torch.scene.hdr import write_hdr

    path = str(tmp_path / "env.hdr")
    env = np.random.default_rng(0).uniform(0, 4, (8, 16, 3))
    write_hdr(path, env.astype(np.float32))
    return path


ARGVS = {
    "defaults": [],
    "spp_batch": ["--spp-batch", "--spp", "8"],
    "frame_batch_auto": ["--frame-batch", "auto", "--width", "64",
                         "--height", "64", "--spp", "1"],
    "interactive_auto": ["--frame-batch", "auto", "--interactive"],
    "interactive_knobs": ["--interactive", "--auto-frame-batch", "4",
                          "--motion-preview", "3", "--spp", "1"],
    "interactive_fixed_batch": ["--interactive", "--frame-batch", "2"],
    "estimators": ["--scene", "bunny", "--sky", "hosek", "--sampler",
                   "sobol", "--intersector", "bvh", "--seed", "3"],
    "display": ["--scene", "materials", "--priming", "--denoise", "--aov",
                "--tonemap", "aces", "--clamp", "2.5", "--frame-batch",
                "3"],
    "thin_lens": ["--scene", "cornell-spheres", "--aperture", "0.1",
                  "--focus-dist", "2", "--max-depth", "3", "--spp", "2",
                  "--orbit", "--width", "96", "--height", "48"],
    "envmap": ["--sky", "envmap", "--envmap", "HDR", "--env-nee",
               "--env-cell", "4", "--env-rr", "0.5", "--intersector",
               "brute"],
}


@pytest.mark.parametrize("name", list(ARGVS))
def test_cli_builds_the_jax_config(tmp_path, monkeypatch, name):
    """The same RenderConfig (every field), camera, auto frame batch and
    motion preview as the JAX CLI; among them JAX's spp_batch rule
    (--spp-batch, or frame_batch > 1) and the interactive viewer's
    frame_batch = 1 under --frame-batch auto."""
    argv = [str(_hdr(tmp_path)) if a == "HDR" else a for a in ARGVS[name]]
    argv += ["--out", str(tmp_path / "o.png")]
    j = _captured(monkeypatch, japp, argv)
    t = _captured(monkeypatch, tapp, argv + ["--device", "cpu"])
    assert dataclasses.asdict(t["cfg"]) == dataclasses.asdict(j["cfg"])
    assert t["auto_frame_batch"] == j["auto_frame_batch"]
    assert t["motion_preview"] == j["motion_preview"]
    for f in ("position", "front", "up", "right"):
        np.testing.assert_array_equal(getattr(t["camera"], f),
                                      getattr(j["camera"], f), err_msg=f)


def test_traversal_backend_xla_is_refused(tmp_path):
    with pytest.raises(ValueError, match="not part of pathtracer_torch"):
        tapp.main(["--traversal-backend", "xla", "--device", "cpu",
                   "--width", "8", "--height", "8",
                   "--out", str(tmp_path / "x.png")])


@pytest.mark.parametrize("spec", ["a.obj", "dir/b.glb@1,2,3",
                                  "c.gltf@-1.5,0,2.25,0.5",
                                  "d@e.obj@0.1,0.2,0.3,2,33.5",
                                  "f.obj@0,0,0,1,-90"])
def test_parse_spec_matches_jax(spec):
    jp, jm = japp._parse_spec(spec)
    tp, tm = tapp._parse_spec(spec)
    assert tp == jp
    if jm is None:
        assert tm is None
    else:
        assert tm.dtype == jm.dtype == np.float32
        np.testing.assert_array_equal(tm, jm)


def test_parse_spec_bad_transform_exits():
    with pytest.raises(SystemExit, match="bad transform"):
        tapp._parse_spec("a.obj@1,2")


def _assets(tmp_path):
    glb = str(tmp_path / "scene.glb")
    _build_glb(glb)
    Image.fromarray(np.random.default_rng(4).integers(
        0, 256, (6, 10, 3), dtype=np.uint8)).save(tmp_path / "wood.png")
    with open(tmp_path / "tex.mtl", "w") as f:
        f.write(MTL_TEXTURED.format(tex="wood.png"))
    obj = str(tmp_path / "m.obj")
    with open(obj, "w") as f:
        f.write(OBJ_TEXTURED)
    return glb, obj


def test_composed_scene_matches_jax(tmp_path):
    """A .glb with a transform, an OBJ/MTL with a map_Kd PNG, and the
    OBJ again scaled and turned: the JAX tables bit for bit."""
    glb, obj = _assets(tmp_path)
    specs = [glb + "@1,0.5,-2,0.75,30", obj, obj + "@-3,0,0,2,-45"]
    assert_same_tables(japp.load_scene(specs), tapp.load_scene(specs))


@pytest.mark.parametrize("name", ["cornell", "cornell-spheres",
                                  "materials"])
def test_presets_match_jax(name):
    assert_same_tables(japp.load_scene(name), tapp.load_scene([name]))


@pytest.mark.parametrize("spec", ["cornell", "cornell-spheres", "materials",
                                  "bunny", "sponza", "sponza-textured",
                                  "model.glb", "model.glb@1,2,3"])
def test_default_camera_matches_jax(spec):
    j, t = japp.default_camera(spec), tapp.default_camera(spec)
    for f in ("position", "front", "up", "right"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))


def test_preset_cannot_compose(tmp_path):
    _, obj = _assets(tmp_path)
    with pytest.raises(SystemExit, match="cannot be composed"):
        tapp.load_scene(["cornell", obj])
    with pytest.raises(SystemExit, match="unknown scene"):
        tapp.load_scene([obj, str(tmp_path / "x.ply")])


@pytest.mark.parametrize("flag", [["--tris", "1000"], ["--textured"]])
def test_port_only_sponza_knobs_are_rejected(flag, capsys):
    """--tris and --textured were the port's alone: both CLIs now reject
    them as unrecognized arguments (the sponza-textured preset is the
    textured scene), and load_scene and the presets take JAX's
    arguments."""
    for mod in (japp, tapp):
        with pytest.raises(SystemExit) as e:
            mod.main(["--scene", "sponza", *flag])
        assert e.value.code == 2
        assert "unrecognized arguments" in capsys.readouterr().err
    assert list(inspect.signature(tapp.load_scene).parameters) == \
        list(inspect.signature(japp.load_scene).parameters)
    assert set(tapp._PRESETS) == set(japp._PRESETS)
    assert all(not inspect.signature(f).parameters
               for f in tapp._PRESETS.values())


def test_sky_envmap_requires_envmap(tmp_path):
    with pytest.raises(SystemExit, match="requires --envmap"):
        tapp.main(["--sky", "envmap", "--device", "cpu", "--width", "8",
                   "--height", "8", "--out", str(tmp_path / "x.png")])


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_ldr_envmap_matches_jax(tmp_path, mode):
    """An 8-bit PNG env map: (u8 / 255) ** 2.2 in float32, bit for bit."""
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (8, 16, len(mode)), dtype=np.uint8)
    path = str(tmp_path / "sky.png")
    Image.fromarray(img, mode).save(path)
    j, t = japp.load_envmap(path), tapp.load_envmap(path)
    assert t.dtype == j.dtype == np.float32 and t.shape == (8, 16, 3)
    np.testing.assert_array_equal(t, j)


def test_hdr_envmap_matches_jax(tmp_path):
    path = _hdr(tmp_path)
    np.testing.assert_array_equal(tapp.load_envmap(path),
                                  japp.load_envmap(path))


def test_jpeg_envmap_raises(tmp_path):
    path = str(tmp_path / "sky.jpg")
    Image.fromarray(np.zeros((8, 16, 3), np.uint8)).save(path)
    with pytest.raises(ValueError, match=r"sky\.jpg: cannot decode a JPEG"):
        tapp.load_envmap(path)


@pytest.mark.parametrize("cols,rows", [(24, 4), (100, 39), (7, 3)])
def test_frame_to_ansi_matches_jax(cols, rows):
    rng = np.random.default_rng(cols)
    img = rng.uniform(-10, 270, (33, 50, 3)).astype(np.float32)
    np.testing.assert_array_equal(tviewer.downsample(img, cols, 2 * rows),
                                  jviewer.downsample(img, cols, 2 * rows))
    assert tviewer.frame_to_ansi(img, cols, rows) == \
        jviewer.frame_to_ansi(img, cols, rows)


def _feed(monkeypatch, data):
    r, w = os.pipe()
    os.write(w, data)
    os.close(w)
    f = os.fdopen(r)
    monkeypatch.setattr(sys, "stdin", f)
    return f


@pytest.mark.parametrize("data,keys", [
    (b"\x1b[A", ["up"]), (b"\x1b[1;2A", ["up"]), (b"\x1b[1;2Aw", ["up", "w"]),
    (b"\x1b[15~w", ["", "w"]), (b"\x1b", ["esc"]),
    (b"wasd", ["w", "a", "s", "d"]), (b"\x1bOD", ["left"]),
    (b"\x1bxW", ["esc", "w"])])
def test_read_keys_parses_like_jax(monkeypatch, data, keys):
    """CSI/SS3 sequences are consumed whole, as tests/test_app.py
    requires of the JAX viewer."""
    with _feed(monkeypatch, data):
        assert tviewer._read_keys(0.05) == keys
    with _feed(monkeypatch, data):
        assert jviewer._read_keys(0.05) == keys


def _cornell_renderer(**kw):
    from pathtracer_torch.config import RenderConfig
    from pathtracer_torch.render import Renderer
    from pathtracer_torch.scene.procedural import cornell_box

    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=2,
                       spp_batch=True)
    return Renderer(cornell_box().finalize(device="cpu"), cfg,
                    tapp.default_camera("cornell"), device="cpu", **kw)


def test_run_interactive_piped_stdin(monkeypatch, capsys):
    """With a piped stdin the viewer only renders: the first step is the
    motion preview (the camera starts moved), the next a single frame,
    then auto frame batches; every frame draws rows - 1 ANSI lines."""
    r = _cornell_renderer(auto_frame_batch=2, motion_preview=2)
    with _feed(monkeypatch, b"wwww"):
        n = tviewer.run_interactive(r, cols=16, rows=9, max_frames=3)
    assert n == 3 and r.film.frame == 3 and r._frames_done == 3
    out = capsys.readouterr().out
    frames = out.split("\x1b[H")[1:]
    assert len(frames) == 3
    for k, fr in enumerate(frames):
        body = fr.split("\x1b[0m\nframe")[0]
        assert len(body.split("\n")) == 8
        assert f"frame {[0, 1, 3][k]:4d}" in fr
    assert np.all(np.isfinite(r.display()))


def test_cli_interactive_and_orbit(tmp_path, monkeypatch, capsys):
    """--interactive hands the viewer knobs to the Renderer and writes
    --out; --orbit --quiet writes frame_NNNN.png per step and prints
    nothing."""
    seen = {}
    real = tviewer.run_interactive

    def two_frames(r, **kw):
        seen.update(afb=r.auto_frame_batch, mp=r.motion_preview)
        return real(r, cols=8, rows=5, max_frames=2)

    monkeypatch.setattr(tviewer, "run_interactive", two_frames)
    base = ["--scene", "cornell", "--width", "16", "--height", "16",
            "--spp", "1", "--max-depth", "2", "--device", "cpu"]
    with _feed(monkeypatch, b""):
        assert tapp.main(base + ["--interactive", "--out",
                                 str(tmp_path / "i.png")]) == 0
    assert seen == {"afb": 8, "mp": 2}
    assert "rendered 2 frames" in capsys.readouterr().out
    assert (tmp_path / "i.png").read_bytes()[:4] == b"\x89PNG"

    out = tmp_path / "orbit"
    assert tapp.main(base + ["--orbit", "--frames", "4", "--quiet",
                             "--out", str(out)]) == 0
    assert capsys.readouterr().out == ""
    assert sorted(os.listdir(out)) == [f"frame_{i:04d}.png"
                                       for i in range(4)]


def test_interactive_refuses_mesh(tmp_path):
    """--interactive takes --mesh now (the viewer broadcasts rank 0's
    view; tests/test_torch_sharding_gloo.py drives it): without a process
    group the pair is refused only for the launch, naming torchrun."""
    with pytest.raises(SystemExit, match="launch with torchrun"):
        tapp.main(["--interactive", "--mesh", "1,1", "--device", "cpu"])


def test_png_decode_is_pil_free_and_matches_pil():
    """The native decode of each 8-bit PNG mode, padded by png_rgba,
    equals PIL's convert("RGBA")."""
    from pathtracer_torch.utils import native

    rng = np.random.default_rng(6)
    base = Image.fromarray(rng.integers(0, 256, (7, 5, 3), dtype=np.uint8))
    for im in (base, base.convert("RGBA"), base.convert("L"),
               base.convert("LA"), base.quantize(64)):
        buf = io.BytesIO()
        im.save(buf, format="PNG")
        np.testing.assert_array_equal(
            native.png_rgba(buf.getvalue(), "t"),
            np.asarray(im.convert("RGBA")), err_msg=im.mode)
