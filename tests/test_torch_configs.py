"""The port's config sweep (pathtracer_torch/bench/configs.py) against
benchmarks/run_configs.py.

- build_configs: names, order, every RenderConfig field, the cameras
  and the accuracy probe's cfg equal run_configs.build_configs' at three
  scales and under PT_CFG_SPP_BATCH=0 / PT_CFG_FB=0;
- each config's scene tables equal the JAX package's bit for bit
  (config 4's sky through each package's RGBE file under TMPDIR);
- accuracy_probe equals run_configs.accuracy_probe as (rmse, ok) on
  stored images (each package's render_frame monkeypatched), and the
  probe renders the same cfg;
- the entry under PT_PLATFORM=cpu prints run_configs' keys with the
  frame batch and the device, and passes the golden gate; it refuses
  --write-goldens and raises without a card;
- python -m pathtracer_torch.bench attaches the sweep's file only when
  a card wrote it, and marks it stale unless it names this tree's
  sources.

No assertion reads a time or a rate.
"""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import pathtracer.render as jrender
from benchmarks import run_configs
from pathtracer_torch.bench import __main__ as entry
from pathtracer_torch.bench import configs, harness
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.render import render_frame
from pathtracer_torch.scene import procedural
from pathtracer_torch.scene.types import (META_FIELDS, OPTIONAL_FIELDS,
                                          TENSOR_FIELDS)

CFG_KNOBS = ("PT_CFG_SPP_BATCH", "PT_CFG_FB")
RUN_CONFIGS_KEYS = {"config", "mrays_per_sec", "ms_per_frame",
                    "rays_per_frame", "tris", "resolution", "spp",
                    "inlier_rmse_vs_golden", "accuracy_ok"}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads keep this file's renders from oversubscribing
    the cores when test files run side by side."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _knobs(monkeypatch, tmp_path, **env):
    for k in CFG_KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("TMPDIR", str(tmp_path))


@pytest.mark.parametrize("env", [{}, {"PT_CFG_SPP_BATCH": "0"},
                                 {"PT_CFG_FB": "0"}],
                         ids=["default", "spp_batch0", "fb0"])
@pytest.mark.parametrize("scale", [1.0, 0.25, 0.0625])
def test_configs_equal_run_configs(scale, env, monkeypatch, tmp_path):
    _knobs(monkeypatch, tmp_path, **env)
    ref = run_configs.build_configs(scale)
    got = configs.build_configs(scale)
    assert [c[0] for c in got] == [c[0] for c in ref]
    for (name, _, cfg, cam), (_, _, jcfg, jcam) in zip(got, ref):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), name
        for f in ("position", "front", "up", "right"):
            np.testing.assert_array_equal(getattr(cam, f),
                                          getattr(jcam, f), err_msg=name)
        assert (cam.yaw, cam.pitch) == (jcam.yaw, jcam.pitch)
        jprobe = dataclasses.replace(jcfg, width=run_configs.PROBE_RES,
                                     height=run_configs.PROBE_RES,
                                     spp=run_configs.PROBE_SPP)
        assert dataclasses.asdict(configs.probe_cfg(cfg)) \
            == dataclasses.asdict(jprobe), name
    if scale == 1.0 and not env:
        assert [c[2].frame_batch for c in got] == [1, 8, 8, 8, 4]


def test_gate_constants_equal_run_configs():
    for k in ("PROBE_RES", "PROBE_SPP", "RMSE_TOL", "OUTLIER_TOL",
              "MEAN_TOL", "GOLDEN_DIR"):
        assert getattr(configs, k) == getattr(run_configs, k), k


def _host_tables(scene):
    out = {}
    for f in TENSOR_FIELDS + OPTIONAL_FIELDS:
        a = getattr(scene, f)
        if a is not None:
            a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        out[f] = a
    return out


@pytest.mark.parametrize("idx", [1, 2, 3, 4, 5])
def test_scene_tables_equal_jax(idx, monkeypatch, tmp_path):
    _knobs(monkeypatch, tmp_path)
    js = run_configs.build_configs(1.0)[idx - 1][1]()
    ts = configs.build_configs(1.0)[idx - 1][1]()
    jt, tt = _host_tables(js), _host_tables(ts)
    for f, a in jt.items():
        b = tt[f]
        if a is None:
            assert b is None, f
            continue
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    for f in META_FIELDS:
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.n_tris == js.n_tris
    if idx == 4:
        assert ts.has_envmap and ts.has_textures
        assert (tmp_path / "bench_env.hdr").exists()


def _stored_image(case, golden):
    rng = np.random.default_rng(16)
    img = golden.copy()
    if case == "noise":
        img = img + rng.normal(0.0, 1e-3, img.shape).astype(np.float32)
    elif case == "flips":
        flat = img.reshape(-1, img.shape[-1])
        pick = rng.choice(flat.shape[0], int(0.03 * flat.shape[0]),
                          replace=False)
        flat[pick] += 0.5
    elif case == "mean_shift":
        img = img * np.float32(1.0 + 2e-3)
    return img.astype(np.float32)


# (case, golden index, expected ok); index 9 has no golden: its image is
# config 4's golden and its cfg config 4's
GATE_CASES = [("golden", 3, True), ("noise", 3, True), ("flips", 5, False),
              ("mean_shift", 4, False), ("missing", 9, False)]


@pytest.mark.parametrize("case,idx,expect_ok", GATE_CASES,
                         ids=[c[0] for c in GATE_CASES])
def test_probe_equals_run_configs(case, idx, expect_ok, monkeypatch,
                                  tmp_path):
    """Both probes on one stored image: the same (rmse, ok), and the same
    cfg handed to render_frame (config idx's, or config 4's for the
    missing golden)."""
    _knobs(monkeypatch, tmp_path)
    k = min(idx, 4) if case == "missing" else idx
    img = _stored_image(case, configs.load_golden(k))
    seen = {}

    def jfake(scene, cfg, cam, frame):
        seen["jax"] = (cfg, frame)
        return img

    def tfake(scene, cfg, cam, frame):
        seen["torch"] = (cfg, frame)
        return torch.from_numpy(img)

    monkeypatch.setattr(jrender, "render_frame", jfake)
    monkeypatch.setattr(configs, "render_frame", tfake)
    _, _, jcfg, jcam = run_configs.build_configs(1.0)[k - 1]
    _, _, tcfg, tcam = configs.build_configs(1.0)[k - 1]
    ref = run_configs.accuracy_probe(None, jcfg, jcam, idx)
    got = configs.accuracy_probe(None, tcfg, tcam, idx, "cpu")
    assert got == ref
    assert got[1] is expect_ok
    if case == "missing":
        assert got == (None, False)
    assert dataclasses.asdict(seen["torch"][0]) \
        == dataclasses.asdict(seen["jax"][0])
    assert seen["torch"][1] == seen["jax"][1] == 0
    assert seen["torch"][0].frame_batch == tcfg.frame_batch
    assert (seen["torch"][0].width, seen["torch"][0].spp) == (64, 4)


def test_robust_gate_fields():
    golden = configs.load_golden(1)
    same = configs.robust_gate(golden, golden)
    assert same == dict(inlier_rmse=0.0, flip_frac=0.0, mean_rel=0.0,
                        ok=True)
    moved = configs.robust_gate(_stored_image("flips", golden), golden)
    assert moved["flip_frac"] == pytest.approx(0.03, abs=1 / 4096)
    assert not moved["ok"]


def test_frame_batch_leaves_a_frame_unchanged():
    """render_frame renders one frame whatever cfg.frame_batch says, so
    the probe may keep the full config's, as run_configs' does (an env
    map: the one table whose default size reads frame_batch)."""
    b = procedural.cornell_box()
    sky = np.full((8, 16, 3), 0.5, np.float32)
    sky[2, 5] = 40.0
    b.set_envmap(sky)
    scene = b.finalize(device="cpu")
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=3,
                       spp_batch=True, sky="envmap",
                       env_importance_sampling=True, emission_gain=1.0)
    cam = configs.camera(configs.BOX_CAM).state(device="cpu")
    one = render_frame(scene, cfg, cam, 0)
    eight = render_frame(scene, dataclasses.replace(cfg, frame_batch=8),
                         cam, 0)
    assert torch.equal(one, eight)


def test_entry_on_cpu_prints_run_configs_keys(monkeypatch, tmp_path,
                                              capsys):
    """Configs 1 and 3 at 16x16 (scale 0.03125), one timed frame after
    the three warm-up frames, the frame batching off (PT_CFG_FB=0): on
    the CPU config 3's 64x64 probe alone takes about 25 s."""
    _knobs(monkeypatch, tmp_path, PT_CFG_FB="0")
    monkeypatch.setenv("PT_PLATFORM", "cpu")
    out = tmp_path / "sweep.json"
    assert configs.main(["--configs", "1,3", "--scale", "0.03125",
                         "--frames", "1", "--out", str(out)]) == 0
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    assert [x["config"] for x in lines] == ["cornell_256_4spp",
                                            "materials_512_64spp"]
    cpu = {"platform": "cpu", "kind": "cpu", "count": 1}
    for rec in lines:
        assert set(rec) == RUN_CONFIGS_KEYS | {"frame_batch", "device"}
        assert rec["accuracy_ok"] is True
        assert rec["rays_per_frame"] > 0
        assert rec["resolution"] == [16, 16] and rec["spp"] == 4
        assert rec["frame_batch"] == 1 and rec["device"] == cpu
    saved = json.loads(out.read_text())
    assert set(saved) == {"date", "scale", "frames", "device", "source",
                          "configs"}
    assert saved["configs"] == lines and saved["device"] == cpu
    assert saved["source"] == harness.source_hash()
    assert (saved["scale"], saved["frames"]) == (0.03125, 1)


def test_entry_refusals(monkeypatch):
    with pytest.raises(SystemExit) as e:
        configs.main(["--write-goldens"])
    assert e.value.code == 2
    monkeypatch.delenv("PT_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        configs.main(["--configs", "1"])
    monkeypatch.setenv("PT_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="PT_PLATFORM"):
        configs.main(["--configs", "1"])


@pytest.mark.parametrize("platform,source,key", [
    pytest.param("gpu", "this", "configs_sweep", id="gpu"),
    pytest.param("cpu", "this", None, id="cpu"),
    pytest.param("gpu", "other", "configs_sweep_stale", id="gpu-stale"),
])
def test_bench_attaches_a_cards_sweep(platform, source, key, monkeypatch,
                                      tmp_path):
    """The bench entry's detail carries the sweep's file as
    configs_sweep when a card wrote it from this tree's sources, as
    configs_sweep_stale when a card wrote it from other sources, and
    leaves a CPU file out. The harness step is a stand-in: only the
    attachment is under test."""
    sweep = {"date": "2026-01-01", "scale": 1.0, "frames": 4,
             "device": {"platform": platform, "kind": "x", "count": 1},
             "source": (harness.source_hash() if source == "this"
                        else "0" * 64),
             "configs": [{"config": "cornell_256_4spp"}]}
    path = tmp_path / "configs_latest.json"
    path.write_text(json.dumps(sweep))
    monkeypatch.setattr(entry, "CONFIGS_SWEEP", str(path))

    def step(scene, cfg, cam, frame_idx, prime):
        return None, torch.tensor(64.0), prime

    monkeypatch.setattr(harness, "_step", step)
    monkeypatch.setattr(harness, "time",
                        types.SimpleNamespace(perf_counter=iter(
                            range(1000)).__next__))
    env = dict(PT_PLATFORM="cpu", BENCH_WIDTH="16", BENCH_HEIGHT="16",
               BENCH_TRIS="3000", BENCH_FRAMES="2", BENCH_SPP="1",
               BENCH_UNTEXTURED_REF="0", BENCH_PAIR_METRICS="0")
    detail = entry.run(env)["detail"]
    attached = {k for k in ("configs_sweep", "configs_sweep_stale")
                if k in detail}
    assert attached == ({key} if key else set())
    if key:
        assert detail[key] == sweep
    monkeypatch.setattr(entry, "CONFIGS_SWEEP", str(tmp_path / "absent"))
    assert entry.configs_sweep() is None


def test_source_hash_names_the_sources(tmp_path):
    """source_hash changes with a source's bytes and name, and not with
    build outputs or caches."""
    (tmp_path / "a.py").write_text("x = 1\n")
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text("// k\n")
    first = harness.source_hash(tmp_path)
    for skipped in ("_build", "__pycache__"):
        (tmp_path / skipped).mkdir()
        (tmp_path / skipped / "k.py").write_text("built\n")
    (tmp_path / "notes.txt").write_text("not a source\n")
    assert harness.source_hash(tmp_path) == first
    (tmp_path / "csrc" / "k.cu").write_text("// k2\n")
    second = harness.source_hash(tmp_path)
    assert second != first
    (tmp_path / "csrc" / "k.cu").rename(tmp_path / "csrc" / "j.cu")
    assert harness.source_hash(tmp_path) not in (first, second)
