"""The port's bench path (pathtracer_torch/bench/) against the JAX package's.

CPU: the harness's window arithmetic equal to pathtracer/bench/harness.py's
on the same times and rays; bench_scene / bench_interleaved count the
port's own render_frame_with_stats rays; pair_metrics' schedule counts
exact on JAX's own bounce-1 batch (the two packages' batches differ by
ulps, see below) and its dict close to JAX's; the bench entry under
PT_PLATFORM=cpu prints bench.py's keys, and raises without a card
otherwise.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer.accel.cluster import build_scene_clusters as jbuild_scene
from pathtracer.bench import harness as jharness
from pathtracer.bench import pair_metrics as jpm
from pathtracer.config import RenderConfig as JConfig
from pathtracer.integrator.camera import Camera as JCamera
from pathtracer.kernels import packet as jpacket
from pathtracer.scene import procedural as jproc
from pathtracer_torch.accel.cluster import build_scene_clusters
from pathtracer_torch.bench import __main__ as entry
from pathtracer_torch.bench import harness, pair_metrics, sweep_attrib
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.integrator.camera import Camera
from pathtracer_torch.render import render_frame_with_stats
from pathtracer_torch.scene import procedural


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads keep this file's renders from oversubscribing
    the cores when test files run side by side."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


# --- harness ---------------------------------------------------------------

@pytest.mark.parametrize("frame_batch", [1, 8])
@pytest.mark.parametrize("windows", [1, 3, 4, 9])
def test_result_matches_jax(frame_batch, windows):
    rng = np.random.default_rng(windows)
    times = list(rng.uniform(0.01, 0.2, 7))
    rays = [float(x) for x in rng.integers(10_000, 90_000, 7)]
    kw = dict(width=48, height=32, spp=2, frame_batch=frame_batch,
              spp_batch=True)
    ref = jharness._result(times, rays, JConfig(**kw), windows)
    got = harness._result(times, rays, RenderConfig(**kw), windows)
    assert got.as_dict() == ref.as_dict()
    assert got == harness.BenchResult(**vars(ref))


def _cornell(spheres=False):
    scene = procedural.cornell_box(spheres=spheres).finalize(device="cpu")
    return build_scene_clusters(scene)


def _rays_of_frames(scene, cfg, cam, start, frames):
    cs = cam.state(device="cpu")
    return [float(render_frame_with_stats(scene, cfg, cs, start + i)[1])
            for i in range(frames)]


@pytest.mark.parametrize("frame_batch", [1, 2])
def test_bench_scene_counts_the_renders_rays(frame_batch):
    scene = _cornell()
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=3,
                       intersector="cluster", frame_batch=frame_batch,
                       spp_batch=True)
    cam = Camera(position=(0.5, 0.5, 2.2))
    cam.look_at((0.5, 0.5, 0.0))
    res = harness.bench_scene(scene, cfg, cam, warmup=1, frames=2,
                              windows=2)
    single = RenderConfig(width=16, height=16, spp=2, max_depth=3,
                          intersector="cluster")
    rays = _rays_of_frames(scene, single, cam, frame_batch,
                           2 * frame_batch)
    assert res.frames == 2 and len(res.window_ms) == 2
    assert res.rays_per_frame == sum(rays) / len(rays)
    assert res.mrays_per_sec == pytest.approx(
        res.rays_per_frame / res.ms_per_frame / 1e3)


def test_bench_interleaved_counts_each_legs_rays():
    scenes = {"plain": _cornell(), "spheres": _cornell(spheres=True)}
    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=3,
                       intersector="cluster")
    cam = Camera(position=(0.5, 0.5, 2.2))
    cam.look_at((0.5, 0.5, 0.0))
    res = harness.bench_interleaved(scenes, cfg, cam, warmup=1, frames=3,
                                    windows=2)
    assert set(res) == set(scenes)
    for lab, scene in scenes.items():
        rays = _rays_of_frames(scene, cfg, cam, 1, 3)
        assert res[lab].frames == 3
        assert res[lab].rays_per_frame == sum(rays) / 3
    assert res["plain"].rays_per_frame != res["spheres"].rays_per_frame


# --- pair_metrics ----------------------------------------------------------

@pytest.fixture(scope="module")
def pair_case():
    """tests/test_pair_metrics.py's case in both packages, and JAX's own
    bounce-1 batch and schedule statistics, captured where
    bounce1_pair_metrics waits for them."""
    jscene = jbuild_scene(jproc.sponza_like(target_tris=5_000).finalize())
    jcfg = JConfig(width=64, height=64, spp=1, max_depth=2)
    jcam = JCamera(position=(3.0, 4.5, 6.0))
    jcam.look_at((14.0, 3.0, 6.0))
    seen = []
    real = jax.block_until_ready

    def record(x):
        x = real(x)
        seen.append(jax.tree_util.tree_map(np.asarray, x))
        return x

    jax.block_until_ready = record
    try:
        jdict = jpm.bounce1_pair_metrics(jscene, jcfg, jcam)
    finally:
        jax.block_until_ready = real
    (o2, d2), jstats = seen[0], seen[1]
    scene = build_scene_clusters(procedural.sponza_like(
        target_tris=5_000).finalize(device="cpu"))
    cfg = RenderConfig(width=64, height=64, spp=1, max_depth=2)
    cam = Camera(position=(3.0, 4.5, 6.0))
    cam.look_at((14.0, 3.0, 6.0))
    return dict(jdict=jdict, o2=o2, d2=d2, jstats=jstats, scene=scene,
                cfg=cfg, cam=cam,
                jaccel=jscene.clusters_fine or jscene.clusters)


def _jax_stops(jaccel, o2, d2):
    """JAX's stop per ray (hit or scene exit) on its sorted batch, as its
    bounce1_pair_metrics computes it."""
    o, d = jnp.asarray(o2), jnp.asarray(d2)
    order, _ = jpacket._coherence_order(jaccel, o, d, 2)
    o, d = o[order], d[order]
    hit = jpacket.intersect_clusters(jaccel, o, d, 1e-3, 1e20,
                                     sort_rays=False)
    cap = jpacket._scene_exit(jaccel, o, d, 1e20)
    return np.asarray(jnp.minimum(
        jnp.where(jnp.isfinite(hit.t), hit.t, jnp.inf), cap))


def test_schedule_stats_exact_on_jax_batch(pair_case):
    """On JAX's bounce-1 batch the port's schedule (K1 bit-exact, the same
    stable sorts) with JAX's stops counts exactly JAX's visited and needed
    columns, and the dict they make equals JAX's but for the rate model.
    The port's own stops differ from JAX's by ulps (XLA contracts the
    plane and slab arithmetic into FMAs; amplified by the cancellation in
    d - n.o, 2.3e-5 relative at most here): a count then moves only where
    a schedule entry lies within that band of the stop - the triangle of
    the hit lies on its cluster box's face, so the box's entry is the hit
    t."""
    c = pair_case
    o2, d2 = torch.from_numpy(c["o2"].copy()), torch.from_numpy(
        c["d2"].copy())
    st, best, live = pair_metrics.schedule_and_stops(c["scene"].clusters,
                                                     o2, d2)
    jbest = _jax_stops(c["jaccel"], c["o2"], c["d2"]).reshape(best.shape)
    got = pair_metrics.count_columns(st, torch.from_numpy(jbest.copy()),
                                     live)
    for g, r in zip(got, c["jstats"]):
        np.testing.assert_array_equal(g, r)
    assert got[0].sum() > 0 and got[1].sum() > 0
    pm = pair_metrics.pair_metrics(*got, 128)
    for k in ("rays_probed", "tile_visited_cols_mean",
              "ray_needed_cols_mean", "packet_waste", "sweep_pairs_g",
              "tris_per_cluster"):
        assert pm[k] == c["jdict"][k], k
    # the port's own stops: hit for hit, within 1e-4 relative
    b = best.numpy()
    fin = np.isfinite(jbest)
    np.testing.assert_array_equal(np.isfinite(b), fin)
    np.testing.assert_allclose(b[fin], jbest[fin], rtol=1e-4)
    own = pair_metrics.schedule_stats(c["scene"].clusters, o2, d2)
    np.testing.assert_array_equal(own[3], c["jstats"][3])
    band = (torch.abs(st[:, None, :] - best[:, :, None])
            <= 1e-4 * torch.abs(best[:, :, None])).sum(dim=2).numpy()
    moved = np.abs(own[1].astype(np.int64) - c["jstats"][1])
    assert (moved <= band).all()
    assert 0 < (moved > 0).mean() < 0.05


def test_bounce1_batch_close_to_jax(pair_case):
    """The port's own batch: the same rays but for ulps (XLA contracts
    the cross products and sums into FMAs on the host)."""
    c = pair_case
    o2, d2 = pair_metrics.bounce1_batch(c["scene"], c["cfg"], c["cam"])
    live = c["o2"][:, 0] < 1e29
    np.testing.assert_array_equal(o2[:, 0].numpy() < 1e29, live)
    np.testing.assert_allclose(o2.numpy()[live], c["o2"][live], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(d2.numpy()[live], c["d2"][live], rtol=0,
                               atol=1e-4)


def test_pair_metrics_dict_close_to_jax(pair_case):
    """The whole dict on the port's own batch. Its rays equal JAX's but
    for ulps (test above) and its stops move counts by at most 2 columns
    on under 5% of the rays (the exactness test): the column means
    (~70-110 here) then move by under 0.1, so each field is within one
    unit of the place JAX rounds it to (equal at this size). The ray
    count is exact. On the CPU the rate model is None; cpi is K2's 1
    (JAX's Pallas sweep takes several clusters a column)."""
    c = pair_case
    pm = pair_metrics.bounce1_pair_metrics(c["scene"], c["cfg"], c["cam"])
    ref = c["jdict"]
    assert set(pm) == set(ref)
    assert pm["rays_probed"] == ref["rays_probed"]
    for k, unit in (("tile_visited_cols_mean", 0.1),
                    ("ray_needed_cols_mean", 0.1), ("packet_waste", 0.01),
                    ("sweep_pairs_g", 0.01)):
        assert abs(pm[k] - ref[k]) <= unit * 1.001, k
    assert pm["tris_per_cluster"] == ref["tris_per_cluster"] == 128
    assert pm["cpi"] == 1
    assert pm["sweep_us_per_iter"] is None
    assert pm["sweep_model_ms"] is None and pm["sweep_gpairs_per_s"] is None
    assert pm["packet_waste"] >= 1.0


def test_bounce1_pair_metrics_takes_k2s_rate(pair_case, monkeypatch):
    """On a card the model's rate is K2's cost a column from K2's own
    timer (sweep_attrib.k2_columns, through us_per_col), not P3's
    attribution. The scene stands in for a card's: its batch and counts
    are the CPU's, its device says cuda, and K2's timer is a recorder."""
    c = pair_case
    o2, d2 = pair_metrics.bounce1_batch(c["scene"], c["cfg"], c["cam"])
    stats = pair_metrics.schedule_stats(c["scene"].clusters, o2, d2)
    calls = []

    def k2_timer(device="cuda", *a, **kw):
        calls.append(torch.device(device))
        return {"per_col": 0.0125, "ms": [1.0, 2.0], "per_tile": 0.0,
                "t": []}

    def no_p3(*a, **kw):
        raise AssertionError("the rate came from P3's attribution")

    monkeypatch.setattr(sweep_attrib, "k2_columns", k2_timer)
    monkeypatch.setattr(sweep_attrib, "attribution", no_p3)
    monkeypatch.setattr(pair_metrics, "bounce1_batch",
                        lambda *a, **kw: (o2, d2))
    monkeypatch.setattr(pair_metrics, "schedule_stats",
                        lambda *a, **kw: stats)
    card = types.SimpleNamespace(device=torch.device("cuda"),
                                 clusters=c["scene"].clusters)
    pm = pair_metrics.bounce1_pair_metrics(card, c["cfg"], c["cam"])
    assert calls == [torch.device("cuda")]
    assert pm["sweep_us_per_iter"] == 0.0125
    cols = float(stats[0][stats[2]].sum())
    assert pm["sweep_model_ms"] == round(cols * 0.0125e-3, 1)
    assert pm == pair_metrics.pair_metrics(*stats, 128, 0.0125)


# --- the entry -------------------------------------------------------------

_TINY = dict(BENCH_WIDTH="16", BENCH_HEIGHT="16", BENCH_TRIS="3000",
             BENCH_FRAMES="2", BENCH_SPP="1")


def _tiny_env(monkeypatch):
    for k in list(_TINY) + ["PT_PLATFORM"]:
        monkeypatch.delenv(k, raising=False)
    for k, v in dict(_TINY, PT_PLATFORM="cpu").items():
        monkeypatch.setenv(k, v)


def _entry_line(capsys):
    assert entry.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def _check_bench_line(rec):
    """bench.py's keys at any rate. The entry rounds the rate to 3
    places (value) and its ratio to the 300 Mrays/s target to 4
    (vs_baseline), so a slow CPU frame prints a value of 0.0: the rate's
    unrounded parts in the detail show that it is positive, and
    vs_baseline may differ from value / 300 by the two roundings' half
    units and no more."""
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert rec["metric"] == "sponza_1080p_mrays_per_sec_per_chip"
    d = rec["detail"]
    assert rec["unit"] == "Mrays/s" and rec["value"] >= 0
    assert d["rays_per_frame"] > 0 and d["ms_per_frame"] > 0
    assert abs(rec["vs_baseline"] - rec["value"] / 300.0) \
        <= 0.5e-4 + 0.5e-3 / 300.0
    assert d["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert d["resolution"] == [16, 16] and d["textured"] is True
    assert "untextured_mrays_per_sec" in d
    assert "error" not in d["pair_metrics"]
    assert d["pair_metrics"]["sweep_model_ms"] is None
    assert "vs_design_ceiling_18mrays" not in d and "configs_sweep" not in d


def test_entry_on_cpu_prints_bench_keys(monkeypatch, capsys):
    _tiny_env(monkeypatch)
    _check_bench_line(_entry_line(capsys))


_SLOW_RAYS = 2048.0      # rays a frame of the stand-in step
_SLOW_RATE = 400.0       # rays a second: 0.0004 Mrays/s


def test_entry_at_a_slow_rate_prints_bench_keys(monkeypatch, capsys):
    """The entry at 0.0004 Mrays/s, deterministically: the harness's
    step renders nothing and its clock advances by the frame's rays over
    400 rays/s a step, so every timed frame takes 5.12 s. The line's
    value rounds to 0.0, which the assertions this file held before
    (value > 0, vs_baseline == round(value / 300, 4)) refuse; the
    detail's unrounded parts still show the rate."""
    _tiny_env(monkeypatch)
    now = [0.0]

    def step(scene, cfg, cam, frame_idx, prime):
        now[0] += _SLOW_RAYS / _SLOW_RATE
        return None, torch.tensor(_SLOW_RAYS), prime

    monkeypatch.setattr(harness, "_step", step)
    monkeypatch.setattr(harness, "time",
                        types.SimpleNamespace(perf_counter=lambda: now[0]))
    rec = _entry_line(capsys)
    d = rec["detail"]
    assert d["rays_per_frame"] == _SLOW_RAYS
    assert d["ms_per_frame"] == round(_SLOW_RAYS / _SLOW_RATE * 1e3, 3)
    assert d["untextured_mrays_per_sec"] == 0.0
    assert rec["value"] == 0.0 and rec["vs_baseline"] == 0.0
    assert not (rec["value"] > 0
                and rec["vs_baseline"] == round(rec["value"] / 300.0, 4))
    _check_bench_line(rec)


def test_entry_raises_without_a_card(monkeypatch):
    monkeypatch.delenv("PT_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.run()
    monkeypatch.setenv("PT_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="PT_PLATFORM"):
        entry.run()
