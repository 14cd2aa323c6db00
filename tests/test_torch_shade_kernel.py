"""K10 (csrc/shade.cu, integrator/shade.py): a bounce's shading in one
hand-written kernel, and the predicate that sends a bounce to it.

CPU tests: CPU tensors take the plain chain and launch nothing; each
RenderConfig variant left to the plain chain goes there and each
covered one does not; the launch arguments' layout is the kernel's; the
benchmark's trace reader finds K10's kernel names. The `cuda` tests hold
K10 and its resolve to the plain chain, lane by lane, over one bounce
and over a whole trace_paths, run the shading of a Renderer step under
torch's sync debug mode "error", and count one kernel bounce a bounce:

    python -m pytest tests/test_torch_shade_kernel.py -m cuda --noconftest -q
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from pathtracer_torch import render, tracing
from pathtracer_torch.accel.cluster import build_scene_clusters
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.integrator import path
from pathtracer_torch.integrator import shade as shade_mod
from pathtracer_torch.integrator.camera import Camera
from pathtracer_torch.scene import procedural
from pathtracer_torch.scene.build import MaterialDesc
from pathtracer_torch.scene.types import MAT_DIELECTRIC

PKG = os.path.dirname(os.path.abspath(shade_mod.__file__ + "/.."))
CUDA = torch.device("cuda")
CPU = torch.device("cpu")

# RenderConfig variants: (fields, K10 shades every bounce on a card)
VARIANTS = {
    "default": ({}, True),
    "skip_nee": (dict(skip_nee=True), True),
    "wavefront_sort": (dict(wavefront_sort=True), True),
    "sky_black": (dict(sky="black"), True),
    "sky_envmap": (dict(sky="envmap"), True),
    "env_nee_cell8": (dict(sky="envmap", env_importance_sampling=True), True),
    "env_nee_cell1": (dict(sky="envmap", env_importance_sampling=True,
                           env_nee_cell=1), True),
    "env_shadow_rr": (dict(sky="envmap", env_importance_sampling=True,
                           env_shadow_rr=2.0), True),
    "bilinear_textures": (dict(stochastic_texture_filtering=False), True),
    "clamp_radiance": (dict(clamp_radiance=4.0), True),
    "frame_batch": (dict(spp_batch=True, frame_batch=4), True),
    "priming_off_bounce0": (dict(primary_priming=True), True),
    "reference_quirks": (dict(reference_quirks=True), False),
    "sobol": (dict(sampler="sobol"), False),
    "hosek": (dict(sky="hosek"), False),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_predicate_sends_each_variant_to_its_chain(name, device):
    """On a card K10 shades every variant a cell could run and none of
    those left to the plain chain; on CPU tensors nothing goes to K10."""
    fields, covered = VARIANTS[name]
    cfg = RenderConfig(**fields)
    want = covered and device == "cuda"
    assert shade_mod.kernel_shades(torch.device(device), cfg) is want


@pytest.mark.parametrize("primed,gbuffer", [(True, False), (False, True),
                                            (True, True)])
def test_primed_and_gbuffer_bounces_take_the_plain_chain(primed, gbuffer):
    cfg = RenderConfig()
    assert shade_mod.kernel_shades(CUDA, cfg)
    assert not shade_mod.kernel_shades(CUDA, cfg, primed=primed,
                                       gbuffer=gbuffer)


def _cornell_rays(cfg, dev=CPU):
    scene = procedural.cornell_box(spheres=True).finalize(device="cpu")
    cam = Camera(position=(0.5, 0.5, 2.2))
    cam.look_at((0.5, 0.5, 0.0))
    return scene, _wavefront(scene.to(dev), cfg, cam)


def _wavefront(scene, cfg, cam, first_sample=0):
    """One spp-batched wavefront of the frame: (o, d, pixel, sample)."""
    dev = scene.device
    m = cfg.width * cfg.height
    pix = render._base_pixels(cfg.width, cfg.height, dev).repeat(cfg.spp)
    samp = (first_sample + torch.arange(cfg.spp, dtype=torch.int64,
                                        device=dev)).repeat_interleave(m)
    o, d = render._primary_rays(cfg, cam.state(device=dev), pix, samp)
    return o, d, pix, samp


@pytest.mark.parametrize("max_depth", [1, 3])
def test_cpu_tensors_take_the_plain_chain_and_launch_nothing(max_depth):
    cfg = RenderConfig(width=16, height=12, spp=2, max_depth=max_depth,
                       intersector="brute")
    scene, (o, d, pix, samp) = _cornell_rays(cfg)
    i_fn, o_fn, _ = render.make_intersectors(scene, cfg)
    launches = dict(tracing.LAUNCHES)
    counters = dict(tracing.COUNTERS)
    o0, d0 = o.clone(), d.clone()
    rad, _, rays, _, _ = path.trace_paths(scene, cfg, o, d, pix, samp,
                                          i_fn, o_fn)
    assert tracing.LAUNCHES == launches
    assert tracing.COUNTERS["shade_plain"] - counters["shade_plain"] \
        == max_depth
    assert tracing.COUNTERS["shade_kernel"] == counters["shade_kernel"]
    assert torch.equal(o, o0) and torch.equal(d, d0)   # inputs untouched
    assert int(rays) >= o.shape[0] and bool(torch.isfinite(rad).all())


def _struct_fields(src):
    """(name, C type) of csrc/shade.cu's ShadeParams, in order."""
    body = re.search(r"struct ShadeParams \{(.*?)\};", src, re.S).group(1)
    out = []
    for decl in body.split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        m = re.match(r"((?:const )?[\w ]+?\**) ?(\w+(?:, ?\w+)*)$", decl)
        ctype, names = m.group(1), m.group(2)
        out += [(n.strip(), ctype) for n in names.split(",")]
    return out


def test_launch_arguments_mirror_the_kernel_struct():
    """integrator/shade.ShadeParams lays out csrc/shade.cu's struct:
    the same fields in the same order, pointers as pointers, 64-bit
    integers as c_longlong, floats as c_float."""
    with open(os.path.join(PKG, "csrc", "shade.cu")) as f:
        c_fields = _struct_fields(f.read())
    py_fields = shade_mod.ShadeParams._fields_
    assert [n for n, _ in c_fields] == [n for n, _ in py_fields]
    kinds = {"*": shade_mod._P, "long long": shade_mod._L,
             "int": shade_mod._I, "unsigned": shade_mod._U,
             "float": shade_mod._F}
    for (name, ctype), (_, pytype) in zip(c_fields, py_fields):
        kind = "*" if ctype.endswith("*") else ctype
        assert kinds[kind] is pytype, (name, ctype, pytype)


def test_trace_reader_finds_k10_names():
    from ptbench.trace import handwritten_names, kind_of

    names = handwritten_names(PKG)
    assert {"shade_kernel", "shade_resolve_kernel", "pcg4d_uniform_kernel"} \
        <= names
    assert kind_of("(anonymous namespace)::shade_kernel(ShadeParams)",
                   names) == "handwritten"


def test_env_table_rows_are_the_cell_draws():
    """path._env_table's row of (cell, sample) is the per-lane draw keyed
    on the cell, the rows path._env_draw and K10 gather."""
    scene = _env_scene()
    cfg = RenderConfig(width=20, height=12, sky="envmap",
                       env_importance_sampling=True, env_nee_cell=4)
    samp = torch.tensor([7, 9, 8], dtype=torch.int64)
    table, s0 = path._env_table(scene, cfg, samp, 2, 3)
    assert int(s0) == 7 and table.shape == (5 * 3 * 3, 7)
    cells = torch.arange(15).repeat_interleave(3)
    ids = torch.arange(3).repeat(15) + 7
    u = path.rng.uniform4(cells, ids, 2, path.rng.SALT_ENV_SELECT, cfg.seed)
    l_dir, p_env, le = path._env_sample(scene, u)
    assert torch.equal(table, torch.cat([l_dir, p_env[:, None], le], 1))


# ---------------------------------------------------------------------------
# Scenes of the card tests
# ---------------------------------------------------------------------------

def _env_scene():
    """bunny_like(2) with a checker texture under a small sky with a hot
    disc (tests/test_torch_rng_kernel.py's)."""
    b = procedural.bunny_like(subdivisions=2)
    tex = np.indices((32, 32)).sum(axis=0) % 2
    tid = b.add_texture((np.stack([tex] * 3, -1) * 0.6 + 0.2)
                        .astype(np.float32))
    b.materials[1] = MaterialDesc(albedo=(1, 1, 1), albedo_tex=tid,
                                  roughness=0.4)
    env = np.full((32, 64, 3), 0.5, np.float32)
    env[4:8, 10:14] = 200.0
    b.set_envmap(env)
    return b.finalize(device="cpu")


def _materials_scene():
    """The Cornell materials suite (metal, glass) and an alpha-0.4 card
    across the box: dielectric and passthrough lanes."""
    b = procedural.cornell_box(materials_suite=True)
    card = b.add_material(MaterialDesc(albedo=(0.3, 0.6, 0.2), alpha=0.4,
                                       roughness=0.5))
    v, i = procedural._quad([0.15, 0.1, 0.8], [0.85, 0.1, 0.8],
                            [0.85, 0.7, 0.8], [0.15, 0.7, 0.8])
    b.add_mesh(v, i, card)
    scene = b.finalize(device="cpu")
    assert bool((scene.mat_type == MAT_DIELECTRIC).any())
    return scene


def _sponza(stack=False):
    scene = procedural.sponza_like(target_tris=6000, seed=0,
                                   textured=True).finalize(device="cpu")
    if stack:       # the u8 texture stack instead of composite texels
        scene = dataclasses.replace(scene, tex_comp=None, tex_comp_wh=None)
    return scene


SPONZA_CAM = ((3.0, 4.5, 6.0), (14.0, 3.0, 6.0))
BOX_CAM = ((0.5, 0.5, 2.2), (0.5, 0.5, 0.0))
ENV_CAM = ((0.0, 0.6, 2.6), (0.0, 0.3, 0.0))
ENV = dict(sky="envmap", env_importance_sampling=True)

# name: (scene maker, RenderConfig fields, camera)
CASES = {
    "sponza_textured": (_sponza, {}, SPONZA_CAM),
    "sponza_stack_textures": (lambda: _sponza(stack=True), {}, SPONZA_CAM),
    "sponza_bilinear": (_sponza, dict(stochastic_texture_filtering=False),
                        SPONZA_CAM),
    "env_cell1": (_env_scene, dict(ENV, env_nee_cell=1), ENV_CAM),
    "env_cell8": (_env_scene, dict(ENV, env_nee_cell=8), ENV_CAM),
    "env_shadow_rr": (_env_scene, dict(ENV, env_nee_cell=8,
                                       env_shadow_rr=1.5), ENV_CAM),
    "env_sky_no_nee": (_env_scene, dict(sky="envmap"), ENV_CAM),
    "env_skip_nee": (_env_scene, dict(ENV, skip_nee=True), ENV_CAM),
    "materials_rr": (_materials_scene, dict(rr_start_depth=-1), BOX_CAM),
    "untextured": (lambda: procedural.cornell_box(spheres=True)
                   .finalize(device="cpu"), {}, BOX_CAM),
    "untextured_black_sky": (lambda: procedural.cornell_box(spheres=True)
                             .finalize(device="cpu"), dict(sky="black"),
                             BOX_CAM),
    "skip_nee": (_sponza, dict(skip_nee=True), SPONZA_CAM),
}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K10 is built with nvcc and runs "
                    "only on the card")
    return CUDA


_SCENES = {}


def _case(name, **extra):
    make, fields, cam_spec = CASES[name]
    if name not in _SCENES:
        _SCENES[name] = build_scene_clusters(make()).to(CUDA)
    cfg = RenderConfig(**dict(dict(width=48, height=32, spp=2, seed=12345),
                              **fields, **extra))
    cam = Camera(position=cam_spec[0])
    cam.look_at(cam_spec[1])
    return _SCENES[name], cfg, cam


def _trace(scene, cfg, cam, kernel, monkeypatch):
    """trace_paths over one wavefront, K10 on or off; every traversal
    call's rays are recorded: (kind, o, d, t_max)."""
    i_fn, o_fn, _ = render.make_intersectors(scene, cfg)
    calls = []

    def closest(o, d, t_min, t_max, **kw):
        calls.append(("closest", o.clone(), d.clone(), None))
        return i_fn(o, d, t_min, t_max, **kw)

    def occluded(o, d, t_max, **kw):
        calls.append(("occluded", o.clone(), d.clone(), t_max.clone()))
        return o_fn(o, d, t_max, **kw)

    o, d, pix, samp = _wavefront(scene, cfg, cam, first_sample=40)
    with monkeypatch.context() as m:
        if not kernel:
            m.setattr(shade_mod, "kernel_shades", lambda *a, **kw: False)
        before = dict(tracing.COUNTERS)
        launches = tracing.LAUNCHES["shade"]
        rad, pix_out, rays, _, _ = path.trace_paths(
            scene, cfg, o, d, pix, samp, closest, occluded,
            sample_window=cfg.spp)
        torch.cuda.synchronize()
    counted = {k: tracing.COUNTERS[k] - before[k]
               for k in ("shade_kernel", "shade_plain")}
    counted["launches"] = tracing.LAUNCHES["shade"] - launches
    return rad, pix_out, int(rays), calls, counted


# floats may differ by a few ulps of their row's magnitude
ULPS = 8
EPS32 = float(np.finfo(np.float32).eps)


def _far_lanes(a, b, ulps=ULPS):
    """Lanes whose values differ by more than `ulps` ulps of the row's
    largest magnitude (NaN equal to NaN)."""
    a2, b2 = (x.reshape(x.shape[0], -1) for x in (a, b))
    scale = torch.maximum(a2.abs(), b2.abs()).amax(dim=1, keepdim=True)
    scale = torch.where(torch.isfinite(scale), scale, 0.0)
    both_nan = torch.isnan(a2) & torch.isnan(b2)
    same = (a2 == b2) | both_nan
    near = (a2 - b2).abs() <= ulps * EPS32 * scale
    return ~(same | near).all(dim=1)


def _compare_calls(k_calls, p_calls):
    assert [c[0] for c in k_calls] == [c[0] for c in p_calls]
    for j, (kc, pc) in enumerate(zip(k_calls, p_calls)):
        kind = kc[0]
        k_park = kc[1][:, 0] >= 1e29
        p_park = pc[1][:, 0] >= 1e29
        assert torch.equal(k_park, p_park), \
            f"call {j} ({kind}): {int((k_park != p_park).sum())} lanes " \
            "parked on one side only"
        assert torch.equal(kc[1][k_park], pc[1][p_park])
        assert torch.equal(kc[2][k_park], pc[2][p_park])
        live = ~k_park
        for what, x, y in (("origin", kc[1], pc[1]),
                           ("direction", kc[2], pc[2]),
                           ("t_max", kc[3], pc[3])):
            if x is None:
                continue
            far = _far_lanes(x[live], y[live])
            assert not bool(far.any()), \
                f"call {j} ({kind}) {what}: {int(far.sum())} lanes apart"


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_k10_bounce_equals_the_plain_chain(dev, name, monkeypatch):
    """One bounce and the last segment (max_depth 2): every traversal
    call gets the same parked lanes and rays within a few ulps, the ray
    count is exact and the radiance within a few ulps, lane by lane."""
    scene, cfg, cam = _case(name, max_depth=2)
    rk, pk, nk, ck, cnt_k = _trace(scene, cfg, cam, True, monkeypatch)
    rp, pp, np_, cp, cnt_p = _trace(scene, cfg, cam, False, monkeypatch)
    assert cnt_k == {"shade_kernel": 2, "shade_plain": 0, "launches": 2}
    assert cnt_p == {"shade_kernel": 0, "shade_plain": 2, "launches": 0}
    assert torch.equal(pk, pp)
    assert nk == np_
    _compare_calls(ck, cp)
    far = _far_lanes(rk, rp)
    assert not bool(far.any()), f"radiance: {int(far.sum())} lanes apart"


@pytest.mark.cuda
@pytest.mark.parametrize("name,extra", [
    ("sponza_textured", {}), ("env_cell8", {}),
    ("env_shadow_rr", dict(wavefront_sort=True)),
    ("materials_rr", {}), ("untextured", dict(clamp_radiance=2.0))])
def test_k10_trace_paths_equals_the_plain_chain(dev, name, extra,
                                                monkeypatch):
    """A whole trace_paths (depth 6): the same int64 ray count, the same
    parked lanes in every traversal call, radiance within a few ulps."""
    scene, cfg, cam = _case(name, max_depth=6, **extra)
    rk, pk, nk, ck, cnt_k = _trace(scene, cfg, cam, True, monkeypatch)
    rp, pp, np_, cp, _ = _trace(scene, cfg, cam, False, monkeypatch)
    assert cnt_k["shade_kernel"] == 6 and cnt_k["shade_plain"] == 0
    assert nk == np_
    assert torch.equal(pk, pp)
    _compare_calls(ck, cp)
    far = _far_lanes(rk, rp)
    assert not bool(far.any()), f"radiance: {int(far.sum())} lanes apart"


def _renderer(name, **extra):
    scene, cfg, cam = _case(name, **extra)
    return render.Renderer(scene, cfg, cam, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sponza_textured", "env_cell8"])
def test_step_shading_never_syncs(dev, name, monkeypatch):
    """A Renderer.step under sync debug mode "error" everywhere inside
    trace_paths but the traversal calls (whose chunk_live reads and
    scalar t_max copies are the packet layer's): K10, its resolve, the
    env-NEE table and the gradient sky make no host sync."""
    r = _renderer(name, max_depth=4, spp_batch=True)
    r.step()                                   # builds and loads K10
    torch.cuda.synchronize()
    make, trace_paths = render.make_intersectors, path.trace_paths

    def allowed(fn):
        def call(*a, **kw):
            torch.cuda.set_sync_debug_mode("default")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        return call

    def intersectors(*a, **kw):
        i_fn, o_fn, h_fn = make(*a, **kw)
        return allowed(i_fn), allowed(o_fn), h_fn

    def strict(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return trace_paths(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(render, "make_intersectors", intersectors)
    monkeypatch.setattr(path, "trace_paths", strict)
    before = tracing.COUNTERS["shade_kernel"]
    r.step()
    torch.cuda.synchronize()
    assert tracing.COUNTERS["shade_kernel"] - before == 4
    assert bool(torch.isfinite(r.film.accum).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name,extra,plain", [
    ("sponza_textured", dict(max_depth=6), 0),
    ("env_cell8", dict(max_depth=5, frame_batch=2), 0),
    ("untextured", dict(max_depth=3, skip_nee=True), 0),
    ("sponza_textured", dict(max_depth=4, primary_priming=True), 1)])
def test_step_launches_k10_once_a_bounce(dev, name, extra, plain):
    """LAUNCHES and the shade counters over one Renderer.step: K10 once a
    bounce, the resolve once a bounce with shadow queries, and the
    plain chain only on the primed bounce 0."""
    r = _renderer(name, spp_batch=True, **extra)
    r.step()
    depth = r.cfg.max_depth
    queries = 0 if r.cfg.skip_nee else depth - 1 - plain
    before = dict(tracing.LAUNCHES), dict(tracing.COUNTERS)
    r.step()
    torch.cuda.synchronize()
    rise = {k: tracing.LAUNCHES[k] - before[0][k]
            for k in ("shade", "shade_resolve")}
    rise.update({k: tracing.COUNTERS[k] - before[1][k]
                 for k in ("shade_kernel", "shade_plain")})
    assert rise == {"shade": depth - plain, "shade_resolve": queries,
                    "shade_kernel": depth - plain, "shade_plain": plain}
    assert bool(torch.isfinite(r.film.accum).all())
