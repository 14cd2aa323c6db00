"""K9 (csrc/rng.cu, sampling/rng.pcg4d_uniform): the PCG4D draw of
uniform1/2/4 with sampler="pcg".

CPU tests: the wrapper runs the plain version on CPU tensors and
launches nothing, copies no scalar key word from the host, K9's view of
the key words (kernel_words) addresses every lane's words as the plain
version broadcasts them, and the draws equal the JAX package's bits.
The `cuda` tests hold K9 to the plain version bit for bit, run a draw
under torch's sync debug mode "error", and count K9's launches over a
Renderer step. The file imports jax only inside the CPU test that
compares with the JAX package, so on a card it runs without it:

    python -m pytest tests/test_torch_rng_kernel.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from pathtracer_torch import tracing
from pathtracer_torch.accel.cluster import build_scene_clusters
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.integrator.camera import Camera
from pathtracer_torch.render import Renderer
from pathtracer_torch.sampling import rng
from pathtracer_torch.scene import procedural
from pathtracer_torch.scene.build import MaterialDesc

M32 = 0xFFFFFFFF
SEEDS = (0, 7, 1 << 31, M32)


def _plain(*words):
    return rng._to_unit(rng.pcg4d(rng._key(*words)))


def _words(n, seed, dtype=torch.int64, high=1 << 40):
    """n key words from the seed, with the u32 edge values first; int32
    words wrap (negative values are words >= 2^31)."""
    g = np.random.default_rng(seed)
    w = g.integers(0, high, size=n, dtype=np.int64)
    k = min(n, 4)
    w[:k] = [M32, 1 << 31, (1 << 31) + 1, 0xDEADBEEF][:k]
    t = torch.from_numpy(w)
    return t.to(torch.int32) if dtype == torch.int32 else t


def _emulate(words):
    """K9's reads, on the CPU: each word from kernel_words' (tensor,
    stride, kind, immediate) as the kernel addresses it, masked to 32
    bits, then the plain hash."""
    shape, kw = rng.kernel_words(words, torch.device("cpu"))
    n = int(np.prod(shape))
    cols = []
    for e, stride, kind, imm in kw:
        if e is None:
            assert kind == 0
            cols.append(torch.full((n,), imm, dtype=torch.int64))
        else:
            assert kind == {torch.int32: 1, torch.int64: 2}[e.dtype]
            flat = torch.as_strided(e, (n,), (stride,), e.storage_offset())
            cols.append(flat.to(torch.int64) & M32)
    u = rng._to_unit(rng.pcg4d(torch.stack(cols, dim=-1)))
    return u.reshape(tuple(shape) + (4,))


def _layouts():
    """Key-word sets of every layout the main path and the tests hand
    K9: (name, words)."""
    pix32 = _words(3000, 1, torch.int32)
    samp = _words(3000, 2)
    big = _words(3 * 3000, 3, torch.int32)
    grid = _words(40 * 25, 4).reshape(40, 25)
    return [
        ("int32_int64_scalars", (pix32, samp, 3 * 12 + 5, M32)),
        ("strided_and_0d", (big[::3], torch.tensor(1 << 33), 17, 9)),
        ("0d_seed_tensor", (samp, pix32, 0, torch.tensor(M32,
                                                        dtype=torch.int64))),
        ("column_vs_scalar", (pix32[:, None], torch.tensor([5]), 1, 0)),
        ("grid_contiguous", (grid, grid.to(torch.int32), 2, 3)),
        ("all_scalars", (12345, 1 << 31, 70, M32)),
        ("one_lane", (pix32[:1], samp[:1], 11, 0)),
    ]


@pytest.mark.parametrize("name,words", _layouts(),
                         ids=[n for n, _ in _layouts()])
def test_kernel_words_address_every_lane(name, words):
    """K9's addressing (a stride a word, or an immediate) reads the words
    the plain version broadcasts, lane for lane."""
    got = _emulate(words)
    ref = _plain(*words)
    assert got.shape == ref.shape
    assert torch.equal(got, ref), name


@pytest.mark.parametrize("words,what", [
    ((torch.arange(6)[:, None], torch.arange(4)[None, :], 0, 0),
     "one stride"),
    ((torch.arange(12).reshape(3, 4).t(), 0, 0, 0), "one stride"),
    ((torch.arange(5, dtype=torch.int16), 0, 0, 0), "int16"),
    ((torch.arange(5.0), 0, 0, 0), "float32"),
])
def test_kernel_words_refuse_what_k9_cannot_take(words, what):
    with pytest.raises(ValueError, match=what):
        rng.kernel_words(words, torch.device("cpu"))


def test_cpu_draws_take_the_plain_path_and_launch_nothing():
    pix = _words(4096, 5, torch.int32)
    samp = _words(4096, 6)
    before = tracing.LAUNCHES["pcg4d"]
    u4 = rng.uniform4(pix, samp, 2, rng.SALT_BSDF_UV, 99)
    u2 = rng.uniform2(pix, samp, 2, rng.SALT_BSDF_UV, 99)
    u1 = rng.uniform1(pix, samp, 2, rng.SALT_BSDF_UV, 99)
    assert tracing.LAUNCHES["pcg4d"] == before
    assert torch.equal(u4, _plain(pix, samp, 2 * 12 + rng.SALT_BSDF_UV, 99))
    assert torch.equal(u2[0], u4[:, 0]) and torch.equal(u2[1], u4[:, 1])
    assert torch.equal(u1, u4[:, 0])
    assert u4.dtype == torch.float32 and u4.shape == (4096, 4)


@pytest.mark.parametrize("sampler", ["pcg", "sobol"])
def test_scalar_words_copy_nothing_from_the_host(sampler):
    """depth, salt and seed as Python ints: no host sync is counted (on
    a card, none would happen)."""
    pix = _words(512, 7, torch.int32)
    samp = _words(512, 8)
    before = tracing.COUNTERS["host_syncs"]
    for seed in SEEDS:
        rng.uniform4(pix, samp, 5, rng.SALT_RR, seed, sampler)
        rng.uniform4(pix, 3, 1, rng.SALT_JITTER, seed, sampler)
        rng.uniform1(pix, samp, 0, rng.SALT_LIGHT_SELECT, seed, sampler)
    if sampler == "pcg":
        assert tracing.COUNTERS["host_syncs"] == before
    else:   # the Sobol direction table is still copied once a draw
        assert tracing.COUNTERS["host_syncs"] - before == 3 * len(SEEDS)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("depth,salt", [(0, 0), (5, 11), (63, 7)])
def test_uniforms_equal_the_jax_package_bits(seed, depth, salt):
    """Pixel words up to 2^32 - 1 (int64 tensors), sample ids as a
    tensor and as a scalar, against pathtracer.sampling.rng."""
    import jax.numpy as jnp

    from pathtracer.sampling import rng as jrng

    pixel = _words(2048, depth * 16 + salt, high=1 << 32)
    sample = _words(2048, seed & 0xFFFF, high=1 << 32)
    assert bool((pixel >= 1 << 31).any()) and bool((sample >= 1 << 31).any())
    jp = jnp.asarray(pixel.numpy().astype(np.uint32))
    js = jnp.asarray(sample.numpy().astype(np.uint32))
    for s_t, s_j in ((sample, js), (M32, np.uint32(M32)), (3, np.uint32(3))):
        ref4 = np.asarray(jrng.uniform4(jp, s_j, depth, salt, seed))
        got4 = rng.uniform4(pixel, s_t, depth, salt, seed)
        np.testing.assert_array_equal(got4.numpy(), ref4)
        np.testing.assert_array_equal(
            rng.uniform1(pixel, s_t, depth, salt, seed).numpy(),
            np.asarray(jrng.uniform1(jp, s_j, depth, salt, seed)))
        for a, b in zip(rng.uniform2(pixel, s_t, depth, salt, seed),
                        jrng.uniform2(jp, s_j, depth, salt, seed)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K9 is built with nvcc and runs "
                    "only on the card")
    return torch.device("cuda")


def _card_words(n, kinds, dev):
    """Key words of n lanes: 't32' / 't64' a tensor of that width, 's' a
    Python int, '0d' a 0-dim int64 tensor, 'st' an int32 tensor read at
    stride 3."""
    out = []
    for i, k in enumerate(kinds):
        if k == "s":
            out.append([M32, 1 << 31, 70, 0][i])
        elif k == "0d":
            out.append(torch.tensor((1 << 32) + 5 + i, device=dev))
        elif k == "st":
            out.append(_words(3 * n, 10 + i, torch.int32).to(dev)[::3])
        else:
            dt = torch.int32 if k == "t32" else torch.int64
            out.append(_words(n, 20 + i, dt).to(dev))
    return tuple(out)


KINDS = [("t32", "t64", "s", "s"), ("t64", "t32", "t64", "0d"),
         ("st", "s", "t32", "s"), ("s", "t64", "s", "t32"),
         ("t64", "0d", "s", "0d")]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 257, 1 << 20, 8_294_400])
@pytest.mark.parametrize("kinds", KINDS, ids=["-".join(k) for k in KINDS])
def test_k9_equals_plain_bit_for_bit(dev, n, kinds):
    words = _card_words(n, kinds, dev)
    before = tracing.LAUNCHES["pcg4d"]
    got = rng.pcg4d_uniform(*words)
    assert tracing.LAUNCHES["pcg4d"] == before + 1
    assert got.shape == (n, 4) and got.dtype == torch.float32
    ref = _plain(*words)            # the plain chain on the card
    assert torch.equal(got, ref), int((got != ref).sum())
    if n <= 1 << 20:                # and on the CPU
        cpu = tuple(w.cpu() if isinstance(w, torch.Tensor) else w
                    for w in words)
        assert torch.equal(got.cpu(), _plain(*cpu))


@pytest.mark.cuda
def test_k9_uniforms_keep_shape_and_values(dev):
    pix = _words(4096, 30, torch.int32).to(dev).reshape(64, 64)
    samp = _words(4096, 31).to(dev).reshape(64, 64)
    u4 = rng.uniform4(pix, samp, 4, rng.SALT_ENV_UV, 12345)
    assert u4.shape == (64, 64, 4)
    assert torch.equal(u4.cpu(), rng.uniform4(pix.cpu(), samp.cpu(), 4,
                                              rng.SALT_ENV_UV, 12345))
    u1 = rng.uniform1(pix, samp, 4, rng.SALT_ENV_UV, 12345)
    u2 = rng.uniform2(pix, samp, 4, rng.SALT_ENV_UV, 12345)
    assert torch.equal(u1, u4[..., 0]) and torch.equal(u2[1], u4[..., 1])
    with pytest.raises(ValueError, match="one stride"):
        rng.uniform4(pix[:, :1], samp[:1, :], 0, 0)


@pytest.mark.cuda
def test_k9_draw_never_syncs(dev):
    pix = _words(1 << 16, 40, torch.int32).to(dev)
    samp = _words(1 << 16, 41).to(dev)
    seed = torch.tensor(M32, device=dev)
    rng.uniform4(pix, samp, 0, 0)            # builds and loads K9
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        before = tracing.COUNTERS["host_syncs"]
        u = rng.uniform4(pix, samp, 3, rng.SALT_RR, M32)
        v = rng.uniform1(pix, 7, 5, rng.SALT_ALPHA, seed)
        w = rng.uniform2(pix, samp, 1, rng.SALT_LIGHT_UV, 0)[0]
        assert tracing.COUNTERS["host_syncs"] == before
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(u.cpu(), _plain(pix.cpu(), samp.cpu(),
                                       3 * 12 + rng.SALT_RR, M32))
    assert torch.equal(v.cpu(), _plain(pix.cpu(), 7, 5 * 12 + rng.SALT_ALPHA,
                                       M32)[:, 0])
    assert bool(torch.isfinite(w).all())


def _env_scene():
    """bunny_like(2) with a checker texture under a small sky with a hot
    disc: env NEE (cell draws, shadow RR) and texture-filter draws."""
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


SCENES = {
    "box_nee": (lambda: procedural.cornell_box(spheres=True)
                .finalize(device="cpu"),
                dict(spp=2, spp_batch=True),
                ((0.5, 0.5, 2.2), (0.5, 0.5, 0.0))),
    "env_frame_batch": (_env_scene,
                        dict(spp=1, spp_batch=True, frame_batch=2,
                             sky="envmap", env_importance_sampling=True,
                             env_shadow_rr=1.0),
                        ((0.0, 0.6, 2.6), (0.0, 0.3, 0.0))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_step_launches_k9_once_a_draw(dev, scene_name, monkeypatch):
    """One Renderer.step: LAUNCHES["pcg4d"] rises by exactly its
    sampler="pcg" draws, and the eager hash never runs on the card."""
    make, fields, cam_spec = SCENES[scene_name]
    scene = build_scene_clusters(make())
    cfg = RenderConfig(**dict(dict(width=32, height=32, max_depth=4),
                              **fields))
    cam = Camera(position=cam_spec[0])
    cam.look_at(cam_spec[1])
    r = Renderer(scene, cfg, cam, device="cuda")
    r.step()                                  # warm-up
    draws = []
    uniform4, pcg4d = rng.uniform4, rng.pcg4d

    def counted(*a, **kw):
        sampler = kw.get("sampler", a[5] if len(a) > 5 else "pcg")
        draws.append(sampler)
        return uniform4(*a, **kw)

    def eager(v):
        assert v.device.type == "cpu", "the eager PCG4D ran on the card"
        return pcg4d(v)

    monkeypatch.setattr(rng, "uniform4", counted)
    monkeypatch.setattr(rng, "pcg4d", eager)
    before = tracing.LAUNCHES["pcg4d"]
    r.step()
    torch.cuda.synchronize()
    assert draws and set(draws) == {"pcg"}
    assert tracing.LAUNCHES["pcg4d"] - before == len(draws)
    assert bool(torch.isfinite(r.film.accum).all())
