"""pathtracer_torch config, RNG, Morton codes and coherence keys vs the JAX package.

Integer and order-free parts must match bit for bit: PCG4D words
(including words with the high bit set, where a u32 product overflows
signed int64), uniforms, Morton codes and the dirmajor coherence key.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer import config as jconfig
from pathtracer.accel import morton as jmorton
from pathtracer.accel.cluster import build_clusters as jbuild_clusters
from pathtracer.kernels import packet as jpacket
from pathtracer.sampling import rng as jrng
from pathtracer_torch import config as tconfig
from pathtracer_torch.accel import morton as tmorton
from pathtracer_torch.accel.cluster import accel_from_numpy
from pathtracer_torch.kernels import packet as tpacket
from pathtracer_torch.sampling import rng as trng


def test_render_config_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.RenderConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.RenderConfig)}
    assert list(tf) == list(jf)
    assert tf == jf
    assert tconfig.POOL_SATURATION_LANES == jconfig.POOL_SATURATION_LANES
    assert tconfig.RenderConfig() == tconfig.RenderConfig(**dict(
        (k, v) for k, v in dataclasses.asdict(jconfig.RenderConfig()).items()))


@pytest.mark.parametrize("kw", [dict(wavefront_sort=True),
                                dict(skip_nee=True)])
def test_config_rejects_unported_values(kw):
    """The two values the port once rejected are ported now: the config
    takes them as the JAX package's does, and no value is unported."""
    assert not hasattr(tconfig, "_unported")
    assert dataclasses.asdict(tconfig.RenderConfig(**kw)) == \
        dataclasses.asdict(jconfig.RenderConfig(**kw))


@pytest.mark.parametrize("kw", [
    dict(sky="envmap"), dict(sky="envmap", env_importance_sampling=True,
                             env_nee_cell=1, env_shadow_rr=0.5),
    dict(primary_priming=True), dict(tonemap="reinhard"),
    dict(tonemap="aces"), dict(denoise=True), dict(capture_gbuffer=True),
    dict(spp_batch=True, frame_batch=2), dict(clamp_radiance=1.0),
    dict(aperture=0.1, focus_dist=1.0),
    dict(sky="hosek"), dict(sky="envmap", sampler="sobol"),
    dict(sampler="sobol"), dict(primary_priming=True, intersector="bvh"),
    dict(intersector="bvh"), dict(reference_quirks=True)])
def test_config_accepts_ported_slices(kw):
    assert dataclasses.asdict(tconfig.RenderConfig(**kw)) == \
        dataclasses.asdict(jconfig.RenderConfig(**kw))


@pytest.mark.parametrize("kw", [dict(width=0), dict(spp=0),
                                dict(max_depth=0), dict(sky="foo"),
                                dict(traversal_backend="mosaic"),
                                dict(frame_batch=2), dict(aperture=0.2)])
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as jerr:
        jconfig.RenderConfig(**kw)
    with pytest.raises(ValueError) as terr:
        tconfig.RenderConfig(**kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("w,h,spp", [(1024, 1024, 1), (512, 512, 4),
                                     (1920, 1080, 4), (64, 64, 1),
                                     (4096, 4096, 1)])
def test_saturating_frame_batch_matches_jax(w, h, spp):
    assert tconfig.saturating_frame_batch(w, h, spp) == \
        jconfig.saturating_frame_batch(w, h, spp)


def test_config_rejects_xla_backend():
    """The JAX package's lockstep "xla" traversal has no counterpart in
    the port: one route, the kernel wrappers, serves CPU and CUDA."""
    assert jconfig.RenderConfig(traversal_backend="xla")
    with pytest.raises(ValueError, match="not part of pathtracer_torch"):
        tconfig.RenderConfig(traversal_backend="xla")


def _words(shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)
    w.flat[:4] = [0xFFFFFFFF, 0x80000000, 0x80000001, 0xDEADBEEF]
    return w


def test_pcg4d_bit_exact_high_words():
    v = _words((4096, 4), 0)
    assert (v >= 1 << 31).any()
    ref = np.asarray(jrng.pcg4d(jnp.asarray(v)))
    got = trng.pcg4d(torch.from_numpy(v.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


def test_mul32_is_exact_mod_2_32():
    a = _words((20000,), 1).astype(np.int64)
    b = _words((20000,), 2).astype(np.int64)
    ref = (a.astype(object) * b.astype(object)) % (1 << 32)
    got = trng._mul32(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


@pytest.mark.parametrize("depth,salt,seed", [(0, 0, 0), (3, 7, 0),
                                             (5, 10, 12345),
                                             (1, 11, 0xFFFFFFFF)])
def test_uniforms_bit_exact(depth, salt, seed):
    pixel = np.arange(0, 1920 * 1080, 977, dtype=np.int32)
    sample = (np.arange(pixel.size) * 2654435761) % (1 << 32)
    sample = sample.astype(np.uint32)
    ref4 = np.asarray(jrng.uniform4(jnp.asarray(pixel), jnp.asarray(sample),
                                    depth, salt, seed))
    tp, ts = torch.from_numpy(pixel), torch.from_numpy(sample.astype(np.int64))
    got4 = trng.uniform4(tp, ts, depth, salt, seed).numpy()
    np.testing.assert_array_equal(got4, ref4)
    r1 = np.asarray(jrng.uniform1(jnp.asarray(pixel), jnp.asarray(sample),
                                  depth, salt, seed))
    np.testing.assert_array_equal(trng.uniform1(tp, ts, depth, salt,
                                                seed).numpy(), r1)
    ju = jrng.uniform2(jnp.asarray(pixel), jnp.asarray(sample), depth, salt,
                       seed)
    tu = trng.uniform2(tp, ts, depth, salt, seed)
    for a, b in zip(tu, ju):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got4.min() >= 0.0 and got4.max() < 1.0


def test_salts_match():
    names = [n for n in dir(jrng) if n.startswith("SALT_")]
    assert names
    for n in names + ["_SALTS_PER_DEPTH"]:
        assert getattr(trng, n) == getattr(jrng, n), n


def test_morton_codes_bit_exact():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(5000, 3)).astype(np.float32) * 7.0
    pts[:10] = 1e30                        # parked lanes clip to the top
    ref = np.asarray(jmorton.morton_codes(jnp.asarray(pts[10:])))
    got = tmorton.morton_codes(torch.from_numpy(pts[10:])).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    lo = np.float32([-3, -2, -1])
    hi = np.float32([4, 5, 6])
    ref = np.asarray(jmorton.morton_codes(jnp.asarray(pts), jnp.asarray(lo),
                                          jnp.asarray(hi)))
    got = tmorton.morton_codes(torch.from_numpy(pts), torch.from_numpy(lo),
                               torch.from_numpy(hi)).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


@pytest.mark.parametrize("dir_bits", [1, 2, 3])
def test_coherence_key_bit_exact(dir_bits):
    rng = np.random.default_rng(4)
    t = 600
    v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    ja = jbuild_clusters(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
                         max_clusters=16)
    ta = accel_from_numpy(*(np.asarray(getattr(ja, f)) for f in
                            ("aabb_lo", "aabb_hi", "blocks_t")),
                          device="cpu")
    o = rng.uniform(-2, 2, (3000, 3)).astype(np.float32)
    d = rng.normal(size=(3000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[-100:] = 1e30                        # parked lanes sort last
    d[-100:] = 1.0
    ref = np.asarray(jpacket._coherence_key(ja, jnp.asarray(o),
                                            jnp.asarray(d), dir_bits,
                                            scheme="dirmajor"))
    got = tpacket._coherence_key(ta, torch.from_numpy(o),
                                 torch.from_numpy(d), dir_bits).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    assert (got[-100:] == 0xFFFFFFFF).all()
