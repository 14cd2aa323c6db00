"""The Sobol sampler of pathtracer_torch against the JAX package.

Every output is u32 integer arithmetic, so every word must be equal bit
for bit: the direction vectors, reverse_bits, the Laine-Karras hash,
owen_scramble, sobol4, scrambled_sobol4 and uniform4(sampler="sobol"),
over inputs at and above 2^31 (where a u32 product overflows signed
int64 unless split, rng._mul32). The raw sequence is also held to
scipy.stats.qmc.Sobol (tests/test_sobol.py:39).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer.sampling import rng as jrng
from pathtracer.sampling import sobol as jsobol
from pathtracer_torch.sampling import rng as trng
from pathtracer_torch.sampling import sobol as tsobol

EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xDEADBEEF,
                  0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _words(n, seed):
    w = np.random.default_rng(seed).integers(0, 1 << 32, n, dtype=np.uint64)
    return np.concatenate([EDGES, w.astype(np.uint32)])


def _j(x):
    return jnp.asarray(x, jnp.uint32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.uint32).astype(np.int64))


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


def test_direction_vectors_match():
    np.testing.assert_array_equal(tsobol._DIRS,
                                  jsobol._DIRS.astype(np.int64))


def test_reverse_bits_matches():
    x = _words(4096, 1)
    _same(tsobol.reverse_bits(_t(x)), jsobol.reverse_bits(_j(x)))


@pytest.mark.parametrize("seed", [0, 1, 0x9E3779B9, 0xFFFFFFFF])
def test_laine_karras_and_owen_scramble_match(seed):
    x = _words(4096, 2)
    s = np.full_like(x, seed)
    _same(tsobol._laine_karras(_t(x), _t(s)),
          jsobol._laine_karras(_j(x), _j(s)))
    _same(tsobol.owen_scramble(_t(x), _t(s)),
          jsobol.owen_scramble(_j(x), _j(s)))
    # per-lane seeds
    s = _words(4096, 3)
    _same(tsobol.owen_scramble(_t(x), _t(s)),
          jsobol.owen_scramble(_j(x), _j(s)))


def test_sobol4_matches():
    x = np.concatenate([np.arange(1024, dtype=np.uint32), _words(2048, 4)])
    _same(tsobol.sobol4(_t(x)), jsobol.sobol4(_j(x)))


def test_scrambled_sobol4_matches():
    x = _words(4096, 5)
    gk = np.stack([_words(4096, 6 + i) for i in range(4)], axis=-1)
    _same(tsobol.scrambled_sobol4(_t(x), _t(gk)),
          jsobol.scrambled_sobol4(_j(x), _j(gk)))


def test_sobol_matches_scipy_qmc():
    scipy_qmc = pytest.importorskip("scipy.stats.qmc")
    ref = scipy_qmc.Sobol(d=4, scramble=False).random(64)
    pts = tsobol.sobol4(torch.arange(64, dtype=torch.int64)).numpy()
    np.testing.assert_allclose(pts / 2.0 ** 32, ref, atol=1e-9)


@pytest.mark.parametrize("depth,salt,seed", [(0, trng.SALT_JITTER, 0),
                                             (3, trng.SALT_BSDF_UV, 7),
                                             (5, trng.SALT_RR, 0xFFFFFFFF)])
def test_uniform4_sobol_bit_exact(depth, salt, seed):
    rng = np.random.default_rng(depth)
    pixel = rng.integers(0, 1 << 21, 4096).astype(np.uint32)
    sample = _words(4096 - len(EDGES), 9 + depth)
    want = np.asarray(jrng.uniform4(_j(pixel), _j(sample), depth, salt,
                                    seed, sampler="sobol"))
    got = trng.uniform4(_t(pixel), _t(sample), depth, salt, seed,
                        sampler="sobol")
    assert got.dtype == torch.float32 and got.shape == (4096, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got >= 0).all() and (got < 1).all()


def test_uniform_sobol_broadcasts_like_jax():
    """A scalar sample against pixel arrays, a scalar pixel against
    sample arrays, and uniform1/uniform2 slices of the same draw."""
    pixel = np.arange(256, dtype=np.uint32)
    sample = np.uint32(0x80000003)
    want = np.asarray(jrng.uniform4(_j(pixel), _j(sample), 1, 4, 3,
                                    sampler="sobol"))
    got = trng.uniform4(_t(pixel), int(sample), 1, 4, 3, sampler="sobol")
    np.testing.assert_array_equal(got.numpy(), want)
    samples = np.arange(0xFFFFFF00, 0xFFFFFFFF, dtype=np.uint32)
    want = np.asarray(jrng.uniform4(_j(17), _j(samples), 2, 6, 0,
                                    sampler="sobol"))
    got = trng.uniform4(17, _t(samples), 2, 6, 0, sampler="sobol")
    np.testing.assert_array_equal(got.numpy(), want)
    u1 = trng.uniform1(17, _t(samples), 2, 6, 0, sampler="sobol")
    u2a, u2b = trng.uniform2(17, _t(samples), 2, 6, 0, sampler="sobol")
    assert torch.equal(u1, got[:, 0]) and torch.equal(u2b, got[:, 1])
    assert torch.equal(u2a, got[:, 0])


def test_unknown_sampler_raises():
    with pytest.raises(ValueError, match="unknown sampler"):
        trng.uniform4(torch.zeros(4, dtype=torch.int64), 0, 0, 0,
                      sampler="halton")
