"""Coherence keys and the wavefront order, port vs the JAX package, bit
for bit.

- `_coherence_key` (the dirmajor key, the port's one scheme) at 1-3
  direction bits, with parked lanes, and the knobs around it: PT_DIR_BITS
  is read where the JAX package reads it, and PT_KEY_SCHEME /
  PT_KEY_SCHEME_OCCL are accepted at dirmajor and refused at the retired
  mixed and firstcluster keys;
- `integrator/path._wavefront_order`.

    python -m pytest tests/test_torch_keys.py -q -p no:randomly"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pathtracer.accel.cluster import build_clusters as jbuild
from pathtracer.integrator import path as jpath
from pathtracer.kernels import packet as jpacket
from pathtracer.scene import procedural as jproc
from pathtracer_torch import knobs
from pathtracer_torch.accel.cluster import accel_from_numpy
from pathtracer_torch.accel import morton as tmorton
from pathtracer_torch.integrator import path as tpath
from pathtracer_torch.kernels import packet as tpacket
from pathtracer_torch.scene import procedural as tproc


def _soup(t, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    return v0, v1, v2


def _rays(n, seed, park=0, spread=2.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if park:
        o[-park:] = 1e30
        d[-park:] = 1.0
    return o, d


def _accels(t=3000, seed=4, method="morton", **kw):
    """(JAX accel, the port's carried accel) over one soup."""
    ja = jbuild(*(jnp.asarray(x) for x in _soup(t, seed)), method=method,
                **kw)
    ta = accel_from_numpy(*(np.asarray(getattr(ja, f)) for f in
                            ("aabb_lo", "aabb_hi", "blocks_t")),
                          device="cpu")
    return ja, ta


@pytest.fixture(scope="module")
def morton375():
    """3000 triangles in 375 clusters of 8."""
    return _accels(3000, 4, "morton", max_clusters=512, min_k=8)


@pytest.mark.parametrize("scheme", ["dirmajor"])
@pytest.mark.parametrize("dir_bits", [1, 2, 3])
def test_coherence_key_schemes_bit_exact(morton375, scheme, dir_bits):
    ja, ta = morton375
    o, d = _rays(3000, 9, park=100)
    ref = np.asarray(jpacket._coherence_key(ja, jnp.asarray(o),
                                            jnp.asarray(d), dir_bits,
                                            scheme=scheme))
    got = tpacket._coherence_key(ta, torch.from_numpy(o),
                                 torch.from_numpy(d), dir_bits).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    assert (got[-100:] == 0xFFFFFFFF).all()


def test_key_knobs_choose_scheme_and_bits(morton375, monkeypatch):
    """PT_DIR_BITS is read where the JAX package reads it (a call without
    dir_bits); PT_KEY_SCHEME and PT_KEY_SCHEME_OCCL are accepted at
    dirmajor, where the keys are the JAX package's, and refused at mixed
    and firstcluster, naming the knob."""
    ja, ta = morton375
    o, d = _rays(1000, 10)
    monkeypatch.setenv("PT_DIR_BITS", "3")
    monkeypatch.setenv("PT_KEY_SCHEME", "dirmajor")
    monkeypatch.setenv("PT_KEY_SCHEME_OCCL", "dirmajor")
    knobs.check_refused()
    ref = np.asarray(jpacket._coherence_key(ja, jnp.asarray(o),
                                            jnp.asarray(d)))
    got = tpacket._coherence_key(ta, torch.from_numpy(o),
                                 torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    assert not np.array_equal(got, tpacket._coherence_key(
        ta, torch.from_numpy(o), torch.from_numpy(d), 2).numpy())
    for name in ("PT_KEY_SCHEME", "PT_KEY_SCHEME_OCCL"):
        for scheme in ("mixed", "firstcluster"):
            monkeypatch.setenv(name, scheme)
            with pytest.raises(ValueError, match=f"{name}='{scheme}'"):
                knobs.check_refused()
        monkeypatch.setenv(name, "dirmajor")


def test_wavefront_order_bit_exact():
    """path._wavefront_order on the same scene in each package: dead lanes
    last, stable."""
    js = jproc.sponza_like(2000, textured=False).finalize()
    ts = tproc.sponza_like(2000, textured=False).finalize(device="cpu")
    lo, hi = ts.positions.amin(0).numpy(), ts.positions.amax(0).numpy()
    rng = np.random.default_rng(17)
    o = rng.uniform(lo, hi, (5000, 3)).astype(np.float32)
    d = rng.normal(size=(5000, 3)).astype(np.float32)
    o[:300] = o[0]                     # equal keys: stability decides
    d[:300] = d[0]
    active = rng.uniform(size=5000) < 0.7
    ref = np.asarray(jpath._wavefront_order(js, jnp.asarray(o),
                                            jnp.asarray(d),
                                            jnp.asarray(active)))
    got = tpath._wavefront_order(ts, torch.from_numpy(o),
                                 torch.from_numpy(d),
                                 torch.from_numpy(active))
    np.testing.assert_array_equal(got.numpy(), ref)
    n_live = int(active.sum())
    assert active[got.numpy()[:n_live]].all()
    m = tmorton.morton_codes(torch.from_numpy(o), lo=ts.positions.amin(0),
                             hi=ts.positions.amax(0))
    assert int(m.max()) < (1 << 30)
