"""The env-map slice of pathtracer_torch against the JAX package.

Inputs are seeded numpy, fed to the JAX function and to its port: the
RGBE codec (bytes and arrays exact), the env distribution and the scene's
env tables (exact), bunny_like (exact), sample_env (indices exact,
directions to 1e-6), env_pdf (texel indices agree except where theta/phi
sit within an ulp of a texel edge, where arccos/atan2 may round apart),
envmap_radiance (rtol 1e-5, atol 1e-6; the two port variants bit-equal
outside the top half-texel row, as the JAX package's)
and the cell-interleaved env-NEE table (bit-identical to per-lane draws).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer.integrator import sky as jsky
from pathtracer.scene import envlight as jenv
from pathtracer.scene import hdr as jhdr
from pathtracer.scene import procedural as jproc
from pathtracer.scene.build import SceneBuilder as JBuilder
from pathtracer_torch.config import RenderConfig
from pathtracer_torch.integrator import path as tpath
from pathtracer_torch.integrator import sky as tsky
from pathtracer_torch.sampling import rng as trng
from pathtracer_torch.scene import envlight as tenv
from pathtracer_torch.scene import hdr as thdr
from pathtracer_torch.scene import procedural as tproc
from pathtracer_torch.scene.build import SceneBuilder as TBuilder
from pathtracer_torch.scene.types import (META_FIELDS, OPTIONAL_FIELDS,
                                          TENSOR_FIELDS)
from tests.test_torch_shading import assert_parity


def _radiance(h, w, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    img[::3] *= 50.0
    img[1::3] *= 0.01
    img[0, 0] = 0.0
    return img


def _env(h=16, w=32, seed=2, hot=400.0):
    env = np.abs(np.random.default_rng(seed).normal(
        size=(h, w, 3))).astype(np.float32)
    if hot:
        env[h // 4, w // 5] = hot            # hot spot: importance matters
    return env


def _uniforms(n, seed):
    u = np.random.default_rng(seed).uniform(size=(4, n)).astype(np.float32)
    u[:, :4] = [[0.0, 1 - 2 ** -24, 0.5, 0.25]] * 4
    return u


# --- RGBE codec -----------------------------------------------------------

@pytest.mark.parametrize("h,w", [(24, 64), (5, 4), (3, 300)])
def test_hdr_codec_matches_jax(tmp_path, h, w):
    """RLE (w >= 8, with a chunk break past 128) and flat (w < 8) maps:
    the port writes the JAX writer's bytes and reads the same arrays."""
    img = _radiance(h, w, seed=h)
    pj, pt = str(tmp_path / "j.hdr"), str(tmp_path / "t.hdr")
    jhdr.write_hdr(pj, img)
    thdr.write_hdr(pt, img)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    np.testing.assert_array_equal(thdr.read_hdr(pj), jhdr.read_hdr(pj))


def test_hdr_run_records_and_rejects(tmp_path):
    w, h = 16, 2
    p = str(tmp_path / "run.hdr")
    with open(p, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        for _ in range(h):
            f.write(bytes([2, 2, 0, w]))
            for v in (200, 0, 0, 129):
                f.write(bytes([128 + w, v]))   # run records
    np.testing.assert_array_equal(thdr.read_hdr(p), jhdr.read_hdr(p))
    bad = str(tmp_path / "bad.hdr")
    with open(bad, "wb") as f:
        f.write(b"not an hdr file")
    with pytest.raises(ValueError):
        thdr.read_hdr(bad)


# --- distribution and scene tables ---------------------------------------

def test_build_env_distribution_exact():
    env = _env()
    for a, b in zip(tenv.build_env_distribution(env),
                    jenv.build_env_distribution(env)):
        np.testing.assert_array_equal(a, b)


def test_env_tables_match_jax_scene():
    env = _env(8, 16)
    jb, tb = JBuilder(), TBuilder()
    for b in (jb, tb):
        b.add_mesh(np.float32([[0, 0, 0], [1, 0, 0], [0, 1, 0]]),
                   np.int64([[0, 1, 2]]), 0)
        b.set_envmap(env)
    js, ts = jb.finalize(), tb.finalize(device="cpu")
    assert ts.has_envmap and js.has_envmap
    for f in ("envmap", "envmap_blocks", "env_marginal_cdf",
              "env_cond_cdf", "env_pdf"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


def test_bunny_like_tables_exact():
    js = jproc.bunny_like(subdivisions=5).finalize()
    ts = tproc.bunny_like(subdivisions=5).finalize(device="cpu")
    for f in TENSOR_FIELDS + OPTIONAL_FIELDS:
        a, b = getattr(js, f), getattr(ts, f)
        if a is None:
            assert b is None, f
            continue
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)
    for f in META_FIELDS:
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.n_tris == 20_484


# --- sampling and lookups -------------------------------------------------

def test_sample_env_matches_jax():
    env = _env()
    mc, cc, _ = jenv.build_env_distribution(env)
    u = _uniforms(20_000, 5)
    jd, jr, jc = jenv.sample_env(jnp.asarray(mc), jnp.asarray(cc),
                                 *(jnp.asarray(x) for x in u))
    td, tr, tc = tenv.sample_env(torch.from_numpy(mc), torch.from_numpy(cc),
                                 *(torch.from_numpy(x) for x in u))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # float64 directions of the same texels and jitter
    h, w = cc.shape
    theta = (tr.numpy() + u[2].astype(np.float64)) / h * np.pi
    phi = ((tc.numpy() + u[3].astype(np.float64)) / w - 0.5) * 2.0 * np.pi
    exact = np.stack([np.sin(theta) * np.cos(phi), np.cos(theta),
                      np.sin(theta) * np.sin(phi)], axis=-1)
    assert_parity("sample_env", td.numpy(), np.asarray(jd), exact,
                  rtol=1e-6, atol=1e-6)
    # the hot spot draws most samples
    assert ((tr.numpy() == 4) & (tc.numpy() == 6)).mean() > 0.3


@pytest.mark.parametrize("w", [1, 7, 64, 1024])
def test_row_searchsorted_matches_numpy(w):
    rng = np.random.default_rng(w)
    cdf = np.sort(rng.uniform(size=(17, w)).astype(np.float32), axis=1)
    cdf[:, -1] = 1.0
    cdf[3, :] = 1.0                           # degenerate all-ones row
    r = rng.integers(0, 17, size=600)
    u = rng.uniform(size=600).astype(np.float32)
    u[:6] = [0.0, 1.0, 0.5, cdf[0, 0], cdf[5, w // 2],
             np.nextafter(np.float32(1.0), np.float32(0.0))]
    r[4] = 5
    got = tenv._row_searchsorted(torch.from_numpy(cdf), torch.from_numpy(r),
                                 torch.from_numpy(u)).numpy()
    want = [np.searchsorted(cdf[ri], ui, side="left") for ri, ui in zip(r, u)]
    np.testing.assert_array_equal(got, want)


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:3] = [[0, 1, 0], [0, -1, 0], [-1, 0, 0]]   # poles, the phi seam
    return d


def test_env_pdf_matches_jax():
    env = _env()
    _, _, pdf = jenv.build_env_distribution(env)
    h, w = pdf.shape
    d = _dirs(50_000, 6)
    jd = jnp.asarray(d)
    # the JAX package's texel of d (envlight.py:112-115)
    theta = jnp.arccos(jnp.clip(jd[:, 1], -1.0, 1.0))
    phi = jnp.arctan2(jd[:, 2], jd[:, 0])
    jr = np.asarray(jnp.clip((theta / np.pi * h).astype(jnp.int32), 0, h - 1))
    jc = np.asarray(jnp.clip(((phi / (2.0 * np.pi) + 0.5) * w)
                             .astype(jnp.int32), 0, w - 1))
    tr, tc = (x.numpy() for x in tenv.env_texel(h, w, torch.from_numpy(d)))
    same = (tr == jr) & (tc == jc)
    assert same.mean() >= 0.999
    got = tenv.env_pdf(torch.from_numpy(pdf), torch.from_numpy(d)).numpy()
    ref = np.asarray(jenv.env_pdf(jnp.asarray(pdf), jd))
    np.testing.assert_array_equal(got[same], ref[same])


def test_envmap_radiance_matches_jax():
    jb, tb = JBuilder(), TBuilder()
    # no hot spot here: an ulp of atan2 / arccos moves the bilinear
    # weights, and the tolerance holds for a map of moderate gradients
    env = _env(9, 20, hot=None)
    for b in (jb, tb):
        b.add_mesh(np.float32([[0, 0, 0], [1, 0, 0], [0, 1, 0]]),
                   np.int64([[0, 1, 2]]), 0)
        b.set_envmap(env)
    js, ts = jb.finalize(), tb.finalize(device="cpu")
    d = _dirs(20_000, 7)
    ref = np.asarray(jsky.envmap_radiance(js.envmap, jnp.asarray(d)))
    ref_b = np.asarray(jsky.envmap_radiance(js.envmap, jnp.asarray(d),
                                            blocks=js.envmap_blocks))
    got = tsky.envmap_radiance(ts.envmap, torch.from_numpy(d)).numpy()
    got_b = tsky.envmap_radiance(ts.envmap, torch.from_numpy(d),
                                 blocks=ts.envmap_blocks).numpy()
    # The variants are bit-equal except in the top half-texel row (v < 0,
    # within pi / (2 H) of the +y pole): there the four taps clip both
    # rows to row 0 while the 2x2 blocks blend in row 1. The JAX package
    # does the same (its sky lookup uses the blocks, env NEE the taps);
    # the port keeps that for parity.
    top = np.arccos(np.clip(d[:, 1], -1, 1)) / np.pi * 9 - 0.5 < 0.0
    np.testing.assert_array_equal(got_b[~top], got[~top])
    assert top.any()
    for g, r in ((got, ref), (got_b, ref_b)):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)


def test_cell_dedup_table_bit_exact():
    """_env_draw's per-(cell, sample) table equals per-lane draws keyed on
    the cell id (path.py:349-393): the same computation, deduplicated."""
    tb = TBuilder()
    tb.add_mesh(np.float32([[0, 0, 0], [1, 0, 0], [0, 1, 0]]),
                np.int64([[0, 1, 2]]), 0)
    tb.set_envmap(_env(8, 16))
    scene = tb.finalize(device="cpu")
    w = h = 20                       # not a multiple of the cell: ragged
    cfg = RenderConfig(width=w, height=h, sky="envmap",
                       env_importance_sampling=True)
    s_win, depth = 3, 1
    pix = torch.arange(w * h).repeat(s_win)
    samp = torch.arange(s_win).repeat_interleave(w * h) + 7
    l_dir, p_env, le = tpath._env_draw(scene, cfg, pix, samp, depth, s_win)
    cells_x = -(-w // 8)
    cid = (pix // w) // 8 * cells_x + (pix % w) // 8
    u = trng.uniform4(cid, samp, depth, trng.SALT_ENV_SELECT)
    l_ref, _, _ = tenv.sample_env(scene.env_marginal_cdf, scene.env_cond_cdf,
                                  u[:, 0], u[:, 1], u[:, 2], u[:, 3])
    assert torch.equal(l_dir, l_ref)
    assert torch.equal(p_env, tenv.env_pdf(scene.env_pdf, l_ref))
    assert torch.equal(le, tsky.envmap_radiance(scene.envmap, l_ref))
