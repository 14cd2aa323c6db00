"""The small public functions of pathtracer/ that pathtracer_torch carries
at the same module paths, each against the JAX package's:

- film.read_png (pathtracer_torch.film exports it, as pathtracer.film does);
- utils.native.hdr_decode (the port's copy of pt_hdr_decode) against
  scene/hdr.decode_scanlines, its plain version, and read_hdr against
  the JAX reader; utils.native.available;
- sampling.rng.ref_pcg / ref_pcg2d / ref_rand, the reference's scalar RNG
  oracles, on tests/test_rng.py's pinned values and a seeded sweep;
- accel.bruteforce.make_brute_intersectors on a triangle soup, and the
  brute route of render.make_intersectors going through it.
"""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_codecs as ic
from pathtracer.accel.bruteforce import make_brute_intersectors as jbrute
from pathtracer.film import read_png as jread_png
from pathtracer.sampling import rng as jrng
from pathtracer.scene import hdr as jhdr
from pathtracer.utils import native as jnative
from pathtracer_torch import film as tfilm_pkg
from pathtracer_torch.accel.bruteforce import make_brute_intersectors as tbrute
from pathtracer_torch.film import film as tfilm
from pathtracer_torch.sampling import rng as trng
from pathtracer_torch.scene import hdr as thdr
from pathtracer_torch.utils import image_plain
from pathtracer_torch.utils import native as tnative


def _read(name):
    with open(f"{ic.DATA_DIR}/{name}", "rb") as f:
        return f.read()


# --- read_png --------------------------------------------------------------

PNG_FIXTURES = sorted(n for n in os.listdir(ic.DATA_DIR)
                      if n.endswith(".png"))


def test_read_png_is_exported_like_jax():
    assert tfilm_pkg.read_png is tfilm.read_png
    assert "read_png" in tfilm_pkg.__all__


@pytest.mark.parametrize("kind", ["gray", "rgb"])
def test_read_png_reads_write_png_like_jax(tmp_path, kind):
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (9, 11) if kind == "gray" else (9, 11, 3))
    p = str(tmp_path / "a.png")
    tfilm.write_png(p, torch.from_numpy(img.astype(np.float32)))
    got, want = tfilm.read_png(p), jread_png(p)
    assert got.dtype == want.dtype == np.float32 and got.shape == img.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", PNG_FIXTURES)
def test_read_png_matches_jax(tmp_path, name):
    """Every committed PNG kind: the JAX read_png's native decode of an
    8-bit non-interlaced PNG, and its PIL fallback's raw array (palette
    indices, 0/1 of 1-bit gray, unclipped 16-bit gray, RGBA of 16-bit
    gray + alpha) for the rest; the port gives the same array."""
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(_read(name))
    got, want = tfilm.read_png(p), jread_png(p)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize("seed", range(2))
def test_read_png_matches_jax_on_random_pngs(tmp_path, seed):
    """20 PNGs a seed of random colour type, bit depth, size, palette,
    tRNS and interlace, through both read_png."""
    rng = np.random.default_rng(300 + seed)
    p = str(tmp_path / "r.png")
    for it in range(20):
        h, w = (int(x) for x in rng.integers(1, 20, 2))
        ct = int(rng.choice([0, 2, 3, 4, 6]))
        depth = int(rng.choice(image_plain.PNG_DEPTHS[ct]))
        top = (1 << depth) - 1
        kw = {}
        if ct == 3:
            npal = int(rng.integers(1, min(256, top + 1) + 1))
            samples = rng.integers(0, npal, (h, w))
            kw["palette"] = rng.integers(0, 256, (npal, 3))
            if rng.random() < 0.5:
                kw["trns"] = rng.integers(0, 256, npal).astype(np.uint8)
        else:
            c = ic.CHANNELS[ct]
            samples = rng.integers(0, top + 1, (h, w, c) if c > 1 else (h, w))
            if ct in (0, 2) and rng.random() < 0.3:
                kw["trns"] = tuple(int(x) for x in np.ravel(samples)[:c])
        with open(p, "wb") as f:
            f.write(ic.png_file(samples, ct, depth,
                                interlace=bool(rng.random() < 0.4), seed=it,
                                **kw))
        got, want = tfilm.read_png(p), jread_png(p)
        tag = f"type {ct} depth {depth} {w}x{h} {sorted(kw)}"
        assert got.shape == want.shape, tag
        np.testing.assert_array_equal(got, want.astype(np.float32),
                                      err_msg=tag)


def test_read_png_refuses_a_jpeg(tmp_path):
    p = str(tmp_path / "a.png")
    with open(p, "wb") as f:
        f.write(_read("base420.jpg"))
    with pytest.raises(ValueError, match=r"a\.png: not a PNG"):
        tfilm.read_png(p)


# --- hdr_decode ------------------------------------------------------------

def _rgbe_rows(rng, h, w):
    rgbe = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    rgbe[..., 3] = rng.integers(100, 160, (h, w))
    rgbe[0, :2, 3] = 0                      # e == 0: black
    return rgbe


def _hdr_cases():
    rng = np.random.default_rng(4)
    cases = {}
    for h, w in ((3, 8), (2, 300), (4, 5), (1, 1)):
        img = np.abs(rng.normal(0, 3, (h, w, 3))).astype(np.float32)
        img[0, 0] = 0.0
        buf = io.BytesIO()
        rgbe = thdr._encode_rgbe(img)
        if 8 <= w <= 0x7FFF:
            for y in range(h):
                buf.write(bytes([2, 2, w >> 8, w & 255]))
                for c in range(4):
                    plane = rgbe[y, :, c].tobytes()
                    for x in range(0, w, 128):
                        buf.write(bytes([len(plane[x:x + 128])])
                                  + plane[x:x + 128])
        else:
            buf.write(rgbe.tobytes())
        cases[f"written_{h}x{w}"] = (buf.getvalue(), w, h)
    w = 16
    runs = bytearray()
    for _ in range(2):                    # run records in every plane
        runs += bytes([2, 2, 0, w])
        for v in (200, 0, 7, 129):
            runs += bytes([128 + 10, v, 6]) + bytes(range(6))
    cases["rle_runs"] = (bytes(runs), w, 2)
    rows = _rgbe_rows(rng, 2, 5)
    flat = bytearray()
    for y in range(2):                    # old-style repeats, one shifted
        flat += rows[y, 0].tobytes() + bytes([1, 1, 1, 2])
        flat += rows[y, 1].tobytes() + bytes([1, 1, 1, 0])
        flat += bytes([1, 1, 1, 0])       # count 0 << 8: a no-op repeat
        flat += rows[y, 2].tobytes()
    cases["old_style_repeats"] = (bytes(flat), 5, 2)
    mixed = bytearray(cases["rle_runs"][0][:len(runs) // 2])
    mixed += _rgbe_rows(rng, 1, w).tobytes()     # a flat row after RLE
    cases["rle_then_flat"] = (bytes(mixed), w, 2)
    return cases


HDR_CASES = _hdr_cases()


@pytest.mark.parametrize("case", sorted(HDR_CASES))
def test_hdr_decode_matches_plain(case):
    data, w, h = HDR_CASES[case]
    got = tnative.hdr_decode(data, w, h)
    want = thdr.decode_scanlines(data, 0, w, h)
    assert got.dtype == np.float32 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)
    jgot = jnative.hdr_decode(data, w, h)     # the JAX package's library
    np.testing.assert_array_equal(got, jgot)


@pytest.mark.parametrize("bad", ["repeat_first", "repeat_past_end",
                                 "short_rle", "short_flat"])
def test_hdr_decode_rejects_what_the_plain_version_rejects(bad):
    w = 16
    data = {"repeat_first": bytes([1, 1, 1, 3]) + bytes(4 * w),
            "repeat_past_end": bytes([9, 9, 9, 130, 1, 1, 1, 40]),
            "short_rle": bytes([2, 2, 0, w, 128 + 16]),
            "short_flat": bytes(4 * w - 3)}[bad]
    width = 5 if bad == "repeat_past_end" else w
    with pytest.raises(ValueError, match="corrupt .hdr scanlines"):
        tnative.hdr_decode(data, width, 1)
    with pytest.raises((ValueError, IndexError)):
        thdr.decode_scanlines(data, 0, width, 1)


def test_read_hdr_matches_jax(tmp_path):
    img = np.abs(np.random.default_rng(8).normal(0, 2, (6, 40, 3)))
    p = str(tmp_path / "a.hdr")
    jhdr.write_hdr(p, img.astype(np.float32))
    np.testing.assert_array_equal(thdr.read_hdr(p), jhdr.read_hdr(p))
    with open(p, "rb") as f:
        data = f.read()
    with open(p, "wb") as f:
        f.write(data[:len(data) - 50])
    with pytest.raises(ValueError, match=r"a\.hdr: corrupt"):
        thdr.read_hdr(p)


def test_available_is_true_once_built():
    assert tnative.available() is True and jnative.available() is True
    assert "raises" in tnative.available.__doc__


# --- reference RNG oracles -------------------------------------------------

def test_ref_pcg_matches_jax_on_pinned_and_swept_states():
    states = [0, 1, 7, 12345, 0xFFFFFFFF, 0x80000000]
    states += np.random.default_rng(5).integers(0, 1 << 32, 2000).tolist()
    for s in states:
        got, want = trng.ref_pcg(np.uint32(s)), jrng.ref_pcg(np.uint32(s))
        assert all(type(g) is type(w) is np.uint32 for g, w in zip(got,
                                                                   want))
        assert tuple(map(int, got)) == tuple(map(int, want)), s


def test_ref_pcg2d_matches_jax_on_pinned_and_swept_pairs():
    pairs = [(0, 0), (1, 2), (640, 360), (123456789, 987654321),
             (0xFFFFFFFF, 0xFFFFFFFF)]
    pairs += np.random.default_rng(6).integers(0, 1 << 32,
                                               (1000, 2)).tolist()
    for v in pairs:
        got, want = trng.ref_pcg2d(v), jrng.ref_pcg2d(v)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want, err_msg=str(v))


@pytest.mark.parametrize("seed", [7, 0, 0xFFFFFFFF, 2891336453])
def test_ref_rand_matches_jax_along_a_stream(seed):
    ts, js = np.uint32(seed), np.uint32(seed)
    for _ in range(500):
        (tv, ts), (jv, js) = trng.ref_rand(ts), jrng.ref_rand(js)
        assert type(tv) is type(jv) is np.float32
        assert tv.tobytes() == jv.tobytes() and int(ts) == int(js)
        assert 0.0 <= tv <= 1.0


# --- brute-force intersectors ----------------------------------------------

def _soup(n, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    o = rng.uniform(-2, 2, (500, 3)).astype(np.float32)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (v0, v1, v2), o, d


@pytest.mark.parametrize("n_tris,seed", [(40, 1), (300, 2)])
def test_brute_intersectors_match_jax(n_tris, seed):
    """Hit triangles and occlusion exact, t/u/v within the tolerance of
    tests/test_torch_kernels.py's brute-force parity test."""
    v, o, d = _soup(n_tris, seed)
    ji, jo = jbrute(*(jnp.asarray(x) for x in v))
    ti, to = tbrute(*(torch.from_numpy(x) for x in v))
    jh = ji(jnp.asarray(o), jnp.asarray(d), 1e-3, 1e20)
    th = ti(torch.from_numpy(o), torch.from_numpy(d), 1e-3, 1e20)
    np.testing.assert_array_equal(th.tri.numpy(), np.asarray(jh.tri))
    hit = np.asarray(jh.tri) >= 0
    assert hit.sum() > n_tris // 8          # some rays hit
    np.testing.assert_allclose(th.t.numpy()[hit], np.asarray(jh.t)[hit],
                               rtol=1e-5, atol=1e-6)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(th, f).numpy()[hit],
                                   np.asarray(getattr(jh, f))[hit],
                                   rtol=1e-4, atol=1e-5)
    tm = np.full(len(o), 1.5, np.float32)
    jb = np.asarray(jo(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm)))
    tb = to(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm))
    np.testing.assert_array_equal(tb.numpy(), jb)
    blocked, blocker = to(torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(tm), want_blocker=True)
    np.testing.assert_array_equal(blocked.numpy(), jb)
    assert ((blocker.numpy() >= 0) == jb).all()


def test_render_brute_route_goes_through_bruteforce():
    from pathtracer_torch import render
    from pathtracer_torch.config import RenderConfig
    from pathtracer_torch.scene.procedural import cornell_box

    scene = cornell_box().finalize(device="cpu")
    fns = render.make_intersectors(scene, RenderConfig(intersector="brute"))
    assert [f.__qualname__.split(".")[0] for f in fns[:2]] == [
        "make_brute_intersectors"] * 2
