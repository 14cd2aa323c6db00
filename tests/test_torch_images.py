"""pathtracer_torch's image decoders (csrc/image_decode.cpp and their plain
numpy version, utils/image_plain.py) against PIL 12.1.0, and the scene
files that carry such images against the JAX package's loaders.

PIL's Image.open(...).convert("RGBA") / convert("RGB") is what the JAX
package hands every image its native PNG decoder declines, so it is the
reference, held bit for bit (no tolerance) by both decoders:

- the committed fixtures of tests/data/images (every PNG colour type, bit
  depth, Adam7 and tRNS; baseline and progressive JPEG at 4:4:4, 4:2:2,
  4:2:0, 4:4:0 and mixed factors, gray, Adobe RGB, restart intervals),
  whose committed PIL arrays are themselves held to PIL here;
- seeded sweeps of random sizes, qualities and variants;
- glTF/GLB, OBJ/MTL and env maps made of such files: the port's tables
  equal the JAX loaders' field for field.

Formats left out raise ValueError naming the file and the format.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

import image_codecs as ic
from pathtracer.app import load_envmap as jload_envmap
from pathtracer.scene.gltf import load_gltf as jload_gltf
from pathtracer.scene.objload import load_obj as jload_obj
from pathtracer_torch.app import load_envmap as tload_envmap
from pathtracer_torch.scene.gltf import load_gltf as tload_gltf
from pathtracer_torch.scene.objload import load_obj as tload_obj
from pathtracer_torch.utils import image_plain, native

FIXTURES = sorted(n for n in os.listdir(ic.DATA_DIR)
                  if n.endswith((".png", ".jpg")) and not n.startswith(
                      "bench"))
PNGS = [n for n in FIXTURES if n.endswith(".png")]
JPEGS = [n for n in FIXTURES if n.endswith(".jpg")]


@pytest.fixture(scope="module")
def fixtures():
    return ic.load_fixtures()


def _read(name):
    with open(os.path.join(ic.DATA_DIR, name), "rb") as f:
        return f.read()


def _pil(raw, mode):
    return np.asarray(Image.open(io.BytesIO(raw)).convert(mode))


def _decode(decoder, raw, mode):
    if decoder == "plain":
        return image_plain.decode(raw, mode)
    return native.image_decode(raw, "t", len(mode))


def test_committed_arrays_are_pils_decode(fixtures):
    """The committed arrays (the card's reference) are PIL's decode of the
    committed files, and the files are those fixture_set() makes."""
    files, ref = fixtures
    assert sorted(files) == FIXTURES
    assert set(ic.fixture_set()) == set(files)
    for name, raw in files.items():
        for mode, arr in zip(("RGBA", "RGB"), ref[name]):
            np.testing.assert_array_equal(arr, _pil(raw, mode),
                                          err_msg=name)


@pytest.mark.parametrize("decoder", ["plain", "native"])
@pytest.mark.parametrize("name", PNGS)
def test_png_fixture_matches_pil(fixtures, name, decoder):
    files, ref = fixtures
    for mode, want in zip(("RGBA", "RGB"), ref[name]):
        got = _decode(decoder, files[name], mode)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {mode}")


@pytest.mark.parametrize("decoder", ["plain", "native"])
@pytest.mark.parametrize("name", JPEGS)
def test_jpeg_fixture_matches_pil(fixtures, name, decoder):
    """Bit for bit: libjpeg's islow IDCT, fancy upsampling and YCbCr
    tables reproduced exactly, so no tolerance is needed."""
    files, ref = fixtures
    for mode, want in zip(("RGBA", "RGB"), ref[name]):
        got = _decode(decoder, files[name], mode)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {mode}")


@pytest.mark.parametrize("seed", range(4))
def test_random_pngs_match_pil(seed):
    """25 PNGs a seed: random colour type, depth, size (1-23 px a side),
    palette length, tRNS (a key in the image or not), Adam7 and filters;
    native and plain against PIL."""
    rng = np.random.default_rng(100 + seed)
    for it in range(25):
        h, w = (int(x) for x in rng.integers(1, 24, 2))
        ct = int(rng.choice([0, 2, 3, 4, 6]))
        depth = int(rng.choice(image_plain.PNG_DEPTHS[ct]))
        top = (1 << depth) - 1
        kw = {}
        if ct == 3:
            npal = int(rng.integers(1, min(256, top + 1) + 1))
            samples = rng.integers(0, top + 1, (h, w))
            kw["palette"] = rng.integers(0, 256, (npal, 3))
            if rng.random() < 0.5:
                kw["trns"] = rng.integers(0, 256, int(rng.integers(
                    1, npal + 1))).astype(np.uint8)
        else:
            c = ic.CHANNELS[ct]
            samples = rng.integers(0, top + 1, (h, w, c) if c > 1 else (h, w))
            if ct in (0, 2) and rng.random() < 0.5:
                key = (np.ravel(samples)[:c] if rng.random() < 0.7
                       else rng.integers(0, top + 1, c))
                kw["trns"] = tuple(int(x) for x in key)
        raw = ic.png_file(samples, ct, depth,
                          interlace=bool(rng.random() < 0.5), seed=it, **kw)
        for mode in ("RGBA", "RGB"):
            want = _pil(raw, mode)
            tag = f"type {ct} depth {depth} {w}x{h} {sorted(kw)} {mode}"
            np.testing.assert_array_equal(_decode("native", raw, mode), want,
                                          err_msg=tag)
            np.testing.assert_array_equal(_decode("plain", raw, mode), want,
                                          err_msg=tag)


@pytest.mark.parametrize("seed", range(4))
def test_random_jpegs_match_pil(seed):
    """PIL-made JPEGs of random size (1-69 px a side), quality, subsampling,
    progression, restart interval and optimized tables, gray and colour,
    noise and smooth; plus baseline files of random coefficients at
    4:4:0, 4:1:1, 3:1 and mixed factors. Native against PIL, and plain
    against PIL on the smaller ones (it runs a Python loop a symbol)."""
    rng = np.random.default_rng(200 + seed)
    for it in range(16):
        h, w = (int(x) for x in rng.integers(1, 70, 2))
        if it % 3 == 0:
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        else:
            y, x = np.mgrid[0:h, 0:w]
            img = 128 + 60 * np.sin(x[..., None] / 3.0 + y[..., None] / 5.0
                                    + np.arange(3))
            img = np.clip(img + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(
                np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img[..., 0] if it % 7 == 0 else img).save(
            buf, format="JPEG", quality=int(rng.integers(5, 101)),
            subsampling=int(rng.integers(0, 3)),
            progressive=bool(rng.random() < 0.5),
            restart_marker_blocks=int(rng.integers(0, 4)),
            optimize=bool(rng.random() < 0.5))
        raw = buf.getvalue()
        for mode in ("RGBA", "RGB"):
            want = _pil(raw, mode)
            np.testing.assert_array_equal(_decode("native", raw, mode), want,
                                          err_msg=f"{w}x{h} #{it}")
            if h * w < 800:
                np.testing.assert_array_equal(_decode("plain", raw, mode),
                                              want, err_msg=f"{w}x{h} #{it}")
    samplings = (((1, 2), (1, 1), (1, 1)), ((4, 1), (1, 1), (1, 1)),
                 ((3, 1), (1, 1), (1, 1)), ((2, 2), (1, 2), (2, 1)),
                 ((2, 2), (2, 1), (1, 1)))
    for k, sampling in enumerate(samplings):
        raw = ic.jpeg_file(
            ic.random_blocks(rng, sampling, int(rng.integers(1, 3)),
                             int(rng.integers(1, 3))),
            sampling, rng.integers(1, 20, (8, 8)),
            restart=int(rng.integers(0, 3)), adobe=(None, 1)[k % 2])
        for mode in ("RGBA", "RGB"):
            want = _pil(raw, mode)
            np.testing.assert_array_equal(_decode("native", raw, mode), want,
                                          err_msg=str(sampling))
            np.testing.assert_array_equal(_decode("plain", raw, mode), want,
                                          err_msg=str(sampling))


def _jpeg(mode="RGB", **save):
    buf = io.BytesIO()
    Image.new(mode, (16, 8), (10, 200, 30, 0)[:len(mode)]).save(
        buf, format="JPEG", **save)
    return buf.getvalue()


def _sof_patched(marker: int, precision: int = 8) -> bytes:
    """A baseline JPEG whose SOF0 is relabelled (another process) or its
    precision changed: the decoders refuse it at the frame header."""
    raw = bytearray(_jpeg())
    at = raw.index(b"\xff\xc0")
    raw[at + 1] = marker
    raw[at + 4] = precision
    return bytes(raw)


def _other(fmt):
    buf = io.BytesIO()
    Image.new("RGB", (8, 8), (1, 2, 3)).save(buf, format=fmt)
    return buf.getvalue()


REFUSED = {
    "cmyk": (lambda: _jpeg("CMYK"), "CMYK JPEG"),
    "arithmetic": (lambda: _sof_patched(0xC9), "arithmetic-coded JPEG"),
    "arith_progressive": (lambda: _sof_patched(0xCA),
                          "arithmetic-coded JPEG"),
    "12bit": (lambda: _sof_patched(0xC1, 12), "12-bit JPEG"),
    "lossless": (lambda: _sof_patched(0xC3), "lossless JPEG"),
    "hierarchical": (lambda: _sof_patched(0xC5), "hierarchical JPEG"),
    "bmp": (lambda: _other("BMP"), "BMP"),
    "webp": (lambda: _other("WEBP"), "WebP"),
    "gif": (lambda: _other("GIF"), "GIF"),
    "tga": (lambda: _other("TGA"), "not a PNG or JPEG"),
    "png_palette16": (lambda: ic.png_file(np.zeros((2, 2), int), 3, 16,
                                          palette=[[0, 0, 0]]),
                      "PNG of bit depth 16 and colour type 3"),
}


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_refused_formats_raise_naming_file_and_format(kind):
    make, name = REFUSED[kind]
    raw = make()
    with pytest.raises(ValueError, match=rf"^sky\.img: cannot decode an? "
                                         rf"{name}"):
        native.image_rgba(raw, "sky.img")
    with pytest.raises(ValueError):
        image_plain.decode(raw, "RGBA")


@pytest.mark.parametrize("name", ["rgb16_adam7.png", "pal2.png",
                                  "prog420.jpg", "base422_rst.jpg"])
def test_truncated_files_raise_corrupt(fixtures, name):
    """A file cut in half is an error in PIL and in both decoders."""
    files, _ = fixtures
    cut = files[name][:len(files[name]) // 2]
    with pytest.raises(OSError):
        _pil(cut, "RGBA")
    with pytest.raises(ValueError, match=rf"^{name}: corrupt or truncated "
                                         rf"(PNG|\w+ JPEG)"):
        native.image_rgba(cut, name)
    with pytest.raises((ValueError, OSError)):
        image_plain.decode(cut, "RGBA")


def test_image_info_reports_the_files_channels(fixtures):
    files, _ = fixtures
    want = {"gray8.png": 1, "graya16.png": 2, "rgb8_trns.png": 3,
            "rgba16_adam7.png": 4, "pal8.png": 4, "pal4_key.png": 4,
            "base_gray.jpg": 1, "prog420.jpg": 3}
    for name, ch in want.items():
        w, h, c = native.image_info(files[name], name)
        assert c == ch and (w, h) == Image.open(io.BytesIO(files[name])).size


# --- scene files carrying such images -------------------------------------

TEXTURES = ("prog420_rst.jpg", "base422.jpg", "rgb16.png", "graya16_adam7.png",
            "gray2_trns.png", "pal4_adam7.png", "base440_rst.jpg",
            "base_gray.jpg")


def _assert_same_tables(jbuilder, tbuilder):
    from tests.test_torch_loaders import assert_same_tables

    return assert_same_tables(jbuilder, tbuilder)


@pytest.mark.parametrize("kind", ["gltf", "glb"])
def test_gltf_textures_match_jax(tmp_path, kind):
    """A glTF/GLB whose images are JPEG (progressive 4:2:0 with restarts,
    4:2:2, 4:4:0, gray) and 16-bit, Adam7, tRNS-keyed and 4-bit PNG, in
    buffer views, a data URI and external files: the port's tables equal
    the JAX loader's (PIL) bit for bit."""
    from tests.test_torch_loaders import _textured

    raws = [_read(n) for n in TEXTURES]
    for n, raw in zip(TEXTURES, raws):
        (tmp_path / n).write_bytes(raw)

    def images(a):
        out = []
        for i, (n, raw) in enumerate(zip(TEXTURES, raws)):
            mime = "image/jpeg" if n.endswith(".jpg") else "image/png"
            if i % 3 == 0:
                out.append({"uri": n})
            elif i % 3 == 1:
                out.append({"bufferView": a.view(raw), "mimeType": mime})
            else:
                import base64
                out.append({"uri": f"data:{mime};base64,"
                            + base64.b64encode(raw).decode()})
        return out

    slots = [(0, 3, 5), (6, 9, None), (12, None, 14), (None, 8, 10),
             (2, 4, 1)]
    path = _textured(tmp_path, kind, images, slots)
    tf = _assert_same_tables(jload_gltf(path), tload_gltf(path))
    assert tf["textures"].shape[0] == len(TEXTURES) and tf["has_textures"]


def test_glb_with_replaced_images_matches_jax(tmp_path, fixtures):
    """The port's exporter's .glb of a textured procedural scene with its
    images replaced by JPEG and 16-bit PNG bytes (as chip_smoke.py's images
    phase builds it): equal tables in both packages, and equal to the
    scene built from the committed PIL arrays directly."""
    files, ref = fixtures
    path = str(tmp_path / "img.glb")
    ic.write_textured_glb(path, files, tris=2000)
    tb = tload_gltf(path)
    tf = _assert_same_tables(jload_gltf(path), tb)
    assert tf["textures"].shape[0] == len(ic.IMAGE_TEXTURES)
    with ic.decoded_by_pil(files, ref):
        direct = tload_gltf(path).finalize_numpy()
    for k, v in direct.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(tf[k], v, err_msg=k)
        else:
            assert tf[k] == v, k


@pytest.mark.parametrize("name", ["prog420.jpg", "base_gray.jpg", "rgb16.png",
                                  "gray4_adam7.png", "pal2.png"])
def test_obj_map_kd_matches_jax(tmp_path, name):
    """map_Kd in each format: the port's native decode against PIL's
    convert("RGBA") in the JAX loader."""
    from tests.test_torch_loaders import MTL_TEXTURED, OBJ_TEXTURED, _write

    (tmp_path / name).write_bytes(_read(name))
    _write(tmp_path / "tex.mtl", MTL_TEXTURED.format(tex=name))
    p = _write(tmp_path / "m.obj", OBJ_TEXTURED)
    tf = _assert_same_tables(jload_obj(p), tload_obj(p))
    assert tf["has_textures"]


@pytest.mark.parametrize("name", ["prog420.jpg", "base444_rst.jpg",
                                  "adobe_rgb.jpg", "rgb16.png",
                                  "rgba8_adam7.png", "pal4.png",
                                  "rgb8_trns.png"])
def test_envmap_matches_jax(tmp_path, name):
    """LDR env maps in each format: (u8 / 255) ** 2.2 of PIL's
    convert("RGB"), bit for bit the JAX loader's."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(_read(name))
    j, t = jload_envmap(path), tload_envmap(path)
    assert t.dtype == j.dtype == np.float32 and t.shape == j.shape
    np.testing.assert_array_equal(t, j)


# --- malformed JPEG: refused as libjpeg refuses it, never written past ------

def _segment(raw: bytes, marker: int):
    at = raw.index(bytes([0xFF, marker]))
    n = int.from_bytes(raw[at + 2:at + 4], "big")
    return at, raw[at:at + 2 + n]


def _two_frames(where: str) -> bytes:
    """A 16x8 baseline JPEG with the frame header of a 64x48 one added,
    after its own (`header`) or after its scan (`scan`)."""
    small = _jpeg()
    buf = io.BytesIO()
    Image.new("RGB", (64, 48), (1, 2, 3)).save(buf, format="JPEG")
    _, big_sof = _segment(buf.getvalue(), 0xC0)
    if where == "scan":
        return small[:-2] + big_sof + small[-2:]
    at, sof = _segment(small, 0xC0)
    return small[:at + len(sof)] + big_sof + small[at + len(sof):]


def _dht_patched(kind: str) -> bytes:
    """A baseline JPEG whose first DC table is made invalid: a magnitude
    of 16 (`dc_symbol`; jdhuff.c allows 0-15) or two codes of length 1,
    the second the all-ones code (`oversubscribed`)."""
    raw = bytearray(_jpeg())
    at, _ = _segment(bytes(raw), 0xC4)
    assert raw[at + 4] >> 4 == 0              # class 0: a DC table
    if kind == "dc_symbol":
        raw[at + 4 + 17] = 16
    else:
        raw[at + 4 + 1] = 2
    return bytes(raw)


MALFORMED = {
    "second_frame_in_header": lambda: _two_frames("header"),
    "second_frame_after_scan": lambda: _two_frames("scan"),
    "dc_symbol_16": lambda: _dht_patched("dc_symbol"),
    "oversubscribed_huffman": lambda: _dht_patched("oversubscribed"),
}


@pytest.mark.parametrize("kind", sorted(MALFORMED))
def test_malformed_jpeg_raises_like_pil(kind):
    """A second frame header (whose size would overrun the buffer made for
    the first), a DC magnitude above 15 and an oversubscribed Huffman
    table: PIL (libjpeg) raises, and so do both decoders."""
    raw = MALFORMED[kind]()
    with pytest.raises(OSError):
        _pil(raw, "RGBA")
    with pytest.raises(ValueError, match=r"^bad\.jpg: corrupt or truncated "
                                         r"baseline JPEG of 3 components"):
        native.image_rgba(raw, "bad.jpg")
    with pytest.raises(ValueError):
        image_plain.decode(raw, "RGBA")


@pytest.mark.parametrize("delta", [(1, 0), (0, 1), (-1, 0), (0, -3)])
def test_native_decode_refuses_a_size_other_than_the_files(fixtures, delta):
    """pti_decode writes only the probe's width x height: told another
    size, it returns corrupt (2) and leaves the buffer as it was."""
    import ctypes

    files, _ = fixtures
    lib = native._load("images")
    for name in ("prog420.jpg", "rgb16_adam7.png"):
        raw = files[name]
        w, h, _ = native.image_info(raw, name)
        w2, h2 = w + delta[0], h + delta[1]
        out = np.full((h2 * w2 * 4 + 64,), 7, np.uint8)
        buf = np.frombuffer(raw, np.uint8)
        rc = lib.pti_decode(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size, w2,
            h2, 4, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), None,
            0)
        assert rc == 2, name
        assert (out == 7).all(), name


@pytest.mark.parametrize("step", [300, 2047])
def test_out_of_range_dc_saturates_and_wraps_like_libjpeg(step):
    """A gray JPEG whose DC climbs by `step` a block (quant 1). At 300 the
    samples run far past 255 and saturate, as PIL's (SIMD) IDCT packs
    them: equal to PIL. At 2047 the DC runs past the 16 bits of libjpeg's
    JCOEF and the stores wrap (block 16 holds 32752, block 17 wraps to
    -30737), in both decoders alike; PIL's SIMD IDCT also multiplies in
    16 bits there, so it is not the reference for that file."""
    blocks = np.zeros((1, 24, 8, 8), int)
    blocks[0, :, 0, 0] = step * np.arange(24)
    raw = ic.jpeg_file([blocks], [(1, 1)], np.ones((8, 8), int))
    got = native.image_rgba(raw, "w")
    np.testing.assert_array_equal(image_plain.decode(raw, "RGBA"), got)
    if step == 300:
        np.testing.assert_array_equal(got, _pil(raw, "RGBA"))
        assert (got[:, 8 * 4:, :3] == 255).all()
    else:
        assert (got[:, 8 * 16:8 * 17, :3] == 255).all()
        assert (got[:, 8 * 17:8 * 18, :3] == 0).all()
