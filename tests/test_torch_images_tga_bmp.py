"""TGA and BMP through pathtracer_torch's decoders (csrc/image_decode.cpp and
their plain numpy version, utils/image_plain.py) against PIL 12.1.0, and
OBJ/MTL textures and env maps of such files against the JAX package's
loaders (which hand both formats to PIL).

PIL's Image.open(...).convert("RGBA") / convert("RGB") is the reference,
held bit for bit (no tolerance) by both decoders:

- the committed fixtures of tests/data/images (tests/image_codecs.py
  tga_bmp_set: PIL's own TGA and BMP of every mode it writes, raw and
  RLE, both row orders; and, written by hand, 15/16-bit TGA with its
  alpha bit, 16-bit colour maps, colour maps on gray and gray + alpha
  images and from an offset, right-to-left rows, an ID field, core and
  V2-V5 BMP headers, 1/4-bit colour palettes, RLE8/RLE4 with absolute
  runs and deltas, 5-5-5, 5-6-5 and 32-bit bitfields, top-down rows),
  whose committed PIL arrays are themselves held to PIL here;
- seeded sweeps of random sizes and variants;
- what PIL refuses (or cannot load) raises a ValueError naming the file
  and the format.

    python -m pytest tests/test_torch_images_tga_bmp.py -q -p no:randomly
"""

import io
import os
import struct
import subprocess
import sys
import tracemalloc

import numpy as np
import pytest
from PIL import Image

import image_codecs as ic
from pathtracer.app import load_envmap as jload_envmap
from pathtracer.scene.objload import load_obj as jload_obj
from pathtracer_torch.app import load_envmap as tload_envmap
from pathtracer_torch.scene.objload import load_obj as tload_obj
from pathtracer_torch.utils import image_plain, native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARRAYS = "tga_bmp.npz"
FIXTURES = sorted(n for n in os.listdir(ic.DATA_DIR)
                  if n.endswith((".tga", ".bmp")))


@pytest.fixture(scope="module")
def fixtures():
    return ic.load_fixtures(ARRAYS)


def _pil(raw, mode):
    return np.asarray(Image.open(io.BytesIO(raw)).convert(mode))


def _decode(decoder, raw, mode):
    if decoder == "plain":
        return image_plain.decode(raw, mode)
    return native.image_decode(raw, "t", len(mode))


def test_committed_arrays_are_pils_decode(fixtures):
    """The committed arrays (the card's reference) are PIL's decode of the
    committed files, and the files are those tga_bmp_set() makes."""
    files, ref = fixtures
    assert sorted(files) == FIXTURES
    made = ic.tga_bmp_set()
    assert set(made) == set(files)
    for name, raw in files.items():
        assert made[name] == raw, name
        for mode, arr in zip(("RGBA", "RGB"), ref[name]):
            np.testing.assert_array_equal(arr, _pil(raw, mode),
                                          err_msg=name)


@pytest.mark.parametrize("decoder", ["plain", "native"])
@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_matches_pil(fixtures, name, decoder):
    files, ref = fixtures
    for mode, want in zip(("RGBA", "RGB"), ref[name]):
        got = _decode(decoder, files[name], mode)
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {mode}")


def _random_tga(rng):
    """A TGA of a random valid variant: image type, depth, colour map
    (16/24-bit, from an offset), flags, ID field, RLE packets."""
    h, w = int(rng.integers(1, 12)), int(rng.integers(1, 20))
    kind = rng.choice(["rgb24", "rgba32", "a16", "gray", "gray_a", "bits1",
                       "map", "gray_map", "gray_a_map"])
    depth, itype, cmap, cdepth, start = {
        "rgb24": (24, 2, None, 24, 0), "rgba32": (32, 2, None, 24, 0),
        "a16": (16, 2, None, 24, 0), "gray": (8, 3, None, 24, 0),
        "gray_a": (16, 3, None, 24, 0), "bits1": (1, 3, None, 24, 0),
        "map": (8, 1, True, 0, 0), "gray_map": (8, 3, True, 0, 0),
        "gray_a_map": (16, 3, True, 0, 0)}[kind]
    if cmap:
        cdepth = int(rng.choice([16, 24]))
        start = int(rng.integers(0, 40))
        n = int(rng.integers(1, 256 - start + 1))
        cmap = rng.integers(0, 256, (n, cdepth // 8))
    else:
        cmap = None
    nb = (w + 7) // 8 if depth == 1 else w * (depth // 8)
    levels = int(rng.choice([2, 256]))
    rows = ic._blocky(rng, h, nb, 1, levels, int(rng.integers(1, 5)))[..., 0]
    if depth == 8 and cmap is not None and rng.random() < 0.5:
        rows = rows % (start + len(cmap) + 3)
    rle = depth > 1 and rng.random() < 0.5
    return ic.tga_file(rows, itype + (8 if rle else 0), depth, cmap=cmap,
                       cmap_depth=cdepth, cmap_start=start,
                       flags=int(rng.choice([0, 0x10, 0x20, 0x30])),
                       id_bytes=bytes(int(rng.integers(0, 3))),
                       seed=int(rng.integers(1 << 30)))


def _random_bmp(rng):
    """A BMP of a random valid variant: header, bit depth, palette (size,
    gray ramps), compression (RLE8/RLE4, bitfields), row order."""
    h, w = int(rng.integers(1, 9)), int(rng.integers(1, 24))
    bits = int(rng.choice([1, 4, 8, 16, 24, 32]))
    header = int(rng.choice([12, 40, 52, 56, 64, 108, 124]))
    comp, masks, palette, colors = 0, None, None, 0
    if bits <= 8:
        n = int(rng.integers(1, (1 << bits) + 1))
        palette = rng.integers(0, 256, (n, 3))
        if rng.random() < 0.3:              # gray ramps: PIL's "L" / "1"
            ramp = [0, 255] if n == 2 else list(range(n))
            palette = np.repeat(np.array(ramp)[:, None], 3, 1)
        colors = 0 if n == 1 << bits and rng.random() < 0.5 else n
        if header != 12 and rng.random() < 0.5 and bits in (4, 8):
            comp = 1 if bits == 8 else 2
    elif header != 12 and rng.random() < 0.5:
        comp = 3
        masks = {16: [(0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)],
                 24: [(0xFF0000, 0xFF00, 0xFF)],
                 32: [(0xFF0000, 0xFF00, 0xFF, 0),
                      (0xFF000000, 0xFF0000, 0xFF00, 0),
                      (0xFF000000, 0xFF00, 0xFF, 0),
                      (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                      (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                      (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                      (0xFF000000, 0xFF00, 0xFF, 0xFF0000),
                      (0, 0, 0, 0)]}[bits]
        masks = masks[int(rng.integers(len(masks)))]
        if bits == 32 and header < 56 and masks[3]:
            masks = masks[:3] + (0,)
            if masks not in ((0xFF0000, 0xFF00, 0xFF, 0),
                             (0xFF000000, 0xFF0000, 0xFF00, 0),
                             (0xFF000000, 0xFF00, 0xFF, 0)):
                masks = (0xFF0000, 0xFF00, 0xFF, 0)
    top = header != 12 and rng.random() < 0.3
    if comp in (1, 2):
        data = ic._blocky(rng, h, w, 1, len(palette),
                          int(rng.integers(1, 5)))[..., 0]
    else:
        data = rng.integers(0, 256, (h, (w * bits + 7) // 8))
    return ic.bmp_file(data, w, h, bits, header=header, comp=comp,
                       palette=palette, masks=masks, top_down=top,
                       colors=colors, seed=int(rng.integers(1 << 30)))


@pytest.mark.parametrize("fmt", ["tga", "bmp"])
@pytest.mark.parametrize("seed", range(3))
def test_random_files_match_pil(fmt, seed):
    """40 random variants a seed: both decoders give PIL's arrays, or
    raise where PIL does (a BMP whose gray-ramp palette makes PIL read
    wider pixels than its rows hold, or an RLE BMP of a black-and-white
    palette); most decode."""
    rng = np.random.default_rng(100 * seed + (fmt == "bmp"))
    make = _random_tga if fmt == "tga" else _random_bmp
    decoded = 0
    for i in range(40):
        raw = make(rng)
        for mode in ("RGBA", "RGB"):
            try:
                want = _pil(raw, mode)
            except (OSError, ValueError):
                want = None
            for decoder in ("plain", "native"):
                if want is None:
                    with pytest.raises(ValueError):
                        _decode(decoder, raw, mode)
                    continue
                np.testing.assert_array_equal(
                    _decode(decoder, raw, mode), want,
                    err_msg=f"{fmt} {i} {mode} {decoder}: {raw[:40].hex()}")
            decoded += want is not None
    assert decoded >= 60


def _tga_head(img_type, depth, w, h, cmap_type=0, clen=0, cdepth=0):
    return struct.pack("<BBBHHBHHHHBB", 0, cmap_type, img_type, 0, clen,
                       cdepth, 0, 0, w, h, depth, 0)


def _pil_tga(mode, **kw):
    buf = io.BytesIO()
    Image.new(mode, (5, 3)).save(buf, format="TGA", **kw)
    return buf.getvalue()


Z = np.zeros
# variants PIL refuses or cannot load: (bytes, the name in the error)
REFUSED = {
    "tga_cmap32": (lambda: ic.tga_file(Z((2, 3), np.uint8), 1, 8,
                                       cmap=Z((2, 4), np.uint8),
                                       cmap_depth=32),
                   "8-bit colour-mapped TGA with a 32-bit colour map"),
    "tga_map_without_cmap": (lambda: _tga_head(1, 8, 2, 1) + bytes(2),
                             "8-bit colour-mapped TGA without a colour "
                             "map"),
    "tga_rgb_with_cmap": (lambda: ic.tga_file(Z((1, 6), np.uint8), 2, 24,
                                              cmap=Z((2, 3), np.uint8)),
                          "24-bit true-colour TGA with a colour map"),
    "tga_1bit_with_cmap": (lambda: ic.tga_file(Z((1, 1), np.uint8), 3, 1,
                                               cmap=Z((2, 3), np.uint8)),
                           "1-bit gray TGA with a colour map"),
    "tga_gray24": (lambda: _tga_head(3, 24, 2, 1) + bytes(6),
                   "24-bit gray TGA"),
    "tga_cmap300": (lambda: ic.tga_file(Z((1, 2), np.uint8), 1, 8,
                                        cmap=Z((300, 3), np.uint8)),
                    "8-bit colour-mapped TGA with a colour map of 300 "
                    "entries"),
    "bmp_2bit": (lambda: ic.bmp_file(Z((1, 4), np.uint8), 2, 1, 2),
                 "2-bit BMP"),
    "bmp_jpeg": (lambda: ic.bmp_file(Z((1, 6), np.uint8), 2, 1, 24, comp=4),
                 "BMP with compression 4"),
    "bmp_444": (lambda: ic.bmp_file(Z((1, 4), np.uint8), 2, 1, 16, comp=3,
                                    masks=(0xF00, 0xF0, 0xF)),
                "16-bit BITFIELDS BMP with masks"),
    "bmp_8bit_bitfields": (lambda: ic.bmp_file(
        Z((1, 2), np.uint8), 2, 1, 8, comp=3, masks=(1, 2, 4),
        palette=Z((2, 3), np.uint8)), "8-bit BITFIELDS BMP"),
    "bmp_rle8_24bit": (lambda: ic.bmp_file(Z((1, 2), np.uint8), 2, 1, 24,
                                           comp=1), "24-bit RLE8 BMP"),
    "bmp_header20": (lambda: b"BM" + struct.pack("<IHHII", 40, 0, 0, 34, 20)
                     + bytes(22), "BMP with a 20-byte header"),
}


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_refused_variants_raise_naming_file_and_format(kind):
    make, name = REFUSED[kind]
    raw = make()
    with pytest.raises(Exception):
        _pil(raw, "RGBA")
    with pytest.raises(ValueError, match=rf"^tex\.img: cannot decode an? "
                                         rf"{name}"):
        native.image_rgba(raw, "tex.img")
    with pytest.raises(image_plain.Refused) as err:
        image_plain.decode(raw, "RGBA")
    assert err.value.kind == "format"


def _cut(name, frac=0.6):
    def make():
        with open(os.path.join(ic.DATA_DIR, name), "rb") as f:
            raw = f.read()
        return raw[:int(len(raw) * frac)]
    return make


# broken data: (bytes, the format named in the error)
CORRUPT = {
    "tga_raw_cut": (_cut("rgba.tga"), "32-bit true-colour TGA"),
    "tga_rle_cut": (_cut("rgb_rle.tga"), "24-bit true-colour RLE TGA"),
    "tga_run_past_row": (lambda: _tga_head(11, 8, 3, 2) + bytes([0x85, 9]),
                         "8-bit gray RLE TGA"),
    "tga_1bit_rle": (lambda: _pil_tga("1", rle=True), "1-bit gray RLE TGA"),
    "bmp_raw_cut": (_cut("rgb24.bmp"), "24-bit BMP"),
    "bmp_rle_cut": (_cut("rle8.bmp", 0.8), "8-bit RLE8 BMP"),
    "bmp_rle_short": (lambda: ic.bmp_file(Z((1, 2), np.uint8), 4, 2, 8,
                                          comp=1, palette=Z((3, 3))),
                      "8-bit RLE8 BMP"),
}


@pytest.mark.parametrize("kind", sorted(CORRUPT))
def test_broken_files_raise_corrupt(kind):
    """A file PIL cannot load for want of data (cut short, a TGA run past
    its row, PIL's own 1-bit RLE TGA, an RLE stream that ends early)."""
    make, name = CORRUPT[kind]
    raw = make()
    with pytest.raises(Exception):
        _pil(raw, "RGBA")
    with pytest.raises(ValueError, match=rf"^t\.tga: corrupt or truncated "
                                         rf"{name}"):
        native.image_rgba(raw, "t.tga")
    with pytest.raises(image_plain.Refused) as err:
        image_plain.decode(raw, "RGBA")
    assert err.value.kind == "corrupt"


def _rle8_delta_bmp(w, h, up):
    """An RLE8 BMP of w x h: a run of two pixels of index 7, then a delta
    of 3 right and `up` rows (PIL's four bytes: two skipped, then right
    and up), which may reach past the image's end."""
    i = np.arange(256)
    pal = np.stack([i // 2, 255 - i, i, 0 * i], 1).astype(np.uint8)  # BGR0
    pix = bytes([2, 7, 0, 2, 0, 0, 3, up])
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 1, len(pix), 2835,
                       2835, 256, 0)
    off = 14 + len(info) + pal.nbytes
    return (b"BM" + struct.pack("<IHHI", off + len(pix), 0, 0, off) + info
            + pal.tobytes() + pix)


@pytest.mark.parametrize("decoder", ["plain", "native"])
def test_rle_delta_past_the_end_matches_pil(decoder):
    """A delta that reaches rows past the image's end fills the image's
    rest with index 0, as PIL does."""
    raw = _rle8_delta_bmp(40, 3, 255)
    want = _pil(raw, "RGBA")
    assert (want[-1, :2] == [7, 248, 3, 255]).all()
    assert np.array_equal(_decode(decoder, raw, "RGBA"), want)


_BOUNDED_CODE = """
import resource, sys
from pathtracer_torch.utils import native
small, big = (open(name, "rb").read() for name in sys.argv[1:])
native.image_rgba(small, "small.bmp")
vm = next(int(line.split()[1]) for line in open("/proc/self/status")
          if line.startswith("VmSize:")) << 10
resource.setrlimit(resource.RLIMIT_AS, (vm + (64 << 20),
                                        resource.RLIM_INFINITY))
native.image_rgba(big, "big.bmp")
"""


@pytest.mark.parametrize("decoder", ["plain", "native"])
def test_rle_delta_grows_no_further_than_the_image(decoder, tmp_path):
    """A delta of 255 rows on a 1,000,000 x 1 RLE8 BMP: the decoders
    allocate for the image's 1,000,000 indices, not the 255,000,000 the
    delta spans (only the first w * h are read), and give PIL's pixels.
    The plain version's peak is read by tracemalloc; the native one runs
    in a process that decodes the same file with a delta of 1 row first
    and then this one with its address space held to 64 MB more."""
    w = 1_000_000
    raw = _rle8_delta_bmp(w, 1, 255)
    want = np.zeros((1, w, 4), np.uint8)
    want[...] = [0, 255, 0, 255]
    want[0, :2] = [7, 248, 3, 255]
    if decoder == "plain":
        tracemalloc.start()
        try:
            got = image_plain.decode(raw, "RGBA")
            peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        assert peak < 64 << 20, peak
    else:
        small, big = tmp_path / "small.bmp", tmp_path / "big.bmp"
        small.write_bytes(_rle8_delta_bmp(w, 1, 1))
        big.write_bytes(raw)
        native.image_rgba(raw, "big.bmp")   # built before the child runs
        res = subprocess.run(
            [sys.executable, "-c", _BOUNDED_CODE, str(small), str(big)],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        got = native.image_rgba(raw, "big.bmp")
    assert np.array_equal(got, want)


def test_tga_is_tried_after_every_magic(fixtures):
    """TGA has no magic bytes: a file with a PNG, JPEG, BMP or other
    signature is never read as TGA, cut short or not, and bytes that fail
    PIL's TGA header test are named as none of the formats."""
    from tests.test_torch_images import _jpeg

    png = ic.png_file(np.zeros((4, 4), int), 0, 8)
    for raw, fmt in ((png[:30], "PNG"), (_jpeg()[:60], "JPEG"),
                     (b"BM" + bytes(4), "BMP")):
        with pytest.raises(ValueError, match=f"corrupt or truncated .*{fmt}"):
            native.image_rgba(raw, "x")
    for lead in (b"GIF89a", b"II*\0", b"DDS "):
        with pytest.raises(ValueError, match="cannot decode"):
            native.image_rgba(lead + bytes(40), "x")
    junk = bytes([0, 2, 7]) + bytes(40)      # image type 7: not a TGA
    assert not image_plain.tga_accept(junk)
    with pytest.raises(ValueError, match="not a PNG, JPEG, BMP or TGA"):
        native.image_rgba(junk, "x")


def test_image_info_reports_the_files_channels(fixtures):
    files, _ = fixtures
    want = {"l.tga": 1, "1.bmp": 1, "l.bmp": 1, "la.tga": 2, "rgb.tga": 3,
            "p.tga": 3, "p8.bmp": 3, "rgb555.bmp": 3, "bgrx32.bmp": 3,
            "rgba.tga": 4, "bgra16.tga": 4, "p_cmap16.tga": 4,
            "la_cmap16_rle.tga": 4, "bgra32_v4.bmp": 4}
    for name, ch in want.items():
        w, h, c = native.image_info(files[name], name)
        assert (c, (w, h)) == (ch, Image.open(io.BytesIO(files[name])).size)


# --- scene files carrying such images -------------------------------------

@pytest.mark.parametrize("name", ["rgba_rle.tga", "p_cmap16.tga",
                                  "la_cmap16_rle.tga", "bgra16_rle_flipx.tga",
                                  "rle4.bmp", "bgra32_v4.bmp", "1.bmp",
                                  "core8.bmp"])
def test_obj_map_kd_matches_jax(tmp_path, name):
    """An OBJ/MTL whose map_Kd is a TGA or BMP: the port's tables equal
    the JAX loader's (PIL's convert("RGBA")) bit for bit."""
    from tests.test_torch_images import _assert_same_tables, _read
    from tests.test_torch_loaders import MTL_TEXTURED, OBJ_TEXTURED, _write

    (tmp_path / name).write_bytes(_read(name))
    _write(tmp_path / "tex.mtl", MTL_TEXTURED.format(tex=name))
    p = _write(tmp_path / "m.obj", OBJ_TEXTURED)
    tf = _assert_same_tables(jload_obj(p), tload_obj(p))
    assert tf["has_textures"]


@pytest.mark.parametrize("name", ["rgb_topdown.tga", "p_cmap_start.tga",
                                  "rle8.bmp", "rgb565_bitfields.bmp"])
def test_envmap_matches_jax(tmp_path, name):
    """LDR env maps in TGA and BMP: (u8 / 255) ** 2.2 of PIL's
    convert("RGB"), bit for bit the JAX loader's."""
    from tests.test_torch_images import _read

    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(_read(name))
    j, t = jload_envmap(path), tload_envmap(path)
    assert t.dtype == j.dtype == np.float32 and t.shape == j.shape
    np.testing.assert_array_equal(t, j)
