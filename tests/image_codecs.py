"""Test-side image writers and the committed decode fixtures.

`png_file` writes a PNG of any colour type, bit depth, palette, tRNS
chunk and interlace, with every row's filter type drawn from a seed (PIL
writes no Adam7, no 16-bit colour and no sub-8-bit gray);
`jpeg_file` writes a baseline Huffman JPEG from quantized coefficient
blocks with any sampling factors and restart interval (PIL writes no
4:4:0). PIL decodes both kinds of file, and its decode is the reference
the port's decoders are held to.

`fixture_set()` names the committed fixtures of tests/data/images/: the
files and, in `pil.npz`, PIL's convert("RGBA") and convert("RGB") of
each; `bench_jpegs()` the two 1024x1024 JPEGs whose decode chip_smoke.py
times, with the sha256 of PIL's convert("RGB") in `bench_sha256.json`.
The card has no PIL, so chip_smoke.py and the cuda tests compare
against the committed arrays. Regenerate them (needs PIL) with

    python tests/image_codecs.py
"""

from __future__ import annotations

import contextlib
import io
import os
import struct
import zlib

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "images")
PNG_SIG = b"\x89PNG\r\n\x1a\n"
# Adam7: (x0, y0, dx, dy) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _pack_rows(img: np.ndarray, depth: int) -> np.ndarray:
    """Samples [h, w, c] -> packed scanline bytes [h, row_bytes]."""
    h, w, c = img.shape
    if depth == 16:
        return img.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    if depth == 8:
        return img.astype(np.uint8).reshape(h, w * c)
    bits = np.unpackbits(img.reshape(h, w * c, 1).astype(np.uint8), axis=2,
                         bitorder="big")[:, :, 8 - depth:]
    return np.packbits(bits.reshape(h, -1), axis=1, bitorder="big")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter(rows: np.ndarray, bpp: int, rng) -> bytes:
    """Filter each row with a filter type drawn from rng (0-4)."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int32)
    for row in rows.astype(np.int32):
        ft = int(rng.integers(0, 5))
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pred = (0, left, prev, (left + prev) // 2,
                _paeth(left, prev, upleft))[ft]
        out += bytes([ft]) + ((row - pred) & 255).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def png_file(samples, color_type: int, depth: int, *, palette=None,
             trns=None, interlace=False, seed=0) -> bytes:
    """PNG bytes of integer samples: [H, W] for gray and palette indices,
    [H, W, C] otherwise; palette u8 [N, 3]; trns bytes for a palette or
    the key (gray,) / (r, g, b) for types 0 and 2."""
    img = np.asarray(samples)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if c != CHANNELS[color_type]:
        raise ValueError(f"colour type {color_type} has "
                         f"{CHANNELS[color_type]} channels, not {c}")
    rng = np.random.default_rng(seed)
    bpp = max(1, c * depth // 8)
    if interlace:
        raw = b"".join(
            _filter(_pack_rows(img[y0::dy, x0::dx], depth), bpp, rng)
            for x0, y0, dx, dy in ADAM7 if w > x0 and h > y0)
    else:
        raw = _filter(_pack_rows(img, depth), bpp, rng)
    out = PNG_SIG + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color_type, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        body = (bytes(trns) if color_type == 3
                else struct.pack(f">{len(trns)}H", *trns))
        out += _chunk(b"tRNS", body)
    z = zlib.compress(raw, 9)
    # two IDAT chunks: a decoder must join them
    out += _chunk(b"IDAT", z[:len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:])
    return out + _chunk(b"IEND", b"")


# ---------------------------------------------------------------------------
# Baseline JPEG from coefficients
# ---------------------------------------------------------------------------

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])


def _segments(data: bytes):
    """(marker, body) of each marker segment before the first SOS."""
    pos = 2
    while pos < len(data):
        marker = data[pos + 1]
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        yield marker, data[pos + 4:pos + 2 + n]
        if marker == 0xDA:
            return
        pos += 2 + n


def standard_tables():
    """The DHT bodies PIL (libjpeg) writes without optimize: the tables
    of the JPEG standard's Annex K, keyed by (class, id)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (8, 8)).save(buf, format="JPEG")
    tables = {}
    for marker, body in _segments(buf.getvalue()):
        if marker != 0xC4:
            continue
        pos = 0
        while pos < len(body):
            tc_th = body[pos]
            n = sum(body[pos + 1:pos + 17])
            tables[(tc_th >> 4, tc_th & 15)] = body[pos:pos + 17 + n]
            pos += 17 + n
    return tables


def _huff_codes(table: bytes) -> dict:
    """symbol -> (code, length) of a DHT table body (class/id byte first)."""
    counts, syms = table[1:17], table[17:]
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[syms[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class _Bits:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, length: int):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _magnitude(v: int):
    size = abs(v).bit_length()
    return size, (v if v >= 0 else v + (1 << size) - 1)


def jpeg_file(blocks, sampling, quant, *, restart=0, adobe=None) -> bytes:
    """Baseline JPEG of quantized coefficient blocks.

    blocks[c]: int [rows, cols, 8, 8] (row-major, natural order) of
    component c, covering its whole MCU area; sampling[c]: (h, v); quant:
    u8 [8, 8]; restart: the restart interval in MCUs (0: none); adobe: the
    Adobe APP14 transform byte (0 keeps RGB) or None for a JFIF header.
    The image is 8 * hmax * mcu_cols wide and 8 * vmax * mcu_rows high,
    less nothing: callers choose block counts that tile whole MCUs.
    """
    tables = standard_tables()
    nc = len(blocks)
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcu_rows = blocks[0].shape[0] // sampling[0][1]
    mcu_cols = blocks[0].shape[1] // sampling[0][0]
    height, width = 8 * vmax * mcu_rows, 8 * hmax * mcu_cols
    out = bytearray(b"\xff\xd8")
    if adobe is None:
        body = b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
        out += b"\xff\xe0" + struct.pack(">H", len(body) + 2) + body
    else:
        body = b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe])
        out += b"\xff\xee" + struct.pack(">H", len(body) + 2) + body
    q = np.asarray(quant, np.uint8).reshape(64)[ZIGZAG].tobytes()
    out += b"\xff\xdb" + struct.pack(">H", 67) + b"\x00" + q
    sof = struct.pack(">BHHB", 8, height, width, nc)
    ids = (82, 71, 66) if adobe == 0 else range(1, nc + 1)
    for cid, (h, v) in zip(ids, sampling):
        sof += bytes([cid, (h << 4) | v, 0])
    out += b"\xff\xc0" + struct.pack(">H", len(sof) + 2) + sof
    dht = tables[(0, 0)] + tables[(1, 0)]
    out += b"\xff\xc4" + struct.pack(">H", len(dht) + 2) + dht
    if restart:
        out += b"\xff\xdd" + struct.pack(">HH", 4, restart)
    sos = bytes([nc]) + b"".join(bytes([cid, 0x00]) for cid in ids)
    sos += b"\x00\x3f\x00"
    out += b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos
    dc, ac = _huff_codes(tables[(0, 0)]), _huff_codes(tables[(1, 0)])
    bits = _Bits()
    pred = [0] * nc
    n_mcu = mcu_rows * mcu_cols
    for m in range(n_mcu):
        if restart and m and m % restart == 0:
            bits.flush()
            bits.out += bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            pred = [0] * nc
        my, mx = divmod(m, mcu_cols)
        for c in range(nc):
            h, v = sampling[c]
            for by in range(v):
                for bx in range(h):
                    zz = blocks[c][my * v + by, mx * h + bx].reshape(64)[
                        ZIGZAG].astype(int)
                    size, val = _magnitude(int(zz[0]) - pred[c])
                    pred[c] = int(zz[0])
                    bits.put(*dc[size])
                    bits.put(val, size)
                    run = 0
                    for k in range(1, 64):
                        if zz[k] == 0:
                            run += 1
                            continue
                        while run > 15:
                            bits.put(*ac[0xF0])
                            run -= 16
                        size, val = _magnitude(int(zz[k]))
                        bits.put(*ac[(run << 4) | size])
                        bits.put(val, size)
                        run = 0
                    if run:
                        bits.put(*ac[0x00])
    bits.flush()
    return bytes(out + bits.out + b"\xff\xd9")


def random_blocks(rng, sampling, mcu_rows, mcu_cols, scale=(60, 12)):
    """Quantized coefficient blocks with DC in [-scale0, scale0] and AC
    falling off with frequency, per component."""
    out = []
    fy, fx = np.indices((8, 8))
    falloff = 1.0 / (1.0 + fy + fx)
    for h, v in sampling:
        shape = (mcu_rows * v, mcu_cols * h, 8, 8)
        b = np.round(rng.normal(0.0, scale[1], shape) * falloff).astype(int)
        b[..., 0, 0] = rng.integers(-scale[0], scale[0] + 1, shape[:2])
        out.append(np.clip(b, -1023, 1023))
    return out


# ---------------------------------------------------------------------------
# The committed fixtures
# ---------------------------------------------------------------------------

def _natural(rng, h, w):
    """A smooth RGB image with some noise (JPEG-friendly)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(x / 5.0 + y / 9.0),
                    128 + 90 * np.cos(y / 4.0),
                    128 + 80 * np.sin((x + y) / 7.0)], -1)
    img += rng.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def fixture_set(seed: int = 11) -> dict:
    """name -> file bytes of every committed fixture (needs PIL)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = 19, 23
    files = {}
    pal = rng.integers(0, 256, (16, 3))
    for depth in (1, 2, 4, 8, 16):
        top = (1 << depth) - 1
        for il in (False, True):
            sfx = f"{depth}{'_adam7' if il else ''}"
            files[f"gray{sfx}.png"] = png_file(
                rng.integers(0, top + 1, (h, w)), 0, depth, interlace=il,
                seed=depth)
            if depth >= 8:
                for ct, name in ((2, "rgb"), (4, "graya"), (6, "rgba")):
                    files[f"{name}{sfx}.png"] = png_file(
                        rng.integers(0, top + 1, (h, w, CHANNELS[ct])), ct,
                        depth, interlace=il, seed=depth + ct)
            if depth <= 8:
                n = min(16, 1 << depth)
                files[f"pal{sfx}.png"] = png_file(
                    rng.integers(0, n, (h, w)), 3, depth, palette=pal[:n],
                    trns=rng.integers(0, 256, n // 2).astype(np.uint8),
                    interlace=il, seed=depth + 3)
    # tRNS colour keys, the key present in the image
    g = rng.integers(0, 2, (h, w))
    files["gray1_trns.png"] = png_file(g, 0, 1, trns=(1,))
    g = rng.integers(0, 4, (h, w))
    files["gray2_trns.png"] = png_file(g, 0, 2, trns=(0,))
    g = rng.integers(0, 256, (h, w))
    files["gray8_trns.png"] = png_file(g, 0, 8, trns=(int(g[3, 4]),))
    g = rng.integers(250, 262, (h, w))
    files["gray16_trns.png"] = png_file(g, 0, 16, trns=(int(g[0, 0]),))
    # a tRNS of one transparent entry (PIL reads it as an index)
    files["pal4_key.png"] = png_file(rng.integers(0, 16, (h, w)), 3, 4,
                                     palette=pal, trns=b"\xff\x00\xff")
    c = rng.integers(0, 4, (h, w, 3)) * 60
    files["rgb8_trns.png"] = png_file(c, 2, 8, trns=tuple(c[2, 2]),
                                      interlace=True)
    c = rng.integers(0, 3, (h, w, 3)) * 0x0101 * 70
    files["rgb16_trns.png"] = png_file(c, 2, 16, trns=tuple(c[1, 1]))

    nat = _natural(rng, 37, 45)
    for sub, tag in ((0, "444"), (1, "422"), (2, "420")):
        for prog in (False, True):
            for rst in (0, 2):
                buf = io.BytesIO()
                Image.fromarray(nat).save(
                    buf, format="JPEG", quality=88, subsampling=sub,
                    progressive=prog, restart_marker_blocks=rst)
                kind = "prog" if prog else "base"
                name = f"{kind}{tag}{'_rst' if rst else ''}.jpg"
                files[name] = buf.getvalue()
    for prog in (False, True):
        buf = io.BytesIO()
        Image.fromarray(nat[..., 1]).save(buf, format="JPEG", quality=75,
                                          progressive=prog,
                                          restart_marker_rows=1)
        files[f"{'prog' if prog else 'base'}_gray.jpg"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(nat).save(buf, format="JPEG", keep_rgb=True,
                              quality=90)
    files["adobe_rgb.jpg"] = buf.getvalue()
    quant = np.full((8, 8), 4)
    for sampling, tag in ((((1, 2), (1, 1), (1, 1)), "440"),
                          (((2, 2), (1, 2), (2, 1)), "mixed")):
        files[f"base{tag}_rst.jpg"] = jpeg_file(
            random_blocks(rng, sampling, 3, 4), sampling, quant, restart=3)
    return files


def bench_jpegs(seed: int = 12) -> dict:
    """name -> bytes of the two 1024x1024 4:2:0 JPEGs (baseline and
    progressive) whose decode chip_smoke.py times (needs PIL)."""
    from PIL import Image

    nat = _natural(np.random.default_rng(seed), 1024, 1024)
    out = {}
    for prog in (False, True):
        buf = io.BytesIO()
        Image.fromarray(nat).save(buf, format="JPEG", quality=90,
                                  subsampling=2, progressive=prog)
        out[f"bench420_{'prog' if prog else 'base'}.jpg"] = buf.getvalue()
    return out


def digest(arr: np.ndarray) -> str:
    """sha256 of an array's shape and bytes."""
    import hashlib

    h = hashlib.sha256(repr((arr.shape, str(arr.dtype))).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def glb_with_images(glb: bytes, images) -> bytes:
    """The .glb with the bytes of image i replaced by images[i] (PNG or
    JPEG, mimeType set from the magic), every buffer view re-laid."""
    import json

    jlen = struct.unpack("<I", glb[12:16])[0]
    doc = json.loads(glb[20:20 + jlen])
    blen = struct.unpack("<I", glb[20 + jlen:24 + jlen])[0]
    blob = glb[28 + jlen:28 + jlen + blen]
    by_view = {img["bufferView"]: i for i, img in enumerate(doc["images"])}
    new = bytearray()
    for vi, view in enumerate(doc["bufferViews"]):
        start = view.get("byteOffset", 0)
        data = (images[by_view[vi]] if vi in by_view
                else blob[start:start + view["byteLength"]])
        new += b"\0" * (-len(new) % 4)
        view["byteOffset"], view["byteLength"] = len(new), len(data)
        new += data
    new += b"\0" * (-len(new) % 4)
    for img, raw in zip(doc["images"], images):
        img["mimeType"] = ("image/jpeg" if raw[:2] == b"\xff\xd8"
                           else "image/png")
    doc["buffers"][0]["byteLength"] = len(new)
    js = json.dumps(doc, separators=(",", ":")).encode()
    js += b" " * (-len(js) % 4)
    return (struct.pack("<III", 0x46546C67, 2, 28 + len(js) + len(new))
            + struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(new), 0x004E4942) + bytes(new))


# sponza_like's five textures, replaced in the .glb by these fixtures
IMAGE_TEXTURES = ("prog420.jpg", "base422_rst.jpg", "rgb16.png",
                  "graya16_adam7.png", "base420.jpg")


def write_textured_glb(path: str, files: dict, tris: int = 20_000):
    """The textured sponza_like scene exported by pathtracer_torch, its
    images replaced by the bytes of IMAGE_TEXTURES (JPEG and 16-bit PNG)."""
    from pathtracer_torch.scene.export import export_glb
    from pathtracer_torch.scene.procedural import sponza_like

    export_glb(sponza_like(target_tris=tris, textured=True), path)
    with open(path, "rb") as f:
        glb = f.read()
    with open(path, "wb") as f:
        f.write(glb_with_images(glb, [files[n] for n in IMAGE_TEXTURES]))


@contextlib.contextmanager
def decoded_by_pil(files: dict, ref: dict):
    """Within the block pathtracer_torch's loaders take each fixture's
    committed PIL array for its bytes instead of decoding them: a scene
    loaded so is built from the decoded arrays directly."""
    from pathtracer_torch.utils import native

    by_bytes = {files[n]: ref[n][0] for n in files}
    saved = native.image_rgba
    native.image_rgba = lambda raw, what: by_bytes[bytes(raw)]
    try:
        yield
    finally:
        native.image_rgba = saved


def pil_arrays(files: dict) -> dict:
    """PIL's convert("RGBA") and convert("RGB") of each fixture."""
    from PIL import Image

    out = {}
    for name, raw in files.items():
        im = Image.open(io.BytesIO(raw))
        out[f"{name}:RGBA"] = np.asarray(im.convert("RGBA"))
        out[f"{name}:RGB"] = np.asarray(im.convert("RGB"))
    return out


def load_fixtures():
    """(name -> bytes, name -> (PIL RGBA, PIL RGB)) of the committed set."""
    ref = np.load(os.path.join(DATA_DIR, "pil.npz"))
    names = sorted({k.split(":")[0] for k in ref.files})
    files = {}
    for n in names:
        with open(os.path.join(DATA_DIR, n), "rb") as f:
            files[n] = f.read()
    return files, {n: (ref[f"{n}:RGBA"], ref[f"{n}:RGB"]) for n in names}


def main():
    import json

    files = fixture_set()
    os.makedirs(DATA_DIR, exist_ok=True)
    for name, raw in files.items():
        with open(os.path.join(DATA_DIR, name), "wb") as f:
            f.write(raw)
    np.savez_compressed(os.path.join(DATA_DIR, "pil.npz"),
                        **pil_arrays(files))
    bench = bench_jpegs()
    for name, raw in bench.items():
        with open(os.path.join(DATA_DIR, name), "wb") as f:
            f.write(raw)
    digests = {k: digest(v) for k, v in pil_arrays(bench).items()
               if k.endswith(":RGB")}
    with open(os.path.join(DATA_DIR, "bench_sha256.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(files)} fixtures and {len(bench)} bench JPEGs in "
          f"{DATA_DIR}")


if __name__ == "__main__":
    main()
