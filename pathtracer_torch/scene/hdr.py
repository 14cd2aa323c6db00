"""Radiance RGBE (.hdr) reader/writer (counterpart of pathtracer/scene/hdr.py).

The JAX package's numpy codec, copied: the port imports nothing of
`pathtracer`. The writer emits byte for byte the JAX writer's files.
`read_hdr` parses the header here and decodes the scanlines with the
native decoder (`utils/native.hdr_decode`, csrc/image_decode.cpp), as
the JAX reader does when its library is built; `decode_scanlines` is
the plain Python version it is held to bit for bit:

- header: `#?RADIANCE`/`#?RGBE`, `FORMAT=32-bit_rle_rgbe`, blank line,
  then a resolution line (`-Y H +X W` is the standard orientation);
- scanlines: "new RLE" (marker 0x02 0x02 W_hi W_lo, then four run-length
  coded component planes) or flat RGBE with old-style (1,1,1,n) repeats;
- RGBE -> float: rgb = mantissa * 2^(e - 128 - 8); e == 0 means black.
"""

from __future__ import annotations

import numpy as np

from pathtracer_torch.utils import native


def _decode_rgbe(rgbe: np.ndarray) -> np.ndarray:
    """RGBE u8 [..., 4] -> linear f32 [..., 3]."""
    rgbe = rgbe.astype(np.int32)
    e = rgbe[..., 3]
    scale = np.where(e == 0, 0.0,
                     np.ldexp(1.0, e - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def _encode_rgbe(rgb: np.ndarray) -> np.ndarray:
    """Linear f32 [..., 3] -> RGBE u8 [..., 4]."""
    rgb = np.maximum(np.asarray(rgb, np.float32), 0.0)
    maxc = rgb.max(axis=-1)
    m, e = np.frexp(maxc)
    scale = np.where(maxc < 1e-32, 0.0, np.ldexp(1.0, 8) * m / np.maximum(
        maxc, 1e-32))
    q = np.minimum(rgb * scale[..., None], 255.0).astype(np.uint8)
    eb = np.where(maxc < 1e-32, 0, e + 128).astype(np.uint8)
    return np.concatenate([q, eb[..., None]], axis=-1)


def _read_scanline_rle(data: bytes, pos: int, width: int) -> tuple:
    """One new-RLE scanline -> (rgbe u8 [W, 4], new pos)."""
    out = np.empty((4, width), np.uint8)
    for c in range(4):
        x = 0
        while x < width:
            n = data[pos]
            pos += 1
            if n > 128:                       # run: repeat next byte
                count = n - 128
                out[c, x:x + count] = data[pos]
                pos += 1
            else:                             # literal bytes
                count = n
                out[c, x:x + count] = np.frombuffer(
                    data, np.uint8, count, pos)
                pos += count
            x += count
    return out.T.copy(), pos


def _read_scanline_flat(data: bytes, pos: int, width: int) -> tuple:
    """One flat RGBE scanline with (1,1,1,n) repeats -> (rgbe, new pos)."""
    row = np.empty((width, 4), np.uint8)
    x = 0
    shift = 0
    while x < width:
        px = np.frombuffer(data, np.uint8, 4, pos)
        pos += 4
        if px[0] == 1 and px[1] == 1 and px[2] == 1:
            count = int(px[3]) << shift
            # a repeat with nothing to repeat, or one running past the
            # scanline, is malformed
            if x == 0 or x + count > width:
                raise ValueError("corrupt .hdr: bad RLE repeat")
            row[x:x + count] = row[x - 1]
            x += count
            shift += 8
        else:
            row[x] = px
            x += 1
            shift = 0
    return row, pos


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file -> linear radiance f32 [H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    pos = data.index(b"\n") + 1
    fmt = b"32-bit_rle_rgbe"
    while True:
        end = data.index(b"\n", pos)
        line = data[pos:end]
        pos = end + 1
        if line.startswith(b"FORMAT="):
            fmt = line.split(b"=", 1)[1].strip()
        if line == b"":
            break
    if fmt != b"32-bit_rle_rgbe":
        raise ValueError(f"{path}: unsupported FORMAT {fmt!r}")
    end = data.index(b"\n", pos)
    res = data[pos:end].split()
    pos = end + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {res!r}")
    h, w = int(res[1]), int(res[3])
    try:
        return native.hdr_decode(data[pos:], w, h)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def decode_scanlines(data: bytes, pos: int, w: int, h: int) -> np.ndarray:
    """Plain version of native.hdr_decode: h scanlines of width w from
    data[pos:] -> linear radiance f32 [H, W, 3]."""
    rows = []
    for _ in range(h):
        if (8 <= w <= 0x7FFF and pos + 4 <= len(data)
                and data[pos] == 2 and data[pos + 1] == 2
                and (data[pos + 2] << 8 | data[pos + 3]) == w):
            row, pos = _read_scanline_rle(data, pos + 4, w)
        else:
            row, pos = _read_scanline_flat(data, pos, w)
        rows.append(row)
    return _decode_rgbe(np.stack(rows))


def write_hdr(path: str, img: np.ndarray):
    """Write linear radiance f32 [H, W, 3] as new-RLE Radiance .hdr."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    rgbe = _encode_rgbe(img)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\n")
        f.write(b"FORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        if not (8 <= w <= 0x7FFF):
            f.write(rgbe.tobytes())          # flat (tiny/huge widths)
            return
        for y in range(h):
            f.write(bytes([2, 2, (w >> 8) & 0xFF, w & 0xFF]))
            for c in range(4):
                plane = rgbe[y, :, c].tobytes()
                for x in range(0, w, 128):   # literal chunks <= 128
                    chunk = plane[x:x + 128]
                    f.write(bytes([len(chunk)]) + chunk)
