"""Plain numpy versions of the native image decoders (csrc/image_decode.cpp).

Each step is written out as the format defines it, and the conversions
are those of PIL's `Image.open(...).convert("RGBA")` / `convert("RGB")`,
which the JAX package hands every image its native PNG decoder declines.
The native decoders are held to these bit for bit; the tests hold both
to PIL. Slow (a Python loop per byte of a filtered row and per Huffman
symbol): for the tests, not for scenes.

PNG: every colour type and bit depth, Adam7, PLTE and tRNS, with PIL's
rules: 1/2/4-bit gray scaled by 255/85/17; 16-bit gray clipped at 255;
other 16-bit samples cut to their high byte; a tRNS key compared, low
byte only, with the 8-bit gray or RGB value (1-bit: 0 or 255); palette
entries past the PLTE black, past the tRNS opaque.

JPEG: baseline, extended (8-bit) and progressive Huffman, 1 or 3
components, any integral sampling factors, restart intervals; decoded
as libjpeg(-turbo) does by default: the JDCT_ISLOW integer IDCT (its
output saturated, as the SIMD builds PIL uses give it), "fancy"
(triangle) upsampling for 2:1 factors and box upsampling for the rest,
the fixed-point YCbCr -> RGB tables, and the colour space rule of
jdapimin.c (JFIF or Adobe transform 1 or component ids 1, 2, 3: YCbCr;
Adobe transform 0 or ids 'R', 'G', 'B': RGB). Coefficients are stored as
libjpeg's 16-bit JCOEF (a store wraps) and the DC predictor wraps at 32
bits; a second frame header, a Huffman table with a code past its length
and a DC table with a magnitude above 15 are corrupt, as in libjpeg.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIG = b"\x89PNG\r\n\x1a\n"
PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
              4: (8, 16), 6: (8, 16)}
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
GRAY_SCALE = {1: 255, 2: 85, 4: 17, 8: 1}


def png_chunks(data: bytes):
    """(type, body) of each chunk up to IEND."""
    if data[:8] != PNG_SIG:
        raise ValueError("not a PNG")
    pos, out = 8, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if pos + 12 + n > len(data):
            raise ValueError("truncated PNG chunk")
        out.append((kind, data[pos + 8:pos + 8 + n]))
        pos += 12 + n
        if kind == b"IEND":
            break
    return out


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, pos: int, h: int, rowbytes: int, bpp: int):
    """h filtered rows from raw[pos:] -> (u8 [h, rowbytes], new pos)."""
    out = np.zeros((h, rowbytes), np.uint8)
    prev = [0] * rowbytes
    for y in range(h):
        if pos + 1 + rowbytes > len(raw):
            raise ValueError("PNG image data too short")
        ft = raw[pos]
        cur = list(raw[pos + 1:pos + 1 + rowbytes])
        pos += 1 + rowbytes
        for i in range(rowbytes):
            a = cur[i - bpp] if i >= bpp else 0
            c = prev[i - bpp] if i >= bpp else 0
            if ft == 1:
                cur[i] = (cur[i] + a) & 255
            elif ft == 2:
                cur[i] = (cur[i] + prev[i]) & 255
            elif ft == 3:
                cur[i] = (cur[i] + (a + prev[i]) // 2) & 255
            elif ft == 4:
                cur[i] = (cur[i] + _paeth(a, prev[i], c)) & 255
            elif ft != 0:
                raise ValueError(f"PNG filter type {ft}")
        out[y] = cur
        prev = cur
    return out, pos


def _unpack(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered rows -> samples int32 [h, w, ch]."""
    h = rows.shape[0]
    if depth == 16:
        s = rows[:, :w * ch * 2].reshape(h, w * ch, 2).astype(np.int32)
        s = s[..., 0] << 8 | s[..., 1]
    elif depth == 8:
        s = rows[:, :w * ch].astype(np.int32)
    else:
        bits = np.unpackbits(rows, axis=1)[:, :w * ch * depth]
        weights = 1 << np.arange(depth - 1, -1, -1)
        s = (bits.reshape(h, w * ch, depth) * weights).sum(-1)
    return s.reshape(h, w, ch).astype(np.int32)


def png_decode(data: bytes):
    """PNG -> (samples int32 [H, W, C] in the file's own channels and bit
    depth, meta dict: width, height, depth, color, palette u8 [N, 3] or
    None, trns bytes or None)."""
    chunks = png_chunks(data)
    if not chunks or chunks[0][0] != b"IHDR" or len(chunks[0][1]) != 13:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, comp, filt, inter = struct.unpack(">IIBBBBB",
                                                          chunks[0][1])
    if (color not in PNG_DEPTHS or depth not in PNG_DEPTHS[color]
            or comp or filt or inter > 1 or w == 0 or h == 0):
        raise ValueError(f"PNG of bit depth {depth} and colour type "
                         f"{color} (interlace {inter})")
    palette = trns = None
    idat = bytearray()
    for kind, body in chunks[1:]:
        if kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8)[:len(body) // 3 * 3]
            palette = palette.reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat += body
    if color == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    raw = zlib.decompress(bytes(idat))
    ch = PNG_CHANNELS[color]
    bpp = max(1, ch * depth // 8)
    out = np.zeros((h, w, ch), np.int32)
    passes = ADAM7 if inter else ((0, 0, 1, 1),)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue
        rows, pos = _unfilter(raw, pos, ph, (pw * ch * depth + 7) // 8,
                              bpp)
        out[y0::dy, x0::dx] = _unpack(rows, pw, ch, depth)
    return out, dict(width=w, height=h, depth=depth, color=color,
                     palette=palette, trns=trns)


def png_convert(samples: np.ndarray, meta: dict, mode: str) -> np.ndarray:
    """The file's samples -> u8 [H, W, 4] ("RGBA") or [H, W, 3] ("RGB") by
    PIL's conversion rules (module docstring)."""
    depth, color, trns = meta["depth"], meta["color"], meta["trns"]
    h, w = samples.shape[:2]
    alpha = np.full((h, w), 255, np.int32)
    if color == 3:
        pal = np.zeros((256, 3), np.int32)
        pal[:len(meta["palette"])] = meta["palette"][:256]
        rgb = pal[samples[..., 0]]
        if trns is not None:
            table = np.full(256, 255, np.int32)
            table[:len(trns)] = np.frombuffer(trns, np.uint8)[:256]
            alpha = table[samples[..., 0]]
    elif color in (0, 4):
        g = samples[..., 0]
        if depth == 16:
            g = np.minimum(g, 255) if color == 0 else g >> 8
        else:
            g = g * GRAY_SCALE[depth]
        rgb = np.repeat(g[..., None], 3, -1)
        if color == 4:
            alpha = samples[..., 1] >> (8 if depth == 16 else 0)
        elif trns is not None and len(trns) >= 2:
            key = struct.unpack(">H", trns[:2])[0]
            key = (255 if key else 0) if depth == 1 else key & 255
            alpha = np.where(g == key, 0, 255)
    else:
        rgb = samples[..., :3] >> (8 if depth == 16 else 0)
        if color == 6:
            alpha = samples[..., 3] >> (8 if depth == 16 else 0)
        elif trns is not None and len(trns) >= 6:
            key = np.array(struct.unpack(">3H", trns[:6])) & 255
            alpha = np.where((rgb == key).all(-1), 0, 255)
    out = rgb if mode == "RGB" else np.concatenate([rgb, alpha[..., None]],
                                                   -1)
    return out.astype(np.uint8)


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])
SOF_SUPPORTED = (0xC0, 0xC1, 0xC2)


class _Bits:
    """MSB-first reader of one restart interval's unstuffed bytes; reads
    past the end give zero bits (libjpeg's behaviour on a short scan)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0     # in bits

    def bit(self) -> int:
        byte = self.pos >> 3
        v = (self.data[byte] >> (7 - (self.pos & 7))) & 1 if byte < len(
            self.data) else 0
        self.pos += 1
        return v

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def huff(self, table: dict) -> int:
        code = 0
        for length in range(1, 17):
            code = (code << 1) | self.bit()
            sym = table.get((length, code))
            if sym is not None:
                return sym
        raise ValueError("corrupt JPEG: bad Huffman code")

    def extend(self, s: int) -> int:
        v = self.bits(s)
        return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _s16(v: int) -> int:
    """v stored in a 16-bit JCOEF (two's complement wrap)."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _s32(v: int) -> int:
    return ((v + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def _huff_table(counts, syms):
    """{(length, code): symbol}, or None when a code runs out of its
    length (the all-ones code or past it), which jdhuff.c refuses where a
    scan uses the table."""
    table, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            table[(length, code)] = syms[k]
            code += 1
            k += 1
        if code >= 1 << length:
            return None
        code <<= 1
    return table


def _scan_intervals(data: bytes, pos: int):
    """Entropy-coded data from pos -> (list of unstuffed restart
    intervals, position of the next marker)."""
    intervals, cur = [], bytearray()
    n = len(data)
    while pos < n:
        b = data[pos]
        if b != 0xFF:
            cur.append(b)
            pos += 1
            continue
        nxt = data[pos + 1] if pos + 1 < n else 0xD9
        if nxt == 0x00:
            cur.append(0xFF)
            pos += 2
        elif nxt == 0xFF:
            pos += 1
        elif 0xD0 <= nxt <= 0xD7:
            intervals.append(bytes(cur))
            cur = bytearray()
            pos += 2
        else:
            break
    intervals.append(bytes(cur))
    return intervals, pos


def _idct_1d(d, shift):
    """libjpeg's jpeg_idct_islow butterfly (jidctint.c) on 8 int64 arrays,
    descaled by `shift` bits."""
    z1 = (d[2] + d[6]) * 4433
    tmp2 = z1 + d[6] * -15137
    tmp3 = z1 + d[2] * 6270
    tmp0 = (d[0] + d[4]) * 8192
    tmp1 = (d[0] - d[4]) * 8192
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    out = (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)
    rnd = 1 << (shift - 1)
    return [(x + rnd) >> shift for x in out]


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """Blocks int [N, 64] (natural order) and their quant table [64] ->
    samples u8 [N, 8, 8]."""
    x = (coef.astype(np.int64) * quant.astype(np.int64)).reshape(-1, 8, 8)
    cols = _idct_1d([x[:, k, :] for k in range(8)], 11)     # pass 1
    ws = np.stack(cols, 1)                                   # [N, row, col]
    rows = _idct_1d([ws[:, :, k] for k in range(8)], 18)    # pass 2
    v = np.stack(rows, 2)
    # saturated, as libjpeg-turbo's SIMD IDCTs (PIL's) pack it; the C
    # IDCT's range-limit table would wrap past +-512 instead
    return np.clip(v + 128, 0, 255).astype(np.uint8)


def _clamped(x: np.ndarray, axis: int, step: int) -> np.ndarray:
    """x shifted by step along axis, the edge sample repeated."""
    n = x.shape[axis]
    idx = np.clip(np.arange(n) + step, 0, n - 1)
    return np.take(x, idx, axis=axis)


def upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A component's samples [dh, dw] -> [dh * fv, dw * fh] as libjpeg's
    jdsample.c does it: triangle filters for (2, 1), (1, 2) and (2, 2)
    (the first two only wider than 2 samples), box replication else."""
    x = plane.astype(np.int32)
    dh, dw = x.shape
    if (fh, fv) == (1, 1):
        return plane
    if (fh, fv) == (1, 2):
        up, dn = _clamped(x, 0, -1), _clamped(x, 0, 1)
        out = np.empty((2 * dh, dw), np.int32)
        out[0::2] = (3 * x + up + 1) >> 2
        out[1::2] = (3 * x + dn + 2) >> 2
        return out.astype(np.uint8)
    if (fh, fv) == (2, 1) and dw > 2:
        lf, rt = _clamped(x, 1, -1), _clamped(x, 1, 1)
        out = np.empty((dh, 2 * dw), np.int32)
        out[:, 0::2] = (3 * x + lf + 1) >> 2
        out[:, 1::2] = (3 * x + rt + 2) >> 2
        return out.astype(np.uint8)
    if (fh, fv) == (2, 2) and dw > 2:
        cs = np.empty((2 * dh, dw), np.int32)
        cs[0::2] = 3 * x + _clamped(x, 0, -1)
        cs[1::2] = 3 * x + _clamped(x, 0, 1)
        out = np.empty((2 * dh, 2 * dw), np.int32)
        out[:, 0::2] = (3 * cs + _clamped(cs, 1, -1) + 8) >> 4
        out[:, 1::2] = (3 * cs + _clamped(cs, 1, 1) + 7) >> 4
        return out.astype(np.uint8)
    return np.repeat(np.repeat(plane, fv, 0), fh, 1)


def _ycc_tables():
    """jdcolor.c's build_ycc_rgb_table (SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (91881 * x + half) >> 16
    cb_b = (116130 * x + half) >> 16
    cr_g = -46802 * x
    cb_g = -22554 * x + half
    return cr_r, cb_b, cr_g, cb_g


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    cr_r, cb_b, cr_g, cb_g = _ycc_tables()
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _decode_block_baseline(bits, block, pred, ci, dc, ac):
    t = bits.huff(dc)
    pred[ci] = _s32(pred[ci] + bits.extend(t))
    block[0] = _s16(pred[ci])
    k = 1
    while k < 64:
        rs = bits.huff(ac)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            block[ZIGZAG[k]] = _s16(bits.extend(s))
            k += 1
        elif r == 15:
            k += 16
        else:
            break


def _decode_dc_first(bits, block, pred, ci, dc, al):
    t = bits.huff(dc)
    pred[ci] = _s32(pred[ci] + bits.extend(t))
    block[0] = _s16(pred[ci] * (1 << al))


def _decode_ac_first(bits, block, st, ac, ss, se, al):
    if st["eobrun"]:
        st["eobrun"] -= 1
        return
    k = ss
    while k <= se:
        rs = bits.huff(ac)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            block[ZIGZAG[k]] = _s16(bits.extend(s) * (1 << al))
        elif r == 15:
            k += 15
        else:
            st["eobrun"] = (1 << r) - 1 + (bits.bits(r) if r else 0)
            break
        k += 1


def _refine(bits, block, z, p1):
    """Correction bit of an already nonzero coefficient."""
    c = block[z]
    if bits.bit() and (c & p1) == 0:
        block[z] = _s16(c + p1 if c >= 0 else c - p1)


def _decode_ac_refine(bits, block, st, ac, ss, se, al):
    p1 = 1 << al
    k = ss
    if not st["eobrun"]:
        while k <= se:
            rs = bits.huff(ac)
            r, s = rs >> 4, rs & 15
            val = 0
            if s:
                val = p1 if bits.bit() else -p1
            elif r != 15:
                st["eobrun"] = (1 << r) + (bits.bits(r) if r else 0)
                break
            while k <= se:
                z = ZIGZAG[k]
                if block[z]:
                    _refine(bits, block, z, p1)
                else:
                    if r == 0:
                        break
                    r -= 1
                k += 1
            if val and k <= se:
                block[ZIGZAG[k]] = val
            k += 1
    if st["eobrun"]:
        while k <= se:
            z = ZIGZAG[k]
            if block[z]:
                _refine(bits, block, z, p1)
            k += 1
        st["eobrun"] -= 1


def jpeg_decode(data: bytes) -> np.ndarray:
    """JPEG -> u8 [H, W, 1] (gray) or [H, W, 3] (RGB), as libjpeg decodes
    it (module docstring). Raises ValueError on what it does not take."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG")
    quant, dc_tabs, ac_tabs = {}, {}, {}
    restart, jfif, adobe = 0, False, None
    frame = None
    coefs, latched = [], {}
    pos, eoi = 2, False
    while pos + 1 < len(data):
        if data[pos] != 0xFF:
            pos += 1                      # garbage between segments
            continue
        m = data[pos + 1]
        if m == 0xFF:
            pos += 1
            continue
        if m == 0xD9:
            eoi = True
            break
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            pos += 2
            continue
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + n]
        pos += 2 + n
        if m == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    vals = struct.unpack(">64H", body[i + 1:i + 129])
                    i += 129
                else:
                    vals = tuple(body[i + 1:i + 65])
                    i += 65
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = vals
                quant[tq] = q
        elif m == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1:i + 17]
                k = sum(counts)
                table = _huff_table(counts, body[i + 17:i + 17 + k])
                (ac_tabs if tc else dc_tabs)[th] = table
                i += 17 + k
        elif m == 0xDD:
            restart = struct.unpack(">H", body[:2])[0]
        elif m == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            if frame is not None:
                raise ValueError("JPEG with a second frame header")
            if m not in SOF_SUPPORTED or body[0] != 8:
                raise ValueError(f"JPEG SOF{m - 0xC0} of {body[0]}-bit "
                                 "precision")
            hgt, wid, nc = struct.unpack(">HHB", body[1:6])
            comps = [dict(id=body[6 + 3 * c], h=body[7 + 3 * c] >> 4,
                          v=body[7 + 3 * c] & 15, tq=body[8 + 3 * c])
                     for c in range(nc)]
            if nc not in (1, 3) or hgt == 0 or wid == 0:
                raise ValueError(f"JPEG of {nc} components, {wid}x{hgt}")
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mcux = -(-wid // (8 * hmax))
            mcuy = -(-hgt // (8 * vmax))
            for c in comps:
                c["bw"] = -(-wid * c["h"] // (8 * hmax))
                c["bh"] = -(-hgt * c["v"] // (8 * vmax))
                coefs.append(np.zeros((mcuy * c["v"], mcux * c["h"], 64),
                                      np.int64))
            frame = dict(w=wid, h=hgt, comps=comps, hmax=hmax, vmax=vmax,
                         mcux=mcux, mcuy=mcuy, progressive=m == 0xC2)
        elif m == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            ns = body[0]
            scomps = []
            for k in range(ns):
                cid, tables = body[1 + 2 * k], body[2 + 2 * k]
                ci = next(i for i, c in enumerate(frame["comps"])
                          if c["id"] == cid)
                scomps.append((ci, tables >> 4, tables & 15))
                if ci not in latched:
                    latched[ci] = quant[frame["comps"][ci]["tq"]].copy()
            ss, se = body[1 + 2 * ns], body[2 + 2 * ns]
            ah, al = body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 15
            intervals, pos = _scan_intervals(data, pos)
            _decode_scan(frame, coefs, scomps, dc_tabs, ac_tabs, restart,
                         intervals, ss, se, ah, al)
    if frame is None or not eoi:   # a file cut short is an error, as in PIL
        raise ValueError("JPEG without a frame header or cut short")
    return _finish(frame, coefs, latched, jfif, adobe)


def _decode_scan(frame, coefs, scomps, dc_tabs, ac_tabs, restart,
                 intervals, ss, se, ah, al):
    comps = frame["comps"]
    prog = frame["progressive"]
    if len(scomps) == 1:
        ci = scomps[0][0]
        units = [[(ci, by, bx)] for by in range(comps[ci]["bh"])
                 for bx in range(comps[ci]["bw"])]
    else:
        units = []
        for my in range(frame["mcuy"]):
            for mx in range(frame["mcux"]):
                unit = []
                for ci, _, _ in scomps:
                    c = comps[ci]
                    unit += [(ci, my * c["v"] + by, mx * c["h"] + bx)
                             for by in range(c["v"]) for bx in range(c["h"])]
                units.append(unit)
    tabs = {ci: (td, ta) for ci, td, ta in scomps}
    for td, ta in tabs.values():
        dc, ac = dc_tabs.get(td), ac_tabs.get(ta)
        if ((not prog or (ss == 0 and ah == 0))
                and (dc is None or max(dc.values(), default=0) > 15)):
            raise ValueError("JPEG scan without a valid DC table")
        if (not prog or ss > 0) and ac is None:
            raise ValueError("JPEG scan without a valid AC table")
    per = restart or len(units)
    for i in range(0, len(units), per):
        bits = _Bits(intervals[i // per] if i // per < len(intervals)
                     else b"")
        pred = [0] * len(comps)
        st = {"eobrun": 0}
        for unit in units[i:i + per]:
            for ci, by, bx in unit:
                block = coefs[ci][by, bx]
                td, ta = tabs[ci]
                if not prog:
                    _decode_block_baseline(bits, block, pred, ci,
                                           dc_tabs[td], ac_tabs[ta])
                elif ss == 0 and ah == 0:
                    _decode_dc_first(bits, block, pred, ci, dc_tabs[td], al)
                elif ss == 0:
                    if bits.bit():
                        block[0] = _s16(int(block[0]) | 1 << al)
                elif ah == 0:
                    _decode_ac_first(bits, block, st, ac_tabs[ta], ss, se,
                                     al)
                else:
                    _decode_ac_refine(bits, block, st, ac_tabs[ta], ss, se,
                                      al)


def _finish(frame, coefs, latched, jfif, adobe) -> np.ndarray:
    w, h = frame["w"], frame["h"]
    planes = []
    for ci, c in enumerate(frame["comps"]):
        q = latched.get(ci)
        if q is None:
            raise ValueError("JPEG component never scanned")
        blocks = idct_islow(coefs[ci].reshape(-1, 64), q)
        bh, bw = coefs[ci].shape[:2]
        plane = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(
            bh * 8, bw * 8)
        dw = -(-w * c["h"] // frame["hmax"])
        dh = -(-h * c["v"] // frame["vmax"])
        fh, fv = frame["hmax"] // c["h"], frame["vmax"] // c["v"]
        if frame["hmax"] % c["h"] or frame["vmax"] % c["v"]:
            raise ValueError("JPEG with fractional sampling factors")
        planes.append(upsample(plane[:dh, :dw], fh, fv)[:h, :w])
    if len(planes) == 1:
        return planes[0][..., None]
    ids = tuple(c["id"] for c in frame["comps"])
    if jfif:
        rgb_space = False
    elif adobe is not None:
        rgb_space = adobe == 0
    else:
        rgb_space = ids == (82, 71, 66)
    if rgb_space:
        return np.stack(planes, -1)
    return ycc_to_rgb(*planes)


def decode(data: bytes, mode: str) -> np.ndarray:
    """PNG or JPEG bytes -> u8 [H, W, 4] (mode "RGBA") or [H, W, 3]
    ("RGB"), as PIL's convert(mode) gives it."""
    if data[:8] == PNG_SIG:
        samples, meta = png_decode(data)
        return png_convert(samples, meta, mode)
    img = jpeg_decode(data)
    if img.shape[2] == 1:
        img = np.repeat(img, 3, -1)
    if mode == "RGB":
        return img
    return np.concatenate([img, np.full(img.shape[:2] + (1,), 255,
                                        np.uint8)], -1)
