// Host image decoders of pathtracer_torch: PNG (every colour type and bit
// depth, Adam7, PLTE/tRNS), JPEG (baseline, extended 8-bit and progressive
// Huffman, 1 or 3 components, any integral sampling factors, restart
// intervals), TGA (image types 1-3 and 9-11, 1- to 32-bit pixels, 16- and
// 24-bit colour maps, both origins), BMP (core, info and V2-V5 headers,
// 1- to 32-bit pixels, RLE8, RLE4 and BITFIELDS, both row orders) and
// Radiance RGBE scanlines.
//
// The pixels are those of PIL's Image.open(...).convert("RGBA") /
// convert("RGB"): PIL's own conversions for PNG (1/2/4-bit gray scaled,
// 16-bit gray clipped at 255, other 16-bit samples cut to the high byte,
// tRNS keys compared on their low byte), libjpeg's defaults for JPEG
// (JDCT_ISLOW integer IDCT, "fancy" triangle upsampling, fixed-point
// YCbCr -> RGB), and PIL's TgaImagePlugin and BmpImagePlugin for TGA and
// BMP (see the TGA/BMP section). utils/image_plain.py is the plain numpy
// version, step for step; the two agree bit for bit.
//
// Built at first use by utils/native.py:
//   g++ -O3 -std=c++17 -fPIC -shared image_decode.cpp -lz
//
// C interface (return 0 on success; 1 the format is not handled, 2 the
// data is corrupt or truncated, and then `name` (cap bytes) holds the
// format as far as it was read, e.g. "progressive JPEG of 3 components"):
//   pti_probe(data, n, &w, &h, &channels, name, cap)
//       PNG: the file's own channels (1 gray, 2 gray+alpha, 3 RGB or
//       palette, 4 RGBA or palette with tRNS); JPEG: 1 or 3; TGA/BMP: 1
//       gray, 2 gray+alpha, 3 RGB or palette, 4 RGBA or alpha through a
//       palette
//   pti_decode(data, n, w, h, out_channels, out, name, cap)
//       u8 [h, w, out_channels], 3 or 4; w and h are the probe's, and a
//       file whose frame says otherwise is corrupt
//   pti_png_samples(data, n, w, h, out, name, cap)
//       a PNG's own samples, u16 [h, w, file channels] (palette indices)
//   pti_hdr_decode(data, n, w, h, out)      RGBE scanlines -> f32 [h, w, 3]

#include <zlib.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Unsupported : std::runtime_error {
  Unsupported() : std::runtime_error("unsupported") {}
};
struct Corrupt : std::runtime_error {
  Corrupt() : std::runtime_error("corrupt") {}
};

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | p[3];
}
inline uint32_t be16(const uint8_t* p) { return (uint32_t(p[0]) << 8) | p[1]; }

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                          {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                          {0, 1, 1, 2}};

struct Png {
  int w = 0, h = 0, depth = 0, color = 0, interlace = 0;
  std::vector<uint8_t> idat;
  const uint8_t* pal = nullptr;
  int npal = 0;
  const uint8_t* trns = nullptr;
  int ntrns = 0;
  int channels() const {
    switch (color) {
      case 0: case 3: return 1;
      case 2: return 3;
      case 4: return 2;
      default: return 4;
    }
  }
};

bool png_depth_ok(int color, int depth) {
  switch (color) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 ||
                   depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

void png_parse(const uint8_t* d, int64_t n, Png& p, bool with_data,
               std::string& name) {
  if (n < 8 || std::memcmp(d, kPngSig, 8) != 0) throw Unsupported();
  name = "PNG";
  int64_t pos = 8;
  bool first = true;
  while (pos + 8 <= n) {
    uint32_t len = be32(d + pos);
    const uint8_t* type = d + pos + 4;
    const uint8_t* body = d + pos + 8;
    if (pos + 12 + int64_t(len) > n) throw Corrupt();
    if (first) {
      if (std::memcmp(type, "IHDR", 4) != 0 || len != 13) throw Corrupt();
      p.w = int(be32(body));
      p.h = int(be32(body + 4));
      p.depth = body[8];
      p.color = body[9];
      p.interlace = body[12];
      name = "PNG of bit depth " + std::to_string(p.depth) +
             " and colour type " + std::to_string(p.color);
      if (p.interlace == 1)
        name += " (Adam7)";
      else if (p.interlace)
        name += " (interlace method " + std::to_string(p.interlace) + ")";
      if (!png_depth_ok(p.color, p.depth) || body[10] || body[11] ||
          p.interlace > 1 || p.w <= 0 || p.h <= 0)
        throw Unsupported();
      first = false;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      p.pal = body;
      p.npal = int(len / 3);
    } else if (std::memcmp(type, "tRNS", 4) == 0) {
      p.trns = body;
      p.ntrns = int(len);
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      if (with_data) p.idat.insert(p.idat.end(), body, body + len);
    }
    pos += 12 + int64_t(len);
    if (std::memcmp(type, "IEND", 4) == 0) break;
  }
  if (first) throw Corrupt();
  if (p.color == 3 && p.pal == nullptr) throw Corrupt();
}

struct Pass {
  int x0, y0, dx, dy, pw, ph;
  int64_t rowbytes;
};

std::vector<Pass> png_passes(const Png& p) {
  std::vector<Pass> out;
  int np = p.interlace ? 7 : 1;
  for (int i = 0; i < np; ++i) {
    Pass s;
    if (p.interlace) {
      s.x0 = kAdam7[i][0]; s.y0 = kAdam7[i][1];
      s.dx = kAdam7[i][2]; s.dy = kAdam7[i][3];
    } else {
      s.x0 = s.y0 = 0; s.dx = s.dy = 1;
    }
    s.pw = (p.w - s.x0 + s.dx - 1) / s.dx;
    s.ph = (p.h - s.y0 + s.dy - 1) / s.dy;
    if (s.pw <= 0 || s.ph <= 0) continue;
    s.rowbytes = (int64_t(s.pw) * p.channels() * p.depth + 7) / 8;
    out.push_back(s);
  }
  return out;
}

inline int paeth(int a, int b, int c) {
  int pp = a + b - c;
  int pa = std::abs(pp - a), pb = std::abs(pp - b), pc = std::abs(pp - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Unfilter ph rows of rowbytes (each led by its filter byte) in place.
void unfilter(uint8_t* raw, int ph, int64_t rowbytes, int bpp) {
  uint8_t* prev = nullptr;
  for (int y = 0; y < ph; ++y) {
    uint8_t ft = raw[0];
    uint8_t* cur = raw + 1;
    switch (ft) {
      case 0: break;
      case 1:
        for (int64_t i = bpp; i < rowbytes; ++i) cur[i] += cur[i - bpp];
        break;
      case 2:
        if (prev)
          for (int64_t i = 0; i < rowbytes; ++i) cur[i] += prev[i];
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          cur[i] += uint8_t((a + b) >> 1);
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          cur[i] += uint8_t(paeth(a, b, c));
        }
        break;
      default: throw Corrupt();
    }
    prev = cur;
    raw += 1 + rowbytes;
  }
}

inline int sample(const uint8_t* row, int64_t idx, int depth) {
  switch (depth) {
    case 8: return row[idx];
    case 16: return (int(row[2 * idx]) << 8) | row[2 * idx + 1];
    default: {
      int64_t bit = idx * depth;
      int shift = 8 - depth - int(bit & 7);
      return (row[bit >> 3] >> shift) & ((1 << depth) - 1);
    }
  }
}

// The pixels PIL's convert gives (out, out_ch 3 or 4), or the file's own
// samples (samples, u16 [h, w, channels()]) when samples is not null.
void png_decode(const uint8_t* d, int64_t n, int w, int h, int out_ch,
                uint8_t* out, uint16_t* samples, std::string& name) {
  Png p;
  png_parse(d, n, p, true, name);
  if (p.w != w || p.h != h) throw Corrupt();
  std::vector<Pass> passes = png_passes(p);
  int ch = p.channels();
  int bpp = std::max(1, ch * p.depth / 8);
  int64_t total = 0;
  for (const Pass& s : passes) total += int64_t(s.ph) * (1 + s.rowbytes);
  std::vector<uint8_t> raw(static_cast<size_t>(total));
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) throw Corrupt();
  zs.next_in = p.idat.data();
  zs.avail_in = uInt(p.idat.size());
  size_t done = 0;
  int rc = Z_OK;
  while (done < raw.size() && rc == Z_OK) {   // uInt-sized pieces
    const size_t piece = std::min(raw.size() - done, size_t(1) << 30);
    zs.next_out = raw.data() + done;
    zs.avail_out = uInt(piece);
    rc = inflate(&zs, Z_NO_FLUSH);
    done += piece - zs.avail_out;
  }
  inflateEnd(&zs);
  if (done != raw.size()) throw Corrupt();   // image data too short

  // PIL's conversion of each sample kind to 8 bits (see file comment)
  uint8_t pal[256][4];
  for (int i = 0; i < 256; ++i) {
    pal[i][0] = pal[i][1] = pal[i][2] = 0;
    pal[i][3] = 255;
  }
  if (p.color == 3) {
    for (int i = 0; i < std::min(p.npal, 256); ++i)
      for (int c = 0; c < 3; ++c) pal[i][c] = p.pal[3 * i + c];
    if (p.trns)
      for (int i = 0; i < std::min(p.ntrns, 256); ++i) pal[i][3] = p.trns[i];
  }
  int gray_key = -1, rgb_key[3] = {-1, -1, -1};
  if (p.color == 0 && p.trns && p.ntrns >= 2) {
    int key = int(be16(p.trns));
    gray_key = p.depth == 1 ? (key ? 255 : 0) : (key & 255);
  }
  if (p.color == 2 && p.trns && p.ntrns >= 6)
    for (int c = 0; c < 3; ++c) rgb_key[c] = int(be16(p.trns + 2 * c)) & 255;
  const int gray_scale = p.depth == 1 ? 255 : p.depth == 2 ? 85
                         : p.depth == 4 ? 17 : 1;
  const int wide = p.depth == 16 ? 8 : 0;

  uint8_t* rows = raw.data();
  for (const Pass& s : passes) {
    unfilter(rows, s.ph, s.rowbytes, bpp);
    for (int py = 0; py < s.ph; ++py) {
      const uint8_t* row = rows + int64_t(py) * (1 + s.rowbytes) + 1;
      int y = s.y0 + py * s.dy;
      for (int px = 0; px < s.pw; ++px) {
        int x = s.x0 + px * s.dx;
        int64_t i0 = int64_t(px) * ch;
        if (samples) {
          uint16_t* o = samples + (int64_t(y) * p.w + x) * ch;
          for (int c = 0; c < ch; ++c) o[c] = uint16_t(sample(row, i0 + c,
                                                              p.depth));
          continue;
        }
        int r, g, b, a = 255;
        switch (p.color) {
          case 3: {
            int idx = sample(row, i0, p.depth);
            r = pal[idx][0]; g = pal[idx][1]; b = pal[idx][2]; a = pal[idx][3];
            break;
          }
          case 0: case 4: {
            int v = sample(row, i0, p.depth);
            if (p.depth == 16)
              v = p.color == 0 ? std::min(v, 255) : v >> 8;
            else
              v *= gray_scale;
            r = g = b = v;
            if (p.color == 4)
              a = sample(row, i0 + 1, p.depth) >> wide;
            else if (v == gray_key)
              a = 0;
            break;
          }
          default: {
            r = sample(row, i0, p.depth) >> wide;
            g = sample(row, i0 + 1, p.depth) >> wide;
            b = sample(row, i0 + 2, p.depth) >> wide;
            if (p.color == 6)
              a = sample(row, i0 + 3, p.depth) >> wide;
            else if (r == rgb_key[0] && g == rgb_key[1] && b == rgb_key[2])
              a = 0;
          }
        }
        uint8_t* o = out + (int64_t(y) * p.w + x) * out_ch;
        o[0] = uint8_t(r); o[1] = uint8_t(g); o[2] = uint8_t(b);
        if (out_ch == 4) o[3] = uint8_t(a);
      }
    }
    rows += int64_t(s.ph) * (1 + s.rowbytes);
  }
}

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------

// zigzag index -> natural index, with libjpeg's 16 extra entries that
// absorb a corrupt run past the end of a block
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
  bool present = false;
  bool oversubscribed = false;   // a code runs out of its length
  int max_sym = 0;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t syms[256];
  uint16_t fast[1 << 9];   // (length << 8) | symbol, 0: longer than 9 bits

  void build(const uint8_t* counts, const uint8_t* s, int nsym) {
    std::memcpy(syms, s, size_t(nsym));
    std::memset(fast, 0, sizeof(fast));
    max_sym = 0;
    for (int i = 0; i < nsym; ++i) max_sym = std::max(max_sym, int(s[i]));
    oversubscribed = false;
    int32_t code = 0;
    int k = 0;
    for (int l = 1; l <= 16; ++l) {
      valoffset[l] = k - code;
      if (counts[l - 1]) {
        for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
          if (l <= 9) {
            int lo = code << (9 - l), hi = (code + 1) << (9 - l);
            for (int j = lo; j < hi && j < (1 << 9); ++j)
              fast[j] = uint16_t((l << 8) | syms[k]);
          }
        }
        maxcode[l] = code - 1;
      } else {
        maxcode[l] = -1;
      }
      // jdhuff.c refuses the all-ones code and past it (JERR_BAD_HUFF_TABLE)
      if (code >= (int32_t(1) << l)) oversubscribed = true;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    present = true;
  }
};

// MSB-first bits of one restart interval's unstuffed bytes; zeros past the
// end (libjpeg's behaviour on a short scan)
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int n = 0;
  Bits(const uint8_t* b, const uint8_t* e) : p(b), end(e) {}
  inline void fill() {
    while (n <= 56) {
      uint64_t b = p < end ? *p++ : 0;
      acc |= b << (56 - n);
      n += 8;
    }
  }
  inline int get(int k) {
    if (k == 0) return 0;
    fill();
    int v = int(acc >> (64 - k));
    acc <<= k;
    n -= k;
    return v;
  }
  inline int bit() { return get(1); }
  inline int huff(const Huff& t) {
    fill();
    int f = t.fast[acc >> (64 - 9)];
    if (f) {
      int l = f >> 8;
      acc <<= l;
      n -= l;
      return f & 255;
    }
    int l = 10;
    int32_t code = int32_t(acc >> (64 - l));
    while (code > t.maxcode[l]) {
      ++l;
      if (l > 16) throw Corrupt();
      code = int32_t(acc >> (64 - l));
    }
    acc <<= l;
    n -= l;
    return t.syms[(code + t.valoffset[l]) & 255];
  }
  inline int extend(int s) {
    int v = get(s);
    return (s && v < (1 << (s - 1))) ? v - (1 << s) + 1 : v;
  }
};

struct Comp {
  int id, h, v, tq;
  int bw, bh;          // blocks with data (ceil of the component's size)
  int aw, ah;          // blocks allocated (whole MCUs)
  std::vector<int16_t> coef;   // libjpeg's JCOEF: stores wrap to 16 bits
  int32_t quant[64];
  bool latched = false;
};

struct Jpeg {
  int w = 0, h = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool progressive = false, have_frame = false, jfif = false;
  int adobe = -1;
  int restart = 0;
  int32_t quant[4][64];
  bool have_quant[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  std::vector<Comp> comps;
};

struct ScanComp {
  int ci, td, ta;
};

// Entropy-coded data from pos: unstuffed bytes and the start of each
// restart interval; returns the position of the next marker.
int64_t scan_intervals(const uint8_t* d, int64_t n, int64_t pos,
                       std::vector<uint8_t>& buf,
                       std::vector<size_t>& starts) {
  buf.clear();
  starts.assign(1, 0);
  while (pos < n) {
    uint8_t b = d[pos];
    if (b != 0xFF) {
      buf.push_back(b);
      ++pos;
      continue;
    }
    uint8_t nxt = pos + 1 < n ? d[pos + 1] : 0xD9;
    if (nxt == 0x00) {
      buf.push_back(0xFF);
      pos += 2;
    } else if (nxt == 0xFF) {
      pos += 1;
    } else if (nxt >= 0xD0 && nxt <= 0xD7) {
      starts.push_back(buf.size());
      pos += 2;
    } else {
      break;
    }
  }
  return pos;
}

struct Unit {
  int ci, by, bx;
};

void decode_scan(Jpeg& j, const std::vector<ScanComp>& sc,
                 const std::vector<uint8_t>& buf,
                 const std::vector<size_t>& starts, int ss, int se, int ah,
                 int al) {
  // the block order of the scan, one MCU (a list of blocks) at a time
  std::vector<Unit> units;
  int per_mcu;
  if (sc.size() == 1) {
    const Comp& c = j.comps[sc[0].ci];
    per_mcu = 1;
    units.reserve(size_t(c.bh) * c.bw);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx) units.push_back({sc[0].ci, by, bx});
  } else {
    per_mcu = 0;
    for (const ScanComp& s : sc) per_mcu += j.comps[s.ci].h * j.comps[s.ci].v;
    units.reserve(size_t(j.mcux) * j.mcuy * per_mcu);
    for (int my = 0; my < j.mcuy; ++my)
      for (int mx = 0; mx < j.mcux; ++mx)
        for (const ScanComp& s : sc) {
          const Comp& c = j.comps[s.ci];
          for (int by = 0; by < c.v; ++by)
            for (int bx = 0; bx < c.h; ++bx)
              units.push_back({s.ci, my * c.v + by, mx * c.h + bx});
        }
  }
  int td[4] = {0, 0, 0, 0}, ta[4] = {0, 0, 0, 0};
  for (const ScanComp& s : sc) {
    td[s.ci] = s.td;
    ta[s.ci] = s.ta;
    bool need_dc = !j.progressive || (ss == 0 && ah == 0);
    bool need_ac = !j.progressive || ss > 0;
    // as jdhuff.c checks a table where a scan starts to use it: DC
    // magnitudes above 15 and oversubscribed codes are corrupt
    const Huff& dct = j.dc[s.td];
    const Huff& act = j.ac[s.ta];
    if ((need_dc && (!dct.present || dct.oversubscribed || dct.max_sym > 15))
        || (need_ac && (!act.present || act.oversubscribed)))
      throw Corrupt();
  }
  size_t n_mcu = units.size() / size_t(per_mcu);
  size_t per = j.restart ? size_t(j.restart) : n_mcu;
  const int32_t p1 = 1 << al;
  for (size_t m0 = 0, iv = 0; m0 < n_mcu; m0 += per, ++iv) {
    const uint8_t* b0 = buf.data();
    const uint8_t* beg =
        iv < starts.size() ? b0 + starts[iv] : b0 + buf.size();
    const uint8_t* end = iv + 1 < starts.size() ? b0 + starts[iv + 1]
                                                 : b0 + buf.size();
    Bits bits(beg, end);
    uint32_t pred[4] = {0, 0, 0, 0};   // wraps, as in libjpeg-turbo
    int eobrun = 0;
    size_t m1 = std::min(n_mcu, m0 + per);
    for (size_t u = m0 * per_mcu; u < m1 * per_mcu; ++u) {
      const Unit& un = units[u];
      Comp& c = j.comps[un.ci];
      int16_t* blk = c.coef.data() + (size_t(un.by) * c.aw + un.bx) * 64;
      if (!j.progressive) {
        int t = bits.huff(j.dc[td[un.ci]]);
        pred[un.ci] += uint32_t(bits.extend(t));
        blk[0] = int16_t(pred[un.ci]);
        const Huff& act = j.ac[ta[un.ci]];
        for (int k = 1; k < 64;) {
          int rs = bits.huff(act);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            blk[kNatural[k]] = int16_t(bits.extend(s));
            ++k;
          } else if (r == 15) {
            k += 16;
          } else {
            break;
          }
        }
      } else if (ss == 0 && ah == 0) {
        int t = bits.huff(j.dc[td[un.ci]]);
        pred[un.ci] += uint32_t(bits.extend(t));
        blk[0] = int16_t(pred[un.ci] << al);
      } else if (ss == 0) {
        if (bits.bit()) blk[0] = int16_t(blk[0] | p1);
      } else if (ah == 0) {
        if (eobrun) {
          --eobrun;
          continue;
        }
        const Huff& act = j.ac[ta[un.ci]];
        for (int k = ss; k <= se; ++k) {
          int rs = bits.huff(act);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            blk[kNatural[k]] = int16_t(uint32_t(bits.extend(s)) << al);
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = (1 << r) - 1 + bits.get(r);
            break;
          }
        }
      } else {
        const Huff& act = j.ac[ta[un.ci]];
        int k = ss;
        auto refine = [&](int z) {
          int32_t v = blk[z];
          if (bits.bit() && (v & p1) == 0)
            blk[z] = int16_t(v >= 0 ? v + p1 : v - p1);
        };
        if (!eobrun) {
          for (; k <= se; ++k) {
            int rs = bits.huff(act);
            int r = rs >> 4, s = rs & 15;
            int32_t val = 0;
            if (s) {
              val = bits.bit() ? p1 : -p1;
            } else if (r != 15) {
              eobrun = (1 << r) + bits.get(r);
              break;
            }
            while (k <= se) {
              int z = kNatural[k];
              if (blk[z]) {
                refine(z);
              } else {
                if (r == 0) break;
                --r;
              }
              ++k;
            }
            if (val && k <= se) blk[kNatural[k]] = int16_t(val);
          }
        }
        if (eobrun) {
          for (; k <= se; ++k)
            if (blk[kNatural[k]]) refine(kNatural[k]);
          --eobrun;
        }
      }
    }
  }
}

// libjpeg's jpeg_idct_islow (jidctint.c) on one block of dequantized
// coefficients, its output saturated; out: 8 rows of 8 samples, row
// stride `stride`
void idct_islow(const int16_t* coef, const int32_t* q, uint8_t* out,
                int64_t stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; ++c) {
    int64_t d[8];
    for (int k = 0; k < 8; ++k) d[k] = int64_t(coef[k * 8 + c]) * q[k * 8 + c];
    int64_t z1 = (d[2] + d[6]) * 4433;
    int64_t tmp2 = z1 + d[6] * -15137, tmp3 = z1 + d[2] * 6270;
    int64_t tmp0 = (d[0] + d[4]) * 8192, tmp1 = (d[0] - d[4]) * 8192;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    int64_t t0 = d[7], t1 = d[5], t2 = d[3], t3 = d[1];
    z1 = t0 + t3;
    int64_t z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
    int64_t z5 = (z3 + z4) * 9633;
    t0 *= 2446; t1 *= 16819; t2 *= 25172; t3 *= 12299;
    z1 *= -7373; z2 *= -20995;
    z3 = z3 * -16069 + z5;
    z4 = z4 * -3196 + z5;
    t0 += z1 + z3; t1 += z2 + z4; t2 += z2 + z3; t3 += z1 + z4;
    const int64_t r = int64_t(1) << 10;
    ws[0 * 8 + c] = (tmp10 + t3 + r) >> 11;
    ws[7 * 8 + c] = (tmp10 - t3 + r) >> 11;
    ws[1 * 8 + c] = (tmp11 + t2 + r) >> 11;
    ws[6 * 8 + c] = (tmp11 - t2 + r) >> 11;
    ws[2 * 8 + c] = (tmp12 + t1 + r) >> 11;
    ws[5 * 8 + c] = (tmp12 - t1 + r) >> 11;
    ws[3 * 8 + c] = (tmp13 + t0 + r) >> 11;
    ws[4 * 8 + c] = (tmp13 - t0 + r) >> 11;
  }
  for (int row = 0; row < 8; ++row) {
    const int64_t* d = ws + row * 8;
    int64_t z1 = (d[2] + d[6]) * 4433;
    int64_t tmp2 = z1 + d[6] * -15137, tmp3 = z1 + d[2] * 6270;
    int64_t tmp0 = (d[0] + d[4]) * 8192, tmp1 = (d[0] - d[4]) * 8192;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    int64_t t0 = d[7], t1 = d[5], t2 = d[3], t3 = d[1];
    z1 = t0 + t3;
    int64_t z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
    int64_t z5 = (z3 + z4) * 9633;
    t0 *= 2446; t1 *= 16819; t2 *= 25172; t3 *= 12299;
    z1 *= -7373; z2 *= -20995;
    z3 = z3 * -16069 + z5;
    z4 = z4 * -3196 + z5;
    t0 += z1 + z3; t1 += z2 + z4; t2 += z2 + z3; t3 += z1 + z4;
    const int64_t vals[8] = {tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                             tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3};
    uint8_t* o = out + row * stride;
    for (int k = 0; k < 8; ++k) {
      // saturated, as libjpeg-turbo's SIMD IDCTs (PIL's) pack it; the C
      // IDCT's range-limit table would wrap past +-512 instead
      int64_t v = ((vals[k] + (int64_t(1) << 17)) >> 18) + 128;
      o[k] = uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
}

// A component's samples [dh][dw] -> [dh * fv][dw * fh] (jdsample.c: fancy
// triangle filters for 2:1 factors, box replication else)
std::vector<uint8_t> upsample(const std::vector<uint8_t>& x, int dh, int dw,
                              int fh, int fv) {
  if (fh == 1 && fv == 1) return x;
  std::vector<uint8_t> out(size_t(dh) * fv * dw * fh);
  const int ow = dw * fh;
  auto at = [&](int y, int xx) -> int {
    y = y < 0 ? 0 : y >= dh ? dh - 1 : y;
    xx = xx < 0 ? 0 : xx >= dw ? dw - 1 : xx;
    return x[size_t(y) * dw + xx];
  };
  if (fh == 1 && fv == 2) {
    for (int y = 0; y < dh; ++y)
      for (int i = 0; i < dw; ++i) {
        int c = 3 * at(y, i);
        out[size_t(2 * y) * ow + i] = uint8_t((c + at(y - 1, i) + 1) >> 2);
        out[size_t(2 * y + 1) * ow + i] = uint8_t((c + at(y + 1, i) + 2) >> 2);
      }
    return out;
  }
  if (fh == 2 && fv == 1 && dw > 2) {
    for (int y = 0; y < dh; ++y)
      for (int i = 0; i < dw; ++i) {
        int c = 3 * at(y, i);
        out[size_t(y) * ow + 2 * i] = uint8_t((c + at(y, i - 1) + 1) >> 2);
        out[size_t(y) * ow + 2 * i + 1] = uint8_t((c + at(y, i + 1) + 2) >> 2);
      }
    return out;
  }
  if (fh == 2 && fv == 2 && dw > 2) {
    std::vector<int> cs(static_cast<size_t>(dw));
    for (int y = 0; y < 2 * dh; ++y) {
      int ny = (y & 1) ? y / 2 + 1 : y / 2 - 1;
      for (int i = 0; i < dw; ++i) cs[i] = 3 * at(y / 2, i) + at(ny, i);
      uint8_t* o = out.data() + size_t(y) * ow;
      for (int i = 0; i < dw; ++i) {
        int l = cs[i > 0 ? i - 1 : 0], r = cs[i + 1 < dw ? i + 1 : dw - 1];
        o[2 * i] = uint8_t((3 * cs[i] + l + 8) >> 4);
        o[2 * i + 1] = uint8_t((3 * cs[i] + r + 7) >> 4);
      }
    }
    return out;
  }
  for (int y = 0; y < dh * fv; ++y)
    for (int i = 0; i < ow; ++i) out[size_t(y) * ow + i] = at(y / fv, i / fh);
  return out;
}

// Name the frame a SOF marker m starts and refuse what the
// decoder does not take: arithmetic coding, lossless and hierarchical
// processes, precisions other than 8 bits, CMYK/YCCK and other component
// counts, and a height left to a DNL marker.
void name_frame(const Jpeg& j, int m, const uint8_t* body, int64_t blen,
                std::string& name) {
  const std::string sof = " (SOF" + std::to_string(m - 0xC0) + ")";
  if (m >= 0xC9) {
    name = "arithmetic-coded JPEG" + sof;
    throw Unsupported();
  }
  if (m == 0xC3 || (m >= 0xC5 && m <= 0xC7)) {
    name = m == 0xC3 ? "lossless JPEG" : m == 0xC5 ? "hierarchical JPEG"
             : m == 0xC6 ? "hierarchical progressive JPEG"
                         : "hierarchical lossless JPEG";
    name += sof;
    throw Unsupported();
  }
  if (blen < 6) throw Corrupt();
  if (body[0] != 8) {
    name = std::to_string(body[0]) + "-bit JPEG" + sof;
    throw Unsupported();
  }
  const int nc = body[5];
  if (nc != 1 && nc != 3) {
    name = nc == 4 ? (j.adobe == 2 ? "YCCK JPEG" : "CMYK JPEG")
                     : std::to_string(nc) + "-component JPEG";
    throw Unsupported();
  }
  name = std::string(m == 0xC2 ? "progressive" : "baseline") +
           " JPEG of " + std::to_string(nc) +
           (nc > 1 ? " components" : " component");
  if (be16(body + 1) == 0) {
    name += " whose height a DNL marker gives";
    throw Unsupported();
  }
}

void jpeg_parse(const uint8_t* d, int64_t n, Jpeg& j, bool with_data,
                std::string& name) {
  if (n < 3 || d[0] != 0xFF || d[1] != 0xD8) throw Unsupported();
  name = "JPEG";
  int64_t pos = 2;
  bool eoi = false;
  std::vector<uint8_t> buf;
  std::vector<size_t> starts;
  while (pos < n) {
    if (d[pos] != 0xFF) {   // garbage between segments
      ++pos;
      continue;
    }
    if (pos + 1 >= n) break;
    int m = d[pos + 1];
    if (m == 0xFF) {
      ++pos;
      continue;
    }
    if (m == 0xD9) {
      eoi = true;
      break;
    }
    if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {
      pos += 2;
      continue;
    }
    if (pos + 4 > n) throw Corrupt();
    int64_t len = be16(d + pos + 2);
    if (len < 2 || pos + 2 + len > n) throw Corrupt();
    const uint8_t* body = d + pos + 4;
    int64_t blen = len - 2;
    pos += 2 + len;
    if (m == 0xDB) {
      for (int64_t i = 0; i < blen;) {
        int pq = body[i] >> 4, tq = body[i] & 15;
        if (tq > 3 || i + 1 + 64 * (pq ? 2 : 1) > blen) throw Corrupt();
        for (int k = 0; k < 64; ++k)
          j.quant[tq][kNatural[k]] =
              pq ? int32_t(be16(body + i + 1 + 2 * k)) : body[i + 1 + k];
        j.have_quant[tq] = true;
        i += 1 + 64 * (pq ? 2 : 1);
      }
    } else if (m == 0xC4) {
      for (int64_t i = 0; i < blen;) {
        if (i + 17 > blen) throw Corrupt();
        int tc = body[i] >> 4, th = body[i] & 15;
        int nsym = 0;
        for (int k = 0; k < 16; ++k) nsym += body[i + 1 + k];
        if (th > 3 || tc > 1 || nsym > 256 || i + 17 + nsym > blen)
          throw Corrupt();
        (tc ? j.ac : j.dc)[th].build(body + i + 1, body + i + 17, nsym);
        i += 17 + nsym;
      }
    } else if (m == 0xDD) {
      if (blen < 2) throw Corrupt();
      j.restart = int(be16(body));
    } else if (m == 0xE0 && blen >= 5 && std::memcmp(body, "JFIF\0", 5) == 0) {
      j.jfif = true;
    } else if (m == 0xEE && blen >= 12 && std::memcmp(body, "Adobe", 5) == 0) {
      j.adobe = body[11];
    } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 &&
               m != 0xCC) {
      // one frame a file (libjpeg: JERR_SOF_DUPLICATE): a second one
      // would change the size the caller's buffer was made for
      if (j.have_frame) throw Corrupt();
      name_frame(j, m, body, blen, name);
      j.h = int(be16(body + 1));
      j.w = int(be16(body + 3));
      int nc = body[5];
      if (blen < 6 + 3 * nc || j.w == 0) throw Corrupt();
      j.comps.assign(size_t(nc), Comp());
      j.hmax = j.vmax = 1;
      for (int c = 0; c < nc; ++c) {
        Comp& cp = j.comps[c];
        cp.id = body[6 + 3 * c];
        cp.h = body[7 + 3 * c] >> 4;
        cp.v = body[7 + 3 * c] & 15;
        cp.tq = body[8 + 3 * c];
        if (cp.h < 1 || cp.h > 4 || cp.v < 1 || cp.v > 4 || cp.tq > 3)
          throw Corrupt();
        j.hmax = std::max(j.hmax, cp.h);
        j.vmax = std::max(j.vmax, cp.v);
      }
      j.mcux = (j.w + 8 * j.hmax - 1) / (8 * j.hmax);
      j.mcuy = (j.h + 8 * j.vmax - 1) / (8 * j.vmax);
      for (Comp& cp : j.comps) {
        if (j.hmax % cp.h || j.vmax % cp.v) {
          name = "JPEG with fractional sampling factors";
          throw Unsupported();
        }
        cp.bw = int((int64_t(j.w) * cp.h + 8 * j.hmax - 1) / (8 * j.hmax));
        cp.bh = int((int64_t(j.h) * cp.v + 8 * j.vmax - 1) / (8 * j.vmax));
        cp.aw = j.mcux * cp.h;
        cp.ah = j.mcuy * cp.v;
        if (with_data) cp.coef.assign(size_t(cp.aw) * cp.ah * 64, 0);
      }
      j.progressive = m == 0xC2;
      j.have_frame = true;
      if (!with_data) return;
    } else if (m == 0xDA) {
      if (!j.have_frame || blen < 1) throw Corrupt();
      int ns = body[0];
      if (ns < 1 || ns > 4 || blen < 4 + 2 * ns) throw Corrupt();
      std::vector<ScanComp> sc;
      for (int k = 0; k < ns; ++k) {
        int cid = body[1 + 2 * k], tables = body[2 + 2 * k];
        int ci = -1;
        for (size_t c = 0; c < j.comps.size(); ++c)
          if (j.comps[c].id == cid) ci = int(c);
        if (ci < 0 || (tables >> 4) > 3 || (tables & 15) > 3) throw Corrupt();
        Comp& cp = j.comps[ci];
        if (!cp.latched) {
          if (!j.have_quant[cp.tq]) throw Corrupt();
          std::memcpy(cp.quant, j.quant[cp.tq], sizeof(cp.quant));
          cp.latched = true;
        }
        sc.push_back({ci, tables >> 4, tables & 15});
      }
      int ss = body[1 + 2 * ns], se = body[2 + 2 * ns];
      int ah = body[3 + 2 * ns] >> 4, al = body[3 + 2 * ns] & 15;
      if (ss > 63 || se > 63 || al > 13) throw Corrupt();
      if (j.progressive && ss > 0 && ns != 1) throw Corrupt();
      pos = scan_intervals(d, n, pos, buf, starts);
      decode_scan(j, sc, buf, starts, ss, se, ah, al);
    }
  }
  // a file cut short (no EOI) is an error, as it is in PIL
  if (!j.have_frame || !eoi) throw Corrupt();
}

void jpeg_decode(const uint8_t* d, int64_t n, int w, int h, int out_ch,
                 uint8_t* out, std::string& name) {
  Jpeg j;
  jpeg_parse(d, n, j, true, name);
  if (j.w != w || j.h != h) throw Corrupt();
  std::vector<std::vector<uint8_t>> planes;
  for (Comp& c : j.comps) {
    if (!c.latched) throw Corrupt();
    const int64_t pw = int64_t(c.aw) * 8;
    std::vector<uint8_t> plane(size_t(pw) * c.ah * 8);
    for (int by = 0; by < c.ah; ++by)
      for (int bx = 0; bx < c.aw; ++bx)
        idct_islow(c.coef.data() + (size_t(by) * c.aw + bx) * 64, c.quant,
                   plane.data() + int64_t(by) * 8 * pw + bx * 8, pw);
    std::vector<int16_t>().swap(c.coef);
    const int dw = int((int64_t(w) * c.h + j.hmax - 1) / j.hmax);
    const int dh = int((int64_t(h) * c.v + j.vmax - 1) / j.vmax);
    std::vector<uint8_t> crop(size_t(dw) * dh);
    for (int y = 0; y < dh; ++y)
      std::memcpy(crop.data() + size_t(y) * dw, plane.data() + y * pw,
                  size_t(dw));
    const int fh = j.hmax / c.h, fv = j.vmax / c.v;
    std::vector<uint8_t> up = upsample(crop, dh, dw, fh, fv);
    const int uw = dw * fh;
    std::vector<uint8_t> full(size_t(w) * h);
    for (int y = 0; y < h; ++y)
      std::memcpy(full.data() + size_t(y) * w, up.data() + size_t(y) * uw,
                  size_t(w));
    planes.push_back(std::move(full));
  }
  const size_t npx = size_t(w) * h;
  if (planes.size() == 1) {
    for (size_t i = 0; i < npx; ++i) {
      uint8_t* o = out + i * out_ch;
      o[0] = o[1] = o[2] = planes[0][i];
      if (out_ch == 4) o[3] = 255;
    }
    return;
  }
  bool rgb_space;
  if (j.jfif)
    rgb_space = false;
  else if (j.adobe >= 0)
    rgb_space = j.adobe == 0;
  else
    rgb_space = j.comps[0].id == 82 && j.comps[1].id == 71 &&
                j.comps[2].id == 66;
  // jdcolor.c's build_ycc_rgb_table, SCALEBITS 16
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    int64_t x = i - 128;
    cr_r[i] = int((91881 * x + (1 << 15)) >> 16);
    cb_b[i] = int((116130 * x + (1 << 15)) >> 16);
    cr_g[i] = -46802 * x;
    cb_g[i] = -22554 * x + (1 << 15);
  }
  auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
  for (size_t i = 0; i < npx; ++i) {
    uint8_t* o = out + i * out_ch;
    int y = planes[0][i], cb = planes[1][i], cr = planes[2][i];
    if (rgb_space) {
      o[0] = uint8_t(y); o[1] = uint8_t(cb); o[2] = uint8_t(cr);
    } else {
      o[0] = clamp(y + cr_r[cr]);
      o[1] = clamp(y + int((cb_g[cb] + cr_g[cr]) >> 16));
      o[2] = clamp(y + cb_b[cb]);
    }
    if (out_ch == 4) o[3] = 255;
  }
}

// ---------------------------------------------------------------------------
// TGA and BMP, as PIL's TgaImagePlugin and BmpImagePlugin read them
// ---------------------------------------------------------------------------
//
// Both read into PIL's image modes (Pil: "1" as 0/255, L, LA, P with a
// palette, L/LA read through a TGA colour map, RGB, RGBA), which
// pil_convert turns into convert("RGBA") / convert("RGB"). The rules are
// PIL's (utils/image_plain.py lists them): 5- and 6-bit channels scale by
// v * 255 / 31 and v * 255 / 63, a palette index past the palette is
// black and opaque, a 16-bit TGA pixel is opaque where its top bit is
// clear, a BMP palette of gray ramp entries makes an L or "1" image read
// with the file's bytes as 8- or 1-bit pixels, a BMP RLE stream is walked
// as BmpRleDecoder walks it and a TGA one as PIL's tga_rle decoder does.

constexpr int64_t kMaxPixels = 2 * int64_t(89478485);   // PIL's bomb limit

// PIL raw modes of the two formats
enum Raw {
  kRawP, kRawL, kRawLA, kRaw1, kRawP1, kRawP4, kRawBGRA15Z, kRawBGR15,
  kRawBGR16, kRawBytes
};

struct RawMode {
  Raw kind = kRawP;
  int n = 1;                       // bytes a pixel (kRawBytes: 3 or 4)
  int r = 2, g = 1, b = 0, a = -1;  // kRawBytes: byte of each channel
};

RawMode bytes_mode(const char* order) {   // e.g. "BGRX": B, G, R, pad
  RawMode m;
  m.kind = kRawBytes;
  m.n = int(std::strlen(order));
  for (int i = 0; i < m.n; ++i) {
    if (order[i] == 'R') m.r = i;
    if (order[i] == 'G') m.g = i;
    if (order[i] == 'B') m.b = i;
    if (order[i] == 'A') m.a = i;
  }
  return m;
}

RawMode simple_mode(Raw kind) {
  RawMode m;
  m.kind = kind;
  m.n = (kind == kRawLA || kind == kRawBGRA15Z || kind == kRawBGR15 ||
         kind == kRawBGR16) ? 2 : 1;
  return m;
}

// bytes of a row of w pixels in raw mode m
int64_t row_bytes(const RawMode& m, int64_t w) {
  if (m.kind == kRaw1 || m.kind == kRawP1) return (w + 7) / 8;
  if (m.kind == kRawP4) return (w * 4 + 7) / 8;
  return w * m.n;
}

// channels a pixel holds once unpacked (the mode's bands)
int mode_channels(const RawMode& m) {
  switch (m.kind) {
    case kRawLA: return 2;
    case kRawBGRA15Z: return 4;
    case kRawBGR15: case kRawBGR16: return 3;
    case kRawBytes: return m.a >= 0 ? 4 : 3;
    default: return 1;
  }
}

inline int scale5(int v) { return v * 255 / 31; }

// one row of w pixels from src (raw mode m) into dst (mode_channels a px)
void unpack_row(const RawMode& m, const uint8_t* src, int64_t w,
                uint8_t* dst) {
  const int ch = mode_channels(m);
  for (int64_t x = 0; x < w; ++x) {
    uint8_t* o = dst + x * ch;
    switch (m.kind) {
      case kRaw1: o[0] = (src[x >> 3] >> (7 - (x & 7))) & 1 ? 255 : 0; break;
      case kRawP1: o[0] = (src[x >> 3] >> (7 - (x & 7))) & 1; break;
      case kRawP4: o[0] = (src[x >> 1] >> ((x & 1) ? 0 : 4)) & 15; break;
      case kRawLA: o[0] = src[2 * x]; o[1] = src[2 * x + 1]; break;
      case kRawBGRA15Z: case kRawBGR15: case kRawBGR16: {
        const int v = src[2 * x] | (src[2 * x + 1] << 8);
        o[2] = uint8_t(scale5(v & 31));
        if (m.kind == kRawBGR16) {
          o[1] = uint8_t(((v >> 5) & 63) * 255 / 63);
          o[0] = uint8_t(scale5((v >> 11) & 31));
        } else {
          o[1] = uint8_t(scale5((v >> 5) & 31));
          o[0] = uint8_t(scale5((v >> 10) & 31));
        }
        if (m.kind == kRawBGRA15Z) o[3] = (v & 0x8000) ? 0 : 255;
        break;
      }
      case kRawBytes: {
        const uint8_t* p = src + x * m.n;
        o[0] = p[m.r];
        o[1] = p[m.g];
        o[2] = p[m.b];
        if (m.a >= 0) o[3] = p[m.a];
        break;
      }
      default: o[0] = src[x];   // P, L
    }
  }
}

// A file read in PIL's terms: w x h pixels of ch bands; with a palette
// (P, or L/LA through a TGA colour map) band 0 indexes it and an LA
// image keeps band 1 as its alpha.
struct Pil {
  int64_t w = 0, h = 0;
  int ch = 1;
  bool has_pal = false;
  uint8_t pal[256][4];
  std::vector<uint8_t> px;

  void reset_palette() {
    for (auto& e : pal) e[0] = e[1] = e[2] = 0, e[3] = 255;
  }
};

// PIL's convert("RGBA") (out_ch 4) / convert("RGB") (out_ch 3)
void pil_convert(const Pil& im, int out_ch, uint8_t* out) {
  const int64_t npx = im.w * im.h;
  for (int64_t i = 0; i < npx; ++i) {
    const uint8_t* p = im.px.data() + i * im.ch;
    uint8_t* o = out + i * out_ch;
    uint8_t a = 255;
    if (im.has_pal) {
      const uint8_t* e = im.pal[p[0]];
      o[0] = e[0]; o[1] = e[1]; o[2] = e[2];
      a = im.ch == 2 ? p[1] : e[3];
    } else if (im.ch <= 2) {
      o[0] = o[1] = o[2] = p[0];
      if (im.ch == 2) a = p[1];
    } else {
      o[0] = p[0]; o[1] = p[1]; o[2] = p[2];
      if (im.ch == 4) a = p[3];
    }
    if (out_ch == 4) o[3] = a;
  }
}

// h rows of raw mode m from d[pos..], stride bytes apart, into im.px;
// bottom_up: the file's first row is the image's last. Every row must be
// there (PIL's raw decoder).
void read_rows(const uint8_t* d, int64_t n, int64_t pos, int64_t stride,
               const RawMode& m, bool bottom_up, Pil& im) {
  const int64_t rb = row_bytes(m, im.w);
  if (pos < 0 || pos + (im.h - 1) * stride + rb > n) throw Corrupt();
  im.px.assign(size_t(im.w * im.h * im.ch), 0);
  for (int64_t y = 0; y < im.h; ++y) {
    const int64_t dy = bottom_up ? im.h - 1 - y : y;
    unpack_row(m, d + pos + y * stride, im.w,
               im.px.data() + dy * im.w * im.ch);
  }
}

bool tga_accept(const uint8_t* d, int64_t n) {
  if (n < 18) return false;
  const int w = d[12] | (d[13] << 8), h = d[14] | (d[15] << 8);
  const int depth = d[16], type = d[2];
  return d[1] <= 1 && w > 0 && h > 0 &&
         (depth == 1 || depth == 8 || depth == 16 || depth == 24 ||
          depth == 32) &&
         (type == 1 || type == 2 || type == 3 || type == 9 || type == 10 ||
          type == 11);
}

// PIL's tga_rle decoder: packets of (count & 0x7f) + 1 pixels of `size`
// bytes, a run (high bit) of one pixel or a literal; a run past a row's
// end is an overrun, a literal goes on over the next rows. Rows in file
// order into rows [h][w * size].
void tga_rle(const uint8_t* d, int64_t n, int64_t pos, int64_t w, int64_t h,
             int size, std::vector<uint8_t>& rows) {
  if (size == 0) throw Corrupt();   // PIL's decoder never fills a 1-bit row
  const int64_t rb = w * size;
  rows.assign(size_t(rb * h), 0);
  int64_t y = 0, x = 0;
  while (y < h) {
    if (pos >= n) throw Corrupt();
    const int head = d[pos];
    int64_t len = int64_t(size) * ((head & 0x7F) + 1);
    if (head & 0x80) {
      if (pos + 1 + size > n || x + len > rb) throw Corrupt();
      uint8_t* o = rows.data() + y * rb + x;
      for (int64_t i = 0; i < len; i += size)
        std::memcpy(o + i, d + pos + 1, size_t(size));
      pos += 1 + size;
      x += len;
      if (x == rb) x = 0, ++y;
    } else {
      if (pos + 1 + len > n) throw Corrupt();
      int64_t src = pos + 1;
      pos += 1 + len;
      while (len > 0 && y < h) {
        const int64_t m = std::min(len, rb - x);
        std::memcpy(rows.data() + y * rb + x, d + src, size_t(m));
        src += m;
        len -= m;
        x += m;
        if (x == rb) x = 0, ++y;
      }
    }
  }
}

// A TGA's header, colour map and mode (PIL's TgaImageFile), and with
// `with_data` its pixels.
void tga_read(const uint8_t* d, int64_t n, bool with_data, Pil& im,
              std::string& name) {
  const int id_len = d[0], cmap_type = d[1], type = d[2];
  const int cstart = d[3] | (d[4] << 8), clen = d[5] | (d[6] << 8);
  const int cdepth = d[7], depth = d[16], flags = d[17];
  im.w = d[12] | (d[13] << 8);
  im.h = d[14] | (d[15] << 8);
  static const char* kKinds[] = {"", "colour-mapped", "true-colour", "gray"};
  name = std::to_string(depth) + "-bit " + kKinds[type & 7] +
         ((type & 8) ? " RLE" : "") + " TGA";
  if (im.w * im.h > kMaxPixels) throw Corrupt();
  int64_t pos = 18 + id_len;
  im.reset_palette();
  if (cmap_type) {
    if (cdepth != 16 && cdepth != 24) {
      name += " with a " + std::to_string(cdepth) + "-bit colour map";
      throw Unsupported();
    }
    const RawMode pm = cdepth == 16 ? simple_mode(kRawBGRA15Z)
                                    : bytes_mode("BGR");
    const int64_t eb = pm.n;
    if (pos + eb * clen > n) throw Corrupt();
    if (cstart + clen > 256) {
      name += " with a colour map of " + std::to_string(cstart + clen) +
              " entries";
      throw Unsupported();
    }
    uint8_t px[4] = {0, 0, 0, 255};
    for (int i = 0; i < clen; ++i) {
      unpack_row(pm, d + pos + eb * i, 1, px);
      uint8_t* e = im.pal[cstart + i];
      e[0] = px[0]; e[1] = px[1]; e[2] = px[2];
      e[3] = cdepth == 16 ? px[3] : 255;
    }
    pos += eb * clen;
    im.has_pal = true;
  }
  RawMode m;
  const int key = ((type & 7) << 8) | depth;
  switch (key) {
    case (1 << 8) | 8: m = simple_mode(kRawP); break;
    case (3 << 8) | 1: m = simple_mode(kRaw1); break;
    case (3 << 8) | 8: m = simple_mode(kRawL); break;
    case (3 << 8) | 16: m = simple_mode(kRawLA); break;
    case (2 << 8) | 16: m = simple_mode(kRawBGRA15Z); break;
    case (2 << 8) | 24: m = bytes_mode("BGR"); break;
    case (2 << 8) | 32: m = bytes_mode("BGRA"); break;
    default: throw Unsupported();
  }
  if (m.kind == kRawP && !cmap_type) {
    name += " without a colour map";
    throw Unsupported();
  }
  if (cmap_type && m.kind != kRawP && m.kind != kRawL && m.kind != kRawLA) {
    name += " with a colour map";
    throw Unsupported();
  }
  im.ch = mode_channels(m);
  if (!with_data) return;
  const bool bottom_up = !(flags & 0x20);
  if (type & 8) {
    std::vector<uint8_t> rows;
    tga_rle(d, n, pos, im.w, im.h, depth / 8, rows);
    read_rows(rows.data(), int64_t(rows.size()), 0, im.w * (depth / 8), m,
              bottom_up, im);
  } else {
    read_rows(d, n, pos, row_bytes(m, im.w), m, bottom_up, im);
  }
  if (flags & 0x10)   // PIL's FLIP_LEFT_RIGHT after the load
    for (int64_t y = 0; y < im.h; ++y) {
      uint8_t* row = im.px.data() + y * im.w * im.ch;
      for (int64_t a = 0, b = im.w - 1; a < b; ++a, --b)
        for (int c = 0; c < im.ch; ++c)
          std::swap(row[a * im.ch + c], row[b * im.ch + c]);
    }
}

inline uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}
inline uint32_t le16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }

// PIL's BmpRleDecoder from d[pos..]: indices [h][w] in file row order
void bmp_rle(const uint8_t* d, int64_t n, int64_t pos, int64_t w, int64_t h,
             bool rle4, std::vector<uint8_t>& out) {
  const int64_t total = w * h;
  out.clear();
  out.reserve(size_t(total));
  int64_t x = 0;
  while (int64_t(out.size()) < total) {
    if (pos + 2 > n) break;
    int count = d[pos];
    const int byte = d[pos + 1];
    pos += 2;
    if (count) {                                    // encoded run
      if (x + count > w) count = int(std::max<int64_t>(0, w - x));
      for (int i = 0; i < count; ++i)
        out.push_back(uint8_t(rle4 ? (i % 2 ? byte & 15 : byte >> 4)
                                   : byte));
      x += count;
    } else if (byte == 0) {                         // end of line
      while (int64_t(out.size()) % w) out.push_back(0);
      x = 0;
    } else if (byte == 1) {                         // end of bitmap
      break;
    } else if (byte == 2) {                         // delta: four bytes
      if (pos + 2 > n) break;
      pos += 2;
      if (pos + 2 > n) throw Corrupt();
      const int64_t right = d[pos], up = d[pos + 1];
      pos += 2;
      // only the first w * h indices are read: a delta grows no further
      out.resize(size_t(std::min(int64_t(out.size()) + right + up * w, total)),
                 0);
      x = int64_t(out.size()) % w;
    } else {                                        // absolute run
      const int64_t nb = rle4 ? byte / 2 : byte;
      const int64_t got = std::min(nb, n - pos);
      for (int64_t i = 0; i < got; ++i) {
        const int v = d[pos + i];
        if (rle4) {
          out.push_back(uint8_t(v >> 4));
          out.push_back(uint8_t(v & 15));
        } else {
          out.push_back(uint8_t(v));
        }
      }
      pos += got;
      if (got < nb) break;
      x += byte;
      if (pos % 2) ++pos;
    }
  }
  if (int64_t(out.size()) < total) throw Corrupt();
}

// A BMP's headers, palette and mode (PIL's BmpImageFile), and with
// `with_data` its pixels.
void bmp_read(const uint8_t* d, int64_t n, bool with_data, Pil& im,
              std::string& name) {
  name = "BMP";
  if (n < 18) throw Corrupt();
  int64_t offset = le32(d + 10);
  const uint32_t hsize = le32(d + 14);
  if (hsize != 12 && hsize != 40 && hsize != 52 && hsize != 56 &&
      hsize != 64 && hsize != 108 && hsize != 124) {
    name = "BMP with a " + std::to_string(hsize) + "-byte header";
    throw Unsupported();
  }
  if (n < 14 + int64_t(hsize)) throw Corrupt();
  const uint8_t* hd = d + 18;
  int64_t pos = 14 + hsize;
  uint32_t comp = 0, colors = 0, bits, masks[4] = {0, 0, 0, 0};
  int pad = 4;
  bool top_down = false;
  if (hsize == 12) {
    im.w = le16(hd);
    im.h = le16(hd + 2);
    bits = le16(hd + 6);
    pad = 3;
  } else {
    im.w = le32(hd);
    const uint32_t h_raw = le32(hd + 4);
    bits = le16(hd + 10);
    comp = le32(hd + 12);
    colors = le32(hd + 28);
    top_down = hd[7] == 0xFF;
    im.h = top_down ? int64_t(4294967296LL - h_raw) : int64_t(h_raw);
    if (comp == 3) {
      if (hsize >= 52) {
        const int nm = hsize >= 56 ? 4 : 3;
        for (int i = 0; i < nm; ++i) masks[i] = le32(hd + 36 + 4 * i);
      } else {
        if (pos + 12 > n) throw Corrupt();
        for (int i = 0; i < 3; ++i) masks[i] = le32(d + pos + 4 * i);
        pos += 12;
      }
    }
  }
  static const char* kComp[] = {"", "RLE8 ", "RLE4 ", "BITFIELDS "};
  name = std::to_string(bits) + "-bit " + (comp < 4 ? kComp[comp] : "") +
         "BMP";
  if (im.w == 0 || im.h == 0 || im.w * im.h > kMaxPixels) throw Corrupt();
  if (colors == 0 && bits < 32) colors = 1u << bits;
  if (offset == 14 + int64_t(hsize) && bits <= 8) offset += 4 * int64_t(colors);
  RawMode m;
  bool pal_mode = false;
  switch (bits) {
    case 1: m = simple_mode(kRawP1); pal_mode = true; break;
    case 4: m = simple_mode(kRawP4); pal_mode = true; break;
    case 8: m = simple_mode(kRawP); pal_mode = true; break;
    case 16: m = simple_mode(kRawBGR15); break;
    case 24: m = bytes_mode("BGR"); break;
    case 32: m = bytes_mode("BGRX"); break;
    default: throw Unsupported();
  }
  bool rle = false;
  if (comp == 3) {
    struct Masks {
      uint32_t bits, r, g, b, a;
      const char* raw;
    };
    static const Masks kMasks[] = {
        {32, 0xFF0000, 0xFF00, 0xFF, 0x0, "BGRX"},
        {32, 0xFF000000, 0xFF0000, 0xFF00, 0x0, "XBGR"},
        {32, 0xFF000000, 0xFF00, 0xFF, 0x0, "BGXR"},
        {32, 0xFF000000, 0xFF0000, 0xFF00, 0xFF, "ABGR"},
        {32, 0xFF, 0xFF00, 0xFF0000, 0xFF000000, "RGBA"},
        {32, 0xFF0000, 0xFF00, 0xFF, 0xFF000000, "BGRA"},
        {32, 0xFF000000, 0xFF00, 0xFF, 0xFF0000, "BGAR"},
        {32, 0x0, 0x0, 0x0, 0x0, "BGRA"},
        {24, 0xFF0000, 0xFF00, 0xFF, 0, "BGR"},
        {16, 0xF800, 0x7E0, 0x1F, 0, "BGR;16"},
        {16, 0x7C00, 0x3E0, 0x1F, 0, "BGR;15"}};
    const Masks* hit = nullptr;
    for (const Masks& k : kMasks)
      if (k.bits == bits && k.r == masks[0] && k.g == masks[1] &&
          k.b == masks[2] && (bits != 32 || k.a == masks[3])) {
        hit = &k;
        break;
      }
    if (hit == nullptr) {
      char buf[80];
      std::snprintf(buf, sizeof(buf), " with masks %x %x %x %x", masks[0],
                    masks[1], masks[2], masks[3]);
      name += buf;
      throw Unsupported();
    }
    if (std::strcmp(hit->raw, "BGR;16") == 0)
      m = simple_mode(kRawBGR16);
    else if (std::strcmp(hit->raw, "BGR;15") == 0)
      m = simple_mode(kRawBGR15);
    else
      m = bytes_mode(hit->raw);
  } else if (comp == 1 || comp == 2) {
    rle = true;
  } else if (comp != 0) {
    name = "BMP with compression " + std::to_string(comp);
    throw Unsupported();
  }
  im.reset_palette();
  if (pal_mode) {
    if (colors == 0 || colors > 65536) {
      name += " with " + std::to_string(colors) + " palette entries";
      throw Unsupported();
    }
    // as many entries as the file holds (PIL reads what is there)
    const int64_t n_ent = std::max<int64_t>(
        0, std::min<int64_t>(colors, (n - pos) / pad));
    bool gray = n_ent == colors;
    for (int64_t i = 0; gray && i < n_ent; ++i) {
      const int64_t v = colors == 2 ? (i == 0 ? 0 : 255) : i;
      const uint8_t* e = d + pos + i * pad;
      gray = v < 256 && e[0] == v && e[1] == v && e[2] == v;
    }
    if (gray) {
      m = simple_mode(colors == 2 ? kRaw1 : kRawL);
    } else if (n_ent > 256) {
      name += " with " + std::to_string(n_ent) + " palette entries";
      throw Unsupported();
    } else {
      for (int64_t i = 0; i < n_ent; ++i) {
        const uint8_t* e = d + pos + i * pad;
        im.pal[i][0] = e[2]; im.pal[i][1] = e[1]; im.pal[i][2] = e[0];
      }
      im.has_pal = true;
    }
  }
  if (rle && !im.has_pal && m.kind != kRawL) {   // "1" or true colour
    throw Unsupported();
  }
  im.ch = rle ? 1 : mode_channels(m);
  const int64_t stride = ((im.w * bits + 31) >> 3) & ~int64_t(3);
  if (!rle && row_bytes(m, im.w) > stride) throw Corrupt();
  if (!with_data) return;
  if (rle) {
    std::vector<uint8_t> idx;
    bmp_rle(d, n, offset, im.w, im.h, comp == 2, idx);
    im.px.assign(idx.size(), 0);
    for (int64_t y = 0; y < im.h; ++y)
      std::memcpy(im.px.data() + (top_down ? y : im.h - 1 - y) * im.w,
                  idx.data() + y * im.w, size_t(im.w));
    return;
  }
  read_rows(d, n, offset, stride, m, !top_down, im);
}

// PIL's mode of a TGA or BMP as "the file's own channels": 1 gray, 2
// gray + alpha, 3 RGB or palette, 4 RGBA or palette with alpha
int pil_channels(const Pil& im) {
  if (!im.has_pal) return im.ch;
  if (im.ch == 2) return 4;
  for (const auto& e : im.pal)
    if (e[3] != 255) return 4;
  return 3;
}

// Runs f(name) and maps its exceptions to the C interface's codes; name
// (the format, as far as f read it) goes to out_name.
template <class F>
int guarded(char* out_name, int32_t cap, F f) {
  std::string name;
  int rc = 0;
  try {
    f(name);
  } catch (const Unsupported&) {
    rc = 1;
  } catch (const Corrupt&) {
    rc = 2;
  } catch (const std::bad_alloc&) {
    rc = 2;
  }
  if (out_name && cap > 0) std::snprintf(out_name, size_t(cap), "%s",
                                         name.c_str());
  return rc;
}

bool is_png(const uint8_t* d, int64_t n) {
  return n >= 8 && std::memcmp(d, kPngSig, 8) == 0;
}

bool is_jpeg(const uint8_t* d, int64_t n) {
  return n >= 2 && d[0] == 0xFF && d[1] == 0xD8;
}

bool is_bmp(const uint8_t* d, int64_t n) {
  return n >= 2 && d[0] == 'B' && d[1] == 'M';
}

// None of the formats decoded: name what it is, for the caller's
// refusal. Runs after the PNG, JPEG and BMP tests and before the TGA one
// (which has no magic bytes), so a file with one of these signatures is
// never read as TGA.
[[noreturn]] void refuse_other(const uint8_t* d, int64_t n,
                               std::string& name) {
  struct Magic {
    const char* bytes;
    size_t len;
    const char* name;
  };
  static const Magic kMagics[] = {
      {"GIF8", 4, "GIF"}, {"II*\0", 4, "TIFF"}, {"MM\0*", 4, "TIFF"},
      {"\xabKTX 20\xbb", 8, "KTX2"}, {"DDS ", 4, "DDS"}};
  if (n >= 12 && std::memcmp(d, "RIFF", 4) == 0 &&
      std::memcmp(d + 8, "WEBP", 4) == 0) {
    name = "WebP";
    throw Unsupported();
  }
  for (const Magic& mg : kMagics)
    if (size_t(n) >= mg.len && std::memcmp(d, mg.bytes, mg.len) == 0) {
      name = mg.name;
      throw Unsupported();
    }
  name = "not a PNG, JPEG, BMP or TGA (starts with";
  char hex[4];
  for (int64_t i = 0; i < std::min<int64_t>(n, 8); ++i) {
    std::snprintf(hex, sizeof(hex), " %02x", d[i]);
    name += hex;
  }
  name += ")";
  throw Unsupported();
}

}  // namespace

extern "C" {

int pti_probe(const uint8_t* data, int64_t n, int32_t* w, int32_t* h,
              int32_t* channels, char* name, int32_t cap) {
  return guarded(name, cap, [&](std::string& nm) {
    if (is_bmp(data, n) || (!is_png(data, n) && !is_jpeg(data, n) &&
                            tga_accept(data, n))) {
      Pil im;
      if (is_bmp(data, n))
        bmp_read(data, n, false, im, nm);
      else
        tga_read(data, n, false, im, nm);
      *w = int32_t(im.w);
      *h = int32_t(im.h);
      *channels = pil_channels(im);
    } else if (is_png(data, n)) {
      Png p;
      png_parse(data, n, p, false, nm);
      *w = p.w;
      *h = p.h;
      *channels = p.color == 3 ? (p.trns ? 4 : 3) : p.channels();
    } else if (is_jpeg(data, n)) {
      Jpeg j;
      jpeg_parse(data, n, j, false, nm);
      *w = j.w;
      *h = j.h;
      *channels = int32_t(j.comps.size());
    } else {
      refuse_other(data, n, nm);
    }
  });
}

int pti_decode(const uint8_t* data, int64_t n, int32_t w, int32_t h,
               int32_t out_channels, uint8_t* out, char* name, int32_t cap) {
  if (out_channels != 3 && out_channels != 4) return 1;
  return guarded(name, cap, [&](std::string& nm) {
    if (is_png(data, n)) {
      png_decode(data, n, w, h, out_channels, out, nullptr, nm);
    } else if (is_jpeg(data, n)) {
      jpeg_decode(data, n, w, h, out_channels, out, nm);
    } else if (is_bmp(data, n) || tga_accept(data, n)) {
      Pil im;
      if (is_bmp(data, n))
        bmp_read(data, n, true, im, nm);
      else
        tga_read(data, n, true, im, nm);
      if (im.w != w || im.h != h) throw Corrupt();
      pil_convert(im, out_channels, out);
    } else {
      refuse_other(data, n, nm);
    }
  });
}

int pti_png_samples(const uint8_t* data, int64_t n, int32_t w, int32_t h,
                    uint16_t* out, char* name, int32_t cap) {
  return guarded(name, cap, [&](std::string& nm) {
    if (!is_png(data, n)) refuse_other(data, n, nm);
    png_decode(data, n, w, h, 0, nullptr, out, nm);
  });
}

// The JAX package's pt_hdr_decode (native/pathtracer_native.cpp), copied:
// `data` starts at the first scanline; new-RLE scanlines (0x02 0x02 W_hi
// W_lo, four run-length coded planes) or flat RGBE with old-style
// (1, 1, 1, n) repeats; rgb = mantissa * 2^(e - 136), e == 0 black.
int pti_hdr_decode(const uint8_t* data, int64_t n, int32_t w, int32_t h,
                   float* out) {
  if (w <= 0 || h <= 0) return 1;
  std::vector<uint8_t> row(size_t(w) * 4);
  int64_t pos = 0;
  for (int32_t y = 0; y < h; ++y) {
    if (w >= 8 && w <= 0x7FFF && pos + 4 <= n && data[pos] == 2 &&
        data[pos + 1] == 2 &&
        ((int32_t(data[pos + 2]) << 8) | data[pos + 3]) == w) {
      pos += 4;
      for (int c = 0; c < 4; ++c) {
        int32_t x = 0;
        while (x < w) {
          if (pos >= n) return 2;
          int count = data[pos++];
          if (count > 128) {   // run
            count -= 128;
            if (pos >= n || x + count > w) return 2;
            uint8_t v = data[pos++];
            for (int i = 0; i < count; ++i) row[size_t(x + i) * 4 + c] = v;
          } else {             // literals
            if (pos + count > n || x + count > w) return 2;
            for (int i = 0; i < count; ++i)
              row[size_t(x + i) * 4 + c] = data[pos++];
          }
          x += count;
        }
      }
    } else {
      int32_t x = 0;
      int shift = 0;
      while (x < w) {
        if (pos + 4 > n) return 2;
        const uint8_t* px = data + pos;
        pos += 4;
        if (px[0] == 1 && px[1] == 1 && px[2] == 1) {
          int64_t count = int64_t(px[3]) << shift;
          if (x == 0 || x + count > w) return 2;
          for (int64_t i = 0; i < count; ++i)
            std::memcpy(&row[size_t(x + i) * 4], &row[size_t(x - 1) * 4], 4);
          x += int32_t(count);
          shift += 8;
        } else {
          std::memcpy(&row[size_t(x) * 4], px, 4);
          ++x;
          shift = 0;
        }
      }
    }
    float* o = out + size_t(y) * w * 3;
    for (int32_t x = 0; x < w; ++x) {
      int e = row[size_t(x) * 4 + 3];
      float scale = e == 0 ? 0.0f : std::ldexp(1.0f, e - 136);
      o[x * 3 + 0] = row[size_t(x) * 4 + 0] * scale;
      o[x * 3 + 1] = row[size_t(x) * 4 + 1] * scale;
      o[x * 3 + 2] = row[size_t(x) * 4 + 2] * scale;
    }
  }
  return 0;
}

}  // extern "C"
