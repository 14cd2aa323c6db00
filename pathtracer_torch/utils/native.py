"""ctypes binding to the native host code (counterpart of pathtracer/utils/native.py).

Two libraries, each compiled at first use into `pathtracer_torch/_build/`
and rebuilt when its source is newer:

- the host runtime, `native/pathtracer_native.cpp` (the JAX package's
  own source): `pt_sah_split_build` (the SBVH leaf build behind the
  cluster accel), the PNG encoder (`pt_png_encode`) and the glTF
  accessor unpack (`pt_accessor_to_f32` / `_to_i32`);

      g++ -O3 -std=c++17 -fPIC -shared native/pathtracer_native.cpp -lz

- the image decoders, `pathtracer_torch/csrc/image_decode.cpp` (the
  port's own): PNG of every colour type, bit depth and interlace, JPEG
  (baseline, extended 8-bit and progressive Huffman, gray or three
  components, any integral sampling factors), TGA (image types 1-3 and
  9-11, 1-32-bit pixels, colour maps, both origins), BMP (core, info,
  V2-V5 headers, 1-32-bit pixels, RLE8, RLE4, BITFIELDS, both row
  orders) and Radiance RGBE scanlines; `utils/image_plain.py` is their
  plain numpy version. TGA has no magic bytes: a file that is no PNG,
  JPEG, BMP or other named format is read as TGA when its header passes
  PIL's TGA test.

      g++ -O3 -std=c++17 -fPIC -shared csrc/image_decode.cpp -lz

A failed build raises: the port has no Python fallback and no other
image decoder (the JAX package falls back to Python and to PIL).
`image_rgba` / `image_rgb` give the pixels PIL's convert("RGBA") /
convert("RGB") gives; an image they do not decode (arithmetic-coded,
12-bit, lossless, hierarchical or CMYK/YCCK JPEG, GIF, TIFF, WebP, DDS,
KTX2, and the TGA and BMP variants PIL refuses) is a ValueError naming
the file and its format.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
LIBS = {
    "runtime": (os.path.join(os.path.dirname(_PKG), "native",
                             "pathtracer_native.cpp"),
                os.path.join(BUILD_DIR, "libpathtracer_native.so")),
    "images": (os.path.join(_PKG, "csrc", "image_decode.cpp"),
               os.path.join(BUILD_DIR, "libpathtracer_images.so")),
}

_lock = threading.Lock()
_libs: dict = {}
_NAME_BYTES = 160   # the decoders' name of a refused or corrupt format


def build(name: str = "runtime") -> str:
    """Compile library `name` ("runtime" or "images") if missing or
    stale; returns its path."""
    src, so = LIBS[name]
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-std=c++17", "-fPIC",
           "-shared", "-o", tmp, src, "-lz"]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"native build failed: {' '.join(cmd)}\n"
                           f"{res.stderr}")
    os.replace(tmp, so)
    return so


def _bind(name: str, lib):
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if name == "images":
        lib.pti_probe.argtypes = [u8p, ctypes.c_int64, i32p, i32p, i32p,
                                  ctypes.c_char_p, ctypes.c_int32]
        lib.pti_probe.restype = ctypes.c_int
        lib.pti_decode.argtypes = [u8p, ctypes.c_int64, ctypes.c_int32,
                                   ctypes.c_int32, ctypes.c_int32, u8p,
                                   ctypes.c_char_p, ctypes.c_int32]
        lib.pti_decode.restype = ctypes.c_int
        lib.pti_png_samples.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_char_p, ctypes.c_int32]
        lib.pti_png_samples.restype = ctypes.c_int
        lib.pti_hdr_decode.argtypes = [u8p, ctypes.c_int64, ctypes.c_int32,
                                       ctypes.c_int32, f32p]
        lib.pti_hdr_decode.restype = ctypes.c_int
        return
    lib.pt_sah_split_build.argtypes = [
        f32p, f32p, f32p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_float, i32p, i32p, i32p, f32p,
        f32p, ctypes.c_int32, ctypes.c_int64]
    lib.pt_sah_split_build.restype = ctypes.c_int
    lib.pt_png_encode_bound.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    lib.pt_png_encode_bound.restype = ctypes.c_int64
    lib.pt_png_encode.argtypes = [
        u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, u8p,
        ctypes.POINTER(ctypes.c_int64)]
    lib.pt_png_encode.restype = ctypes.c_int
    lib.pt_accessor_to_f32.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, f32p]
    lib.pt_accessor_to_f32.restype = ctypes.c_int
    lib.pt_accessor_to_i32.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, i32p]
    lib.pt_accessor_to_i32.restype = ctypes.c_int


def _load(name: str = "runtime"):
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build(name))
            _bind(name, lib)
            _libs[name] = lib
        return _libs[name]


def available() -> bool:
    """True once both native libraries are built and loaded.

    Unlike the JAX package's `available()`, which reports False when its
    library cannot be built and lets every caller fall back to Python or
    PIL, the port builds at first use and raises when a build fails:
    this never returns False.
    """
    _load("runtime")
    _load("images")
    return True


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def sah_split_build(v0, v1, v2, k: int, n_bins: int = 16,
                    dup_budget: float = 1.5):
    """SBVH-style spatial-split SAH leaves over triangles v0/v1/v2 f32[T, 3].

    Returns (leaves, leaf_lo, leaf_hi): a list of unique-id int32 arrays
    (each <= k long) and the clipped-union leaf AABBs f32[L, 3].
    """
    lib = _load()
    t = int(v0.shape[0])
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    cap = int(dup_budget * t) + 8
    n_leaves = ctypes.c_int32()
    leaf_off = np.empty(cap + 1, np.int32)
    leaf_ids = np.empty(cap, np.int32)
    leaf_lo = np.empty((cap, 3), np.float32)
    leaf_hi = np.empty((cap, 3), np.float32)
    rc = lib.pt_sah_split_build(
        _ptr(v0, ctypes.c_float), _ptr(v1, ctypes.c_float),
        _ptr(v2, ctypes.c_float), t, k, n_bins, ctypes.c_float(dup_budget),
        ctypes.byref(n_leaves), _ptr(leaf_off, ctypes.c_int32),
        _ptr(leaf_ids, ctypes.c_int32), _ptr(leaf_lo, ctypes.c_float),
        _ptr(leaf_hi, ctypes.c_float), cap, cap)
    if rc != 0:
        raise RuntimeError(f"pt_sah_split_build failed with code {rc}")
    nl = n_leaves.value
    leaves = [leaf_ids[leaf_off[i]:leaf_off[i + 1]].copy()
              for i in range(nl)]
    return leaves, leaf_lo[:nl].copy(), leaf_hi[:nl].copy()


def png_encode(img: np.ndarray) -> bytes:
    """Encode u8 [H, W] / [H, W, C] (C in 1, 3, 4) as PNG bytes."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, ch = img.shape
    if ch not in (1, 3, 4):
        raise ValueError(f"png_encode: {ch} channels (want 1, 3 or 4)")
    n = ctypes.c_int64(lib.pt_png_encode_bound(w, h, ch))
    out = np.empty(n.value, np.uint8)
    rc = lib.pt_png_encode(_ptr(img, ctypes.c_uint8), w, h, ch,
                           _ptr(out, ctypes.c_uint8), ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"pt_png_encode failed with code {rc}")
    return out[:n.value].tobytes()


def _checked(rc: int, name, what: str):
    """Raise the ValueError of a decoder's code rc (0: none), naming
    `what` and the format the decoder read (`name`, its buffer)."""
    if rc == 0:
        return
    fmt = name.value.decode()
    if rc == 1:
        article = "an" if fmt[0] in "aeiouAEIOU8" else "a"
        raise ValueError(f"{what}: cannot decode {article} {fmt}: "
                         "pathtracer_torch decodes PNG, 8-bit baseline "
                         "or progressive Huffman JPEG (gray, YCbCr or "
                         "RGB), and TGA and BMP as PIL reads them")
    raise ValueError(f"{what}: corrupt or truncated {fmt}")


def image_info(data: bytes, what: str = "image"):
    """(width, height, channels) of a PNG, JPEG, BMP or TGA. channels is
    the file's own: PNG 1 gray, 2 gray + alpha, 3 RGB or palette, 4 RGBA
    or palette with tRNS; JPEG 1 or 3; BMP and TGA 1 gray, 2 gray +
    alpha, 3 RGB or palette, 4 RGBA, a palette with alpha or gray + alpha
    through a colour map. Raises ValueError naming `what` and the format
    when the decoders do not take the image."""
    lib = _load("images")
    buf = np.frombuffer(data, np.uint8)
    w, h, ch = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    name = ctypes.create_string_buffer(_NAME_BYTES)
    rc = lib.pti_probe(_ptr(buf, ctypes.c_uint8), buf.size, ctypes.byref(w),
                       ctypes.byref(h), ctypes.byref(ch), name, _NAME_BYTES)
    _checked(rc, name, what)
    return w.value, h.value, ch.value


def image_decode(data: bytes, what: str, channels: int) -> np.ndarray:
    """PNG, JPEG, BMP or TGA -> u8 [H, W, channels] (4: PIL's
    convert("RGBA"), 3: convert("RGB")). Raises ValueError naming `what` and the format when
    the image is not decoded."""
    w, h, _ = image_info(data, what)
    lib = _load("images")
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((h, w, channels), np.uint8)
    name = ctypes.create_string_buffer(_NAME_BYTES)
    rc = lib.pti_decode(_ptr(buf, ctypes.c_uint8), buf.size, w, h, channels,
                        _ptr(out, ctypes.c_uint8), name, _NAME_BYTES)
    _checked(rc, name, what)
    return out


def png_samples(data: bytes, what: str) -> np.ndarray:
    """A PNG's own samples, u16 [H, W, C] in the file's channels and bit
    depth (a palette PNG: its indices, C = 1), as PIL's np.asarray of the
    image holds them for palette, 1-bit and 16-bit gray PNGs."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{what}: not a PNG")
    w, h, ch = image_info(data, what)
    lib = _load("images")
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((h, w, 1 if data[25] == 3 else ch), np.uint16)
    name = ctypes.create_string_buffer(_NAME_BYTES)
    rc = lib.pti_png_samples(_ptr(buf, ctypes.c_uint8), buf.size, w, h,
                             _ptr(out, ctypes.c_uint16), name, _NAME_BYTES)
    _checked(rc, name, what)
    return out


def image_rgba(data: bytes, what: str) -> np.ndarray:
    """u8 [H, W, 4], as PIL's Image.open(...).convert("RGBA") gives it."""
    return image_decode(data, what, 4)


def image_rgb(data: bytes, what: str) -> np.ndarray:
    """u8 [H, W, 3], as PIL's Image.open(...).convert("RGB") gives it."""
    return image_decode(data, what, 3)


def hdr_decode(data: bytes, w: int, h: int) -> np.ndarray:
    """Radiance RGBE scanlines -> linear f32 [H, W, 3] (`data` starts at
    the first scanline; the caller parses the header). New-RLE and
    flat/old-style scanlines, as scene/hdr.py's plain version reads
    them. Raises ValueError on corrupt or truncated data."""
    lib = _load("images")
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((h, w, 3), np.float32)
    rc = lib.pti_hdr_decode(_ptr(buf, ctypes.c_uint8), buf.size, w, h,
                            _ptr(out, ctypes.c_float))
    if rc:
        raise ValueError(f"corrupt .hdr scanlines ({w}x{h}, "
                         f"pti_hdr_decode code {rc})")
    return out


def accessor_to_f32(buf: bytes, offset: int, count: int, n_comp: int,
                    component_type: int, stride: int,
                    normalized: bool) -> np.ndarray:
    """Strided glTF accessor -> f32 [count, n_comp] (stride 0: packed);
    normalized integers follow the glTF rules (x / max, signed clamped
    at -1)."""
    lib = _load()
    src = np.frombuffer(buf, np.uint8)
    out = np.empty((count, n_comp), np.float32)
    rc = lib.pt_accessor_to_f32(
        _ptr(src, ctypes.c_uint8), src.size, offset, count, n_comp,
        component_type, stride, int(normalized), _ptr(out, ctypes.c_float))
    if rc != 0:
        raise ValueError(f"glTF accessor ({count} x {n_comp} of type "
                         f"{component_type} at byte {offset}) does not fit "
                         f"its buffer (pt_accessor_to_f32 code {rc})")
    return out


def accessor_to_i32(buf: bytes, offset: int, count: int,
                    component_type: int, stride: int) -> np.ndarray:
    """Strided u8/u16/u32 glTF index accessor -> i32 [count] (stride 0:
    packed; a u32 above 2^31 - 1 wraps, view the result as uint32)."""
    lib = _load()
    src = np.frombuffer(buf, np.uint8)
    out = np.empty((count,), np.int32)
    rc = lib.pt_accessor_to_i32(
        _ptr(src, ctypes.c_uint8), src.size, offset, count, component_type,
        stride, _ptr(out, ctypes.c_int32))
    if rc != 0:
        raise ValueError(f"glTF index accessor ({count} of type "
                         f"{component_type} at byte {offset}) does not fit "
                         f"its buffer (pt_accessor_to_i32 code {rc})")
    return out
