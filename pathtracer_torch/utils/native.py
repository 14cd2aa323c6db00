"""ctypes binding to the native host runtime (counterpart of pathtracer/utils/native.py).

Binds the entry points of `native/pathtracer_native.cpp` the port uses:
`pt_sah_split_build` (the SBVH leaf build behind the cluster accel), the
PNG codec (`pt_png_encode`; `pt_png_probe` + `pt_png_decode`, which read
8-bit non-interlaced PNG: gray, gray + alpha, RGB, RGBA and palette)
and the glTF accessor unpack (`pt_accessor_to_f32` / `_to_i32`). The
C++ source is the JAX package's own; it is compiled at first use with

    g++ -O3 -std=c++17 -fPIC -shared native/pathtracer_native.cpp -lz

into `pathtracer_torch/_build/`. If it cannot be built, the call raises:
the port has no Python fallback, and no other image decoder. An image the
decoder declines (JPEG, 16-bit or interlaced PNG, a gray or RGB PNG with
a tRNS colour key) is an error naming the file and its format
(`png_rgba`).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "pathtracer_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
_SO = os.path.join(BUILD_DIR, "libpathtracer_native.so")

_lock = threading.Lock()
_lib = None


def build() -> str:
    """Compile the native library if missing or stale; returns its path."""
    if (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return _SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-std=c++17", "-fPIC",
           "-shared", "-o", tmp, _SRC, "-lz"]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"native build failed: {' '.join(cmd)}\n"
                           f"{res.stderr}")
    os.replace(tmp, _SO)
    return _SO


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            i32p = ctypes.POINTER(ctypes.c_int32)
            f32p = ctypes.POINTER(ctypes.c_float)
            u8p = ctypes.POINTER(ctypes.c_uint8)
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
            lib.pt_png_probe.argtypes = [u8p, ctypes.c_int64, i32p, i32p,
                                         i32p]
            lib.pt_png_probe.restype = ctypes.c_int
            lib.pt_png_decode.argtypes = [u8p, ctypes.c_int64, u8p]
            lib.pt_png_decode.restype = ctypes.c_int
            lib.pt_accessor_to_f32.argtypes = [
                u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, f32p]
            lib.pt_accessor_to_f32.restype = ctypes.c_int
            lib.pt_accessor_to_i32.argtypes = [
                u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, i32p]
            lib.pt_accessor_to_i32.restype = ctypes.c_int
            _lib = lib
        return _lib


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


def png_decode(data: bytes):
    """Decode an 8-bit non-interlaced PNG -> u8 [H, W, C] (C: 1 gray, 2
    gray + alpha, 3 RGB, 4 RGBA; palettes expand to 3 or, with tRNS, 4).
    None when the decoder declines the format (see `png_rgba`); a PNG it
    accepts but cannot inflate raises."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    w, h, ch = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    if lib.pt_png_probe(_ptr(buf, ctypes.c_uint8), buf.size,
                        ctypes.byref(w), ctypes.byref(h),
                        ctypes.byref(ch)) != 0:
        return None
    out = np.empty((h.value, w.value, ch.value), np.uint8)
    if lib.pt_png_decode(_ptr(buf, ctypes.c_uint8), buf.size,
                         _ptr(out, ctypes.c_uint8)) != 0:
        raise ValueError("PNG data is corrupt (pt_png_decode failed)")
    return out


def image_format(data: bytes) -> str:
    """Name an image's format, for the error of an image png_decode
    declines."""
    if data[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if data[:8] != b"\x89PNG\r\n\x1a\n" or len(data) < 29:
        return f"not a PNG (starts with {bytes(data[:8])!r})"
    depth, color, interlace = data[24], data[25], data[28]
    if depth != 8:
        return f"{depth}-bit PNG"
    if interlace:
        return "interlaced (Adam7) PNG"
    if color in (0, 2) and b"tRNS" in data:
        return "gray or RGB PNG with a tRNS colour key"
    return f"PNG of colour type {color}"


def png_rgba(data: bytes, what: str) -> np.ndarray:
    """Decode a PNG to u8 [H, W, 4] as PIL's convert("RGBA") gives it:
    gray to (g, g, g, 255), gray + alpha to (g, g, g, a), RGB to
    (r, g, b, 255). Raises ValueError naming `what` and the format when
    the decoder declines the image."""
    arr = png_decode(data)
    if arr is None:
        raise ValueError(f"{what}: cannot decode a {image_format(data)}: "
                         "pathtracer_torch reads 8-bit non-interlaced PNG "
                         "only")
    if arr.shape[2] == 4:
        return arr
    rgba = np.empty(arr.shape[:2] + (4,), np.uint8)
    rgba[..., :3] = arr[..., :1] if arr.shape[2] in (1, 2) else arr
    rgba[..., 3] = arr[..., 1] if arr.shape[2] == 2 else 255
    return rgba


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
