"""ctypes binding to the native host runtime (counterpart of pathtracer/utils/native.py).

Binds two entry points of `native/pathtracer_native.cpp`:
`pt_sah_split_build` (the SBVH leaf build behind the cluster accel) and
`pt_png_encode` (PNG output without PIL). The C++ source is the JAX
package's own; it is compiled at first use with

    g++ -O3 -std=c++17 -fPIC -shared native/pathtracer_native.cpp -lz

into `pathtracer_torch/_build/`. If it cannot be built, the call raises:
the port has no Python fallback.
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
