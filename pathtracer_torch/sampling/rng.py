"""Counter-based random numbers (counterpart of pathtracer/sampling/rng.py).

Every random number is a pure hash of the key (pixel, sample,
depth * _SALTS_PER_DEPTH + salt, seed), bit for bit the JAX package's.
No torch global RNG and no `torch.Generator` is involved.

u32 arithmetic is emulated in int64 with `& 0xFFFFFFFF`: CPU torch
`uint32` has no `+` or `>>`. A product of two words below 2^32 does not
fit in int64, so `_mul32` splits one operand into 16-bit halves and
never relies on signed overflow wrapping.

`pcg4d_uniform` is the PCG draw's wrapper: on CUDA tensors it launches
K9 (csrc/rng.cu, one thread a lane in native u32 arithmetic, the key
words as launch arguments), on CPU tensors it runs the plain version,
`_to_unit(pcg4d(_key(...)))`, never the reverse. The two agree bit for
bit. Scalar key words are never copied from the host: K9 takes them as
immediates, the plain version as `torch.full` broadcasts.

`ref_pcg`, `ref_pcg2d` and `ref_rand` are the Vulkan reference's scalar
RNG (common.glsl:27-49), used only by tests to pin its observable
behaviour; the renderer uses the counter-based PCG4D.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pathtracer_torch.kernels import LAUNCHES, cuda_build

SALT_JITTER = 0
SALT_ALPHA = 1
SALT_DIELECTRIC = 2
SALT_LIGHT_SELECT = 3
SALT_LIGHT_UV = 4
SALT_BSDF_LOBE = 5
SALT_BSDF_UV = 6
SALT_RR = 7
SALT_ENV_SELECT = 8
SALT_ENV_UV = 9
SALT_TEX_FILTER = 10
SALT_ENV_RR = 11
_SALTS_PER_DEPTH = 12

M32 = 0xFFFFFFFF


def _mul32(a, b):
    """(a * b) mod 2^32 for int64 tensors holding u32 words."""
    a_lo = a & 0xFFFF
    a_hi = a >> 16
    return (a_lo * b + (((a_hi * (b & 0xFFFF)) & 0xFFFF) << 16)) & M32


def pcg4d(v):
    """PCG4D hash: int64[..., 4] u32 words -> int64[..., 4] u32 words."""
    v = (_mul32(v & M32, 1664525) + 1013904223) & M32
    x, y, z, w = v.unbind(-1)
    x = (x + _mul32(y, w)) & M32
    y = (y + _mul32(z, x)) & M32
    z = (z + _mul32(x, y)) & M32
    w = (w + _mul32(y, z)) & M32
    x, y, z, w = (a ^ (a >> 16) for a in (x, y, z, w))
    x = (x + _mul32(y, w)) & M32
    y = (y + _mul32(z, x)) & M32
    z = (z + _mul32(x, y)) & M32
    w = (w + _mul32(y, z)) & M32
    return torch.stack([x, y, z, w], dim=-1)


def _device(words):
    """The device of the first tensor among the key words (CPU if none)."""
    return next((w.device for w in words if isinstance(w, torch.Tensor)),
                torch.device("cpu"))


def _broadcast(words):
    """The tensor words broadcast together (views; torch.broadcast_shapes
    would import sympy on its first call) and their shape."""
    views = torch.broadcast_tensors(*(w for w in words
                                      if isinstance(w, torch.Tensor)))
    return iter(views), (views[0].shape if views else torch.Size())


def _key(pixel, sample, depth_salt, seed):
    """Stack (pixel, sample, depth_salt, seed) words, broadcast together.
    A scalar word becomes a `torch.full` of the broadcast shape: a fill
    on the device, not a copy of host data."""
    words = (pixel, sample, depth_salt, seed)
    dev = _device(words)
    views, shape = _broadcast(words)
    return torch.stack([next(views).to(device=dev, dtype=torch.int64) & M32
                        if isinstance(w, torch.Tensor) else
                        torch.full(shape, int(w) & M32, dtype=torch.int64,
                                   device=dev) for w in words], dim=-1)


def _to_unit(bits):
    """u32 word -> f32 in [0, 1): top 24 bits scaled by 2^-24 (exact)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _flat_stride(t):
    """The element stride s with which t's entries lie at i * s for the
    row-major lane index i, or None where no single stride does."""
    stride, span = None, 1
    for size, st in reversed(list(zip(t.shape, t.stride()))):
        if size == 1:
            continue
        if stride is None:
            stride = st
        elif st != stride * span:
            return None
        span *= size
    return stride or 0


_SIG = {"pt_pcg4d_uniform": [ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_int, ctypes.c_uint] * 4
        + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]}
# K9's word kinds (csrc/rng.cu WordKind)
_KIND = {torch.int32: 1, torch.int64: 2}


def kernel_words(words, dev):
    """K9's view of the key words (pixel, sample, depth_salt, seed): the
    broadcast shape and, a word, (tensor, stride, kind, immediate) - the
    tensor expanded to the shape, whose entry of row-major lane i lies
    `stride` elements past its first, or None for a Python int, passed
    as the immediate. Raises on a word K9 cannot take."""
    views, shape = _broadcast(words)
    out = []
    for name, w in zip(("pixel", "sample", "depth_salt", "seed"), words):
        if not isinstance(w, torch.Tensor):
            out.append((None, 0, 0, int(w) & M32))
            continue
        e = next(views)
        stride = _flat_stride(e)
        if w.device != dev or w.dtype not in _KIND or stride is None:
            raise ValueError(
                f"pcg4d_uniform {name}: want an int32 or int64 tensor on "
                f"{dev} at one stride over the lanes, got {w.dtype} "
                f"{tuple(w.shape)} strides {w.stride()} on {w.device}")
        out.append((e, stride, _KIND[w.dtype], 0))
    return shape, out


def pcg4d_uniform(pixel, sample, depth_salt, seed):
    """Four U[0,1) floats f32[..., 4] of one PCG4D draw keyed on (pixel,
    sample, depth_salt, seed): K9 on CUDA, the plain version on CPU.

    Each word is a Python int or an integer tensor (the tensors broadcast
    together). K9 takes int32 or int64 word tensors on the draw's device
    whose broadcast lies at one stride over the lanes (kernel_words); it
    raises on any other word.
    """
    words = (pixel, sample, depth_salt, seed)
    dev = _device(words)
    if dev.type == "cpu":
        return _to_unit(pcg4d(_key(*words)))
    if dev.type != "cuda":
        raise ValueError(f"pcg4d_uniform: unsupported device {dev}")
    shape, kw = kernel_words(words, dev)
    out = torch.empty(tuple(shape) + (4,), dtype=torch.float32, device=dev)
    n = out.numel() // 4
    if n:
        args = [a for e, stride, kind, imm in kw for a in
                (None if e is None else e.data_ptr(), stride, kind, imm)]
        lib = cuda_build.load("rng", _SIG)
        rc = lib.pt_pcg4d_uniform(*args, n, out.data_ptr(),
                                  cuda_build.stream_ptr(dev))
        cuda_build.check_launch(rc, "pcg4d")
        LAUNCHES["pcg4d"] += 1
    return out


def uniform4(pixel, sample, depth, salt, seed=0, sampler="pcg"):
    """Four U[0,1) floats keyed on (pixel, sample, depth, salt).

    sampler: "pcg" = independent PCG4D uniforms (pcg4d_uniform: K9 on
    CUDA); "sobol" = padded 4D Owen-scrambled Sobol (sampling/sobol.py),
    keyed per (pixel, depth, salt, seed) group with the sample index as
    its counter.
    """
    depth_salt = (int(depth) * _SALTS_PER_DEPTH + salt) & M32
    if sampler == "sobol":
        from pathtracer_torch.sampling import sobol

        key = _key(pixel, sample, depth_salt, seed)
        # group key: everything but the sample index (the Sobol counter)
        gk = pcg4d(_key(pixel, 0x536F626C, depth_salt, seed))
        gk = gk.expand(key.shape)
        return _to_unit(sobol.scrambled_sobol4(key[..., 1], gk))
    if sampler != "pcg":
        raise ValueError(f"unknown sampler {sampler!r} (pcg|sobol)")
    return pcg4d_uniform(pixel, sample, depth_salt, seed)


def uniform2(pixel, sample, depth, salt, seed=0, sampler="pcg"):
    u = uniform4(pixel, sample, depth, salt, seed, sampler)
    return u[..., 0], u[..., 1]


def uniform1(pixel, sample, depth, salt, seed=0, sampler="pcg"):
    return uniform4(pixel, sample, depth, salt, seed, sampler)[..., 0]


# ---------------------------------------------------------------------------
# Reference-parity oracles: scalar Python with the JAX package's numpy
# result types (np.uint32 words, np.float32 draws).
# ---------------------------------------------------------------------------

def ref_pcg(state):
    """One step of the reference's pcg stream (common.glsl:27-33).

    Returns (output_word, new_state): the state advances by an LCG and
    the output mixes the previous state.
    """
    prev = (int(state) * 747796405 + 2891336453) & M32
    word = (((prev >> ((prev >> 28) + 4)) ^ prev) * 277803737) & M32
    return np.uint32((word >> 22) ^ word), np.uint32(prev)


def ref_pcg2d(v):
    """The reference's pcg2d seed hash (common.glsl:34-44). v: two u32
    words; returns uint32[2]."""
    x, y = (int(a) & M32 for a in v)
    x = (x * 1664525 + 1013904223) & M32
    y = (y * 1664525 + 1013904223) & M32
    for _ in range(2):
        x = (x + y * 1664525) & M32
        y = (y + x * 1664525) & M32
        x ^= x >> 16
        y ^= y >> 16
    return np.array([x, y], np.uint32)


def ref_rand(state):
    """The reference's rand() (common.glsl:45-49). Returns (float,
    new_state)."""
    out, state = ref_pcg(state)
    return np.float32(out) * np.float32(1.0 / 0xFFFFFFFF), state
