"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by hand with nvcc into a shared library with a
plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -Xptxas -v -shared -Xcompiler -fPIC -o _build/lib<name>.so csrc/<name>.cu

at first use, into `pathtracer_torch/_build/` (gitignored). No PyTorch
headers are included, so a build takes seconds. `-fmad=false` keeps
every a*b+c as a rounded product and a rounded sum, so the kernels
evaluate their expressions exactly as the plain PyTorch versions do.
Nothing here is imported or built when a module is imported.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs = {}
# nvcc's stderr per library (register / shared-memory report of -Xptxas -v)
build_logs = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of pathtracer_torch are built with nvcc at first use")


def build(name: str) -> str:
    """Compile csrc/<name>.cu if the library is missing or older than the
    source or a header of csrc/ (csrc/*.cuh)."""
    src = os.path.join(CSRC, f"{name}.cu")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    deps = [src] + glob.glob(os.path.join(CSRC, "*.cuh"))
    if os.path.exists(so) and os.path.getmtime(so) >= max(
            os.path.getmtime(d) for d in deps):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    build_logs[name] = res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{' '.join(cmd)}\n"
                           f"{res.stderr}")
    os.replace(tmp, so)
    return so


def load(name: str, signatures: dict):
    """Build (if needed) and dlopen lib<name>.so, binding `signatures`.

    signatures: {function: [ctypes argtypes]}; every function returns
    the int cudaError_t of its launch.
    """
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on `device`, as a raw pointer."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check_launch(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{rc}")
