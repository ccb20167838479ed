"""Build and load the port's hand-written Hopper kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into ONE
shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use (never at import: the package imports on machines with
no CUDA toolkit), from the sources in the checkout only, into
``aat_tpu_torch/build/`` (git-ignored). The library's file name carries a
digest of the sources, so an edited kernel rebuilds and a stale library is
never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float

# C entry points: name -> argtypes (every one returns cudaGetLastError()).
_SIGNATURES = {
    # frames, basis, filters, out, n_frames, stream
    "aat_mel_forward": [_P, _P, _P, _P, _I, _P],
    # q, k, v, key_mask, out, is_bf16, B, T, S, H, KVH, D,
    # q strides (b, t, h), k strides (b, s, h), v strides (b, s, h),
    # sm_scale, stream
    "aat_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
                      _F, _P],
}


class KernelLibrary:
    """The loaded library plus what its build reported."""

    def __init__(self, path: str, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self._lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def call(self, name: str, *args) -> None:
        """Launch through the C entry ``name``; raise on a CUDA error."""
        err = getattr(self._lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")


_library = None


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's kernels need the CUDA toolkit")


def library() -> KernelLibrary:
    """Build (once per source digest) and load the kernel library."""
    global _library
    if _library is not None:
        return _library
    srcs = _sources()
    digest = hashlib.sha256()
    for path in srcs:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libaat_kernels_{digest.hexdigest()[:16]}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(lib_path):
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", tmp] + [s for s in srcs if s.endswith(".cu")]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - start
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, lib_path)
    _library = KernelLibrary(lib_path, seconds, log)
    return _library


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, as a C pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
