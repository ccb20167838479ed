"""Build and load the port's hand-written Hopper kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into ONE
shared library with a plain C interface, loaded with ``ctypes``. The
sources compile in parallel, one ``nvcc -c`` each, and link once. The build
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

_FLASH_FWD = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
              _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
              _F, _I, _I, _I, _F, _F, _I, _I, _P]
_DROPOUT = [_P, _P, _I, _I] + [_I64] * 12 + [_I, _I, _F, _P]
_FLASH_BWD_DQ = [_P] * 8 + [_I] * 7 + [_I64] * 9 + [_F, _I, _I, _I, _F, _F, _I, _I, _P]

# C entry points: name -> argtypes (every one returns cudaGetLastError()).
_SIGNATURES = {
    # frames, basis, filters, band, out, n_batch, frames per batch row, batch
    # stride, frame stride, stream
    "aat_mel_forward": [_P, _P, _P, _P, _P, _I, _I, _I64, _I64, _P],
    # q, k, v, key_mask, out, lse (or null), B, T, S, H, KVH, D (q and k), DV
    # (v and out; DV == D but for the bf16 kernels' (192, 128)), q strides
    # (b, t, h), k strides (b, s, h), v strides (b, s, h), sm_scale, causal,
    # pack_len, seed, rate, inv_keep, heads_total, head_offset (the dropout
    # hash's head keys), stream: both on the tensor cores, f32 as 3xTF32
    # (flash_fwd_tf32x3.cu) and bf16 (flash_fwd_mma.cu)
    "aat_flash_fwd_tf32x3": _FLASH_FWD,
    "aat_flash_fwd_mma": _FLASH_FWD,
    # q, k, v, key_mask, out, dout, lse, dq, B, T, S, H, KVH, D, DV, q/k/v
    # strides as above, sm_scale, causal, pack_len, seed, rate, inv_keep,
    # heads_total, head_offset, stream: both on the tensor cores, f32 as
    # 3xTF32 (flash_bwd_tf32x3.cu) and bf16 (flash_bwd_mma.cu)
    "aat_flash_bwd_dq_tf32x3": _FLASH_BWD_DQ,
    "aat_flash_bwd_dq_mma": _FLASH_BWD_DQ,
    # as the dq entries with dk, dv (f32 per q-head) in place of dq, and a
    # [B, H, T] f32 scratch for delta
    "aat_flash_bwd_dkv_tf32x3": [_P] * 10 + _FLASH_BWD_DQ[8:],
    "aat_flash_bwd_dkv_mma": [_P] * 10 + _FLASH_BWD_DQ[8:],
    # x, codebook, cbn, idx, N, K, D, stream
    "aat_vq_nearest": [_P, _P, _P, _P, _I, _I, _I, _P],
    # x (dy), y (dx), dtype, ndim, 4 local sizes, 4 global offsets, 4 global
    # extents, seed, keep_min, scale, stream: the element dropout's forward
    # and its backward, which regenerates the keep mask (dropout.cu)
    "aat_dropout_fwd": _DROPOUT,
    "aat_dropout_bwd": _DROPOUT,
}


class KernelLibrary:
    """The loaded library plus what its build reported. ``calls`` counts the
    launches through each C entry, so a run can tell which of two kernels
    behind one wrapper (the f32 and bf16 flash kernels) it went through."""

    def __init__(self, path: str, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self.calls = dict.fromkeys(_SIGNATURES, 0)
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
        self.calls[name] += 1


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
        start = time.perf_counter()
        log = _build(lib_path, [s for s in srcs if s.endswith(".cu")])
        seconds = time.perf_counter() - start
    _library = KernelLibrary(lib_path, seconds, log)
    return _library


def _build(lib_path: str, cu_sources) -> str:
    """One ``nvcc -c`` per source, all started together, then one link.
    Returns the compilers' output; raises if any step fails."""
    nvcc = _nvcc()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC"]
    tag = f"{os.getpid()}.tmp"
    objs = [f"{lib_path}.{os.path.basename(s)}.{tag}.o" for s in cu_sources]
    procs = [subprocess.Popen([nvcc, *flags, "-Xptxas", "-v", "-c", "-o", o, s],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(cu_sources, objs)]
    logs, failed = [], []
    for src, proc in zip(cu_sources, procs):
        out, _ = proc.communicate()
        logs.append(f"== {os.path.basename(src)}\n{out}")
        if proc.returncode != 0:
            failed.append(os.path.basename(src))
    log = "".join(logs)
    try:
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
        tmp = f"{lib_path}.{tag}"
        link = subprocess.run([nvcc, *flags, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
        os.replace(tmp, lib_path)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return log


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, as a C pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch(name: str, device, *args) -> None:
    """Launch through the C entry ``name`` on the operands' ``device``: the
    C entries set no device, so ``device`` is made current around the call
    (``cudaFuncSetAttribute`` and the launch then reach its GPU, not the
    current one), and its current stream is passed as the last argument.
    Every wrapper launches through here."""
    import torch

    with torch.cuda.device(device):
        library().call(name, *args, stream_handle(device))


def check_cuda(x, kernel: str) -> None:
    """Raise unless ``x`` lies on a CUDA device: a wrapper launches its
    kernel or raises, and only a CPU tensor takes a plain version."""
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} kernel needs CUDA tensors, got {x.device}")
