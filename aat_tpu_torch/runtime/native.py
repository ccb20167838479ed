"""Build and load the native host library (``csrc/aat_host.cpp``), the
counterpart of ``aat_tpu/runtime/__init__.py`` ``load_library``.

The library is built with ``g++ -O3 -shared -fPIC -std=c++17`` at first
use (never at import), into ``aat_tpu_torch/build/`` (git-ignored), under
a name that carries a digest of the source, so an edited source rebuilds
and a stale library is never loaded. Where no compiler is there, or the
build fails, :func:`library` warns once and returns None, and
:mod:`aat_tpu_torch.runtime.host_ops` takes its numpy routes, as the JAX
package does. This is host code: it runs on the CPU beside the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional

from aat_tpu_torch.runtime.kernels import BUILD_DIR, CSRC

logger = logging.getLogger(__name__)

SOURCE = os.path.join(CSRC, "aat_host.cpp")

_I64 = ctypes.c_int64
_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)

# C entry points: name -> (argtypes, restype)
_SIGNATURES = {
    # waveform, length, starts, ends, out_lens, segments, max_frames,
    # segments_out, mask_out
    "assemble_segments": ([_F32P, _I64, _I64P, _I64P, _I64P, _I64, _I64, _F32P, _F32P], None),
    # row pointers (float64), lengths, rows, max_len, out, mask_out
    "normalize_pad": ([ctypes.POINTER(ctypes.POINTER(ctypes.c_double)), _I64P, _I64, _I64,
                       _F32P, _I64P], None),
    # amplitude, length, n_points, out
    "smoothed_amplitude": ([_F32P, _I64, _I64, _F32P], None),
    # smoothed, length, eps, threshold, out_idx, capacity -> count
    "find_minima": ([_F32P, _I64, ctypes.c_float, ctypes.c_float, _I64P, _I64], _I64),
    # a, len(a), b, len(b) -> distance
    "edit_distance": ([_I64P, _I64, _I64P, _I64], _I64),
}

_lock = threading.Lock()
_library = None
_tried = False


class HostLibrary:
    """The loaded library and its build: ``path``, ``built`` (whether this
    process compiled it) and the bound entry points as attributes."""

    def __init__(self, path: str, built: bool):
        self.path = path
        self.built = built
        self._lib = ctypes.CDLL(path)
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
            setattr(self, name, fn)


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libaat_host_{digest}.so")


def _build(path: str) -> bool:
    """Compile into a temporary file, then rename it into place (another
    process building the same source at once is harmless)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", SOURCE, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError) as exc:
        logger.warning("native host build failed (%s); using the numpy routes", exc)
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def library() -> Optional[HostLibrary]:
    """The host library, built if needed; None where it cannot be built
    (tried once a process)."""
    global _library, _tried
    with _lock:
        if _library is not None or _tried:
            return _library
        _tried = True
        path = library_path()
        built = False
        if not os.path.exists(path):
            if not _build(path):
                return None
            built = True
        _library = HostLibrary(path, built)
        return _library
