"""Host routines of the collator, the per-utterance tokenizer and WER
(counterpart of ``aat_tpu/runtime/host_ops.py``).

Each routine takes the native route (``csrc/aat_host.cpp`` through
:mod:`aat_tpu_torch.runtime.native`) when the library is built, and its
numpy route otherwise, as the JAX package does. The two are bitwise equal
(``tests/test_torch_host_native.py``): the float32 rounding of the numpy
expressions is the spec. ``calls[route][name]`` counts the calls that
took each route, so a run can show which one it took.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np

from aat_tpu_torch.runtime import native

ENTRIES = ("assemble_segments", "normalize_pad", "smoothed_amplitude", "find_minima",
           "edit_distance")
calls = {route: dict.fromkeys(ENTRIES, 0) for route in ("native", "numpy")}


def reset_calls() -> None:
    for counts in calls.values():
        counts.update(dict.fromkeys(ENTRIES, 0))


def _route(name: str):
    """The native library, or None for the numpy route; counts the call."""
    lib = native.library()
    calls["native" if lib is not None else "numpy"][name] += 1
    return lib


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def assemble_segments(waveform: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                      out_lens: np.ndarray, max_frames: int) -> Tuple[np.ndarray, np.ndarray]:
    """Dense segment batch of one utterance: row s holds
    ``waveform[starts[s]:ends[s]]`` (what of it lies in the waveform)
    zero-padded to ``max_frames``, and its mask is 1 on the first
    ``out_lens[s]`` frames → (segments [S, F] f32, mask [S, F] f32)."""
    waveform = np.ascontiguousarray(waveform, np.float32)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    out_lens = np.ascontiguousarray(out_lens, np.int64)
    lib = _route("assemble_segments")
    if lib is not None:
        s = len(starts)
        segments = np.empty((s, max_frames), np.float32)
        mask = np.empty((s, max_frames), np.float32)
        lib.assemble_segments(_f32p(waveform), waveform.shape[-1], _i64p(starts), _i64p(ends),
                              _i64p(out_lens), s, max_frames, _f32p(segments), _f32p(mask))
        return segments, mask
    f = np.arange(max_frames)
    idx = np.clip(starts[:, None] + f[None, :], 0, waveform.shape[-1] - 1)
    # samples past the waveform's end are zeros, as in the native route (a
    # padded trailing segment can end past the row; the JAX numpy fallback
    # repeats the last sample there, its native route zero-fills)
    data_len = np.minimum(ends, waveform.shape[-1]) - starts
    in_data = f[None, :] < data_len[:, None]
    segments = np.where(in_data, waveform[idx], 0.0).astype(np.float32)
    mask = (f[None, :] < out_lens[:, None]).astype(np.float32)
    return segments, mask


def normalize_pad(waveforms: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row zero-mean/unit-var over the valid samples (float64), then
    right padding (HF processor semantics) → (f32 [B, L], int64 mask)."""
    rows = [np.ascontiguousarray(w, np.float64) for w in waveforms]
    lib = _route("normalize_pad")
    if lib is not None:
        n, max_len = len(rows), max(r.shape[-1] for r in rows)
        out = np.empty((n, max_len), np.float32)
        mask = np.empty((n, max_len), np.int64)
        ptrs = (ctypes.POINTER(ctypes.c_double) * n)(
            *[r.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) for r in rows])
        lengths = np.array([r.shape[-1] for r in rows], np.int64)
        lib.normalize_pad(ptrs, _i64p(lengths), n, max_len, _f32p(out), _i64p(mask))
        return out, mask
    from aat_tpu_torch.data.collate import zero_mean_unit_var_pad

    return zero_mean_unit_var_pad(rows)


def smoothed_amplitude(amplitude_f32: np.ndarray, n_points: int) -> np.ndarray:
    """Running mean over ``n_points`` as differences of a sequential float32
    cumsum (numpy semantics: its rounding is visible to the 1e-5
    comparator downstream)."""
    amplitude_f32 = np.ascontiguousarray(amplitude_f32, np.float32)
    t = amplitude_f32.shape[-1]
    out_len = max(t - n_points, 0)
    lib = _route("smoothed_amplitude")
    if lib is not None and out_len > 0:
        out = np.empty((out_len,), np.float32)
        lib.smoothed_amplitude(_f32p(amplitude_f32), t, n_points, _f32p(out))
        return out
    c = np.cumsum(amplitude_f32)
    return (c[n_points:] - c[:-n_points]) / float(n_points)


def find_minima(smoothed: np.ndarray, eps: float = 1e-5,
                threshold: float = 15.0) -> np.ndarray:
    """Indices of epsilon-strict interior local maxima with value above
    ``threshold``, int64."""
    x = np.ascontiguousarray(smoothed, np.float32)
    t = x.shape[-1]
    lib = _route("find_minima")
    if lib is not None:
        out = np.empty((max(t, 1),), np.int64)
        n = lib.find_minima(_f32p(x), t, ctypes.c_float(eps), ctypes.c_float(threshold),
                            _i64p(out), out.shape[0])
        return out[:n].copy()
    if t < 3:
        return np.zeros((0,), np.int64)
    interior = (x[1:-1] > x[2:] + np.float32(eps)) & (x[1:-1] > x[:-2] + np.float32(eps))
    idx = np.nonzero(interior)[0] + 1
    return idx[x[idx] > threshold]


def edit_distance(a: np.ndarray, b: np.ndarray) -> int:
    """Levenshtein distance between two id sequences."""
    a = np.ascontiguousarray(a, np.int64)
    b = np.ascontiguousarray(b, np.int64)
    lib = _route("edit_distance")
    if lib is not None:
        return int(lib.edit_distance(_i64p(a), len(a), _i64p(b), len(b)))
    from aat_tpu_torch.training.metrics import _edit_distance

    return _edit_distance(a.tolist(), b.tolist())
