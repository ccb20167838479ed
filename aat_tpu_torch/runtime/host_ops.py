"""Host numpy routines of the collator and the per-utterance tokenizer
(counterpart of ``aat_tpu/runtime/host_ops.py``).

The JAX package routes these through its native ``aat_host.cpp`` when it
is built, and through these same numpy expressions otherwise; the two are
bitwise equal (``tests/test_runtime.py``). The port has the numpy route
only, so the float32 rounding it gives is the spec.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def assemble_segments(waveform: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                      out_lens: np.ndarray, max_frames: int) -> Tuple[np.ndarray, np.ndarray]:
    """Dense segment batch of one utterance: row s holds
    ``waveform[starts[s]:ends[s]]`` zero-padded to ``max_frames``, and its
    mask is 1 on the first ``out_lens[s]`` frames → (segments [S, F] f32,
    mask [S, F] f32)."""
    waveform = np.ascontiguousarray(waveform, np.float32)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    out_lens = np.ascontiguousarray(out_lens, np.int64)
    f = np.arange(max_frames)
    idx = np.clip(starts[:, None] + f[None, :], 0, waveform.shape[-1] - 1)
    in_data = f[None, :] < (ends - starts)[:, None]
    segments = np.where(in_data, waveform[idx], 0.0).astype(np.float32)
    mask = (f[None, :] < out_lens[:, None]).astype(np.float32)
    return segments, mask


def normalize_pad(waveforms: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row zero-mean/unit-var over the valid samples (float64), then
    right padding (HF processor semantics) → (f32 [B, L], int64 mask)."""
    from aat_tpu_torch.data.collate import zero_mean_unit_var_pad

    return zero_mean_unit_var_pad([np.ascontiguousarray(w, np.float64) for w in waveforms])


def smoothed_amplitude(amplitude_f32: np.ndarray, n_points: int) -> np.ndarray:
    """Running mean over ``n_points`` as differences of a sequential float32
    cumsum (numpy semantics: its rounding is visible to the 1e-5
    comparator downstream)."""
    c = np.cumsum(np.ascontiguousarray(amplitude_f32, np.float32))
    return (c[n_points:] - c[:-n_points]) / float(n_points)


def find_minima(smoothed: np.ndarray, eps: float = 1e-5,
                threshold: float = 15.0) -> np.ndarray:
    """Indices of epsilon-strict interior local maxima with value above
    ``threshold``, int64."""
    x = np.ascontiguousarray(smoothed, np.float32)
    if x.shape[-1] < 3:
        return np.zeros((0,), np.int64)
    interior = (x[1:-1] > x[2:] + np.float32(eps)) & (x[1:-1] > x[:-2] + np.float32(eps))
    idx = np.nonzero(interior)[0] + 1
    return idx[x[idx] > threshold]
