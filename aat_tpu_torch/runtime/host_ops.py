"""Host numpy routines of the per-utterance tokenizer (counterpart of
``aat_tpu/runtime/host_ops.py:77-109``).

The JAX package routes these through its native ``aat_host.cpp`` when it
is built, and through these same numpy expressions otherwise; the two are
bitwise equal (``tests/test_runtime.py``). The port has the numpy route
only, so the float32 rounding it gives is the spec.
"""

from __future__ import annotations

import numpy as np


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
