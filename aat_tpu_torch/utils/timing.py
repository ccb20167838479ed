"""Timing and profiling helpers (counterpart of ``aat_tpu/utils/timing.py``):
:class:`RecordTimings`, wall-clock seconds of named sections, and
:func:`profile_trace`, a ``torch.profiler`` trace of a code region."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict


class RecordTimings:
    """A reusable context manager that adds the seconds spent inside it to
    ``metrics[key]``::

        timings: Dict[str, float] = {}
        with RecordTimings(timings, "collate"):
            ...
    """

    def __init__(self, metrics: Dict[str, float], key: str):
        self.metrics = metrics
        self.key = key

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        elapsed = time.perf_counter() - self._start
        self.metrics[self.key] = self.metrics.get(self.key, 0.0) + elapsed
        return False


@contextlib.contextmanager
def profile_trace(logdir: str = "aat_tpu_torch_trace"):
    """``torch.profiler`` trace of the region, the CPU and (where there is
    one) the CUDA timeline, written as a Chrome trace
    ``<logdir>/trace.json`` when the region ends; yields the profiler, so
    the caller can read ``key_averages()`` too. The JAX package's
    counterpart writes a ``jax.profiler`` trace into ``logdir``."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
