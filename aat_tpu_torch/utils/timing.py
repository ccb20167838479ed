"""Timing, tracing and profiling helpers (counterpart of
``aat_tpu/utils/timing.py``).

- :func:`span` marks a named section on the ``torch.profiler`` clock while
  a profiler records, and costs one flag test when none does.
- :func:`count`, :func:`counters` and :func:`reset`: a process-wide table
  of counters, always on, for per-batch rates (not per-kernel ones);
  :func:`count_device` adds a device scalar, read when the table is read.
- :class:`RecordTimings` adds the host seconds of a named section to a
  caller's dict, through :func:`span`.
- :func:`profile_trace` writes a ``torch.profiler`` trace of a code region.

A span that is on emits two zero-length host markers,
``aat.<name>.begin`` and ``aat.<name>.end``, rather than one
``record_function`` range: Kineto turns a range that encloses kernel
launches into a device-side ``gpu_user_annotation`` event, which would
enter every union of device intervals read from the trace (busy time, idle
gaps). A marker encloses no launch. Markers reach the profiler only from
threads it follows (the caller's and autograd's); a thread that code
starts while the profiler records is not followed, so work in such a
thread is counted, not spanned.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Tuple

import torch
from torch._C._autograd import _profiler_enabled


class _Table:
    """Counters by name, and the CUDA event pairs of device spans and the
    device scalars of counters not yet read (resolved into
    ``span.<name>.device_s`` and their counters when the table is read)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._values: Dict[str, float] = {}
        self._pending: List[Tuple[str, object, object]] = []
        self._scalars: List[Tuple[str, object]] = []

    def add(self, name: str, value: float):
        with self._lock:
            self._values[name] = self._values.get(name, 0) + value

    def add_pair(self, name: str, start, end):
        with self._lock:
            self._pending.append((name, start, end))

    def add_scalar(self, name: str, value):
        with self._lock:
            self._scalars.append((name, value))

    def read(self) -> Dict[str, float]:
        with self._lock:
            for name, start, end in self._pending:
                end.synchronize()
                self._values[name] = self._values.get(name, 0) + start.elapsed_time(end) / 1e3
            for name, value in self._scalars:
                self._values[name] = self._values.get(name, 0) + float(value)
            self._pending.clear()
            self._scalars.clear()
            return dict(self._values)

    def clear(self):
        with self._lock:
            self._values.clear()
            self._pending.clear()
            self._scalars.clear()


_TABLE = _Table()


def count(name: str, value: float = 1):
    """Add ``value`` to the counter ``name``."""
    _TABLE.add(name, value)


def count_device(name: str, value):
    """Add ``value``, a number or a device scalar, to the counter ``name``
    when the table is next read: the caller waits for no device. Callers
    count so only while a profiler records."""
    _TABLE.add_scalar(name, value)


def counters() -> Dict[str, float]:
    """A copy of the counter table, device spans' pending event pairs read
    first (each waits for its end event)."""
    return _TABLE.read()


def reset():
    """Empty the counter table."""
    _TABLE.clear()


def _mark(name: str):
    with torch.profiler.record_function(name):
        pass


class _Off:
    """The span while no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "device", "_start")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.device = device

    def __enter__(self):
        _mark(f"aat.{self.name}.begin")
        count(f"span.{self.name}.calls")
        self._start = None
        if self.device and torch.cuda.is_initialized():
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream())
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream())
            _TABLE.add_pair(f"span.{self.name}.device_s", self._start, end)
        _mark(f"aat.{self.name}.end")
        return False


def span(name: str, device: bool = False):
    """A context manager marking the section ``name``.

    While no torch profiler records in the process it is one shared object
    that does nothing. While one records it emits the markers
    ``aat.<name>.begin`` and ``aat.<name>.end`` on the profiler's clock and
    counts ``span.<name>.calls``. With ``device`` (the section's work runs
    on CUDA, so CUDA is initialised) it also records a timing event pair
    on the current CUDA stream, read into ``span.<name>.device_s``:
    stream-order device time from the device reaching the section's first
    launch to its finishing the last, gaps between them included."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, device)


class RecordTimings:
    """A reusable context manager that adds the seconds spent inside it to
    ``metrics[key]``, and marks the section as ``span(key)``::

        timings: Dict[str, float] = {}
        with RecordTimings(timings, "collate"):
            ...
    """

    def __init__(self, metrics: Dict[str, float], key: str):
        self.metrics = metrics
        self.key = key

    def __enter__(self):
        self._span = span(self.key)
        self._span.__enter__()
        self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        elapsed = time.perf_counter() - self._start
        self.metrics[self.key] = self.metrics.get(self.key, 0.0) + elapsed
        return self._span.__exit__(exc_type, exc_value, traceback)


@contextlib.contextmanager
def profile_trace(logdir: str = "aat_tpu_torch_trace"):
    """``torch.profiler`` trace of the region, the CPU and (where there is
    one) the CUDA timeline with the spans' markers, written as a Chrome
    trace ``<logdir>/trace.json`` when the region ends; yields the
    profiler, so the caller can read ``key_averages()`` too. The JAX
    package's counterpart writes a ``jax.profiler`` trace into ``logdir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
