"""Wall-clock timing of named sections (counterpart of
``aat_tpu/utils/timing.py`` ``RecordTimings``)."""

from __future__ import annotations

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
