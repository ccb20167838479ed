"""The port's tracing (``utils/timing``): ``span`` does nothing while no
profiler records and emits ordered, nested markers while one does; device
spans on the CPU record no event; the data layer's counters; RecordTimings
on ``span``; and dropout's values unchanged under an active span."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aat_tpu_torch.data.dataloaders import BatchIterator
from aat_tpu_torch.ops.dropout import dropout
from aat_tpu_torch.utils import timing


@pytest.fixture(autouse=True)
def fresh_counters():
    timing.reset()
    yield
    timing.reset()


def markers(prof):
    """The ``aat.`` markers of a profiler pass, in time order."""
    found = [(e.time_range.start, e.name) for e in prof.events() if e.name.startswith("aat.")]
    return [name for _, name in sorted(found)]


def refuse(*args, **kwargs):
    raise AssertionError("called while it should not be")


def test_span_off_is_one_shared_no_op(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    a, b = timing.span("a"), timing.span("b", device=True)
    assert a is b
    with a:
        with b:
            torch.ones(3).sum()
    assert timing.counters() == {}


def test_span_markers_are_ordered_and_nested():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("outer"):
            for _ in range(2):
                with timing.span("inner"):
                    torch.ones(8).sum()
    assert markers(prof) == ["aat.outer.begin", "aat.inner.begin", "aat.inner.end",
                             "aat.inner.begin", "aat.inner.end", "aat.outer.end"]
    got = timing.counters()
    assert got["span.outer.calls"] == 1 and got["span.inner.calls"] == 2


def test_device_span_without_cuda_records_no_event(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("dev", device=True):
            torch.ones(8).sum()
    assert markers(prof) == ["aat.dev.begin", "aat.dev.end"]
    assert timing.counters() == {"span.dev.calls": 1}


def test_batch_iterator_counts_gets_waits_and_collates():
    def collate(items):
        time.sleep(0.03)
        return {"x": np.asarray(items)}

    it = BatchIterator(list(range(3)), collate, batch_size=1, shuffle=False, prefetch=2)
    for _ in range(2):
        for _batch in it:
            time.sleep(0.1)
    got = timing.counters()
    # only the first get of each epoch finds the fresh prefetch queue empty
    assert got["data.empty_gets"] == 2
    assert got["data.gets"] == got["data.batches"] == 6
    assert got["data.collate_s"] >= 0.18
    assert got["data.wait_s"] >= 0.05


def test_record_timings_marks_its_section():
    timings = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.RecordTimings(timings, "section"):
            time.sleep(0.01)
    assert markers(prof) == ["aat.section.begin", "aat.section.end"]
    assert timings["section"] >= 0.01


def test_dropout_under_an_active_span_is_bit_for_bit():
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (4, 9, 17)).astype(np.float32))
    off = dropout(12345, x, 0.1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("outer"):
            on = dropout(12345, x, 0.1)
    assert torch.equal(on, off)
    assert markers(prof) == ["aat.outer.begin", "aat.ops.dropout.begin", "aat.ops.dropout.end",
                             "aat.outer.end"]
    assert timing.counters()["span.ops.dropout.calls"] == 1
