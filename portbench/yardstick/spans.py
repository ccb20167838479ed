"""What the per-layer readers take from the port's own tracing
(``aat_tpu_torch.utils.timing``): its counter table, and its spans rebuilt
from the ``aat.<name>.begin`` / ``aat.<name>.end`` markers among a profiler
pass's host operations, with the device's idle gaps put down to them.

A program without that tracing (no ``counters()``, no markers) gives
``None`` throughout, never an error."""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

from portbench.yardstick import trace

PREFIX = "aat."
# the spans of the training step, by the phase their idle gaps count to
MODEL = ("train.forward", "train.backward")


def port_counters() -> Optional[Dict[str, float]]:
    """The port's counter table, or ``None`` where the port has none."""
    try:
        from aat_tpu_torch.utils import timing
    except ImportError:
        return None
    read = getattr(timing, "counters", None)
    return read() if read is not None else None


def device_ms_per_step(span: str) -> Optional[float]:
    """``span``'s device milliseconds over the profiled training steps:
    ``span.<span>.device_s`` over ``span.train.step.calls``. Both exist
    only for the steps a profiler recorded."""
    table = port_counters()
    if not table:
        return None
    steps, seconds = table.get("span.train.step.calls"), table.get(f"span.{span}.device_s")
    if not steps or seconds is None:
        return None
    return 1e3 * seconds / steps


def ratio(numerator: str, denominator: str, scale: float) -> Optional[float]:
    """``scale`` × one counter over another, or ``None`` without them."""
    table = port_counters()
    if not table or not table.get(denominator) or numerator not in table:
        return None
    return scale * table[numerator] / table[denominator]


Span = Tuple[str, float, float, Tuple[str, ...]]


def spans(host_ops: Sequence[Tuple[str, float, float]]) -> List[Span]:
    """The port's spans from their markers, ``(name, begin_us, end_us,
    enclosing names outermost first)``, in order of their begin: a span
    runs from its begin marker's start to its end marker's end. Markers of
    one thread nest; the autograd thread's run while the caller waits in
    the backward, inside its span. An end without its begin is dropped, a
    begin without its end runs to the last marker."""
    marks = sorted((start if name.endswith(".begin") else end, name)
                   for name, start, end in host_ops
                   if name.startswith(PREFIX) and name.endswith((".begin", ".end")))
    open_: List[Tuple[str, float]] = []
    out: List[Span] = []
    for t, mark in marks:
        name, edge = mark[len(PREFIX):].rsplit(".", 1)
        if edge == "begin":
            open_.append((name, t))
            continue
        for i in range(len(open_) - 1, -1, -1):
            if open_[i][0] == name:
                out.append((name, open_[i][1], t, tuple(n for n, _ in open_[:i])))
                del open_[i]
                break
    last = marks[-1][0] if marks else 0.0
    for i, (name, begin) in enumerate(open_):
        out.append((name, begin, last, tuple(n for n, _ in open_[:i])))
    return sorted(out, key=lambda s: s[1])


def phase_at(ordered: Sequence[Span], begins: Sequence[float], t: float) -> Optional[Span]:
    """The innermost span open at ``t`` (the latest-beginning one whose
    interval holds it), or ``None``."""
    for j in range(bisect.bisect_right(begins, t) - 1, -1, -1):
        span = ordered[j]
        if span[2] >= t:
            return span
        if not span[3]:  # an outermost span ended before t: nothing before it is open
            return None
    return None


def idle_by_phase(obs: dict) -> Optional[Dict[str, float]]:
    """The traced steps' idle device time in µs, by the port's span open on
    the host when each gap began (``trace.gaps_by_host``'s rule on the
    port's spans): ``h2d`` (innermost ``train.h2d``), ``model``
    (``train.forward``, ``train.backward`` or a span inside them),
    ``between_steps`` (no ``train.step`` open), ``other``; and ``steps``,
    the ``train.step`` spans. ``None`` without markers or a device trace."""
    ops, window = obs.get("device_ops"), obs.get("traced_window_us")
    if not ops or not window:
        return None
    ordered = spans(obs.get("host_ops") or [])
    steps = sum(1 for s in ordered if s[0] == "train.step")
    if not steps:
        return None
    begins = [s[1] for s in ordered]
    out = {"h2d": 0.0, "model": 0.0, "between_steps": 0.0, "other": 0.0, "steps": steps}
    for a, b in trace.idle_gaps(ops, *window):
        span = phase_at(ordered, begins, a)
        chain = () if span is None else span[3] + (span[0],)
        if "train.step" not in chain:
            key = "between_steps"
        elif span[0] == "train.h2d":
            key = "h2d"
        elif any(name in MODEL for name in chain):
            key = "model"
        else:
            key = "other"
        out[key] += b - a
    return out


def idle_ms_per_step(obs: dict, phase: str) -> Optional[float]:
    got = idle_by_phase(obs)
    return None if got is None else got[phase] / 1e3 / got["steps"]
