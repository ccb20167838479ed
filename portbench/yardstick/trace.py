"""Reductions of a profiler trace to numbers, on plain lists of
``(name, start_us, end_us)``: the device's busy time as the union of its
operation intervals (a copy of ``chip_smoke.profile_training_step``'s
arithmetic), the operations that took most device time, and the longest
idle gaps named by what the host was doing when each began."""

from __future__ import annotations

import bisect
from typing import Dict, List, Sequence, Tuple

Span = Tuple[str, float, float]


def busy_us(ops: Sequence[Span]) -> float:
    """Length of the union of the operations' intervals."""
    total, end = 0.0, float("-inf")
    for _, lo, hi in sorted(ops, key=lambda s: s[1]):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def idle_gaps(ops: Sequence[Span], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The intervals of ``[lo, hi]`` in which no operation ran."""
    gaps, cursor = [], lo
    for _, start, end in sorted(ops, key=lambda s: s[1]):
        if start > cursor:
            gaps.append((cursor, min(start, hi)))
        cursor = max(cursor, end)
        if cursor >= hi:
            break
    if cursor < hi:
        gaps.append((cursor, hi))
    return [(a, b) for a, b in gaps if b > a]


def top_ops(ops: Sequence[Span], n: int = 10) -> List[list]:
    """``[[name, seconds], ...]``: the ``n`` operation names with the most
    device time, summed over their launches."""
    by_name: Dict[str, float] = {}
    for name, start, end in ops:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], us / 1e6] for name, us in ranked]


def host_at(host_ops: Sequence[Span], starts: Sequence[float], t: float) -> str:
    """The innermost host operation running at ``t`` (the latest-starting
    one whose interval holds ``t``), or ``"host idle"``; ``host_ops`` sorted
    by start, ``starts`` their starts."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(i - 500, 0) - 1, -1):  # the 500 latest starts
        name, start, end = host_ops[j]
        if end >= t:
            best = name
            break
    return best or "host idle"


SHORT_GAP_US = 20.0


def gaps_by_host(ops: Sequence[Span], host_ops: Sequence[Span], lo: float, hi: float,
                 n: int = 10) -> List[list]:
    """``[[host operation, seconds], ...]``: the device's idle time in
    ``[lo, hi]``, each gap named by the host operation running when it
    began, summed by name, the ``n`` largest. Gaps under ``SHORT_GAP_US``
    (launch to launch) are summed under one name of their own."""
    host_sorted = sorted(host_ops, key=lambda s: s[1])
    starts = [s for _, s, _ in host_sorted]
    by_name: Dict[str, float] = {}
    for a, b in idle_gaps(ops, lo, hi):
        name = (host_at(host_sorted, starts, a) if b - a >= SHORT_GAP_US
                else f"gaps under {SHORT_GAP_US:g} us")
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], us / 1e6] for name, us in ranked]


def device_time_us(ops: Sequence[Span], patterns: Sequence[str]) -> float:
    """Device time of the operations whose name holds any of ``patterns``."""
    return sum(end - start for name, start, end in ops
               if any(p in name for p in patterns))
