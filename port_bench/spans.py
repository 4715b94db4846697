"""The program's own spans and counters (``e2e_tts_tpu_torch.utils.tracing``),
which it records while the traced window's profiler runs, and the interval
arithmetic their readers share.  A program without the tracer gives
``records() is None``, and its readers return None: the metric is left out
of the line."""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

Interval = Tuple[int, int]


def records() -> Optional[tuple]:
    """(spans, counts) recorded in this process, or None."""
    try:
        from e2e_tts_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.spans(), tracing.counts()


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The intervals merged: sorted and disjoint."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [(s, e) for s, e in out]


def minus(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """The merged intervals ``a`` less the merged intervals ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def measure(intervals: List[Interval]) -> int:
    return sum(e - s for s, e in intervals)


def device_busy(rec) -> List[Interval]:
    """The window's device operations (``trace.read``'s ``ops``), merged."""
    return union((s, e) for _, s, e, _ in rec["ops"])


def duration_ns(span) -> int:
    return span.end_ns - span.start_ns
