"""The traced window: ``torch.profiler`` with CUDA activity (CUPTI: every
kernel and memory operation on the card, from any thread, and the runtime
calls that launched them), read from its in-memory events.

- ``busy_s``: the union of the device operations' intervals in the window
  (overlapping operations count once), the arithmetic of
  ``chip_smoke.profile_busy``;
- each kernel is labelled with the benchmark's span (``time.time_ns``)
  that holds the host call that launched it; the profiler's clock is not
  ``time.time_ns``'s, so ``marks`` (host times around three
  ``torch.cuda._sleep`` launches at the window's start) give the offset
  between the two;
- the breakdown: the device operations that took most time, and the idle
  gaps summed by the span the host was in (``host`` outside every span).
"""

from __future__ import annotations

import bisect
import statistics
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch


def start():
    """(profiler, marks): the profiler running, and the host times around
    three marker launches (on a card)."""
    act = torch.profiler.ProfilerActivity
    on_card = torch.cuda.is_available()
    prof = torch.profiler.profile(activities=[act.CUDA if on_card else act.CPU])
    prof.start()
    marks = []
    for _ in range(3 if on_card else 0):
        a = time.time_ns()
        torch.cuda._sleep(1)
        marks.append((a + time.time_ns()) // 2)
    return prof, marks


MARKER = "spin_kernel"


class Spans:
    """Labelled host intervals; ``at(t)`` gives the innermost one holding t."""

    def __init__(self, spans: List[Tuple[int, int, str]]):
        self.spans = sorted(spans)
        self.starts = [s[0] for s in self.spans]

    def at(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - 64, -1), -1):
            s, e, label = self.spans[j]
            if s <= t <= e:
                return label
        return None


def read(prof, spans: List[Tuple[int, int, str]], t0_ns: int, t1_ns: int, marks) -> Dict:
    """The window's device operations: a list of (name, start_ns, end_ns,
    label) on the host clock, busy_s, window_s and the breakdown."""
    events = prof.profiler.kineto_results.events()
    launches, device = {}, []
    for e in events:
        if str(e.device_type()).endswith("CUDA"):
            device.append(e)
        elif e.correlation_id():
            launches[e.correlation_id()] = e.start_ns()
    markers = sorted(launches[e.correlation_id()] for e in device
                     if MARKER in e.name() and e.correlation_id() in launches)[:len(marks)]
    offset = (int(statistics.median(m - h for m, h in zip(markers, marks)))
              if len(markers) == len(marks) and marks else 0)
    index = Spans(spans)
    ops = []
    linked = 0
    for e in device:
        s, d = e.start_ns() - offset, e.duration_ns()
        if s + d < t0_ns or s > t1_ns or MARKER in e.name():
            continue
        launch = launches.get(e.correlation_id())
        linked += launch is not None
        ops.append((e.name(), s, s + d, index.at(launch - offset) if launch is not None else None))
    ops.sort(key=lambda o: o[1])
    busy, end, gaps = 0, t0_ns, []
    for name, s, e, _ in ops:
        s, e = max(s, t0_ns), min(e, t1_ns)
        if s > end:
            gaps.append((end, s))
        busy += max(0, e - max(s, end))
        end = max(end, e)
    if t1_ns > end:
        gaps.append((end, t1_ns))
    by_name = defaultdict(float)
    for name, s, e, _ in ops:
        by_name[name] += (e - s) / 1e9
    by_gap = defaultdict(float)
    for a, b in gaps:
        by_gap[index.at((a + b) // 2) or "host"] += (b - a) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"ops": ops, "busy_s": busy / 1e9, "window_s": (t1_ns - t0_ns) / 1e9,
            "linked": linked, "offset_ns": offset, "breakdown": {"device_ops": top(by_name), "idle_gaps": top(by_gap)}}
