"""What a driver hands the harness after its window."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List


@dataclass
class Outcome:
    metrics: Dict[str, float]          # the cell's end-to-end metrics but setup_s
    attempted: int
    failed: int
    counters: Dict = field(default_factory=dict)   # what the per-layer readers read
    spans: List[tuple] = field(default_factory=list)  # (start_ns, end_ns, label)
    check: Callable[..., Dict[str, float]] = None  # compared numbers, by name; check(control=...)
    close: Callable[[], None] = lambda: None       # removes what the run wrote


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least q%
    of the values at or below it."""
    v = sorted(values)
    if not v:
        return math.nan
    k = max(1, math.ceil(q / 100.0 * len(v)))
    return float(v[k - 1])
