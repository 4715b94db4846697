"""Open-loop arrival schedules.

Poisson arrivals at rate r over a window of s seconds, with the same work
on every seed: n = round(r * s) requests whose inter-arrival gaps are the
exponential distribution's stratified quantiles (mean 1 / r), in an order
the seed draws, scaled to fill the window.  Runs on different seeds then
differ in when the bursts come, not in how many requests or how bursty.
The driver records each request's due time and how late it was sent.
"""

from __future__ import annotations

import numpy as np


def poisson_due_times(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times in seconds from the window's start, sorted, the first at 0."""
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    gaps = gaps[np.random.default_rng([seed, 3]).permutation(n)]
    due = np.cumsum(gaps) - gaps[0]
    return due * (seconds / gaps.sum())
