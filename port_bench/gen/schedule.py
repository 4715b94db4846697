"""Open-loop arrival schedules.

Poisson arrivals at rate r over a window of s seconds, with the same work
on every seed: n = round(r * s) requests whose inter-arrival gaps are the
exponential distribution's stratified quantiles (mean 1 / r), in an order
the seed draws, scaled to fill the window.  Runs on different seeds then
differ in when the bursts come, not in how many requests or how bursty.
A mix may deal its gaps and lengths over slices of ``slice_requests``
requests (``dealt``): every slice then holds one of each stratum, and the
seed draws the order within it, so no seed crowds its longest requests or
its shortest gaps into one part of the window.
A mix that also gives ``slices_seed`` deals its gaps and lengths from that
fixed seed, cuts the window into blocks of ``slice_requests`` consecutive
requests, each with its gaps and lengths, and lets the seed draw the
blocks' order (``arranged``): every seed then runs the same bursts behind
the same long requests, at other times of the window.
The driver records each request's due time and how late it was sent.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np


def dealt_slices(n: int, slice_requests: int, rng: np.random.Generator) -> List[np.ndarray]:
    """The ranks 0..n-1 of n sorted values dealt over k = ceil(n /
    slice_requests) slices: each stratum of k neighbouring ranks one to a
    slice (the last, shorter stratum to slices the seed picks), each slice's
    ranks in an order the seed draws."""
    k = max(1, math.ceil(n / slice_requests))
    slot = np.concatenate([rng.permutation(k)[:min(k, n - start)] for start in range(0, n, k)])
    return [rng.permutation(np.flatnonzero(slot == j)) for j in range(k)]


def dealt(n: int, slice_requests: Optional[int], rng: np.random.Generator) -> np.ndarray:
    """An order of the ranks 0..n-1 of n sorted values: any the seed draws,
    or with ``slice_requests`` the slices of ``dealt_slices`` one after the
    other, each slice a run of consecutive requests."""
    if not slice_requests:
        return rng.permutation(n)
    return np.concatenate(dealt_slices(n, slice_requests, rng))


def arranged(n: int, slice_requests: Optional[int], seed: int, stream: int,
             slices_seed: Optional[int] = None) -> np.ndarray:
    """The order of the ranks 0..n-1 of a mix's sorted gaps (``stream`` 3)
    or lengths (``stream`` 1) for ``seed``: ``dealt`` from the seed's own
    generator; with ``slices_seed``, ``dealt`` from that fixed seed's, then
    cut into blocks of ``slice_requests`` consecutive requests that are put
    in an order the seed draws, the same for both streams, so each block
    keeps its gaps beside its lengths."""
    if slices_seed is None:
        return dealt(n, slice_requests, np.random.default_rng([seed, stream]))
    base = dealt(n, slice_requests, np.random.default_rng([slices_seed, stream]))
    blocks = [base[i:i + slice_requests] for i in range(0, n, slice_requests)]
    order = np.random.default_rng([seed, 4]).permutation(len(blocks))
    return np.concatenate([blocks[j] for j in order])


def poisson_due_times(rate: float, seconds: float, seed: int,
                      slice_requests: Optional[int] = None,
                      slices_seed: Optional[int] = None) -> np.ndarray:
    """Due times in seconds from the window's start, sorted, the first at 0."""
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    gaps = gaps[arranged(n, slice_requests, seed, 3, slices_seed)]
    due = np.cumsum(gaps) - gaps[0]
    return due * (seconds / gaps.sum())
