"""Seeded Vietnamese text for the serving mixes.

Sentences are syllables drawn from ``syllables.txt`` (the syllables of
``bench.py``'s 16 sentences and of the synthetic corpus's vocabulary), with
a comma every few syllables and a full stop at the end.  A mix file states
the distribution of lengths; the set of lengths of a run is the mix's own
(stratified quantiles of that distribution), and the seed draws their order
(or, with the mix's ``slices_seed``, the order of fixed slices of them:
``schedule.arranged``) and the words, so runs on different seeds do the
same amount of work.  No two texts of a run are equal.
"""

from __future__ import annotations

import os
from statistics import NormalDist
from typing import List, Optional

import numpy as np

from .schedule import arranged, dealt

_HERE = os.path.dirname(os.path.abspath(__file__))


def syllables() -> List[str]:
    with open(os.path.join(_HERE, "syllables.txt"), encoding="utf8") as f:
        return [w for w in (line.strip() for line in f) if w]


def _stratified(n: int, ppf) -> np.ndarray:
    """n draws of a distribution as its quantiles at (i + 0.5) / n."""
    return np.array([ppf((i + 0.5) / n) for i in range(n)])


def lengths(spec: dict, n: int, rng: Optional[np.random.Generator],
            slice_requests: Optional[int] = None,
            order: Optional[np.ndarray] = None) -> np.ndarray:
    """n integer lengths (characters, or syllables for ``unit: syllables``)
    from a mix's ``length`` spec, in an order drawn from ``rng`` (dealt over
    slices of ``slice_requests``, where given; ``schedule.dealt``) or in the
    ``order`` given (``schedule.arranged``):
    ``{"dist": "lognormal", "median": m, "sigma": s, "min": a, "max": b}`` or
    ``{"dist": "uniform", "min": a, "max": b}``."""
    lo, hi = spec["min"], spec["max"]
    if spec["dist"] == "lognormal":
        nd = NormalDist(np.log(spec["median"]), spec["sigma"])
        vals = np.exp(_stratified(n, nd.inv_cdf))
    elif spec["dist"] == "uniform":
        vals = _stratified(n, lambda q: lo + q * (hi + 1 - lo))
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    vals = np.clip(np.floor(vals), lo, hi).astype(int)
    return vals[dealt(n, slice_requests, rng) if order is None else order]


class TextMaker:
    """Sentences and texts of given lengths from one generator; every text
    it returns is new."""

    def __init__(self, rng: np.random.Generator, sentence_syllables=(6, 20), comma_every=(4, 9)):
        self.rng = rng
        self.words = syllables()
        self.sentence_syllables = sentence_syllables
        self.comma_every = comma_every
        self.seen = set()

    def sentence(self, n_syllables: int, stop: bool = True) -> str:
        rng, out, since = self.rng, [], 0
        gap = int(rng.integers(*self.comma_every, endpoint=True))
        for i in range(n_syllables):
            w = self.words[int(rng.integers(len(self.words)))]
            since += 1
            if since == gap and i < n_syllables - 1:
                w += ","
                since, gap = 0, int(rng.integers(*self.comma_every, endpoint=True))
            out.append(w)
        text = " ".join(out)
        return text + "." if stop else text

    def _new(self, make) -> str:
        for _ in range(1000):
            text = make()
            if text not in self.seen:
                self.seen.add(text)
                return text
        raise RuntimeError("could not draw a new text in 1000 tries")

    def text_of_chars(self, n_chars: int) -> str:
        """Sentences until the text has ``n_chars`` characters, cut at the
        last syllable that fits (at least one syllable)."""
        def make():
            parts, size = [], 0
            while size < n_chars + 1:
                s = self.sentence(int(self.rng.integers(*self.sentence_syllables,
                                                        endpoint=True)))
                parts.append(s)
                size += len(s) + 1
            text = " ".join(parts)
            if len(text) > n_chars:
                cut = text.rfind(" ", 0, n_chars + 1)
                text = text[:cut] if cut > 0 else text.split(" ")[0]
            return text.rstrip(",")
        return self._new(make)

    def text_of_syllables(self, n: int) -> str:
        return self._new(lambda: self.sentence(n))


def make_texts(mix: dict, n: int, seed: int) -> List[str]:
    """The n texts of a serving mix for ``seed``: ``mix["length"]`` gives
    their lengths (``unit`` "chars" or "syllables"), ``mix["sentence_syllables"]``
    the sentences' lengths, ``mix["slice_requests"]`` the slices they are
    dealt over and ``mix["slices_seed"]`` the fixed seed of those slices
    (``schedule.arranged``)."""
    rng = np.random.default_rng([seed, 1])
    spec = mix["length"]
    maker = TextMaker(rng, tuple(mix.get("sentence_syllables", (6, 20))))
    if mix.get("slices_seed") is None:
        sizes = lengths(spec, n, rng, mix.get("slice_requests"))
    else:
        sizes = lengths(spec, n, None, order=arranged(n, mix["slice_requests"], seed, 1,
                                                      mix["slices_seed"]))
    if spec.get("unit", "chars") == "syllables":
        return [maker.text_of_syllables(int(k)) for k in sizes]
    return [maker.text_of_chars(int(k)) for k in sizes]


def speakers_of(mix: dict, n: int, seed: int) -> List[int]:
    """Each request's speaker, uniform over the mix's ``speakers``."""
    rng = np.random.default_rng([seed, 2])
    return [int(s) for s in rng.integers(mix["speakers"], size=n)]
