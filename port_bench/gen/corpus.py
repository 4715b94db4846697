"""A feature workdir made from a seed, in the layout the training CLI's
``prepare`` writes: ``file_list.txt`` (wav|speaker|phonemes|phonemes a
word), ``stats.json``, ``speakers.json`` and per utterance ``mels/``,
``f0/``, ``pitch/`` and ``energy/`` arrays beside a ``wavs/`` directory
(the wav files themselves are not needed past ``prepare`` and are not
written).

Lengths follow the mix file: the set of frame counts is the stated
distribution's stratified quantiles (a Beta on [min, max] seconds), the
seed draws their order; each utterance has about ``frames_per_phoneme``
frames a phoneme, jittered by +-``jitter``.  Phonemes are drawn from the
Vietnamese inventory (the reference's frozen copy), 2-5 to a word.  Mels,
f0 (0 where unvoiced), pitch and energy are smooth random contours.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np


def _smooth(rng, n: int, knots: int, lo: float, hi: float) -> np.ndarray:
    """A piecewise-linear contour through ``knots`` uniform values in [lo, hi]."""
    k = rng.uniform(lo, hi, size=max(knots, 2))
    return np.interp(np.linspace(0, len(k) - 1, n), np.arange(len(k)), k)


def frame_counts(mix: dict, hop: int, sr: int, seed: int) -> np.ndarray:
    from scipy.stats import beta

    n = mix["utterances"]
    lo, hi = (int(round(s * sr / hop)) for s in mix["seconds_range"])
    a, b = mix["beta"]
    q = (np.arange(n) + 0.5) / n
    frames = np.round(lo + (hi - lo) * beta.ppf(q, a, b)).astype(int)
    return frames[np.random.default_rng([seed, 4]).permutation(n)]


def write_workdir(root: str, mix: dict, config: dict, seed: int) -> List[dict]:
    """Write the workdir under ``root`` and return one record per utterance
    (id, speaker, phonemes, word sizes, frames)."""
    from ..reference.vie_text.symbols import SPECIALS, symbols

    audio = config["audio"]
    hop, sr = audio["stft"]["hop_length"], audio["signal"]["sampling_rate"]
    n_mels = audio["mel"]["channels"]
    inventory = [s for s in symbols if s not in {x.upper() for x in SPECIALS}]
    rng = np.random.default_rng([seed, 5])
    corpus = os.path.join(root, "corpus")
    for d in ("wavs", "mels", "f0", "pitch", "energy"):
        os.makedirs(os.path.join(corpus, d), exist_ok=True)
    speakers = [f"spk{i}" for i in range(mix["speakers"])]
    lines, records, seen = [], [], set()
    pitch_all, energy_all, f0_voiced = [], [], []
    for i, T in enumerate(frame_counts(mix, hop, sr, seed)):
        fpp = mix["frames_per_phoneme"] * rng.uniform(1 - mix["jitter"], 1 + mix["jitter"])
        L = max(4, int(round(T / fpp)))
        while True:
            phonemes = [inventory[j] for j in rng.integers(len(inventory), size=L)]
            if tuple(phonemes) not in seen:
                seen.add(tuple(phonemes))
                break
        words, left = [], L
        while left > 0:
            w = min(left, int(rng.integers(2, 6)))
            words.append(w)
            left -= w
        uid = f"u{i:05d}"
        spk = speakers[int(rng.integers(len(speakers)))]
        mel = (_smooth(rng, T, T // 16 + 2, -8.0, 0.0)[None, :]
               + rng.normal(0.0, 0.5, size=(n_mels, T))).astype(np.float32)
        voiced = _smooth(rng, T, T // 24 + 2, -1.0, 1.0) > -0.3
        f0 = np.where(voiced, _smooth(rng, T, T // 32 + 2, 110.0, 260.0), 0.0).astype(np.float32)
        pitch = _smooth(rng, T, T // 32 + 2, 100.0, 280.0).astype(np.float32)
        energy = _smooth(rng, T, T // 16 + 2, 5.0, 90.0).astype(np.float32)
        for d, arr in (("mels", mel), ("f0", f0), ("pitch", pitch), ("energy", energy)):
            np.save(os.path.join(corpus, d, f"{uid}.npy"), arr)
        pitch_all.append(pitch)
        energy_all.append(energy)
        f0_voiced.append(f0[f0 > 0])
        wav = os.path.join(corpus, "wavs", f"{uid}.wav")
        lines.append(f"{wav}|{spk}|{' '.join(phonemes)}|{' '.join(map(str, words))}")
        records.append(dict(id=uid, wav=wav, speaker=spk, phonemes=phonemes, words=words,
                            frames=int(T)))
    with open(os.path.join(root, "file_list.txt"), "w", encoding="utf8") as f:
        f.write("\n".join(lines) + "\n")
    p, e, v = (np.concatenate(x) for x in (pitch_all, energy_all, f0_voiced))
    stats = {"pitch": {"min": float(p.min()), "max": float(p.max()), "mean": float(p.mean()),
                       "std": float(p.std())},
             "energy": {"min": float(e.min()), "max": float(e.max()), "mean": float(e.mean()),
                        "std": float(e.std())},
             "f0": {"mean": float(v.mean()), "std": float(v.std())}}
    with open(os.path.join(root, "stats.json"), "w") as f:
        json.dump(stats, f)
    with open(os.path.join(root, "speakers.json"), "w") as f:
        json.dump({s: i for i, s in enumerate(speakers)}, f)
    return records
