"""Perceptual evaluation harness (port of ``e2e_tts_tpu/utils/metrics.py``).

Scores a tree of wavs, per speaker, with the best scorer available:

- ``MosnetScorer``: MOSNet through ``speechmetrics`` when it is installed
  (the reference's scorer);
- ``LearnedMosScorer``: the learned degradation metric
  (``models/mos.py``), on the card unless ``device="cpu"``;
- ``DspProxyScorer``: a signal-health proxy (clipping rate, silence,
  spectral flatness, DC offset) mapped to 1-5; not a perceptual MOS.

``evaluate_directory`` takes a wav tree and returns per-speaker average
scores; ``main`` is its command line (``e2e-tts-torch-mos``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, List

import numpy as np

from ..audio.wav import read_wav


class DspProxyScorer:
    """Heuristic audio-health score in [1, 5] (proxy, not perceptual MOS)."""

    window_s: float = 10.0

    def __call__(self, audio: np.ndarray, sample_rate: int) -> float:
        if len(audio) == 0:
            return 1.0
        score = 5.0
        # clipping penalty
        clip_rate = float(np.mean(np.abs(audio) > 0.999))
        score -= min(2.0, clip_rate * 200)
        # near-silence penalty
        rms = float(np.sqrt(np.mean(audio**2)))
        if rms < 1e-4:
            score -= 3.0
        elif rms < 1e-3:
            score -= 1.5
        # spectral flatness: white-noise-like output scores low
        spec = np.abs(np.fft.rfft(audio[: sample_rate * 10])) + 1e-10
        flatness = float(
            np.exp(np.mean(np.log(spec))) / np.mean(spec)
        )
        score -= min(1.5, flatness * 4)
        # DC offset
        score -= min(0.5, abs(float(np.mean(audio))) * 50)
        return float(np.clip(score, 1.0, 5.0))


class MosnetScorer:
    """MOSNet via speechmetrics, matching the reference (mos_test.py:17-18)."""

    def __init__(self):
        import speechmetrics  # noqa: F401 — optional dependency

        self._metric = speechmetrics.load("mosnet", 10)

    def __call__(self, audio: np.ndarray, sample_rate: int) -> float:
        out = self._metric(audio, rate=sample_rate)
        return float(np.mean(out["mosnet"]))


class LearnedMosScorer:
    """The learned degradation metric (``models/mos.py``): a conv regressor
    trained on calibrated corruptions of clean speech, on MOSNet's [1, 5]
    scale.  It ranks cleaner audio higher; it is not a human-MOS estimate.
    The weights are ``assets/mos/mos.msgpack``; it scores on ``device``
    (CUDA unless ``device="cpu"``)."""

    def __init__(self, asset_dir: str = None, device=None):
        from ..convert import load_into
        from ..models.mos import MosPredictor
        from ..serve.bundle import read_msgpack

        if asset_dir is None:
            repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
            asset_dir = os.path.join(repo, "assets", "mos")
        path = os.path.join(asset_dir, "mos.msgpack")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.model = MosPredictor(device=device)
        load_into(self.model, read_msgpack(path))

    def __call__(self, audio: np.ndarray, sample_rate: int) -> float:
        from ..models.mos import score_audio

        return score_audio(self.model, audio, sample_rate)


def make_scorer(device=None) -> Callable[[np.ndarray, int], float]:
    """Best available scorer: MOSNet (the reference's) > the learned
    degradation metric on ``device`` > the DSP health proxy."""
    try:
        return MosnetScorer()
    except Exception:
        # anything from 'speechmetrics not installed' to missing model
        # files or TF load errors: fall back rather than fail the gate
        pass
    try:
        return LearnedMosScorer(device=device)
    except (FileNotFoundError, ImportError):
        return DspProxyScorer()


def evaluate_directory(
    wav_dir: str,
    scorer: Callable[[np.ndarray, int], float] = None,
    device=None,
) -> Dict[str, float]:
    """Score every wav under wav_dir; per-speaker averages keyed by the
    immediate parent directory (reference layout: wavs/<speaker>/*.wav).
    Without a ``scorer``, ``make_scorer(device)``'s."""
    scorer = scorer or make_scorer(device)
    per_speaker: Dict[str, List[float]] = {}
    for root, _dirs, files in os.walk(wav_dir):
        for name in sorted(files):
            if not name.lower().endswith(".wav"):
                continue
            audio, sr = read_wav(os.path.join(root, name))
            speaker = os.path.basename(root) or "default"
            per_speaker.setdefault(speaker, []).append(scorer(audio, sr))
    return {spk: float(np.mean(v)) for spk, v in per_speaker.items() if v}


def main(argv=None):
    p = argparse.ArgumentParser(description="MOS evaluation harness")
    p.add_argument("--wav-dir", required=True)
    p.add_argument("--output", default="mos_scores.json")
    p.add_argument("--device", default="cuda",
                   help="where the learned scorer runs (cuda, or cpu)")
    args = p.parse_args(argv)
    scores = evaluate_directory(args.wav_dir, device=args.device)
    with open(args.output, "w") as f:
        json.dump(scores, f, indent=1)
    print(json.dumps(scores, indent=1))


if __name__ == "__main__":
    main()
