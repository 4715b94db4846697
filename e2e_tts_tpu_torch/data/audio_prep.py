"""Corpus audio normalization (a copy of ``e2e_tts_tpu/data/audio_prep.py``;
reference: modules/metrics/audio_processing.py).

Loudness normalization to a dBFS target, mono downmix, resampling to the
corpus rate, and silence trimming — implemented natively (the reference uses
pydub + ffmpeg, neither a dependency of this package) with a CLI entry.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from scipy.signal import resample_poly

from ..audio.wav import read_wav, write_wav


def to_mono(audio: np.ndarray) -> np.ndarray:
    return audio.mean(axis=1) if audio.ndim > 1 else audio


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    if sr_in == sr_out:
        return audio
    g = np.gcd(sr_in, sr_out)
    return resample_poly(audio, sr_out // g, sr_in // g).astype(np.float32)


def normalize_loudness(audio: np.ndarray, target_dbfs: float = -20.0) -> np.ndarray:
    """RMS loudness normalization to target dBFS (pydub semantics)."""
    rms = np.sqrt(np.mean(audio**2) + 1e-12)
    current_dbfs = 20 * np.log10(max(rms, 1e-12))
    gain = 10 ** ((target_dbfs - current_dbfs) / 20)
    out = audio * gain
    peak = np.abs(out).max()
    if peak > 1.0:
        out = out / peak
    return out.astype(np.float32)


def trim_silence(
    audio: np.ndarray,
    sample_rate: int,
    threshold_db: float = -40.0,
    frame_ms: float = 10.0,
    keep_ms: float = 100.0,
) -> np.ndarray:
    """Trim leading/trailing silence below threshold, keeping a margin."""
    frame = max(1, int(sample_rate * frame_ms / 1000))
    n = len(audio) // frame
    if n == 0:
        return audio
    frames = audio[: n * frame].reshape(n, frame)
    db = 10 * np.log10(np.mean(frames**2, axis=1) + 1e-12)
    loud = np.nonzero(db > threshold_db)[0]
    if len(loud) == 0:
        return audio
    keep = int(sample_rate * keep_ms / 1000)
    start = max(0, loud[0] * frame - keep)
    end = min(len(audio), (loud[-1] + 1) * frame + keep)
    return audio[start:end]


def process_file(
    in_path: str,
    out_path: str,
    target_sr: int = 22050,
    target_dbfs: float = -20.0,
    trim: bool = True,
) -> None:
    audio, sr = read_wav(in_path)
    audio = to_mono(audio)
    audio = resample(audio, sr, target_sr)
    audio = normalize_loudness(audio, target_dbfs)
    if trim:
        audio = trim_silence(audio, target_sr)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    write_wav(out_path, audio, target_sr)


def main(argv=None):
    p = argparse.ArgumentParser(description="normalize corpus audio")
    p.add_argument("--input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--sample-rate", type=int, default=22050)
    p.add_argument("--dbfs", type=float, default=-20.0)
    p.add_argument("--no-trim", action="store_true")
    args = p.parse_args(argv)
    n = 0
    for name in sorted(os.listdir(args.input_dir)):
        if not name.lower().endswith(".wav"):
            continue
        process_file(
            os.path.join(args.input_dir, name),
            os.path.join(args.output_dir, name),
            args.sample_rate,
            args.dbfs,
            trim=not args.no_trim,
        )
        n += 1
    print(f"[audio-prep] processed {n} files -> {args.output_dir}")


if __name__ == "__main__":
    main()
