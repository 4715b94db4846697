"""Per-utterance feature cache (port of ``e2e_tts_tpu/data/features.py``).

Writes the JAX package's layout, sibling ``.npy`` caches ``mels/ f0/ pitch/
energy/`` next to each corpus's ``wavs/`` (reference:
src/tools/tools_for_data.py:80-213), so a corpus prepared by either package
is read by the other.  The log-mel and the per-frame energy come from the
port's ``audio.mel.mel_spectrogram`` on ``device`` (CUDA unless the caller
passes another; ``device=None`` without CUDA raises); f0 and pitch are host
NumPy and C++ (``audio.features``).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..audio import MelParams, extract_f0, extract_pitch, mel_spectrogram, read_wav
from ..audio.mel import num_frames
from ..config import Config
from ..device import resolve_device

FEATURE_DIRS = ("mels", "f0", "pitch", "energy")


def utterance_paths(wav_path: str) -> Dict[str, str]:
    base = os.path.splitext(os.path.basename(wav_path))[0]
    root = os.path.dirname(os.path.dirname(wav_path))
    return {d: os.path.join(root, d, f"{base}.npy") for d in FEATURE_DIRS}


def mel_and_energy(audio: np.ndarray, p: MelParams, device) -> tuple:
    """(log-mel (n_mels, T), energy (T,)) as float32 numpy, computed on
    ``device``.  As the JAX package does, the signal is zero-padded to a
    multiple of 4 * hop * 16 samples (16384 at hop 256) and the frames past
    ``num_frames(len(audio))`` are dropped: the last one or two frames see
    that zero padding instead of the reflection."""
    bucket = 4 * p.hop_length * 16
    n_pad = -len(audio) % bucket
    padded = np.pad(audio, (0, n_pad)) if n_pad else audio
    mel_len = num_frames(len(audio), p)
    x = torch.from_numpy(np.ascontiguousarray(padded, np.float32)[None]).to(device)
    with torch.no_grad():
        mel, energy = mel_spectrogram(x, p, return_energy=True)
    return (mel[0, :, :mel_len].cpu().numpy().astype(np.float32),
            energy[0, :mel_len].cpu().numpy().astype(np.float32))


def f0_and_pitch(audio: np.ndarray, mel_len: int, sample_rate: int, hop_length: int) -> tuple:
    """(f0, pitch), each (mel_len,) float32, on the host: YIN f0 (0 where
    unvoiced) and the interpolated DIO + StoneMask pitch."""
    f0 = extract_f0(audio, mel_len, sample_rate, hop_length).astype(np.float32)
    pitch = extract_pitch(audio, sample_rate, hop_length)[:mel_len].astype(np.float32)
    if len(pitch) < mel_len:
        pitch = np.pad(pitch, (0, mel_len - len(pitch)), mode="edge")
    return f0, pitch


def create_utterance_features(
    wav_path: str,
    config: Config,
    overwrite: bool = False,
    device=None,
) -> Dict[str, np.ndarray]:
    """Compute + cache mel/f0/pitch/energy for one utterance; the mel and the
    energy on ``device``."""
    device = resolve_device(device)
    paths = utterance_paths(wav_path)
    if not overwrite and all(os.path.exists(p) for p in paths.values()):
        return {k: np.load(p) for k, p in paths.items()}

    audio, sr = read_wav(wav_path)
    assert sr == config.audio.signal.sampling_rate, (wav_path, sr)
    p = MelParams.from_config(config.audio)
    mel, energy = mel_and_energy(audio, p, device)
    f0, pitch = f0_and_pitch(audio, mel.shape[1], sr, p.hop_length)

    out = {"mels": mel, "f0": f0, "pitch": pitch, "energy": energy}
    for key, path in paths.items():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, out[key])
    return out


def load_utterance_features(wav_path: str) -> Dict[str, np.ndarray]:
    return {k: np.load(p) for k, p in utterance_paths(wav_path).items()}


def compute_stats(filelist_entries) -> Dict[str, Dict[str, float]]:
    """Corpus statistics over pitch/f0/energy with IQR outlier removal
    (reference: src/tools/dataloader.py:106-151).  ``min``/``max`` are in the
    normalised domain ((x - mean) / std), where the variance adaptor's
    quantisation bins live."""
    from ..audio.features import remove_outliers

    pitches, f0s, energies = [], [], []
    for wav, *_ in filelist_entries:
        feats = load_utterance_features(wav)
        pitches.append(feats["pitch"])
        f0s.append(feats["f0"][feats["f0"] > 0])
        energies.append(feats["energy"])
    pitch = remove_outliers(np.concatenate(pitches))
    energy = remove_outliers(np.concatenate(energies))
    f0 = np.concatenate(f0s) if f0s else np.zeros(1)

    def d(x):
        mean = float(x.mean())
        std = float(x.std() + 1e-8)
        z = (x - mean) / std
        return {
            "min": float(z.min()),
            "max": float(z.max()),
            "mean": mean,
            "std": std,
        }

    return {"pitch": d(pitch), "energy": d(energy), "f0": d(f0)}
