"""Mel filterbank and Hann window (host-side, NumPy): a copy of
``e2e_tts_tpu/audio/filters.py``, kept here so the port imports nothing of
the JAX package.

Slaney mel scale and area normalization, as ``librosa.filters.mel`` uses by
default, so the filterbank weights are the same numbers.
"""

from __future__ import annotations

import numpy as np


def hz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    freq = np.asanyarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = freq >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asanyarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(
        log_region,
        min_log_hz * np.exp(logstep * (mels - min_log_mel)),
        freqs,
    )
    return freqs


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float = None,
) -> np.ndarray:
    """Triangular mel filterbank, shape (n_mels, 1 + n_fft // 2), float32.

    Slaney normalization (each filter scaled to unit area), matching
    ``librosa.filters.mel(..., norm="slaney", htk=False)``.
    """
    if fmax is None:
        fmax = float(sample_rate) / 2
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0, float(sample_rate) / 2, n_bins, endpoint=True)

    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts.reshape(-1, 1) - fft_freqs.reshape(1, -1)

    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalization
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm.reshape(-1, 1)

    return weights.astype(np.float32)


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window, matching ``torch.hann_window(N)``."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)
