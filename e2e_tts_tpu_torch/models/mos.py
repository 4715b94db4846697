"""Learned MOS-proxy predictor (port of ``e2e_tts_tpu/models/mos.py``).

A small convolutional regressor over log-mels, trained in the JAX package
(``tools/train_mos.py``) to predict a degradation-severity score on speech
corrupted by calibrated distortions (additive noise, clipping, time
dropouts, lowpass smearing, mains hum), on MOSNet's [1, 5] scale: 5 is
clean, 1 severely degraded.  It ranks cleaner audio above degraded audio;
it is not an estimate of human opinion scores.

The weights are the JAX package's ``assets/mos/mos.msgpack``, read with the
port's msgpack reader.  Long audio is scored as the mean over fixed
windows of ``MOS_WINDOW`` frames.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..audio.mel import MelParams, mel_spectrogram
from ..device import resolve_device

# the analysis window in mel frames; ~3 s at hop 256 / 22050 Hz
MOS_WINDOW = 256


class MosPredictor(nn.Module):
    """log-mel (B, T, n_mels) -> score in [1, 5] per clip, on ``device``
    (CUDA unless ``device="cpu"``).

    As flax builds it: three k = 5 stride-2 convolutions with SAME padding,
    which pads (1, 2) at these lengths, each followed by a LayerNorm (eps
    1e-6) and the tanh GELU; mean and standard deviation over time (the
    population variance clipped at 1e-6); two dense layers."""

    def __init__(self, n_mels: int = 80, hidden: int = 64, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.convs = nn.ModuleList(
            nn.Conv1d(n_mels if i == 0 else hidden, hidden, 5, stride=2, device=device)
            for i in range(3))
        for i in range(3):
            self.add_module(f"ln_{i}", nn.LayerNorm(hidden, eps=1e-6, device=device))
        self.fc1 = nn.Linear(2 * hidden, hidden, device=device)
        self.fc2 = nn.Linear(hidden, 1, device=device)
        self.eval()

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = mel.transpose(1, 2)  # (B, n_mels, T)
        for i, conv in enumerate(self.convs):
            t = x.shape[-1]
            total = max((-(-t // 2) - 1) * 2 + 5 - t, 0)  # flax's SAME padding
            x = conv(F.pad(x, (total // 2, total - total // 2)))
            x = getattr(self, f"ln_{i}")(x.transpose(1, 2)).transpose(1, 2)
            x = F.gelu(x, approximate="tanh")
        mu = x.mean(dim=-1)
        sd = torch.sqrt(torch.clamp(x.var(dim=-1, unbiased=False), min=1e-6))
        h = F.gelu(self.fc1(torch.cat([mu, sd], dim=-1)), approximate="tanh")
        return 1.0 + 4.0 * torch.sigmoid(self.fc2(h)[..., 0])


# ---------------------------------------------------------------------------
# Calibrated degradations.  severity in [0, 1]; target = 5 - 4 * severity.
# ---------------------------------------------------------------------------


def _snr_noise(audio, severity, rng):
    """White noise from 40 dB SNR (imperceptible) down to 0 dB."""
    snr_db = 40.0 * (1.0 - severity)
    sig_pow = np.mean(audio**2) + 1e-12
    noise_pow = sig_pow / (10 ** (snr_db / 10))
    return audio + rng.randn(len(audio)) * np.sqrt(noise_pow)


def _clip(audio, severity, rng):
    """Hard clipping from none down to 10% of peak."""
    peak = np.abs(audio).max() + 1e-9
    thresh = peak * (1.0 - 0.9 * severity)
    return np.clip(audio, -thresh, thresh)


def _dropout(audio, severity, rng):
    """Zeroed segments covering up to 40% of the clip (packet loss)."""
    out = audio.copy()
    total = int(len(audio) * 0.4 * severity)
    seg = max(1, int(0.02 * 22050))  # 20 ms holes
    n = max(0, total // seg)
    for _ in range(n):
        s = rng.randint(0, max(1, len(audio) - seg))
        out[s : s + seg] = 0.0
    return out


def _lowpass(audio, severity, rng):
    """Spectral smearing: FFT brickwall from 11 kHz down to 1 kHz."""
    cutoff = 11025.0 * (1.0 - severity) + 1000.0 * severity
    spec = np.fft.rfft(audio)
    freqs = np.fft.rfftfreq(len(audio), 1 / 22050.0)
    return np.fft.irfft(spec * (freqs <= cutoff), n=len(audio))


def _hum(audio, severity, rng):
    """50 Hz mains hum + harmonic, up to half the signal RMS."""
    t = np.arange(len(audio)) / 22050.0
    rms = np.sqrt(np.mean(audio**2)) + 1e-9
    amp = 0.5 * rms * severity
    return audio + amp * (np.sin(2 * np.pi * 50 * t) + 0.5 * np.sin(2 * np.pi * 150 * t))


DEGRADATIONS = (_snr_noise, _clip, _dropout, _lowpass, _hum)


def degrade(audio: np.ndarray, severity: float, rng: np.random.RandomState,
            kind: Optional[int] = None) -> np.ndarray:
    """Apply one (or a random) calibrated degradation at ``severity``."""
    fn = DEGRADATIONS[int(kind) if kind is not None else rng.randint(len(DEGRADATIONS))]
    out = fn(audio.astype(np.float64), float(severity), rng)
    peak = np.abs(out).max()
    if peak > 1.0:
        out = out / peak
    return out.astype(np.float32)


def severity_to_score(severity: float) -> float:
    return 5.0 - 4.0 * float(severity)


# ---------------------------------------------------------------------------
# Inference: audio -> windows of log-mel -> mean score.
# ---------------------------------------------------------------------------


@torch.no_grad()
def mel_windows(audio: np.ndarray, sample_rate: int, device=None) -> torch.Tensor:
    """(n_windows, MOS_WINDOW, 80) log-mel windows of a waveform, computed
    on ``device`` (CUDA unless ``device="cpu"``), one STFT for all."""
    p = MelParams(sample_rate=sample_rate)
    need = MOS_WINDOW * p.hop_length
    if len(audio) < need:
        audio = np.pad(audio, (0, need - len(audio)))
    n_win = len(audio) // need
    segs = np.ascontiguousarray(audio[: n_win * need], np.float32).reshape(n_win, need)
    mel = mel_spectrogram(torch.from_numpy(segs).to(resolve_device(device)), p)
    return mel.transpose(1, 2)[:, :MOS_WINDOW].contiguous()


@torch.no_grad()
def score_audio(model: MosPredictor, audio: np.ndarray, sample_rate: int) -> float:
    """Mean window score for a waveform (float in [-1, 1]) on the model's
    device."""
    wins = mel_windows(audio, sample_rate, next(model.parameters()).device)
    return float(model(wins).double().mean())
