"""STFT, mel-spectrogram and inverse-STFT ops on torch tensors (port of
``e2e_tts_tpu/audio/mel.py``).

Every function runs on the device of its input.  The JAX package computes
these in plain XLA (no Pallas), so here they are plain PyTorch: framing by
``unfold``, ``torch.fft``, the mel projection as one matmul.  The inverse
STFT's overlap-add is ``F.fold``, a gather per output sample and no atomics,
so two runs on the card give the same bits (``index_add_`` on CUDA does not).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .filters import hann_window, mel_filterbank


@dataclass(frozen=True)
class MelParams:
    sample_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    fmin: float = 0.0
    fmax: Optional[float] = 8000.0
    clip_val: float = 1e-5

    @classmethod
    def from_config(cls, audio_cfg, loss: bool = False) -> "MelParams":
        mel = audio_cfg.mel
        return cls(
            sample_rate=audio_cfg.signal.sampling_rate,
            n_fft=audio_cfg.stft.filter_length,
            hop_length=audio_cfg.stft.hop_length,
            win_length=audio_cfg.stft.win_length,
            n_mels=mel.channels,
            fmin=mel.mel_fmin,
            fmax=mel.mel_fmax_loss if loss else mel.mel_fmax,
        )


def _padded_window(n_fft: int, win_length: int) -> np.ndarray:
    """Hann window of ``win_length`` centre-padded to ``n_fft``, as torch.stft
    and torch.istft pad a short window."""
    if win_length > n_fft:
        raise ValueError(f"win_length {win_length} > n_fft {n_fft}")
    window = hann_window(win_length)
    lpad = (n_fft - win_length) // 2
    return np.pad(window, (lpad, n_fft - win_length - lpad))


@functools.lru_cache(maxsize=16)
def stft_window(n_fft: int, win_length: int, device: torch.device) -> torch.Tensor:
    """The centre-padded Hann window (n_fft,) on ``device``."""
    return torch.from_numpy(_padded_window(n_fft, win_length)).to(device)


@functools.lru_cache(maxsize=16)
def _mel_basis(p: MelParams, device: torch.device) -> torch.Tensor:
    """The mel filterbank (n_mels, n_bins) on ``device``."""
    fb = mel_filterbank(p.sample_rate, p.n_fft, p.n_mels, p.fmin, p.fmax)
    return torch.from_numpy(fb).to(device)


def reflect_pad(audio: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis of (..., T) by ``pad`` on both sides."""
    lead = audio.shape[:-1]
    x = F.pad(audio.reshape(-1, 1, audio.shape[-1]), (pad, pad), mode="reflect")
    return x.reshape(*lead, x.shape[-1])


def stft_magnitude(audio: torch.Tensor, p: MelParams, center: bool = False) -> torch.Tensor:
    """Magnitude spectrogram |STFT|, shape (..., n_bins, n_frames).

    The reference's torch.stft settings: reflect pre-padding of
    (n_fft - hop) / 2 on both sides, center=False, periodic Hann, magnitude
    sqrt(re^2 + im^2 + 1e-9).
    """
    window = stft_window(p.n_fft, p.win_length, audio.device)
    pad = p.n_fft // 2 if center else (p.n_fft - p.hop_length) // 2
    frames = reflect_pad(audio, pad).unfold(-1, p.n_fft, p.hop_length) * window
    spec = torch.fft.rfft(frames, n=p.n_fft, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    return mag.transpose(-1, -2)


def dynamic_range_compression(x: torch.Tensor, C: float = 1.0, clip_val: float = 1e-5):
    return torch.log(torch.clamp(x, min=clip_val) * C)


def dynamic_range_decompression(x: torch.Tensor, C: float = 1.0):
    return torch.exp(x) / C


def mel_spectrogram(audio: torch.Tensor, p: MelParams, return_energy: bool = False):
    """Log-mel spectrogram of (..., T) audio in [-1, 1]: (..., n_mels,
    n_frames), and with ``return_energy`` the per-frame L2 norm of the
    magnitudes (..., n_frames) too."""
    mel_basis = _mel_basis(p, audio.device)
    mag = stft_magnitude(audio, p)
    mel = dynamic_range_compression(torch.matmul(mel_basis.to(mag.dtype), mag),
                                    clip_val=p.clip_val)
    if return_energy:
        return mel, torch.linalg.vector_norm(mag, dim=-2)
    return mel


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(..., n_frames, n) frames placed every ``hop_length`` samples and summed:
    (..., n + hop_length * (n_frames - 1)).  ``F.fold`` gathers each output
    sample's terms in one fixed order, so the sum is deterministic."""
    n_frames, n = frames.shape[-2:]
    lead = frames.shape[:-2]
    out_len = n + hop_length * (n_frames - 1)
    cols = frames.reshape(-1, n_frames, n).transpose(1, 2)
    sig = F.fold(cols, output_size=(1, out_len), kernel_size=(1, n), stride=(1, hop_length))
    return sig.reshape(*lead, out_len)


def inverse_stft(magnitude: torch.Tensor, phase: torch.Tensor, n_fft: int, hop_length: int,
                 win_length: int) -> torch.Tensor:
    """Inverse STFT with Hann overlap-add, normalised by the squared-window
    envelope (clamped at 1e-11), with n_fft // 2 samples trimmed from both
    ends: ``torch.istft(mag * exp(i * phase), center=True)`` as the reference
    uses it for the iSTFTNet head.  magnitude, phase: (..., n_bins, n_frames)
    -> (..., hop_length * (n_frames - 1))."""
    window = stft_window(n_fft, win_length, magnitude.device)
    # a real signal's DC and Nyquist bins are real: the CPU's inverse FFT
    # drops their imaginary parts and cuFFT need not, so they are zeroed here
    real_bins = torch.ones(magnitude.shape[-2], 1, device=magnitude.device)
    real_bins[0] = 0.0
    if n_fft % 2 == 0:
        real_bins[-1] = 0.0
    spec = torch.complex(magnitude * torch.cos(phase), magnitude * torch.sin(phase) * real_bins)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window
    n_frames = frames.shape[-2]
    sig = overlap_add(frames, hop_length)
    envelope = overlap_add((window ** 2).expand(n_frames, n_fft), hop_length)
    sig = sig / torch.clamp(envelope, min=1e-11)
    half = n_fft // 2
    return sig[..., half: sig.shape[-1] - half]


def num_frames(num_samples: int, p: MelParams) -> int:
    """Frame count produced by mel_spectrogram for a T-sample input."""
    padded = num_samples + 2 * ((p.n_fft - p.hop_length) // 2)
    return 1 + (padded - p.n_fft) // p.hop_length
