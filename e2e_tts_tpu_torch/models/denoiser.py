"""Vocoder bias denoiser (port of ``e2e_tts_tpu/models/denoiser.py``).

A vocoder leaves a constant bias hum.  It is estimated by vocoding a fixed
mel (all zeros, or normal noise), taking the magnitude spectrum of the
first frame, and subtracted from the magnitude spectrum of the audio to
clean, keeping the audio's phase.
"""

from __future__ import annotations

import torch

from ..audio.mel import inverse_stft, reflect_pad, stft_window


def _stft_mag_phase(audio: torch.Tensor, n_fft: int, hop: int, win: int):
    """(B, T) -> magnitude and phase, each (B, n_fft // 2 + 1, frames), with
    the centre reflect pad of n_fft // 2 and a short window centre-padded."""
    window = stft_window(n_fft, win, audio.device)
    frames = reflect_pad(audio, n_fft // 2).unfold(-1, n_fft, hop) * window
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(-1, -2)
    return spec.abs(), spec.angle()


class Denoiser:
    """Spectral-subtraction denoiser for a vocoder's bias floor.

    ``vocode_fn``: mel (B, T, n_mels) -> audio (B, samples), on ``device``.
    ``mode="normal"`` draws its mel from a ``torch.Generator`` seeded 0, so
    its bias spectrum differs from the JAX package's, which draws from
    ``jax.random.PRNGKey(0)``; ``mode="zeros"`` gives the same one."""

    def __init__(self, vocode_fn, n_mel_channels: int = 80, n_fft: int = 1024,
                 hop_length: int = 256, win_length: int = 1024, mode: str = "zeros",
                 bias_frames: int = 88, device=None):
        self.n_fft = n_fft
        self.hop = hop_length
        self.win = win_length
        shape = (1, bias_frames, n_mel_channels)
        if mode == "zeros":
            mel = torch.zeros(shape)
        elif mode == "normal":
            mel = torch.randn(shape, generator=torch.Generator().manual_seed(0))
        else:
            raise ValueError(f"unknown denoiser mode {mode!r}")
        with torch.no_grad():
            bias_audio = vocode_fn(mel.to(device))
            mag, _ = _stft_mag_phase(bias_audio, n_fft, hop_length, win_length)
        # the first frame's magnitude is the bias spectrum
        self.bias_spec = mag[:, :, 0:1]

    @torch.no_grad()
    def __call__(self, audio: torch.Tensor, strength: float = 0.1) -> torch.Tensor:
        """audio (B, T) -> denoised audio (B, ~T)."""
        mag, phase = _stft_mag_phase(audio, self.n_fft, self.hop, self.win)
        mag = torch.clamp(mag - self.bias_spec * strength, min=0.0)
        return inverse_stft(mag, phase, self.n_fft, self.hop, self.win)
