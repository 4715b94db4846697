"""Plain-PyTorch vocoders on a weight dict ``P``, float32.

HiFi-GAN V1 (Kong et al., arXiv:2010.05646; jik876/hifi-gan
``config_v1.json``): a 7-tap input convolution, per upsampling stage a
leaky ReLU (slope 0.1) and a transposed convolution (padding (k - u) / 2),
then the mean of three ResBlock1s (kernels 3, 7, 11; each three dilated
convolution pairs with residuals); a leaky ReLU at torch's default slope
0.01, a 7-tap output convolution and tanh.  The weight norm is folded into
the kernels, as served.

iSTFTNet C8C8I (Kaneko et al., arXiv:2203.02395): the same trunk with two
x8 stages, then a reflection pad of one sample in front, a 7-tap
convolution to n_fft + 2 channels, magnitude exp() and phase sin() of the
n_fft / 2 + 1 bins, and an inverse STFT (periodic Hann window,
overlap-add normalised by the squared window, n_fft / 2 samples trimmed
from both ends).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .fs2 import conv


def _lrelu(x, slope=0.1):
    return F.leaky_relu(x, slope)


def _trunk(P, cfg, x):
    x = conv(P, "trunk.conv_pre", x)
    kernels = cfg["resblock_kernel_sizes"]
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        x = F.conv_transpose1d(_lrelu(x), P[f"trunk.ups.{i}.weight"], P[f"trunk.ups.{i}.bias"],
                               stride=u, padding=(k - u) // 2)
        acc = 0.0
        for j, dils in enumerate(cfg["resblock_dilation_sizes"]):
            h = x
            for n, d in enumerate(dils):
                r = f"trunk.resblocks.{i}.{j}"
                h = h + conv(P, f"{r}.convs2.{n}", _lrelu(conv(P, f"{r}.convs1.{n}", _lrelu(h), d)))
            acc = acc + h
        x = acc / len(kernels)
    return x


def hifigan(P, cfg, mel):
    """mel (B, T, n_mels) -> waveform (B, T * prod(rates))."""
    x = conv(P, "conv_post", _lrelu(_trunk(P, cfg, mel.transpose(1, 2)), 0.01))
    return torch.tanh(x)[:, 0]


def istftnet(P, cfg, mel):
    """mel (B, T, n_mels) -> waveform (B, T * prod(rates) * hop)."""
    x = _lrelu(_trunk(P, cfg, mel.transpose(1, 2)), 0.01)
    x = conv(P, "conv_post", torch.cat([x[..., 1:2], x], dim=-1))
    n_fft, hop, win = cfg["gen_istft_n_fft"], cfg["gen_istft_hop_size"], cfg["gen_istft_win_size"]
    half = n_fft // 2 + 1
    mag, phase = torch.exp(x[:, :half]), torch.sin(x[:, half:])
    n = np.arange(win, dtype=np.float64)
    w = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win)).astype(np.float32)
    lpad = (n_fft - win) // 2
    window = torch.from_numpy(np.pad(w, (lpad, n_fft - win - lpad))).to(mel.device)
    # a real signal's DC and Nyquist bins carry no imaginary part
    imag_keep = torch.ones(half, 1, device=mel.device)
    imag_keep[0] = 0.0
    if n_fft % 2 == 0:
        imag_keep[-1] = 0.0
    spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase) * imag_keep)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window  # (B, F, n_fft)
    B, n_frames, _ = frames.shape
    out_len = n_fft + hop * (n_frames - 1)
    sig = torch.zeros(B, out_len, device=mel.device)
    env = torch.zeros(out_len, device=mel.device)
    for f in range(n_fft):  # place tap f of every frame at once
        sig[:, f: f + hop * n_frames: hop] += frames[:, :, f]
        env[f: f + hop * n_frames: hop] += window[f] ** 2
    sig = sig / torch.clamp(env, min=1e-11)
    return sig[:, n_fft // 2: out_len - n_fft // 2]


def vocode(P, kind, cfg, mel):
    return hifigan(P, cfg, mel) if kind == "hifigan" else istftnet(P, cfg, mel)
