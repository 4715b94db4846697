"""HiFi-GAN generator (port of ``e2e_tts_tpu/nn/hifigan.py``).

Weight norm is fused into plain kernels when weights are carried across
(``convert.py``), the serving form.  The stack runs channels-first inside;
the public ``forward`` takes (B, T, n_mels) like the JAX package.  The
iSTFTNet head waits (ROADMAP.md, A4).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv1d, ConvTranspose1d

LRELU_SLOPE = 0.1
# the reference's final activation uses torch's default slope, not LRELU_SLOPE
FINAL_SLOPE = 0.01
WN_STD = 0.01  # the JAX package's weight-norm init: v ~ normal(0.01), w = v


def _lrelu(x, slope: float = LRELU_SLOPE):
    return F.leaky_relu(x, slope)


class ResBlock1(nn.Module):
    """2-conv residual unit x len(dilations)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5), *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device, std=WN_STD)
        self.convs1 = nn.ModuleList(Conv1d(channels, channels, kernel_size, d, **kw)
                                    for d in dilations)
        self.convs2 = nn.ModuleList(Conv1d(channels, channels, kernel_size, 1, **kw)
                                    for _ in dilations)

    def forward(self, x):
        """(B, C, T) -> (B, C, T)."""
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2.conv_ncw(_lrelu(c1.conv_ncw(_lrelu(x))))
        return x


class ResBlock2(nn.Module):
    """1-conv residual unit x len(dilations)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3), *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device, std=WN_STD)
        self.convs = nn.ModuleList(Conv1d(channels, channels, kernel_size, d, **kw)
                                   for d in dilations)

    def forward(self, x):
        for c in self.convs:
            x = x + c.conv_ncw(_lrelu(x))
        return x


class _GeneratorTrunk(nn.Module):
    """conv_pre + upsample/resblock pyramid; the resblocks of a stage are averaged."""

    def __init__(self, n_mels: int, upsample_rates, upsample_kernel_sizes,
                 upsample_initial_channel: int, resblock_kernel_sizes,
                 resblock_dilation_sizes, resblock_type: int = 1, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        Res = ResBlock1 if resblock_type == 1 else ResBlock2
        self.conv_pre = Conv1d(n_mels, upsample_initial_channel, 7, std=WN_STD, **kw)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch_in = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(ConvTranspose1d(ch_in, ch, k, u, std=WN_STD, **kw))
            self.resblocks.append(nn.ModuleList(
                Res(ch, rk, tuple(rd), **kw)
                for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes)))
            ch_in = ch
        self.out_channels = ch_in

    def forward(self, x):
        """(B, n_mels, T) -> (B, C, T * prod(rates))."""
        x = self.conv_pre.conv_ncw(x)
        for up, blocks in zip(self.ups, self.resblocks):
            x = up.conv_ncw(_lrelu(x))
            acc = None
            for block in blocks:
                h = block(x)
                acc = h if acc is None else acc + h
            x = acc / len(blocks)
        return x


class HifiGanGenerator(nn.Module):
    """mel (B, T, n_mels) -> waveform (B, T * prod(rates)) in [-1, 1]."""

    def __init__(self, n_mels: int = 80, upsample_rates: Tuple[int, ...] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4),
                 upsample_initial_channel: int = 512,
                 resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11),
                 resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 resblock_type: int = 1, *, device=None,
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(seed)
        kw = dict(generator=g, device=device)
        self.trunk = _GeneratorTrunk(n_mels, upsample_rates, upsample_kernel_sizes,
                                     upsample_initial_channel, resblock_kernel_sizes,
                                     resblock_dilation_sizes, resblock_type, **kw)
        self.conv_post = Conv1d(self.trunk.out_channels, 1, 7, std=WN_STD, **kw)
        self.eval()
        self.requires_grad_(False)

    @classmethod
    def from_config(cls, cfg, n_mels: int = 80, **kw):
        return cls(n_mels, tuple(cfg.upsample_rates), tuple(cfg.upsample_kernel_sizes),
                   cfg.upsample_initial_channel, tuple(cfg.resblock_kernel_sizes),
                   tuple(tuple(d) for d in cfg.resblock_dilation_sizes), cfg.resblock, **kw)

    @torch.no_grad()
    def forward(self, mel):
        x = self.trunk(mel.transpose(1, 2))
        x = self.conv_post.conv_ncw(_lrelu(x, FINAL_SLOPE).float())
        return torch.tanh(x)[:, 0, :]
