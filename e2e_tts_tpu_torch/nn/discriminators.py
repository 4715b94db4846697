"""HiFi-GAN discriminators (multi-period, multi-scale) and the LS-GAN losses
(port of ``e2e_tts_tpu/nn/discriminators.py``).

Channels first: the period discriminator folds (B, T) audio to NCHW
(B, 1, T / p, p) where JAX folds to NHWC (B, T / p, p, 1), and its feature
maps are NCHW; the scale discriminator's are (B, C, T).  Every convolution is
weight-normalised with (v, g, bias) as parameters, drawn from one
``torch.Generator`` in the JAX tree's order.  Widths are constructor
arguments, as in JAX, so that tests can shrink them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .common import WNConv1d, WNConv2d

LRELU_SLOPE = 0.1

REFERENCE_MSD_SPECS = (
    # (features, kernel, stride, groups, pad)
    (128, 15, 1, 1, 7),
    (128, 41, 2, 4, 20),
    (256, 41, 2, 16, 20),
    (512, 41, 4, 16, 20),
    (1024, 41, 4, 16, 20),
    (1024, 41, 1, 16, 20),
    (1024, 5, 1, 1, 2),
)

TINY_MSD_SPECS = (
    (8, 15, 1, 1, 7),
    (16, 41, 4, 4, 20),
    (16, 5, 1, 1, 2),
)


def _lrelu(x):
    return F.leaky_relu(x, LRELU_SLOPE)


class PeriodDiscriminator(nn.Module):
    """One period discriminator: (B, T) -> (logits (B, n), feature maps)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 channels: Sequence[int] = (32, 128, 512, 1024), *, generator, device=None):
        super().__init__()
        self.period = period
        kw = dict(generator=generator, device=device)
        pad = (kernel_size - 1) // 2
        self.convs = nn.ModuleList()
        ch_in = 1
        for ch in channels:
            self.convs.append(WNConv2d(ch_in, ch, (kernel_size, 1), (stride, 1),
                                       ((pad, pad), (0, 0)), **kw))
            ch_in = ch
        self.convs.append(WNConv2d(ch_in, ch_in, (kernel_size, 1), (1, 1), ((2, 2), (0, 0)), **kw))
        self.conv_post = WNConv2d(ch_in, 1, (3, 1), (1, 1), ((1, 1), (0, 0)), **kw)

    def forward(self, audio):
        B, T = audio.shape
        p = self.period
        n_pad = (p - T % p) % p
        if n_pad:  # reflect the tail (its last sample not repeated) to a multiple of p
            audio = F.pad(audio[:, None, :], (0, n_pad), mode="reflect")[:, 0]
        x = audio.reshape(B, 1, -1, p)
        fmaps = []
        for conv in self.convs:
            x = _lrelu(conv(x))
            fmaps.append(x)
        x = self.conv_post(x)
        fmaps.append(x)
        return x.reshape(B, -1), fmaps


class ScaleDiscriminator(nn.Module):
    """One scale discriminator: (B, T) -> (logits (B, n), feature maps)."""

    def __init__(self, specs=REFERENCE_MSD_SPECS, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.convs = nn.ModuleList()
        ch_in = 1
        for ch, k, s, grp, pad in specs:
            self.convs.append(WNConv1d(ch_in, ch, k, stride=s, groups=grp, padding=(pad, pad),
                                       **kw))
            ch_in = ch
        self.conv_post = WNConv1d(ch_in, 1, 3, padding=(1, 1), **kw)

    def forward(self, audio):
        x = audio[:, None, :]
        fmaps = []
        for conv in self.convs:
            x = _lrelu(conv.conv_ncw(x))
            fmaps.append(x)
        x = self.conv_post.conv_ncw(x)
        fmaps.append(x)
        return x.reshape(audio.shape[0], -1), fmaps


class _MultiDiscriminator(nn.Module):
    """``discriminate(x)`` runs one batch through every sub-discriminator:
    (logits, feature maps), a list entry each.  ``forward(real, fake)`` runs
    both as one batch and splits them: (real logits, fake logits, real maps,
    fake maps), as JAX's ``apply(params, real, fake)`` returns them."""

    def discriminate(self, x) -> Tuple[List, List]:
        raise NotImplementedError

    def forward(self, real, fake):
        B = real.shape[0]
        logits, fmaps = self.discriminate(torch.cat([real, fake]))
        return ([lg[:B] for lg in logits], [lg[B:] for lg in logits],
                [[f[:B] for f in fm] for fm in fmaps], [[f[B:] for f in fm] for fm in fmaps])


class MultiPeriodDiscriminator(_MultiDiscriminator):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 channels: Sequence[int] = (32, 128, 512, 1024), *, device=None,
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(seed)
        device = resolve_device(device)
        self.periods = tuple(periods)
        for p in self.periods:  # named as the JAX tree: period_{p}
            self.add_module(f"period_{p}", PeriodDiscriminator(
                p, channels=channels, generator=g, device=device))

    def discriminate(self, x):
        outs = [getattr(self, f"period_{p}")(x) for p in self.periods]
        return [o[0] for o in outs], [o[1] for o in outs]


class MultiScaleDiscriminator(_MultiDiscriminator):
    """Scales 1, 1/2, 1/4...: between scales the audio is average-pooled
    (window 4, stride 2, pad 2), the pad counted in each mean as flax's
    ``avg_pool`` counts it."""

    def __init__(self, n_scales: int = 3, specs=REFERENCE_MSD_SPECS, *, device=None,
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(seed)
        device = resolve_device(device)
        self.n_scales = n_scales
        for i in range(n_scales):  # named as the JAX tree: scale_{i}
            self.add_module(f"scale_{i}", ScaleDiscriminator(specs, generator=g, device=device))

    def discriminate(self, x):
        logits, fmaps = [], []
        for i in range(self.n_scales):
            lg, fm = getattr(self, f"scale_{i}")(x)
            logits.append(lg)
            fmaps.append(fm)
            if i < self.n_scales - 1:
                x = F.avg_pool1d(x[:, None, :], 4, 2, padding=2, count_include_pad=True)[:, 0]
        return logits, fmaps


def build_discriminators(device=None, seed: int = 0, periods: Sequence[int] = (2, 3, 5, 7, 11),
                         mpd_channels: Sequence[int] = (32, 128, 512, 1024), n_scales: int = 3,
                         msd_specs=REFERENCE_MSD_SPECS):
    """(MultiPeriodDiscriminator, MultiScaleDiscriminator) at the reference
    widths unless told otherwise, drawn from ``torch.Generator().manual_seed``
    (seed, seed + 1), on ``device`` (CUDA when None, which raises without a
    card)."""
    mpd = MultiPeriodDiscriminator(periods, mpd_channels, device=device, seed=seed)
    msd = MultiScaleDiscriminator(n_scales, msd_specs, device=device, seed=seed + 1)
    return mpd, msd


# --- GAN losses ------------------------------------------------------------------------------


def feature_loss(real_fmaps: List, fake_fmaps: List) -> torch.Tensor:
    loss = 0.0
    for fr, ff in zip(real_fmaps, fake_fmaps):
        for r, f in zip(fr, ff):
            loss = loss + torch.mean(torch.abs(r - f))
    return loss * 2.0


def discriminator_loss(real_logits: List, fake_logits: List) -> torch.Tensor:
    loss = 0.0
    for r, f in zip(real_logits, fake_logits):
        loss = loss + torch.mean((1.0 - r) ** 2) + torch.mean(f ** 2)
    return loss


def generator_adv_loss(fake_logits: List) -> torch.Tensor:
    loss = 0.0
    for f in fake_logits:
        loss = loss + torch.mean((1.0 - f) ** 2)
    return loss
