"""Mel postnet: 5 x conv(k5) + BatchNorm, tanh on all but the last; the
caller adds the residual (port of ``e2e_tts_tpu/nn/postnet.py``).  The
BatchNorm runs in eval mode on the running statistics (eps 1e-5)."""

from __future__ import annotations

import torch
from torch import nn

from .common import Conv1d


class Postnet(nn.Module):
    def __init__(self, n_mel_channels: int, embedding_dim: int = 512, n_layers: int = 5,
                 kernel_size: int = 5, *, generator: torch.Generator, device=None):
        super().__init__()
        dims = [n_mel_channels] + [embedding_dim] * (n_layers - 1) + [n_mel_channels]
        self.convs = nn.ModuleList(
            Conv1d(dims[i], dims[i + 1], kernel_size, generator=generator, device=device)
            for i in range(n_layers)
        )
        self.bns = nn.ModuleList(
            nn.BatchNorm1d(dims[i + 1], eps=1e-5, device=device) for i in range(n_layers)
        )

    def forward(self, mel):
        """(B, T, n_mels) -> residual correction (B, T, n_mels)."""
        x = mel.transpose(1, 2)
        last = len(self.convs) - 1
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            x = bn(conv.conv_ncw(x))
            if i != last:
                x = torch.tanh(x)
        return x.transpose(1, 2)
