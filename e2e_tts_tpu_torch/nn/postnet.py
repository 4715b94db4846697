"""Mel postnet: 5 x conv(k5) + BatchNorm, tanh on all but the last, dropout
0.5 after each layer in training; the caller adds the residual (port of
``e2e_tts_tpu/nn/postnet.py``).  The BatchNorm follows flax's (eps 1e-5,
running statistics moved by 0.99 / 0.01): batch statistics with ``train``,
the running ones without.  It has no compute dtype: the JAX model keeps it a
float32 island under bfloat16 (``FastSpeech2`` hands it ``mel_linear``'s
float32 output; float64 under ``.double()``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .common import BatchNorm, Conv1d, dropout


class Postnet(nn.Module):
    graph_safe = True  # serve/graphs.py may capture its call

    def __init__(self, n_mel_channels: int, embedding_dim: int = 512, n_layers: int = 5,
                 kernel_size: int = 5, *, generator: torch.Generator, device=None):
        super().__init__()
        self.dropout = 0.5  # hard-coded, as in the JAX package (not in the config)
        dims = [n_mel_channels] + [embedding_dim] * (n_layers - 1) + [n_mel_channels]
        self.convs = nn.ModuleList(
            Conv1d(dims[i], dims[i + 1], kernel_size, generator=generator, device=device)
            for i in range(n_layers)
        )
        self.bns = nn.ModuleList(BatchNorm(dims[i + 1], 1e-5, device=device)
                                 for i in range(n_layers))

    def forward(self, mel, train: bool = False, rng: Optional[torch.Generator] = None):
        """(B, T, n_mels) -> residual correction (B, T, n_mels); dropout draws
        from ``rng`` (none when it is None)."""
        x = mel.transpose(1, 2)
        last = len(self.convs) - 1
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            x = bn(conv.conv_ncw(x), train)
            if i != last:
                x = torch.tanh(x)
            x = dropout(x, self.dropout, rng)
        return x.transpose(1, 2)
