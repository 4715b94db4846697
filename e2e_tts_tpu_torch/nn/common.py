"""Shared nn primitives (port of ``e2e_tts_tpu/nn/common.py``).

Public modules take and return (B, T, C) like the JAX package; convolutions
also offer ``conv_ncw`` for callers that keep (B, C, T) inside a stack.
Parameters are created on ``device`` from an explicit ``torch.Generator``
(on the CPU, so one seed gives the same weights on every device).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def sinusoid_table(n_position: int, d_hid: int) -> np.ndarray:
    """Interleaved sin/cos positional table (sin on even dims, cos on odd)."""
    pos = np.arange(n_position)[:, None].astype(np.float64)
    dim = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000.0, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def t2t_sinusoid(n_position: int, d_hid: int) -> np.ndarray:
    """tensor2tensor-style [sin | cos] table with a zero row 0 (padding)."""
    half = d_hid // 2
    emb = np.exp(np.arange(half) * -(np.log(10000.0) / (half - 1)))
    ang = np.arange(n_position)[:, None] * emb[None, :]
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    if d_hid % 2 == 1:
        table = np.concatenate([table, np.zeros((n_position, 1))], axis=1)
    table[0] = 0.0
    return table.astype(np.float32)


def fuse_weight_norm(v: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Weight norm baked into a plain kernel: ``g * v / max(||v||, 1e-12)``
    with the norm over every axis but the last (the output channel), as the
    JAX package applies it to (k, in, out) kernels."""
    v = np.asarray(v, np.float32)
    norm = np.linalg.norm(v.reshape(-1, v.shape[-1]), axis=0)
    return (v * (np.asarray(g, np.float32) / np.maximum(norm, 1e-12))).astype(np.float32)


def _normal(shape, std: float, generator: torch.Generator, device) -> torch.Tensor:
    return (torch.randn(shape, generator=generator) * std).to(device)


class Linear(nn.Linear):
    """Dense layer with lecun-normal weights and zero bias by default."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, *,
                 generator: torch.Generator, device=None, bias_init: float = 0.0):
        super().__init__(d_in, d_out, bias=bias, device=device)
        with torch.no_grad():
            self.weight.copy_(_normal((d_out, d_in), 1.0 / math.sqrt(d_in), generator, device))
            if bias:
                self.bias.fill_(bias_init)


class Embedding(nn.Embedding):
    """Lookup table with normal(std) rows; ``zero_row0`` zeroes the padding row."""

    def __init__(self, n: int, d: int, *, generator: torch.Generator, device=None,
                 std: Optional[float] = None, zero_row0: bool = False):
        super().__init__(n, d, device=device)
        with torch.no_grad():
            w = _normal((n, d), 1.0 / math.sqrt(d) if std is None else std, generator, device)
            if zero_row0:
                w[0] = 0.0
            self.weight.copy_(w)


class Conv1d(nn.Module):
    """1-D convolution with the JAX package's SAME padding, which is
    asymmetric for even effective kernels: (total // 2, total - total // 2)
    with total = (kernel_size - 1) * dilation.  Weight (out, in, k)."""

    def __init__(self, d_in: int, d_out: int, kernel_size: int, dilation: int = 1,
                 bias: bool = True, *, generator: torch.Generator, device=None,
                 std: Optional[float] = None):
        super().__init__()
        self.dilation = dilation
        total = (kernel_size - 1) * dilation
        self.pad = (total // 2, total - total // 2)
        std = 1.0 / math.sqrt(d_in * kernel_size) if std is None else std
        self.weight = nn.Parameter(_normal((d_out, d_in, kernel_size), std, generator, device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device)) if bias else None

    def conv_ncw(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C_in, T) -> (B, C_out, T)."""
        return F.conv1d(F.pad(x, self.pad), self.weight, self.bias, dilation=self.dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C_in) -> (B, T, C_out)."""
        return self.conv_ncw(x.transpose(1, 2)).transpose(1, 2)


class ConvTranspose1d(nn.Module):
    """Transposed conv with padding (k - u) // 2, so T frames become T * u
    samples.  Weight (in, out, k), as torch's ``conv_transpose1d`` takes it."""

    def __init__(self, d_in: int, d_out: int, kernel_size: int, stride: int, *,
                 generator: torch.Generator, device=None, std: float = 0.01):
        super().__init__()
        self.stride = stride
        self.padding = (kernel_size - stride) // 2
        self.weight = nn.Parameter(_normal((d_in, d_out, kernel_size), std, generator, device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device))

    def conv_ncw(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, self.weight, self.bias, stride=self.stride,
                                  padding=self.padding)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the feature axis with the eps passed in."""

    def __init__(self, d: int, eps: float, device=None):
        super().__init__(d, eps=eps, device=device)
