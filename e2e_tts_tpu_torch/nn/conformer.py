"""Conformer encoder and decoder (port of ``e2e_tts_tpu/nn/conformer.py``).

Each block is the macaron ½FF -> relative-position self-attention
(transformer-XL scheme) -> conv module (LayerNorm, pointwise, GLU,
depthwise, BatchNorm, swish, pointwise) -> ½FF -> LayerNorm, masked at its
end.  The attention is plain PyTorch, as the JAX family's is (it does not
take ``use_flash``, so no Pallas kernel is on its path;
``e2e_tts_tpu/models/blocks.py:38-53`` hands the flag to the transformer only):
the score is (q + u) k^T + skew((q + v) p^T) over sqrt(d_model), masked
keys at -1e9, the softmax in float32.  The BatchNorm runs on batch
statistics in training (``train``) and moves its running ones; otherwise it
uses the running ones.  Dropout draws from ``rng`` (None: deterministic).

Module names follow the flax tree (``convert.py`` maps them):
``layer_norm`` is flax's auto-named ``LayerNorm_0``, and ``Dense_0``,
``Dense_1`` and ``BatchNorm_0`` keep flax's auto-names.  In a 16-bit
compute ``dtype`` the content and position biases are float32 parameters,
so the two score products run in float32, as JAX promotes them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .common import (BatchNorm, DepthwiseConv1d, Embedding, LayerNorm, Linear, cast,
                     compute_dtype, dropout, island, run_layers)
from .transformer import _Positions

NEG_INF = -1e9


def _relative_shift(pos_score: torch.Tensor) -> torch.Tensor:
    """Skew (B, H, T, T) position scores so that column j means offset j - i
    (transformer-XL's relative shift: pad a zero column, reshape, drop a row)."""
    B, H, T1, T2 = pos_score.shape
    padded = nn.functional.pad(pos_score, (1, 0)).reshape(B, H, T2 + 1, T1)
    return padded[:, :, 1:].reshape(B, H, T1, T2)


def _xavier_uniform(shape, generator: torch.Generator, device) -> torch.Tensor:
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    return ((torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit).to(device)


class RelativeMultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, n_head: int, dropout: float = 0.1, *,
                 generator: torch.Generator, device=None, dtype=None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.d_model, self.n_head, self.dropout = d_model, n_head, dropout
        D = d_model // n_head
        self.query_proj = Linear(d_model, d_model, **kw)
        self.key_proj = Linear(d_model, d_model, **kw)
        self.value_proj = Linear(d_model, d_model, **kw)
        self.pos_proj = Linear(d_model, d_model, bias=False, **kw)
        self.u_bias = nn.Parameter(_xavier_uniform((n_head, D), generator, device))
        self.v_bias = nn.Parameter(_xavier_uniform((n_head, D), generator, device))
        self.out_proj = Linear(d_model, d_model, **kw)

    def forward(self, x, pos_emb, key_mask=None, rng: Optional[torch.Generator] = None):
        B, T, _ = x.shape
        H, D = self.n_head, self.d_model // self.n_head
        q = self.query_proj(x).view(B, T, H, D)
        k = self.key_proj(x).view(B, T, H, D)
        v = self.value_proj(x).view(B, T, H, D)
        p = self.pos_proj(pos_emb).view(T, H, D)
        qu, qv = q + self.u_bias, q + self.v_bias  # float32 under a 16-bit dtype
        content = torch.einsum("bqhd,bkhd->bhqk", qu, k.to(qu.dtype))
        pos = _relative_shift(torch.einsum("bqhd,khd->bhqk", qv, p.to(qv.dtype)))
        score = (content + pos) / math.sqrt(self.d_model)
        if key_mask is not None:
            score = torch.where(key_mask[:, None, None, :], score, NEG_INF)
        attn = torch.softmax(island(score), dim=-1).to(v.dtype)
        attn = dropout(attn, self.dropout, rng)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, T, H * D)
        return self.out_proj(out)


class FeedForwardModule(nn.Module):
    def __init__(self, d_model: int, expansion: int = 4, dropout: float = 0.1, *,
                 generator: torch.Generator, device=None, dtype=None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.dropout = dropout
        self.layer_norm = LayerNorm(d_model, 1e-5, device=device, dtype=dtype)
        self.Dense_0 = Linear(d_model, d_model * expansion, **kw)
        self.Dense_1 = Linear(d_model * expansion, d_model, **kw)

    def forward(self, x, rng: Optional[torch.Generator] = None):
        h = self.Dense_0(self.layer_norm(x))
        h = dropout(h * torch.sigmoid(h), self.dropout, rng)  # swish
        return dropout(self.Dense_1(h), self.dropout, rng)


class ConvModule(nn.Module):
    def __init__(self, d_model: int, kernel_size: int = 31, expansion: int = 2,
                 dropout: float = 0.1, *, generator: torch.Generator, device=None, dtype=None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.dropout = dropout
        self.layer_norm = LayerNorm(d_model, 1e-5, device=device, dtype=dtype)
        self.pw1 = Linear(d_model, d_model * expansion, **kw)
        self.depthwise = DepthwiseConv1d(d_model, kernel_size, **kw)
        self.BatchNorm_0 = BatchNorm(d_model, 1e-5, device=device)
        self.pw2 = Linear(d_model, d_model, **kw)

    def forward(self, x, rng: Optional[torch.Generator] = None, train: bool = False):
        a, b = self.pw1(self.layer_norm(x)).chunk(2, dim=-1)
        h = self.depthwise(a * torch.sigmoid(b))  # GLU
        h = self.BatchNorm_0(island(h), train, channels_last=True).to(h.dtype)
        h = self.pw2(h * torch.sigmoid(h))  # swish
        return dropout(h, self.dropout, rng)


class ConformerBlock(nn.Module):
    """``mask_attention=False`` reproduces the reference conformer, whose
    attention never masks padded keys."""

    def __init__(self, d_model: int, n_head: int, ffn_expansion: int = 4, conv_kernel: int = 31,
                 conv_expansion: int = 2, half_step_residual: bool = True,
                 dropout: float = 0.1, mask_attention: bool = True, *,
                 generator: torch.Generator, device=None, dtype=None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.ff_factor = 0.5 if half_step_residual else 1.0
        self.dropout = dropout
        self.mask_attention = mask_attention
        self.ff1 = FeedForwardModule(d_model, ffn_expansion, dropout, **kw)
        self.mhsa_norm = LayerNorm(d_model, 1e-5, device=device, dtype=dtype)
        self.mhsa = RelativeMultiHeadAttention(d_model, n_head, dropout, **kw)
        self.conv = ConvModule(d_model, conv_kernel, conv_expansion, dropout, **kw)
        self.ff2 = FeedForwardModule(d_model, ffn_expansion, dropout, **kw)
        self.final_norm = LayerNorm(d_model, 1e-5, device=device, dtype=dtype)

    def forward(self, x, pos_emb, mask, train: bool = False,
                rng: Optional[torch.Generator] = None):
        x = x + self.ff_factor * self.ff1(x, rng)
        attn = self.mhsa(self.mhsa_norm(x), pos_emb, mask if self.mask_attention else None, rng)
        x = x + dropout(attn, self.dropout, rng)
        x = x + self.conv(x, rng, train)
        x = x + self.ff_factor * self.ff2(x, rng)
        return self.final_norm(x) * mask[..., None]


class _ConformerStack(nn.Module):
    def __init__(self, n_layers: int, d_model: int, n_head: int, ffn_expansion: int,
                 conv_kernel: int, conv_expansion: int, half_step_residual: bool,
                 dropout: float, mask_attention: bool, remat: bool, *,
                 generator: torch.Generator, device=None, dtype=None):
        super().__init__()
        self.mask_attention = mask_attention
        self.remat = remat
        self.layers = nn.ModuleList(
            ConformerBlock(d_model, n_head, ffn_expansion, conv_kernel, conv_expansion,
                           half_step_residual, dropout, mask_attention, generator=generator,
                           device=device, dtype=dtype)
            for _ in range(n_layers)
        )
        self._pos = _Positions(d_model, compute_dtype(dtype))

    def run(self, x, mask, rng, train):
        """Positions are added, padded rows zeroed with ``mask_attention``
        (the reference skips that), then the blocks."""
        pos = self._pos(x.shape[1], x.device)
        x = x + pos[None]
        if self.mask_attention:
            x = x * mask[..., None]
        return run_layers(self.layers, self.remat, x, pos, mask, train, rng=rng)


class ConformerEncoder(_ConformerStack):
    """Phoneme encoder: embedding (row 0 is padding) + sinusoid positions +
    N conformer blocks.  Returns (x, raw embeddings)."""

    def __init__(self, n_symbols: int, n_layers: int, d_model: int, n_head: int,
                 ffn_expansion: int = 4, conv_kernel: int = 31, conv_expansion: int = 2,
                 half_step_residual: bool = True, dropout: float = 0.1,
                 mask_attention: bool = True, remat: bool = False, *,
                 generator: torch.Generator, device=None, dtype=None):
        super().__init__(n_layers, d_model, n_head, ffn_expansion, conv_kernel, conv_expansion,
                         half_step_residual, dropout, mask_attention, remat,
                         generator=generator, device=device, dtype=dtype)
        self.src_word_emb = Embedding(n_symbols + 1, d_model, std=1.0, zero_row0=True,
                                      generator=generator, device=device, dtype=dtype)

    def forward(self, token_ids, mask, rng: Optional[torch.Generator] = None,
                train: bool = False):
        emb = self.src_word_emb(token_ids)
        return self.run(emb, mask, rng, train), emb


class ConformerDecoder(_ConformerStack):
    """Mel decoder over frame-rate sequences.  Returns (x, mask)."""

    def __init__(self, n_layers: int, d_model: int, n_head: int, ffn_expansion: int = 4,
                 conv_kernel: int = 31, conv_expansion: int = 2,
                 half_step_residual: bool = True, dropout: float = 0.1,
                 mask_attention: bool = True, remat: bool = False, *,
                 generator: torch.Generator, device=None, dtype=None):
        super().__init__(n_layers, d_model, n_head, ffn_expansion, conv_kernel, conv_expansion,
                         half_step_residual, dropout, mask_attention, remat,
                         generator=generator, device=device, dtype=dtype)

    def forward(self, x, mask, rng: Optional[torch.Generator] = None, train: bool = False):
        return self.run(cast(x, self._pos.dtype), mask, rng, train), mask
