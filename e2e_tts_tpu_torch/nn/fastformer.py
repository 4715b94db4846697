"""Fastformer encoder and decoder: additive attention, O(T) (port of
``e2e_tts_tpu/nn/fastformer.py``, after Wu et al. 2021).

Per pre-norm layer: a per-head softmax over time pools the queries into a
global query; keys modulated by it are pooled into a global key; the
queries modulated by that go through ``transform`` and add the query
projection back.  The pooling logits ``to_q_attn_logits`` and
``to_k_attn_logits`` are tied across layers: one module each in the stack,
handed to every layer.  The attention is plain PyTorch, as the JAX
family's is (no ``use_flash``, so no Pallas kernel on its path:
``e2e_tts_tpu/models/blocks.py:38-53`` hands the flag to the transformer only).

The additive mask is -1e4 where a position is not kept; ``invert_mask``
reproduces the reference's inverted polarity (valid positions penalised),
and ``pre_zero=False`` its unzeroed padded rows before the first layer, for
migrated checkpoints.  Dropout draws from ``rng`` (None: deterministic).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch import nn

from .common import (Conv1d, Embedding, LayerNorm, Linear, cast, compute_dtype, dropout, gelu,
                     island, run_layers)
from .transformer import _Positions

NEG_INF = -1e4


class FastAttention(nn.Module):
    def __init__(self, d_model: int, n_head: int, dropout: float = 0.2,
                 invert_mask: bool = False, *, generator: torch.Generator, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.d_model, self.n_head, self.dropout = d_model, n_head, dropout
        self.invert_mask = invert_mask
        self.query = Linear(d_model, d_model, **kw)
        self.key = Linear(d_model, d_model, **kw)
        self.transform = Linear(d_model, d_model, **kw)

    def forward(self, x, mask, q_logits_mod, k_logits_mod, rng: Optional[torch.Generator] = None):
        B, T, _ = x.shape
        H, D = self.n_head, self.d_model // self.n_head
        scale = D ** -0.5
        mix_q, mix_k = self.query(x), self.key(x)
        keep = ~mask if self.invert_mask else mask
        neg = (~keep).to(mix_q.dtype) * NEG_INF  # (B, T)

        q_score = q_logits_mod(mix_q) * scale + neg[..., None]  # (B, T, H)
        q_weight = torch.softmax(island(q_score), dim=1).to(mix_q.dtype)
        q_heads = mix_q.view(B, T, H, D)
        pooled_q = torch.einsum("bth,bthd->bhd", q_weight, q_heads).reshape(B, 1, H * D)

        qk = mix_k * pooled_q
        k_score = k_logits_mod(qk) * scale + neg[..., None]
        k_weight = torch.softmax(island(k_score), dim=1).to(qk.dtype)
        pooled_k = torch.einsum("bth,bthd->bhd", k_weight, qk.view(B, T, H, D))

        weighted = (pooled_k[:, None] * q_heads).reshape(B, T, H * D)
        out = self.transform(weighted) + mix_q
        return dropout(out, self.dropout, rng)


class ConvFFN(nn.Module):
    """Conv (k0) -> tanh-GELU -> conv (k1) -> dropout, channels-last."""

    def __init__(self, d_model: int, d_inner: int, kernel_sizes: Tuple[int, int],
                 dropout: float, *, generator: torch.Generator, device=None, dtype=None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.dropout = dropout
        self.w_1 = Conv1d(d_model, d_inner, kernel_sizes[0], **kw)
        self.w_2 = Conv1d(d_inner, d_model, kernel_sizes[1], **kw)

    def forward(self, x, rng: Optional[torch.Generator] = None):
        h = self.w_2.conv_ncw(gelu(self.w_1.conv_ncw(x.transpose(1, 2))))
        return dropout(h.transpose(1, 2), self.dropout, rng)


class FastformerStack(nn.Module):
    """Layers ``attn_norm_i``, ``attn_i``, ``ff_norm_i`` and ``ff_i`` under the
    flax names, and the two tied pooling projections once."""

    def __init__(self, n_layers: int, d_model: int, n_head: int, d_inner: int,
                 kernel_sizes: Tuple[int, int] = (9, 1), dropout: float = 0.2,
                 invert_mask: bool = False, remat: bool = False, *,
                 generator: torch.Generator, device=None, dtype=None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.n_layers, self.remat = n_layers, remat
        self.to_q_attn_logits = Linear(d_model, n_head, **kw)
        self.to_k_attn_logits = Linear(d_model, n_head, **kw)
        for i in range(n_layers):
            setattr(self, f"attn_norm_{i}", LayerNorm(d_model, 1e-5, device=device, dtype=dtype))
            setattr(self, f"ff_norm_{i}", LayerNorm(d_model, 1e-5, device=device, dtype=dtype))
            setattr(self, f"attn_{i}", FastAttention(d_model, n_head, dropout, invert_mask, **kw))
            setattr(self, f"ff_{i}", ConvFFN(d_model, d_inner, kernel_sizes, dropout, **kw))

    def layer(self, i: int, x, mask, rng: Optional[torch.Generator] = None):
        m = mask[..., None]
        h = getattr(self, f"attn_norm_{i}")(x)
        x = x + getattr(self, f"attn_{i}")(h, mask, self.to_q_attn_logits,
                                           self.to_k_attn_logits, rng)
        x = x * m
        x = x + getattr(self, f"ff_{i}")(getattr(self, f"ff_norm_{i}")(x), rng)
        return x * m

    def forward(self, x, mask, rng: Optional[torch.Generator] = None):
        layers = [functools.partial(self.layer, i) for i in range(self.n_layers)]
        return run_layers(layers, self.remat, x, mask, rng=rng)


class _FastformerBase(nn.Module):
    def __init__(self, n_layers, d_model, n_head, d_inner, kernel_sizes, dropout, pre_zero,
                 invert_mask, remat, *, generator, device, dtype):
        super().__init__()
        self.pre_zero = pre_zero
        self.stack = FastformerStack(n_layers, d_model, n_head, d_inner, tuple(kernel_sizes),
                                     dropout, invert_mask, remat, generator=generator,
                                     device=device, dtype=dtype)
        self._pos = _Positions(d_model, compute_dtype(dtype))

    def run(self, x, mask, rng):
        x = x + self._pos(x.shape[1], x.device)[None]
        if self.pre_zero:
            x = x * mask[..., None]
        return self.stack(x, mask, rng)


class FastformerEncoder(_FastformerBase):
    """Phoneme encoder: embedding (row 0 is padding) + sinusoid positions +
    the stack.  Returns (x, raw embeddings)."""

    def __init__(self, n_symbols: int, n_layers: int, d_model: int, n_head: int, d_inner: int,
                 kernel_sizes: Tuple[int, int] = (9, 1), dropout: float = 0.2,
                 pre_zero: bool = True, invert_mask: bool = False, remat: bool = False, *,
                 generator: torch.Generator, device=None, dtype=None):
        super().__init__(n_layers, d_model, n_head, d_inner, kernel_sizes, dropout, pre_zero,
                         invert_mask, remat, generator=generator, device=device, dtype=dtype)
        self.src_word_emb = Embedding(n_symbols + 1, d_model, std=1.0, zero_row0=True,
                                      generator=generator, device=device, dtype=dtype)

    def forward(self, token_ids, mask, rng: Optional[torch.Generator] = None,
                train: bool = False):
        emb = self.src_word_emb(token_ids)
        return self.run(emb, mask, rng), emb


class FastformerDecoder(_FastformerBase):
    """Mel decoder over frame-rate sequences.  Returns (x, mask)."""

    def __init__(self, n_layers: int, d_model: int, n_head: int, d_inner: int,
                 kernel_sizes: Tuple[int, int] = (9, 1), dropout: float = 0.2,
                 pre_zero: bool = True, invert_mask: bool = False, remat: bool = False, *,
                 generator: torch.Generator, device=None, dtype=None):
        super().__init__(n_layers, d_model, n_head, d_inner, kernel_sizes, dropout, pre_zero,
                         invert_mask, remat, generator=generator, device=device, dtype=dtype)

    def forward(self, x, mask, rng: Optional[torch.Generator] = None, train: bool = False):
        return self.run(cast(x, self._pos.dtype), mask, rng), mask
