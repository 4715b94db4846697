"""FFT (feed-forward transformer) blocks, the default FastSpeech2 encoder and
decoder (port of ``e2e_tts_tpu/nn/transformer.py``).

Attention over T >= 256 with ``use_flash`` goes through the hand-written
kernel (``kernels/flash_attention.py``) with heads folded into the batch;
otherwise it is plain PyTorch with the pair mask at -1e9 and the softmax in
float32.  In a 16-bit compute ``dtype`` (``nn/common.py``) the branches keep
the JAX package's semantics: the kernel takes the 16-bit q, k and v and
rounds once, at its output, as the Pallas kernel does; the plain branch
rounds q k^T to the dtype, then divides by a float32 sqrt(d_k) (JAX promotes
the 16-bit scores by the NumPy scalar) and takes the softmax in float32.
Each residual sum enters its LayerNorm unrounded, in float32, as XLA
compiles the JAX block (the add's rounding to the dtype folds away against
LayerNorm's upcast).  The kernel is forward only: asking for it while
autograd records raises, as the JAX package's does, and training runs the
plain branch.
Dropout (after ``fc`` and after ``w_2``) draws from the generator passed as
``rng``; ``rng=None`` is deterministic.  Masks are True = valid and multiply.
``remat`` recomputes each block in the backward pass (``common.remat``).

Split over a model group (``tp``, set by
``parallel/tensor_parallel.parallelize``), attention is megatron's: ``w_q``,
``w_k`` and ``w_v`` column-parallel (this rank's heads, with its slices of
the replicated biases), attention on the local heads (through the kernel,
the local heads folded into the batch, where the unsplit layer would take
it), ``fc`` row-parallel (its partial products summed over the group, then
its bias once).  Where the model axis does not divide the heads, a head is
cut across ranks: q, k and v are gathered, every rank attends over the whole
heads and keeps its columns for ``fc``.  The FFN's ``w_1`` is
column-parallel and ``w_2`` row-parallel, both through ``Conv1d.conv_ncw``
(so its training path on CUDA holds).  Dropout draws on the replicated
activations after the sums, so every rank of the group draws one mask.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..kernels import flash_attention
from ..parallel.tensor_parallel import (copy_to_model, gather_from_model, reduce_from_model,
                                        scatter_to_model)
from .common import (Conv1d, Embedding, LayerNorm, Linear, cast, cast_param, compute_dtype,
                     dropout, island, run_layers, sinusoid_table)

NEG_INF = -1e9
FLASH_MIN_LEN = 256


class MultiHeadAttention(nn.Module):
    tp = None

    def __init__(self, d_model: int, n_head: int, use_flash: bool = False, dropout: float = 0.1,
                 *, generator: torch.Generator, device=None, dtype=None):
        super().__init__()
        self.n_head = n_head
        self.dropout = dropout
        self.d_k = d_model // n_head
        self.use_flash = use_flash
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.w_q = Linear(d_model, n_head * self.d_k, **kw)
        self.w_k = Linear(d_model, n_head * self.d_k, **kw)
        self.w_v = Linear(d_model, n_head * self.d_k, **kw)
        self.fc = Linear(n_head * self.d_k, d_model, **kw)
        self.layer_norm = LayerNorm(d_model, 1e-5, device=device, dtype=dtype)

    def forward(self, x, pair_mask, kv_lens=None, rng: Optional[torch.Generator] = None):
        if self.tp is None:
            B, T, _ = x.shape
            q, k, v = (w(x).view(B, T, self.n_head, self.d_k)
                       for w in (self.w_q, self.w_k, self.w_v))
            h = self.fc(self._attend(q, k, v, pair_mask, kv_lens))
        else:
            h = self._split(x, pair_mask, kv_lens)
        return self.layer_norm(island(dropout(h, self.dropout, rng)) + island(x))

    def _split(self, x, pair_mask, kv_lens):
        """``fc``'s output, the attention split over the model group."""
        B, T, _ = x.shape
        dk, group = self.d_k, self.tp.group
        cols = self.tp.part(self.n_head * dk)  # this rank's columns of q, k, v and fc's input
        xs = copy_to_model(x, group)
        q, k, v = (w(xs, bias=cols) for w in (self.w_q, self.w_k, self.w_v))
        if cols.start % dk == 0 and (cols.stop - cols.start) % dk == 0:  # whole local heads
            out = self._attend(*(t.reshape(B, T, -1, dk) for t in (q, k, v)), pair_mask, kv_lens)
        else:  # a head cut across ranks
            q, k, v = (gather_from_model(t, -1, group).view(B, T, self.n_head, dk)
                       for t in (q, k, v))
            out = scatter_to_model(self._attend(q, k, v, pair_mask, kv_lens), -1, group)
        return reduce_from_model(self.fc(out, bias=False), group) + cast_param(self.fc, "bias")

    def _attend(self, q, k, v, pair_mask, kv_lens):
        """(B, T, H, dk) q, k, v -> (B, T, H * dk): the kernel at T >= 256
        with ``use_flash`` outside autograd, else plain attention."""
        B, T, H, dk = q.shape
        if self.use_flash and kv_lens is not None and T >= FLASH_MIN_LEN:
            if torch.is_grad_enabled() and q.requires_grad:
                raise RuntimeError("the flash attention kernel is forward only: train with "
                                   "use_flash=False")

            def fold(t):
                return t.permute(0, 2, 1, 3).reshape(B * H, T, dk).contiguous()

            lens = torch.repeat_interleave(kv_lens.to(torch.int32), H)
            o = flash_attention(fold(q), fold(k), fold(v), lens)
            out = o.view(B, H, T, dk).permute(0, 2, 1, 3).reshape(B, T, H * dk)
        else:
            scores = island(torch.einsum("bqhd,bkhd->bhqk", q, k)) / np.sqrt(dk)
            scores = torch.where(pair_mask[:, None], scores, torch.full_like(scores, NEG_INF))
            attn = torch.softmax(scores, dim=-1).to(v.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, T, H * dk)
        return out


class ConvFFN(nn.Module):
    tp = None

    def __init__(self, d_model: int, d_inner: int, kernel_sizes: Tuple[int, int] = (9, 1),
                 dropout: float = 0.1, *, generator: torch.Generator, device=None, dtype=None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.dropout = dropout
        self.w_1 = Conv1d(d_model, d_inner, kernel_sizes[0], **kw)
        self.w_2 = Conv1d(d_inner, d_model, kernel_sizes[1], **kw)
        self.layer_norm = LayerNorm(d_model, 1e-5, device=device, dtype=dtype)

    def forward(self, x, rng: Optional[torch.Generator] = None):
        if self.tp is None:
            h = self.w_2.conv_ncw(torch.relu(self.w_1.conv_ncw(x.transpose(1, 2))))
        else:
            group = self.tp.group
            cols = self.tp.part(self.w_1.bias.shape[0])
            h = torch.relu(self.w_1.conv_ncw(copy_to_model(x, group).transpose(1, 2), bias=cols))
            h = reduce_from_model(self.w_2.conv_ncw(h, bias=False), group)
            h = h + cast_param(self.w_2, "bias")[:, None]
        return self.layer_norm(island(dropout(h.transpose(1, 2), self.dropout, rng)) + island(x))


class FFTBlock(nn.Module):
    def __init__(self, d_model: int, n_head: int, d_inner: int,
                 kernel_sizes: Tuple[int, int] = (9, 1), use_flash: bool = False,
                 dropout: float = 0.1, *, generator: torch.Generator, device=None, dtype=None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.slf_attn = MultiHeadAttention(d_model, n_head, use_flash, dropout, **kw)
        self.pos_ffn = ConvFFN(d_model, d_inner, kernel_sizes, dropout, **kw)

    def forward(self, x, mask, rng: Optional[torch.Generator] = None):
        pair_mask = mask[:, :, None] & mask[:, None, :]
        kv_lens = mask.sum(dim=-1)
        x = self.slf_attn(x, pair_mask, kv_lens, rng) * mask[..., None]
        return self.pos_ffn(x, rng) * mask[..., None]


class _Positions:
    """Positions cut from one cached table (``table(n, d_model)``, sinusoids
    by default) that grows on demand (row p of the table does not depend on
    its length), in the compute dtype (float32 for None).  The tables it
    outgrows stay held: a CUDA graph (``serve/graphs.py``) captured over a
    cut of one reads it at each replay."""

    def __init__(self, d_model: int, dtype=None, table=sinusoid_table):
        self.d_model = d_model
        self.dtype = dtype
        self.make = table
        self.table = None
        self.outgrown = []

    def __call__(self, T: int, device) -> torch.Tensor:
        if self.table is None or self.table.shape[0] < T or self.table.device != device:
            n = max(T, 0 if self.table is None else self.table.shape[0])
            table = torch.from_numpy(self.make(max(n, 1), self.d_model))
            if self.table is not None:
                self.outgrown.append(self.table)
            self.table = cast(table, self.dtype).to(device)
        return self.table[:T]


class TransformerEncoder(nn.Module):
    """Phoneme encoder: embedding (row 0 is padding) + sinusoid positions +
    N FFT blocks.  Returns (x, raw embeddings)."""

    graph_safe = True  # serve/graphs.py may capture its call

    def __init__(self, n_symbols: int, n_layers: int, d_model: int, n_head: int,
                 d_inner: int, kernel_sizes: Tuple[int, int] = (9, 1),
                 use_flash: bool = False, dropout: float = 0.1, *, generator: torch.Generator,
                 device=None, dtype=None, remat: bool = False):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.remat = remat
        self.src_word_emb = Embedding(n_symbols + 1, d_model, std=1.0, zero_row0=True, **kw)
        self.layers = nn.ModuleList(
            FFTBlock(d_model, n_head, d_inner, kernel_sizes, use_flash, dropout, **kw)
            for _ in range(n_layers)
        )
        self._pos = _Positions(d_model, compute_dtype(dtype))

    def forward(self, token_ids, mask, rng: Optional[torch.Generator] = None,
                train: bool = False):
        emb = self.src_word_emb(token_ids)
        x = (emb + self._pos(token_ids.shape[1], emb.device)[None]) * mask[..., None]
        return run_layers(self.layers, self.remat, x, mask, rng=rng), emb


class TransformerDecoder(nn.Module):
    """Mel decoder over frame-rate sequences.  Returns (x, mask)."""

    graph_safe = True  # serve/graphs.py may capture its call

    def __init__(self, n_layers: int, d_model: int, n_head: int, d_inner: int,
                 kernel_sizes: Tuple[int, int] = (9, 1), use_flash: bool = False,
                 dropout: float = 0.1, *, generator: torch.Generator, device=None, dtype=None,
                 remat: bool = False):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.remat = remat
        self.layers = nn.ModuleList(
            FFTBlock(d_model, n_head, d_inner, kernel_sizes, use_flash, dropout, **kw)
            for _ in range(n_layers)
        )
        self._pos = _Positions(d_model, compute_dtype(dtype))

    def forward(self, x, mask, rng: Optional[torch.Generator] = None, train: bool = False):
        x = (cast(x, self._pos.dtype) + self._pos(x.shape[1], x.device)[None]) * mask[..., None]
        return run_layers(self.layers, self.remat, x, mask, rng=rng), mask
