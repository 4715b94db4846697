"""FFT (feed-forward transformer) blocks, the default FastSpeech2 encoder and
decoder (port of ``e2e_tts_tpu/nn/transformer.py``).

Attention over T >= 256 with ``use_flash`` goes through the hand-written
kernel (``kernels/flash_attention.py``) with heads folded into the batch;
otherwise it is plain PyTorch with the pair mask at -1e9 and the softmax in
float32.  Masks are True = valid and multiply.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..kernels import flash_attention
from .common import Conv1d, Embedding, LayerNorm, Linear, sinusoid_table

NEG_INF = -1e9
FLASH_MIN_LEN = 256


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, n_head: int, use_flash: bool = False, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.n_head = n_head
        self.d_k = d_model // n_head
        self.use_flash = use_flash
        kw = dict(generator=generator, device=device)
        self.w_q = Linear(d_model, n_head * self.d_k, **kw)
        self.w_k = Linear(d_model, n_head * self.d_k, **kw)
        self.w_v = Linear(d_model, n_head * self.d_k, **kw)
        self.fc = Linear(n_head * self.d_k, d_model, **kw)
        self.layer_norm = LayerNorm(d_model, 1e-5, device=device)

    def forward(self, x, pair_mask, kv_lens=None):
        B, T, _ = x.shape
        H, dk = self.n_head, self.d_k
        q = self.w_q(x).view(B, T, H, dk)
        k = self.w_k(x).view(B, T, H, dk)
        v = self.w_v(x).view(B, T, H, dk)
        if self.use_flash and kv_lens is not None and T >= FLASH_MIN_LEN:
            def fold(t):
                return t.permute(0, 2, 1, 3).reshape(B * H, T, dk).contiguous()

            lens = torch.repeat_interleave(kv_lens.to(torch.int32), H)
            o = flash_attention(fold(q), fold(k), fold(v), lens)
            out = o.view(B, H, T, dk).permute(0, 2, 1, 3).reshape(B, T, H * dk)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(dk)
            scores = torch.where(pair_mask[:, None], scores, torch.full_like(scores, NEG_INF))
            attn = torch.softmax(scores.float(), dim=-1).to(x.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, T, H * dk)
        return self.layer_norm(self.fc(out) + x)


class ConvFFN(nn.Module):
    def __init__(self, d_model: int, d_inner: int, kernel_sizes: Tuple[int, int] = (9, 1), *,
                 generator: torch.Generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.w_1 = Conv1d(d_model, d_inner, kernel_sizes[0], **kw)
        self.w_2 = Conv1d(d_inner, d_model, kernel_sizes[1], **kw)
        self.layer_norm = LayerNorm(d_model, 1e-5, device=device)

    def forward(self, x):
        h = self.w_2.conv_ncw(torch.relu(self.w_1.conv_ncw(x.transpose(1, 2))))
        return self.layer_norm(h.transpose(1, 2) + x)


class FFTBlock(nn.Module):
    def __init__(self, d_model: int, n_head: int, d_inner: int,
                 kernel_sizes: Tuple[int, int] = (9, 1), use_flash: bool = False, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.slf_attn = MultiHeadAttention(d_model, n_head, use_flash, **kw)
        self.pos_ffn = ConvFFN(d_model, d_inner, kernel_sizes, **kw)

    def forward(self, x, mask):
        pair_mask = mask[:, :, None] & mask[:, None, :]
        kv_lens = mask.sum(dim=-1)
        x = self.slf_attn(x, pair_mask, kv_lens) * mask[..., None]
        return self.pos_ffn(x) * mask[..., None]


class _Positions:
    """Sinusoid positions cut from one cached table that grows on demand
    (row p of the table does not depend on its length)."""

    def __init__(self, d_model: int):
        self.d_model = d_model
        self.table = None

    def __call__(self, T: int, device) -> torch.Tensor:
        if self.table is None or self.table.shape[0] < T or self.table.device != device:
            n = max(T, 0 if self.table is None else self.table.shape[0])
            self.table = torch.from_numpy(sinusoid_table(max(n, 1), self.d_model)).to(device)
        return self.table[:T]


class TransformerEncoder(nn.Module):
    """Phoneme encoder: embedding (row 0 is padding) + sinusoid positions +
    N FFT blocks.  Returns (x, raw embeddings)."""

    def __init__(self, n_symbols: int, n_layers: int, d_model: int, n_head: int,
                 d_inner: int, kernel_sizes: Tuple[int, int] = (9, 1),
                 use_flash: bool = False, *, generator: torch.Generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.src_word_emb = Embedding(n_symbols + 1, d_model, std=1.0, zero_row0=True, **kw)
        self.layers = nn.ModuleList(
            FFTBlock(d_model, n_head, d_inner, kernel_sizes, use_flash, **kw)
            for _ in range(n_layers)
        )
        self._pos = _Positions(d_model)

    def forward(self, token_ids, mask):
        emb = self.src_word_emb(token_ids)
        x = (emb + self._pos(token_ids.shape[1], emb.device)[None]) * mask[..., None]
        for layer in self.layers:
            x = layer(x, mask)
        return x, emb


class TransformerDecoder(nn.Module):
    """Mel decoder over frame-rate sequences.  Returns (x, mask)."""

    def __init__(self, n_layers: int, d_model: int, n_head: int, d_inner: int,
                 kernel_sizes: Tuple[int, int] = (9, 1), use_flash: bool = False, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.layers = nn.ModuleList(
            FFTBlock(d_model, n_head, d_inner, kernel_sizes, use_flash, **kw)
            for _ in range(n_layers)
        )
        self._pos = _Positions(d_model)

    def forward(self, x, mask):
        x = (x + self._pos(x.shape[1], x.device)[None]) * mask[..., None]
        for layer in self.layers:
            x = layer(x, mask)
        return x, mask
