"""Long-short transformer encoder and decoder (port of
``e2e_tts_tpu/nn/lstransformer.py``, after Zhu et al. 2021).

Attention per layer is one softmax over two sets of keys: a causal window
(each window of ``window_size`` frames sees itself and the window before,
window 0 a zero window that ``local_norm`` still normalises) and a low-rank
global set (the key/values of each ``segment_size``-frame segment pooled
into ``r`` rows by ``to_dynamic_proj``, a query seeing a segment only once
it is wholly past).  Keys and values are tied; rotary positions go on the
queries and the key/values, in the half-split layout or the interleaved
pairs of the reference's library (``rotary_interleaved``).  Windowing is a
reshape of the sequence padded to a multiple of lcm(window, segment).  The
attention is plain PyTorch, as the JAX family's is (no ``use_flash``, so
no Pallas kernel on its path: ``e2e_tts_tpu/models/blocks.py:38-53`` hands the
flag to the transformer only).  Masked scores are -1e9, so a row with no
valid key stays finite.

``invert_mask`` and ``pre_zero=False`` reproduce the reference's mask
polarity and unzeroed padded rows, for migrated checkpoints.  Dropout draws
from ``rng`` (None: deterministic).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .common import (Embedding, LayerNorm, Linear, cast, compute_dtype, dropout, island,
                     run_layers)
from .fastformer import ConvFFN
from .transformer import _Positions

NEG_INF = -1e9


def _rotary_freqs(T: int, d: int, interleaved: bool = False) -> np.ndarray:
    inv = 1.0 / (10000 ** (np.arange(0, d, 2) / d))
    ang = np.arange(T)[:, None] * inv[None, :]
    if interleaved:  # [a0, a0, a1, a1, ...], rotary-embedding-torch's layout
        return np.repeat(ang, 2, axis=-1).astype(np.float32)
    return np.concatenate([ang, ang], axis=-1).astype(np.float32)  # (T, d)


def _rotate_half(x: torch.Tensor, interleaved: bool = False) -> torch.Tensor:
    if interleaved:  # pairs (x0, x1) -> (-x1, x0)
        pair = x.reshape(*x.shape[:-1], -1, 2)
        return torch.stack([-pair[..., 1], pair[..., 0]], dim=-1).reshape(x.shape)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _apply_rotary(x: torch.Tensor, freqs: torch.Tensor, interleaved: bool = False):
    return x * torch.cos(freqs) + _rotate_half(x, interleaved) * torch.sin(freqs)


class LongShortAttention(nn.Module):
    def __init__(self, d_model: int, n_head: int, window_size: int = 128,
                 segment_size: int = 16, r: int = 1, dropout: float = 0.2,
                 rotary_interleaved: bool = False, invert_mask: bool = False, *,
                 generator: torch.Generator, device=None, dtype=None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.n_head, self.D = n_head, d_model // n_head
        self.window_size, self.segment_size, self.r = window_size, segment_size, r
        self.dropout = dropout
        self.rotary_interleaved, self.invert_mask = rotary_interleaved, invert_mask
        inner = n_head * self.D
        self.to_q = Linear(d_model, inner, bias=False, **kw)
        self.to_kv = Linear(d_model, inner, bias=False, **kw)
        self.local_norm = LayerNorm(self.D, 1e-5, device=device, dtype=dtype)
        self.to_dynamic_proj = Linear(self.D, r, bias=False, **kw)
        self.global_norm = LayerNorm(self.D, 1e-5, device=device, dtype=dtype)
        self.to_out = Linear(inner, d_model, **kw)

    def forward(self, x, mask, rng: Optional[torch.Generator] = None):
        B, T0, _ = x.shape
        H, D = self.n_head, self.D
        w, s, r = self.window_size, self.segment_size, self.r
        mult = int(np.lcm(w, s))
        T = -(-T0 // mult) * mult
        if T > T0:
            x = nn.functional.pad(x, (0, 0, 0, T - T0))
            mask = nn.functional.pad(mask, (0, T - T0))
        if self.invert_mask:  # keep NOT valid, never the padded tail
            mask = (torch.arange(T, device=x.device) < T0)[None, :] & ~mask

        def fold(t):  # (B, T, H*D) -> (B*H, T, D)
            return t.reshape(B, T, H, D).permute(0, 2, 1, 3).reshape(B * H, T, D)

        q, kv = fold(self.to_q(x)), fold(self.to_kv(x))
        freqs = torch.from_numpy(_rotary_freqs(T, D, self.rotary_interleaved)).to(
            q.device, q.dtype)[None]
        q = _apply_rotary(q, freqs, self.rotary_interleaved) * (D ** -0.5)
        kv = _apply_rotary(kv, freqs, self.rotary_interleaved)
        n_win = T // w
        hmask = mask.repeat_interleave(H, dim=0)  # (B*H, T)

        # local: each window attends to [previous window | itself]
        lq = q.reshape(-1, n_win, w, D)
        lkv = kv.reshape(-1, n_win, w, D)
        lkv2 = self.local_norm(torch.cat([nn.functional.pad(lkv[:, :-1], (0, 0, 0, 0, 1, 0)),
                                          lkv], dim=2))  # (BH, n_win, 2w, D)
        lsim = torch.einsum("bwid,bwjd->bwij", lq, lkv2)
        m_win = hmask.reshape(-1, n_win, w)
        key_m = torch.cat([nn.functional.pad(m_win[:, :-1], (0, 0, 1, 0)), m_win], dim=2)
        lsim = torch.where(key_m[:, :, None, :], lsim, NEG_INF)
        i_pos = torch.arange(w, device=x.device)
        j_off = torch.arange(2 * w, device=x.device) - w
        lsim = torch.where((j_off[None, :] <= i_pos[:, None])[None, None], lsim, NEG_INF)

        # global: segments pooled to r rows each, seen once wholly past
        n_seg = T // s
        gkv_seg = kv.reshape(-1, n_seg, s, D)
        p_logits = self.to_dynamic_proj(gkv_seg)  # (BH, n_seg, s, r)
        p_logits = torch.where(hmask.reshape(-1, n_seg, s)[..., None], p_logits, NEG_INF)
        p = torch.softmax(island(p_logits), dim=-2).to(gkv_seg.dtype)
        gkv = torch.einsum("bnsd,bnsr->bnrd", gkv_seg, p).reshape(-1, n_seg * r, D)
        gkv = self.global_norm(gkv)
        n_glob = n_seg * r
        gsim = torch.einsum("bnd,brd->bnr", q, gkv)  # (BH, T, n_glob)
        seg_max = ((torch.arange(n_seg, device=x.device) + 1) * s - 1).repeat_interleave(r)
        g_ok = torch.arange(T, device=x.device)[:, None] >= seg_max[None, :]
        gsim = torch.where(g_ok[None], gsim, NEG_INF).reshape(-1, n_win, w, n_glob)

        attn = torch.softmax(island(torch.cat([gsim, lsim], dim=-1)), dim=-1).to(lq.dtype)
        attn = dropout(attn, self.dropout, rng)
        out = torch.einsum("bwij,bwjd->bwid", attn[..., n_glob:], lkv2)
        out = out + torch.einsum("bwir,brd->bwid", attn[..., :n_glob], gkv)
        out = out.reshape(B, H, T, D).permute(0, 2, 1, 3).reshape(B, T, H * D)
        return self.to_out(out[:, :T0])


class LSTransformerStack(nn.Module):
    """Pre-norm layers ``attn_norm_i``, ``attn_i``, ``ff_norm_i``, ``ff_i``
    under the flax names."""

    def __init__(self, n_layers: int, d_model: int, n_head: int, d_inner: int,
                 kernel_sizes: Tuple[int, int] = (9, 1), window_size: int = 128,
                 segment_size: int = 16, r: int = 1, dropout: float = 0.2,
                 rotary_interleaved: bool = False, invert_mask: bool = False,
                 remat: bool = False, *, generator: torch.Generator, device=None, dtype=None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.n_layers, self.remat = n_layers, remat
        for i in range(n_layers):
            setattr(self, f"attn_norm_{i}", LayerNorm(d_model, 1e-5, device=device, dtype=dtype))
            setattr(self, f"attn_{i}", LongShortAttention(
                d_model, n_head, window_size, segment_size, r, dropout, rotary_interleaved,
                invert_mask, **kw))
            setattr(self, f"ff_norm_{i}", LayerNorm(d_model, 1e-5, device=device, dtype=dtype))
            setattr(self, f"ff_{i}", ConvFFN(d_model, d_inner, kernel_sizes, dropout, **kw))

    def layer(self, i: int, x, mask, rng: Optional[torch.Generator] = None):
        m = mask[..., None]
        x = x + getattr(self, f"attn_{i}")(getattr(self, f"attn_norm_{i}")(x), mask, rng)
        x = x * m
        x = x + getattr(self, f"ff_{i}")(getattr(self, f"ff_norm_{i}")(x), rng)
        return x * m

    def forward(self, x, mask, rng: Optional[torch.Generator] = None):
        layers = [functools.partial(self.layer, i) for i in range(self.n_layers)]
        return run_layers(layers, self.remat, x, mask, rng=rng)


class _LSTBase(nn.Module):
    def __init__(self, n_layers, d_model, n_head, d_inner, kernel_sizes, window_size, r,
                 dropout, pre_zero, rotary_interleaved, invert_mask, remat, *, generator,
                 device, dtype, segment_size=16):
        super().__init__()
        self.pre_zero = pre_zero
        self.stack = LSTransformerStack(
            n_layers, d_model, n_head, d_inner, tuple(kernel_sizes), window_size, segment_size,
            r, dropout, rotary_interleaved, invert_mask, remat, generator=generator,
            device=device, dtype=dtype)
        self._pos = _Positions(d_model, compute_dtype(dtype))

    def run(self, x, mask, rng):
        x = x + self._pos(x.shape[1], x.device)[None]
        if self.pre_zero:
            x = x * mask[..., None]
        return self.stack(x, mask, rng)


class LSTransformerEncoder(_LSTBase):
    """Phoneme encoder: embedding (row 0 is padding) + sinusoid positions +
    the stack.  Returns (x, raw embeddings)."""

    def __init__(self, n_symbols: int, n_layers: int, d_model: int, n_head: int, d_inner: int,
                 kernel_sizes: Tuple[int, int] = (9, 1), window_size: int = 128, r: int = 1,
                 dropout: float = 0.2, pre_zero: bool = True, rotary_interleaved: bool = False,
                 invert_mask: bool = False, remat: bool = False, *,
                 generator: torch.Generator, device=None, dtype=None):
        super().__init__(n_layers, d_model, n_head, d_inner, kernel_sizes, window_size, r,
                         dropout, pre_zero, rotary_interleaved, invert_mask, remat,
                         generator=generator, device=device, dtype=dtype)
        self.src_word_emb = Embedding(n_symbols + 1, d_model, std=1.0, zero_row0=True,
                                      generator=generator, device=device, dtype=dtype)

    def forward(self, token_ids, mask, rng: Optional[torch.Generator] = None,
                train: bool = False):
        emb = self.src_word_emb(token_ids)
        return self.run(emb, mask, rng), emb


class LSTransformerDecoder(_LSTBase):
    """Mel decoder over frame-rate sequences.  Returns (x, mask)."""

    def __init__(self, n_layers: int, d_model: int, n_head: int, d_inner: int,
                 kernel_sizes: Tuple[int, int] = (9, 1), window_size: int = 128, r: int = 1,
                 dropout: float = 0.2, pre_zero: bool = True, rotary_interleaved: bool = False,
                 invert_mask: bool = False, remat: bool = False, *,
                 generator: torch.Generator, device=None, dtype=None):
        super().__init__(n_layers, d_model, n_head, d_inner, kernel_sizes, window_size, r,
                         dropout, pre_zero, rotary_interleaved, invert_mask, remat,
                         generator=generator, device=device, dtype=dtype)

    def forward(self, x, mask, rng: Optional[torch.Generator] = None, train: bool = False):
        return self.run(cast(x, self._pos.dtype), mask, rng), mask
