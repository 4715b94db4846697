"""Reformer encoder and decoder: LSH attention heads beside local attention
heads, weight-tied layers (port of ``e2e_tts_tpu/nn/reformer.py``, after
Kitaev et al. 2020; the reference's bucket 64, 4 hashes, causal, 4 of 8
heads local).

LSH attention shares one query/key projection, hashes each position into
T / bucket_size buckets per round by random rotations (argmax over
[R, -R]), sorts by (bucket, position), attends within each bucket-sized
chunk and the chunk before it (chunk 0 wraps to the last), and merges the
rounds by a softmax over their log-normalisers.  The rotations are JAX's
``jax.random.normal(PRNGKey(0), (D, n_hashes, n_buckets // 2), dtype)``,
which the JAX package uses in serving and in training alike
(``ops/jax_random.py`` computes them).  All of it is plain PyTorch, as the
JAX family's is (no ``use_flash``, so no Pallas kernel on its path:
``e2e_tts_tpu/models/blocks.py:38-53`` hands the flag to the transformer only).

The layers are plain pre-norm residual blocks, each recomputed in the
backward pass (``common.remat``) whenever autograd records, in place of
the reference's reversible residuals, as the JAX package always does.
Dropout draws from ``rng`` (None: deterministic).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.jax_random import lsh_rotations
from .common import (Embedding, LayerNorm, Linear, cast, compute_dtype, dropout, gelu, island,
                     run_layers)
from .transformer import _Positions

NEG_INF = -1e9
SELF_ATTN_PENALTY = -5e4  # the reference's TOKEN_SELF_ATTN_VALUE
N_LOCAL_HEADS = 4
FF_MULT = 4


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-6)


def lsh_attention(qk: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, n_hashes: int = 4,
                  bucket_size: int = 64,
                  rotations: Optional[torch.Tensor] = None,
                  attend_across_buckets: Optional[bool] = None) -> torch.Tensor:
    """Causal LSH attention of (B, T, D) shared queries/keys ``qk`` and values
    ``v`` under ``mask`` (B, T), True = valid; T a multiple of ``bucket_size``.
    ``rotations`` (D, n_hashes, n_buckets // 2) replaces JAX's key-0 draw.
    ``attend_across_buckets``: None keeps the soft cross-bucket penalty
    (SELF_ATTN_PENALTY / 2); True drops it, False masks other buckets."""
    B, T, D = qk.shape
    n_buckets = max(T // bucket_size, 2)
    n_buckets += n_buckets % 2
    if rotations is None:
        rotations = lsh_rotations((D, n_hashes, n_buckets // 2), qk.dtype, qk.device)
    rotated = torch.einsum("btd,dhr->bhtr", qk, rotations.to(qk.dtype))
    buckets = torch.cat([rotated, -rotated], dim=-1).argmax(dim=-1)  # (B, n_hashes, T)
    # padding goes to the last bucket, so that it sorts to the end
    buckets = torch.where(mask[:, None, :], buckets, n_buckets - 1)

    pos = torch.arange(T, device=qk.device)
    order = torch.argsort(buckets * T + pos, dim=-1)  # (B, n_hashes, T)
    undo = torch.argsort(order, dim=-1)

    def gather_t(x):  # (B, T, D) -> (B, n_hashes, T, D) in each round's order
        return torch.gather(x[:, None].expand(B, n_hashes, T, x.shape[-1]), 2,
                            order[..., None].expand(B, n_hashes, T, x.shape[-1]))

    s_qk = gather_t(qk)
    c = bucket_size
    n_chunks = T // c

    def chunk(x):
        return x.reshape(B, n_hashes, n_chunks, c, *x.shape[3:])

    def with_prev(x):  # each chunk beside the one before it; chunk 0 wraps around
        return torch.cat([torch.roll(x, 1, dims=2), x], dim=3)

    cq = chunk(s_qk)
    cpos = chunk(order)
    cbucket = chunk(torch.gather(buckets, 2, order))
    k2 = with_prev(chunk(_l2norm(s_qk)))
    v2 = with_prev(chunk(gather_t(v)))
    kpos = with_prev(cpos)
    kbucket = with_prev(cbucket)
    kvalid = with_prev(chunk(torch.gather(mask[:, None].expand(B, n_hashes, T), 2, order)))

    # the 16-bit products promote to float32 against JAX's NumPy-scalar scale
    dots = island(torch.einsum("bhnid,bhnjd->bhnij", cq, k2)) / math.sqrt(D)
    dots = torch.where(kvalid[..., None, :], dots, NEG_INF)
    same_bucket = cbucket[..., :, None] == kbucket[..., None, :]
    if attend_across_buckets is None:
        dots = torch.where(same_bucket, dots, dots + SELF_ATTN_PENALTY / 2)
    elif not attend_across_buckets:
        dots = torch.where(same_bucket, dots, NEG_INF)
    dots = torch.where(cpos[..., :, None] >= kpos[..., None, :], dots, NEG_INF)
    dots = torch.where(cpos[..., :, None] == kpos[..., None, :], SELF_ATTN_PENALTY, dots)

    # softmax keeping its log-normaliser, for merging the rounds
    m = dots.amax(dim=-1, keepdim=True)
    e = torch.exp(dots - m)
    denom = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-9)
    attn = e / denom
    logits = (m + torch.log(denom))[..., 0].reshape(B, n_hashes, T)
    out = torch.einsum("bhnij,bhnjd->bhnid", attn, v2.to(attn.dtype)).reshape(B, n_hashes, T, D)

    out = torch.gather(out, 2, undo[..., None].expand(B, n_hashes, T, D))
    logits = torch.gather(logits, 2, undo)
    w = torch.softmax(logits, dim=1)[..., None]
    return (out * w).sum(dim=1)


def local_attention(q, k, v, mask, window: int) -> torch.Tensor:
    """Causal windowed attention over (B, T, D): each window sees itself and
    the window before it (window 0 a zero window, masked)."""
    B, T0, D = q.shape
    T = -(-T0 // window) * window
    if T > T0:
        q, k, v = (nn.functional.pad(t, (0, 0, 0, T - T0)) for t in (q, k, v))
        mask = nn.functional.pad(mask, (0, T - T0))
    n_win = T // window

    def with_prev(x):
        return torch.cat([nn.functional.pad(x[:, :-1], (0, 0) * (x.dim() - 2) + (1, 0)), x],
                         dim=2)

    cq = island(q.reshape(B, n_win, window, D)) / math.sqrt(D)
    k2 = with_prev(k.reshape(B, n_win, window, D))
    v2 = with_prev(v.reshape(B, n_win, window, D))
    m2 = with_prev(mask.reshape(B, n_win, window))
    dots = torch.einsum("bwid,bwjd->bwij", cq, k2.to(cq.dtype))
    dots = torch.where(m2[:, :, None, :], dots, NEG_INF)
    i_pos = torch.arange(window, device=q.device)
    j_off = torch.arange(2 * window, device=q.device) - window
    dots = torch.where(j_off[None, :] <= i_pos[:, None], dots, NEG_INF)
    attn = torch.softmax(island(dots), dim=-1).to(q.dtype)
    return torch.einsum("bwij,bwjd->bwid", attn, v2).reshape(B, T, D)[:, :T0]


class LSHSelfAttention(nn.Module):
    """H - N_LOCAL_HEADS LSH heads, then N_LOCAL_HEADS local heads over
    windows of 2 * bucket_size, all causal; the sequence padded to a
    multiple of 2 * bucket_size."""

    def __init__(self, d_model: int, n_head: int = 8, bucket_size: int = 64, n_hashes: int = 4,
                 dropout: float = 0.2, *, generator: torch.Generator, device=None, dtype=None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.n_head, self.D = n_head, d_model // n_head
        self.bucket_size, self.n_hashes, self.dropout = bucket_size, n_hashes, dropout
        self.to_qk = Linear(d_model, n_head * self.D, bias=False, **kw)
        self.to_v = Linear(d_model, n_head * self.D, bias=False, **kw)
        self.to_out = Linear(n_head * self.D, d_model, **kw)

    def forward(self, x, mask, rng: Optional[torch.Generator] = None):
        B, T0, _ = x.shape
        H, D = self.n_head, self.D
        mult = 2 * self.bucket_size
        T = -(-T0 // mult) * mult
        if T > T0:
            x = nn.functional.pad(x, (0, 0, 0, T - T0))
            mask = nn.functional.pad(mask, (0, T - T0))
        qk = self.to_qk(x).reshape(B, T, H, D).permute(0, 2, 1, 3)
        v = self.to_v(x).reshape(B, T, H, D).permute(0, 2, 1, 3)
        n_lsh, n_loc = H - N_LOCAL_HEADS, N_LOCAL_HEADS
        outs = []
        if n_lsh > 0:
            o = lsh_attention(qk[:, :n_lsh].reshape(B * n_lsh, T, D),
                              v[:, :n_lsh].reshape(B * n_lsh, T, D),
                              mask.repeat_interleave(n_lsh, dim=0), self.n_hashes,
                              self.bucket_size)
            outs.append(o.reshape(B, n_lsh, T, D))
        if n_loc > 0:
            lq = qk[:, n_lsh:].reshape(B * n_loc, T, D)
            o = local_attention(lq, lq, v[:, n_lsh:].reshape(B * n_loc, T, D),
                                mask.repeat_interleave(n_loc, dim=0), mult)
            outs.append(o.reshape(B, n_loc, T, D))
        dt = torch.promote_types(outs[0].dtype, outs[-1].dtype)
        out = torch.cat([o.to(dt) for o in outs], dim=1).permute(0, 2, 1, 3).reshape(B, T, H * D)
        return dropout(self.to_out(out[:, :T0]), self.dropout, rng)


class ChunkedFeedForward(nn.Module):
    """tanh-GELU MLP of width FF_MULT * d_model (``Dense_0``, ``Dense_1``,
    flax's auto-names), kept whole rather than chunked over time."""

    def __init__(self, d_model: int, dropout: float = 0.2, *, generator: torch.Generator,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.dropout = dropout
        self.Dense_0 = Linear(d_model, d_model * FF_MULT, **kw)
        self.Dense_1 = Linear(d_model * FF_MULT, d_model, **kw)

    def forward(self, x, rng: Optional[torch.Generator] = None):
        return self.Dense_1(dropout(gelu(self.Dense_0(x)), self.dropout, rng))


class ReformerStack(nn.Module):
    """Weight-tied, as the reference and the JAX encoder and decoder are: one
    attention, feed-forward and pair of norms (``attn_0``, ``ff_0``,
    ``attn_norm_0``, ``ff_norm_0``, JAX's names) shared by every layer."""

    def __init__(self, n_layers: int, d_model: int, n_head: int = 8, bucket_size: int = 64,
                 n_hashes: int = 4, dropout: float = 0.2, *, generator: torch.Generator,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.n_layers = n_layers
        self.attn_0 = LSHSelfAttention(d_model, n_head, bucket_size, n_hashes, dropout, **kw)
        self.ff_0 = ChunkedFeedForward(d_model, dropout, **kw)
        self.attn_norm_0 = LayerNorm(d_model, 1e-5, device=device, dtype=dtype)
        self.ff_norm_0 = LayerNorm(d_model, 1e-5, device=device, dtype=dtype)

    def layer(self, x, mask, rng: Optional[torch.Generator] = None):
        m = mask[..., None]
        x = x + self.attn_0(self.attn_norm_0(x), mask, rng)
        x = x * m
        x = x + self.ff_0(self.ff_norm_0(x), rng)
        return x * m

    def forward(self, x, mask, rng: Optional[torch.Generator] = None):
        return run_layers([self.layer] * self.n_layers, True, x, mask, rng=rng)


class _ReformerBase(nn.Module):
    def __init__(self, n_layers, d_model, n_head, bucket_size, n_hashes, dropout, *,
                 generator, device, dtype):
        super().__init__()
        self.stack = ReformerStack(n_layers, d_model, n_head, bucket_size, n_hashes, dropout,
                                   generator=generator, device=device, dtype=dtype)
        self._pos = _Positions(d_model, compute_dtype(dtype))

    def run(self, x, mask, rng):
        x = (x + self._pos(x.shape[1], x.device)[None]) * mask[..., None]
        return self.stack(x, mask, rng)


class ReformerEncoder(_ReformerBase):
    """Phoneme encoder: embedding (row 0 is padding) + sinusoid positions,
    padded rows zeroed, + the stack.  Returns (x, raw embeddings)."""

    def __init__(self, n_symbols: int, n_layers: int, d_model: int, n_head: int = 8,
                 bucket_size: int = 64, n_hashes: int = 4, dropout: float = 0.2, *,
                 generator: torch.Generator, device=None, dtype=None):
        super().__init__(n_layers, d_model, n_head, bucket_size, n_hashes, dropout,
                         generator=generator, device=device, dtype=dtype)
        self.src_word_emb = Embedding(n_symbols + 1, d_model, std=1.0, zero_row0=True,
                                      generator=generator, device=device, dtype=dtype)

    def forward(self, token_ids, mask, rng: Optional[torch.Generator] = None,
                train: bool = False):
        emb = self.src_word_emb(token_ids)
        return self.run(emb, mask, rng), emb


class ReformerDecoder(_ReformerBase):
    """Mel decoder over frame-rate sequences.  Returns (x, mask)."""

    def __init__(self, n_layers: int, d_model: int, n_head: int = 8, bucket_size: int = 64,
                 n_hashes: int = 4, dropout: float = 0.2, *, generator: torch.Generator,
                 device=None, dtype=None):
        super().__init__(n_layers, d_model, n_head, bucket_size, n_hashes, dropout,
                         generator=generator, device=device, dtype=dtype)

    def forward(self, x, mask, rng: Optional[torch.Generator] = None, train: bool = False):
        return self.run(cast(x, self._pos.dtype), mask, rng), mask
