"""The conformer block family (Gulati et al., arXiv:2005.08100) in plain
PyTorch, float32, as a configuration's ``building_block.conformer`` states
it: half a feed-forward network, relative-position self-attention, the
convolution module (LayerNorm, pointwise, GLU, depthwise, BatchNorm, swish,
pointwise), the other half feed-forward network, then a LayerNorm, masked.

Where it departs from the paper, it follows the conformer of the
reference repo (sooftware/conformer's):

- the score is (q + u) k^T + skew((q + v) p^T), over sqrt(d_model), not
  over sqrt(d_head);
- p is ``pos_proj`` (no bias) of the first T rows of the sinusoid table
  that is also added to the stack's input;
- ``skew`` over T positions is transformer-XL's relative shift as its pad
  and reshape wrap it: row i, column j reads (q_i + v) . p_{T-1-i+j} for
  j <= i, 0 for j = i + 1, and (q_{i+1} + v) . p_{j-i-2} for j >= i + 2;
- with ``mask_attention`` the padded keys score -1e9 and the padded rows
  are zeroed before block 0 (without it, neither);
- in training the BatchNorm normalises by the batch's mean and biased
  variance over every frame, the padded ones too, and leaves its running
  statistics alone (no training loss reads them); otherwise it takes the
  running ones;
- one dropout rate, the side's, drawn in this order: the first
  feed-forward's hidden layer and output, the attention weights, the
  attention's output, the convolution module's output, the second
  feed-forward's hidden layer and output.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..fs2 import NEG_INF, layer_norm, linear, sinusoid_table


def skew(s: torch.Tensor) -> torch.Tensor:
    """(..., T, T) position scores, column k against p_k, to the wrapped
    relative layout of the module docstring, by index."""
    T = s.shape[-1]
    i = torch.arange(T, device=s.device)[:, None]
    j = torch.arange(T, device=s.device)[None, :]
    below = j <= i
    row = torch.where(below, i, torch.clamp(i + 1, max=T - 1))
    col = torch.where(below, T - 1 - i + j, torch.clamp(j - i - 2, min=0))
    out = s[..., row, col]
    return torch.where(j == i + 1, torch.zeros_like(out), out)


def feed_forward(P, name, x, rate, drop):
    h = linear(P, f"{name}.Dense_0", layer_norm(P, f"{name}.layer_norm", x, 1e-5))
    h = drop(h * torch.sigmoid(h), rate)
    return drop(linear(P, f"{name}.Dense_1", h), rate)


def attention(P, name, x, pos, mask, heads, rate, drop, mask_keys):
    B, T, D = x.shape
    dh = D // heads
    q, k, v = (linear(P, f"{name}.{w}_proj", x).view(B, T, heads, dh)
               for w in ("query", "key", "value"))
    p = linear(P, f"{name}.pos_proj", pos, bias=False).view(T, heads, dh)
    content = torch.einsum("bqhd,bkhd->bhqk", q + P[f"{name}.u_bias"], k)
    position = skew(torch.einsum("bqhd,khd->bhqk", q + P[f"{name}.v_bias"], p))
    s = (content + position) / math.sqrt(D)
    if mask_keys:
        s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    w = drop(torch.softmax(s, -1), rate)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, T, D)
    return linear(P, f"{name}.out_proj", o)


def conv_module(P, name, x, rate, drop, train):
    a, gate = linear(P, f"{name}.pw1", layer_norm(P, f"{name}.layer_norm", x, 1e-5)).chunk(2, -1)
    w = P[f"{name}.depthwise.weight"]  # (C, 1, k)
    t = w.shape[-1] - 1
    h = F.conv1d(F.pad((a * torch.sigmoid(gate)).transpose(1, 2), (t // 2, t - t // 2)), w,
                 groups=w.shape[0]).transpose(1, 2)
    bn = f"{name}.BatchNorm_0"
    if train:
        mean = h.mean(dim=(0, 1))
        var = torch.clamp((h * h).mean(dim=(0, 1)) - mean * mean, min=0.0)
    else:
        mean, var = P[f"{bn}.running_mean"], P[f"{bn}.running_var"]
    h = (h - mean) * (torch.rsqrt(var + 1e-5) * P[f"{bn}.weight"]) + P[f"{bn}.bias"]
    return drop(linear(P, f"{name}.pw2", h * torch.sigmoid(h)), rate)


def block(P, name, x, pos, mask, blk, heads, rate, drop, train):
    half = 0.5 if blk["half_step_residual"] else 1.0
    x = x + half * feed_forward(P, f"{name}.ff1", x, rate, drop)
    h = layer_norm(P, f"{name}.mhsa_norm", x, 1e-5)
    x = x + drop(attention(P, f"{name}.mhsa", h, pos, mask, heads, rate, drop,
                           blk["mask_attention"]), rate)
    x = x + conv_module(P, f"{name}.conv", x, rate, drop, train)
    x = x + half * feed_forward(P, f"{name}.ff2", x, rate, drop)
    return layer_norm(P, f"{name}.final_norm", x, 1e-5) * mask[..., None]


def stack(P, prefix, x, mask, blk, n_layers, side, drop, train):
    pos = torch.from_numpy(sinusoid_table(x.shape[1], x.shape[2])).to(x.device)
    x = x + pos[None]
    if blk["mask_attention"]:
        x = x * mask[..., None]
    for i in range(n_layers):
        x = block(P, f"{prefix}.layers.{i}", x, pos, mask, blk, blk[f"{side}_head"],
                  blk[f"{side}_dropout"], drop, train)
    return x
