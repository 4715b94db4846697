"""The HiFi-GAN generator with its low-channel tail folded onto 128 channels
(port of ``e2e_tts_tpu/kernels/folded_tail.py``).

The rewrite is exact algebra, not an approximation: a (B, T, C) signal is
reshaped row-major into (B, T / F, F * C) with F = 128 // C, so that each
folded frame packs F consecutive samples, and every convolution of a stage
whose channels divide 128 becomes a stride-1 convolution over folded frames
with a dense folded kernel (k', F * C, F * C):

    y[t] = sum_j x[t + (j - c) d] W[j]
    <=>  yf[t', q C + co] = sum_{o, p, ci} xf[t' + o, p C + ci] Wf[o, p C + ci, q C + co]
         with j = c + (o F + p - q) / d  (zero where not an integer or out of range)

Transposed convolutions fold the same way into their polyphase form (the
output fold F_out = F_in * stride keeps the folded length constant through
the tail, so refolding to the next stage's F is a free reshape), and the
high-channel stages' transposed convolutions take the same polyphase form
at F = 1.  The folded kernels carry zero blocks, extra multiply-adds, in
exchange for 128-wide channels.

The weights are folded once, in NumPy, from a serving generator's fused
kernels (``HifiGanGenerator``); the forward is plain ``F.conv1d`` in the
compute ``dtype`` (float32 unless given), with the head (``conv_post``) in
float32 as the unfolded generator's.  No Pallas kernel stands behind the
JAX module, so none stands behind this one.  The fold functions take and
return kernels in the JAX package's (k, C_in, C_out) layout.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.common import ConvTranspose1d, compute_dtype, weak

LANES = 128
LRELU_SLOPE = 0.1
FINAL_SLOPE = 0.01  # the reference's head uses torch's default slope


# --------------------------------------------------------------------------
# Folded-weight construction (host side, once per generator)
# --------------------------------------------------------------------------

def fold_conv_weight(w: np.ndarray, dilation: int, f_in: int) -> np.ndarray:
    """(k, C, C) SAME dilated conv -> (k', f_in*C, f_in*C) folded conv."""
    k, c_in, c_out = w.shape
    if c_in != c_out:
        raise ValueError("the resblock convolutions are square")
    c = (k - 1) // 2
    h = c * dilation
    hf = -(-h // f_in)
    wf = np.zeros((2 * hf + 1, f_in * c_in, f_in * c_out), np.float32)
    for o in range(-hf, hf + 1):
        for p in range(f_in):
            for q in range(f_in):
                num = o * f_in + p - q
                if num % dilation:
                    continue
                j = c + num // dilation
                if 0 <= j < k:
                    wf[o + hf, p * c_in:(p + 1) * c_in, q * c_out:(q + 1) * c_out] = w[j]
    return wf


def fold_convT_weight(w: np.ndarray, stride: int, f_in: int) -> Tuple[np.ndarray, int]:
    """(k, C_in, C_out) transposed conv (torch pad=(k-s)//2, out=T*s) folded
    from input fold f_in to output fold f_in*s (same folded length).
    Returns (wf, left_pad_frames)."""
    k, c_in, c_out = w.shape
    p_pad = (k - stride) // 2
    f_out = f_in * stride
    taps: List[Tuple[int, int, int]] = []
    lo, hi = 10**9, -(10**9)
    for q in range(f_out):
        for j in range(k):
            num = q + p_pad - j
            if num % stride:
                continue
            u = num // stride  # input sample offset from f_in * t'
            o = u // f_in  # floor division handles negatives
            lo, hi = min(lo, o), max(hi, o)
            taps.append((u, j, q))
    wf = np.zeros((hi - lo + 1, f_in * c_in, f_out * c_out), np.float32)
    for u, j, q in taps:
        o = u // f_in
        p = u - o * f_in
        wf[o - lo, p * c_in:(p + 1) * c_in, q * c_out:(q + 1) * c_out] += w[j]
    return wf, -lo


def fold_head_weight(w: np.ndarray, f_in: int) -> Tuple[np.ndarray, int]:
    """(k, C, C_head) SAME conv with C_head != C (conv_post) folded on the
    input side only: (k', f_in*C, f_in*C_head).  Returns (wf, left_pad)."""
    k, c_in, c_head = w.shape
    c = (k - 1) // 2
    hf = -(-c // f_in)
    wf = np.zeros((2 * hf + 1, f_in * c_in, f_in * c_head), np.float32)
    for o in range(-hf, hf + 1):
        for p in range(f_in):
            for q in range(f_in):
                j = c + (o * f_in + p - q)
                if 0 <= j < k:
                    wf[o + hf, p * c_in:(p + 1) * c_in, q * c_head:(q + 1) * c_head] = w[j]
    return wf, hf


def _fuse_wn(p) -> Tuple[np.ndarray, np.ndarray]:
    """(v, g, bias) weight-norm parameters, v as (k, in, out) -> (w, bias)
    fused, as numpy float32."""
    v = np.asarray(p["v"], np.float32)
    g = np.asarray(p["g"], np.float32)
    norm = np.linalg.norm(v.reshape(-1, v.shape[-1]), axis=0)
    w = v * (g / np.maximum(norm, 1e-12))[None, None, :]
    return w, np.asarray(p["bias"], np.float32)


# --------------------------------------------------------------------------
# Folded generator
# --------------------------------------------------------------------------

def _kio(conv) -> Tuple[np.ndarray, np.ndarray]:
    """A serving conv's fused kernel as (k, in, out) and its bias, numpy
    float32: ``Conv1d`` holds (out, in, k), ``ConvTranspose1d`` (in, out, k)."""
    w = conv.weight.detach().float().cpu().numpy()
    w = w.transpose(2, 0, 1) if isinstance(conv, ConvTranspose1d) else w.transpose(2, 1, 0)
    return np.ascontiguousarray(w), conv.bias.detach().float().cpu().numpy()


def _lrelu(x, slope: float = LRELU_SLOPE):
    return F.leaky_relu(x, weak(slope, x.dtype))


class FoldedHifiGan(nn.Module):
    """A ``HifiGanGenerator`` (serving form, ResBlock1) with every stage
    whose channels divide 128 folded onto 128 channels: mel (B, T, n_mels)
    -> waveform (B, T * prod(rates)) in [-1, 1].  The folded weights are
    buffers on the generator's device, made once here; ``dtype`` is the
    compute dtype (float32 when None), the head float32."""

    def __init__(self, generator, dtype=None):
        super().__init__()
        hp = generator.hparams
        if hp["resblock_type"] != 1:
            raise ValueError("the folded tail supports ResBlock1 configs")
        self.dtype = compute_dtype(dtype)
        rds = tuple(tuple(d) for d in hp["resblock_dilation_sizes"])
        device = generator.conv_post.weight.device
        tr = generator.trunk
        count = iter(range(10**6))

        def put(w, b):
            """(k, in, out) kernel and bias -> buffers, the kernel as torch's
            (out, in, k); returns their name."""
            name = f"w{next(count)}"
            self.register_buffer(name + "_w", torch.from_numpy(
                np.ascontiguousarray(w.transpose(2, 1, 0))).to(device))
            self.register_buffer(name + "_b", torch.from_numpy(
                np.ascontiguousarray(b)).to(device))
            return name

        self.conv_pre = put(*_kio(tr.conv_pre))
        ch0 = hp["upsample_initial_channel"]
        f_cur = 1
        self.plan: List[dict] = []
        for i, u in enumerate(hp["upsample_rates"]):
            ch = ch0 // (2 ** (i + 1))
            w_up, b_up = _kio(tr.ups[i])
            fold = LANES % ch == 0 and ch < LANES
            if not fold and f_cur != 1:
                raise ValueError("a high-channel stage after a folded stage")
            # the transposed conv in polyphase form at every stage: the
            # sub-positions land in channel blocks and a row-major reshape
            # interleaves them in time
            wf, lpad = fold_convT_weight(w_up, u, f_cur)
            f_new = LANES // ch if fold else 1
            st = {"f": f_new, "ch": ch, "up_lpad": lpad,
                  "up": put(wf, np.tile(b_up, f_cur * u)), "res": []}
            for j, rd in enumerate(rds):
                block, convs = tr.resblocks[i][j], []
                for ci, d in enumerate(rd):
                    w1, b1 = _kio(block.convs1[ci])
                    w2, b2 = _kio(block.convs2[ci])
                    if fold:  # the dilation moves into the folded kernel
                        w1, b1 = fold_conv_weight(w1, d, f_new), np.tile(b1, f_new)
                        w2, b2 = fold_conv_weight(w2, 1, f_new), np.tile(b2, f_new)
                        d = 1
                    convs.append((d, put(w1, b1), put(w2, b2)))
                st["res"].append(convs)
            f_cur = f_new
            self.plan.append(st)

        w_post, b_post = _kio(generator.conv_post)
        self.final_fold = f_cur
        if f_cur > 1:
            wf, self.post_pad = fold_head_weight(w_post, f_cur)
            self.conv_post = put(wf, np.tile(b_post, f_cur))
        else:
            self.post_pad = None
            self.conv_post = put(w_post, b_post)

    def _wb(self, name: str, dtype):
        w, b = getattr(self, name + "_w"), getattr(self, name + "_b")
        return w.to(dtype), b.to(dtype)

    def _conv(self, x, name: str, dil: int = 1, pad=None):
        """A stride-1 conv over (B, T, C) with XLA's SAME split, or ``pad``."""
        w, b = self._wb(name, x.dtype)
        k = w.shape[-1]
        if pad is None:
            total = (k - 1) * dil
            pad = (total // 2, total - total // 2)
        y = F.conv1d(F.pad(x.transpose(1, 2), pad), w, dilation=dil)
        return y.transpose(1, 2) + b

    def _res_stack(self, st, x):
        """The stage's resblocks on x, averaged."""
        acc = None
        for convs in st["res"]:
            h = x
            for d, n1, n2 in convs:
                t = self._conv(_lrelu(h), n1, dil=d)
                h = h + self._conv(_lrelu(t), n2)
            acc = h if acc is None else acc + h
        return acc / len(st["res"])

    @torch.no_grad()
    def forward(self, mel):
        x = mel if self.dtype is None else mel.to(self.dtype)
        x = self._conv(x, self.conv_pre)
        B = x.shape[0]
        for st in self.plan:
            x = _lrelu(x)
            kf = getattr(self, st["up"] + "_w").shape[-1]
            x = self._conv(x, st["up"], pad=(st["up_lpad"], kf - 1 - st["up_lpad"]))
            x = self._res_stack(st, x.reshape(B, -1, st["f"] * st["ch"]))
        x = _lrelu(x, FINAL_SLOPE).float()  # the head in float32, as the generator's
        if self.final_fold > 1:
            y = self._conv(x, self.conv_post, pad=(self.post_pad, self.post_pad))
            return torch.tanh(y).reshape(B, -1)
        return torch.tanh(self._conv(x, self.conv_post))[..., 0]
