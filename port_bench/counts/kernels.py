"""The work a kernel's inputs need, from shapes and lengths: FLOPs, and
bytes with each input byte read once and each output byte written once.
The same work whatever implements it, so a roofline share compares
implementations.  float32 everywhere (4 bytes).

- flash attention, per row of a call with ``kv`` valid keys: only the
  kv valid query rows count; q k^T and the weighted sum of v are
  2 * kv * kv * d FLOPs each (d = heads * head width); q, k, v read and o
  written: 4 * kv * d values.
- MAS on (T, L) log attention with (mel_len, text_len) valid: the valid
  cells read, the whole (T, L) alignment written; an add and a max a valid
  cell.
- forward-sum CTC over a (T, K + 1) log-probability lattice with S = 2K + 1
  states: forward reads the valid log-probabilities and writes alpha
  (T, S_max) and the loss; backward reads them, alpha and the loss's
  gradient and writes the (T, K_max + 1) gradient; ~8 FLOPs a valid state
  and frame each way (a three-way log-sum-exp).
"""

from __future__ import annotations

from typing import Iterable, Tuple

F32 = 4


def flash(kv_lens: Iterable[int], d: int) -> Tuple[float, float]:
    flops = bytes_ = 0.0
    for kv in kv_lens:
        flops += 4.0 * kv * kv * d
        bytes_ += 4.0 * kv * d * F32
    return flops, bytes_


def mas(txt_lens, mel_lens, T: int, L: int) -> Tuple[float, float]:
    cells = sum(float(t) * float(m) for t, m in zip(txt_lens, mel_lens))
    return 2.0 * cells, F32 * (cells + len(txt_lens) * T * L)


def ctc(txt_lens, mel_lens, T: int, L: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of the forward and the backward kernels together."""
    S_max = 2 * L + 1
    flops = bytes_ = 0.0
    for k, m in zip(txt_lens, mel_lens):
        states = float(m) * (2 * float(k) + 1)
        flops += 2 * 8.0 * states
        lp = float(m) * (float(k) + 1)
        bytes_ += F32 * (lp + 2 * states + lp + 2)  # fwd: lp, alpha; bwd: lp, alpha, grad
    B = len(txt_lens)
    bytes_ += F32 * B * (T * S_max + T * (L + 1) + 2)  # alpha written, the gradient written
    return flops, bytes_
