"""Forward-sum CTC over the fixed 1..K lattice: the Hopper kernels (forward
and backward) and their plain PyTorch versions (``ops/ctc.py`` joins them in
one ``torch.autograd.Function``).

The kernels (``csrc/ctc.cu``) replace the JAX package's ``_forward_single``
(``e2e_tts_tpu/ops/ctc.py:30-79``), a ``lax.scan`` of ``_logsumexp3`` over
mel frames, and the reverse scan its autodiff makes.  On log_probs (B, T,
K + 1) float32 (class 0 the blank), text lengths k and mel lengths q, the
forward runs the alpha recursion over 2K + 1 states with JAX's masking (the
-1e30 sentinel, frame 0 always read, frames past q held, acceptance at states
2k and 2k - 1) and returns the per-item loss -total / k, or 0 where k = 0,
total <= -5e29 or the loss is not finite.  It keeps alpha (B, T, 2K + 1) for
the backward, which runs the beta recursion and returns d loss / d log_probs:
the occupancies exp(alpha + beta - total) summed per class, times -g / k.
Their cost is the serial depth of q frames: one block per utterance, the
states across threads (see the source's header).

``ctc_fwd`` and ``ctc_bwd`` take a CPU tensor to ``ctc_fwd_plain`` /
``ctc_bwd_plain`` (the same alpha/beta algorithm in torch ops, any float
dtype, so that ``gradcheck`` can run it in float64); on a CUDA tensor they
launch the kernels or raise.  Lengths are clamped to
[0, K] and [0, T] by both versions.  Unlike JAX's autodiff, a row with k = 0
gets a zero gradient, not NaN (JAX divides the zero cotangent by k = 0).
"""

from __future__ import annotations

import ctypes
import threading

import torch

NEG_INF = -1e30
MAX_SHARED_BYTES = 232448  # what one block may opt into on an H100

_bound = None
_LOCK = threading.Lock()


def _kernel():
    """(shared_bytes, fwd, bwd): the library's C entry points."""
    global _bound
    with _LOCK:
        if _bound is None:
            from .build import library

            lib = library("ctc")
            smem = lib.ctc_shared_bytes
            smem.argtypes = [ctypes.c_int]
            smem.restype = ctypes.c_longlong
            fwd = lib.ctc_fwd_f32
            fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fwd.restype = ctypes.c_int
            bwd = lib.ctc_bwd_f32
            bwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            bwd.restype = ctypes.c_int
            _bound = smem, fwd, bwd
        return _bound


def _lse3(a, b, c):
    """JAX's ``_logsumexp3``: the max floored at -1e30."""
    m = torch.maximum(torch.maximum(a, b), c).clamp(min=NEG_INF)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m) + torch.exp(c - m))


def _lattice(C: int, device):
    """(class of each state, odd-state mask) for S = 2C - 1 states."""
    s = torch.arange(2 * C - 1, device=device)
    odd = s % 2 == 1
    return torch.where(odd, (s + 1) // 2, torch.zeros_like(s)), odd


def _lengths(log_probs, key_lens, query_lens):
    """(k, Tf): labels clamped to [0, K]; the last frame the recursion reaches."""
    _, T, C = log_probs.shape
    k = key_lens.to(torch.int64).clamp(0, C - 1)
    last = query_lens.to(torch.int64).clamp(0, T).clamp(min=1) - 1
    return k, last


def _kept(total, k):
    """The rows whose loss is kept (JAX: isfinite(loss) & total > NEG_INF / 2)."""
    loss = -total / k.to(total.dtype)
    return (k >= 1) & torch.isfinite(loss) & (total > NEG_INF / 2)


def ctc_fwd_plain(log_probs, key_lens, query_lens):
    """(loss (B,), alpha (B, T, S), total (B,)) in torch ops; alpha holds past Tf."""
    B, T, C = log_probs.shape
    cls, odd = _lattice(C, log_probs.device)
    k, last = _lengths(log_probs, key_lens, query_lens)
    emit = log_probs[:, :, cls]  # (B, T, S)
    neg = torch.full((B, 2), NEG_INF, dtype=log_probs.dtype, device=log_probs.device)
    a = torch.cat([log_probs[:, 0, :2], neg[:, :1].expand(B, 2 * C - 3)], dim=1)
    alphas = [a]
    for t in range(1, T):
        shift1 = torch.cat([neg[:, :1], a[:, :-1]], dim=1)
        skip = torch.where(odd, torch.cat([neg, a[:, :-2]], dim=1), neg[:, :1])
        step = _lse3(a, shift1, skip) + emit[:, t]
        a = torch.where((t <= last)[:, None], step, a)
        alphas.append(a)
    alpha = torch.stack(alphas, dim=1)
    rows = torch.arange(B, device=log_probs.device)
    fb = a[rows, 2 * k]
    fl = a[rows, (2 * k - 1).clamp(min=0)]
    m = torch.maximum(fb, fl)
    total = m + torch.log(torch.exp(fb - m) + torch.exp(fl - m))
    total = torch.where(k >= 1, total, torch.full_like(total, NEG_INF))
    loss = torch.where(_kept(total, k), -total / k.clamp(min=1).to(total.dtype),
                       torch.zeros_like(total))
    return loss, alpha, total


def ctc_bwd_plain(grad_loss, log_probs, key_lens, query_lens, alpha, total):
    """d loss / d log_probs (B, T, C) in torch ops: the beta recursion, then the
    occupancies exp(alpha + beta - total) per class."""
    B, T, C = log_probs.shape
    S = 2 * C - 1
    cls, odd = _lattice(C, log_probs.device)
    k, last = _lengths(log_probs, key_lens, query_lens)
    emit = log_probs[:, :, cls]
    s = torch.arange(S, device=log_probs.device)
    neg = torch.full((B, 2), NEG_INF, dtype=log_probs.dtype, device=log_probs.device)
    init = torch.where((s[None] == 2 * k[:, None]) | (s[None] == 2 * k[:, None] - 1),
                       torch.zeros_like(emit[:, 0]), neg[:, :1])
    bt = init
    betas = [None] * T
    for t in range(T - 1, -1, -1):
        if t < T - 1:
            x = bt + emit[:, t + 1]  # successors at frame t + 1
            y = torch.cat([x[:, 1:], neg[:, :1]], dim=1)
            z = torch.where(odd, torch.cat([x[:, 2:], neg], dim=1), neg[:, :1])
            bt = torch.where((t < last)[:, None], _lse3(x, y, z), init)
        betas[t] = bt
    beta = torch.stack(betas, dim=1)
    keep = _kept(total, k)
    frames = torch.arange(T, device=log_probs.device)
    on = keep[:, None, None] & (frames[None, :, None] <= last[:, None, None])
    occ = torch.where(on, torch.exp(alpha + beta - total[:, None, None]), torch.zeros_like(alpha))
    grad = torch.cat([occ[:, :, 0::2].sum(-1, keepdim=True), occ[:, :, 1::2]], dim=-1)
    scale = torch.where(keep, -grad_loss / k.clamp(min=1).to(grad.dtype), torch.zeros_like(total))
    return grad * scale[:, None, None]


def _check(log_probs, key_lens, query_lens):
    if log_probs.dim() != 3 or log_probs.shape[-1] < 2:
        raise ValueError(f"log_probs must be (B, T, K + 1) with K >= 1, got {tuple(log_probs.shape)}")
    B = log_probs.shape[0]
    if key_lens.shape != (B,) or query_lens.shape != (B,):
        raise ValueError(f"key_lens and query_lens must be ({B},)")
    devices = {t.device for t in (log_probs, key_lens, query_lens)}
    if len(devices) != 1:
        raise ValueError(f"log_probs and the lengths must lie on one device, got {devices}")
    dev = log_probs.device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"ctc runs on cpu or cuda, not {dev}")
    if log_probs.dtype != torch.float32:
        raise TypeError(f"the ctc kernels take float32 only, got {log_probs.dtype}")
    if not log_probs.is_contiguous():
        raise ValueError("the ctc kernels need a contiguous log_probs")
    return True


def _count(fn) -> None:
    with _LOCK:
        fn.launches += 1


def ctc_fwd(log_probs, key_lens, query_lens):
    """(B, T, C) log-probabilities, (B,) lengths -> (loss (B,), alpha, total)."""
    if not _check(log_probs, key_lens, query_lens):
        return ctc_fwd_plain(log_probs, key_lens, query_lens)
    B, T, C = log_probs.shape
    shared_bytes, fwd, _ = _kernel()
    if shared_bytes(C) > MAX_SHARED_BYTES:
        raise ValueError(f"ctc: {C} classes need more than {MAX_SHARED_BYTES} bytes of shared memory")
    kl = key_lens.to(torch.int32).contiguous()
    ql = query_lens.to(torch.int32).contiguous()
    alpha = torch.empty(B, T, 2 * C - 1, dtype=torch.float32, device=log_probs.device)
    total = torch.empty(B, dtype=torch.float32, device=log_probs.device)
    loss = torch.empty_like(total)
    stream = torch.cuda.current_stream(log_probs.device).cuda_stream
    with torch.cuda.device(log_probs.device):
        err = fwd(log_probs.data_ptr(), kl.data_ptr(), ql.data_ptr(), alpha.data_ptr(),
                  total.data_ptr(), loss.data_ptr(), B, T, C, stream)
    if err != 0:
        raise RuntimeError(f"ctc forward kernel launch failed: cudaError {err}")
    _count(ctc_fwd)
    return loss, alpha, total


def ctc_bwd(grad_loss, log_probs, key_lens, query_lens, alpha, total):
    """d loss / d log_probs (B, T, C) for the cotangent ``grad_loss`` (B,)."""
    if not _check(log_probs, key_lens, query_lens):
        return ctc_bwd_plain(grad_loss, log_probs, key_lens, query_lens, alpha, total)
    B, T, C = log_probs.shape
    if alpha.shape != (B, T, 2 * C - 1) or total.shape != (B,) or grad_loss.shape != (B,):
        raise ValueError("alpha, total and grad_loss do not match log_probs")
    _, _, bwd = _kernel()
    kl = key_lens.to(torch.int32).contiguous()
    ql = query_lens.to(torch.int32).contiguous()
    g = grad_loss.to(torch.float32).contiguous()
    beta = torch.empty_like(alpha)
    grad = torch.empty_like(log_probs)
    stream = torch.cuda.current_stream(log_probs.device).cuda_stream
    with torch.cuda.device(log_probs.device):
        err = bwd(g.data_ptr(), log_probs.data_ptr(), kl.data_ptr(), ql.data_ptr(),
                  alpha.contiguous().data_ptr(), total.contiguous().data_ptr(), beta.data_ptr(),
                  grad.data_ptr(), B, T, C, stream)
    if err != 0:
        raise RuntimeError(f"ctc backward kernel launch failed: cudaError {err}")
    _count(ctc_bwd)
    return grad


ctc_fwd.launches = 0
ctc_bwd.launches = 0

