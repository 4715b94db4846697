"""Width-1 monotonic alignment search: the Hopper kernel and its plain PyTorch
version.

The kernel (``csrc/mas.cu``) replaces the JAX package's ``_mas_single``
(``e2e_tts_tpu/ops/mas.py:21-77``), a ``lax.scan`` over mel frames.  It takes
log-attention (B, T, L) float32, text and mel lengths (B,), and returns the
0/1 alignment (B, T, L): a max-plus recurrence over frames (``>=`` prefers the
step from the left; -1e30 marks columns past text_len; frames past mel_len
hold), a backtrack from (mel_len - 1, text_len - 1), frame 0 anchored to
phoneme 0 and columns past text_len zeroed.  Its cost is the serial depth of
mel_len frames: one block per utterance, the text axis across threads, the
scores in shared memory (see the source's header).  Each step is one float
add and an exact max, so kernel and plain version agree bit for bit.

``mas`` is the one entry point.  A CPU tensor goes to ``mas_plain``; a CUDA
tensor launches the kernel or raises.  Lengths are clamped to [0, L] and
[0, T] by both.
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
    """(shared_bytes, mas_f32): the library's two C entry points."""
    global _bound
    with _LOCK:
        if _bound is None:
            from .build import library

            lib = library("mas")
            smem = lib.mas_shared_bytes
            smem.argtypes = [ctypes.c_int] * 2
            smem.restype = ctypes.c_longlong
            fn = lib.mas_f32
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _bound = smem, fn
        return _bound


def mas_plain(log_attn: torch.Tensor, text_lens: torch.Tensor, mel_lens: torch.Tensor):
    """The kernel's function in PyTorch: a loop over frames, batched."""
    B, T, L = log_attn.shape
    dev = log_attn.device
    j = torch.arange(L, device=dev)
    tl = text_lens.to(torch.int64).clamp(0, L)
    ml = mel_lens.to(torch.int64).clamp(0, T)
    neg = torch.full((B, 1), NEG_INF, dtype=log_attn.dtype, device=dev)
    la = torch.where(j[None, None, :] < tl[:, None, None], log_attn, neg[:, :, None])
    prev = torch.where(j[None, :] == 0, la[:, 0], neg)
    left = torch.zeros(B, T, L, dtype=torch.bool, device=dev)
    for i in range(1, T):
        shifted = torch.cat([neg, prev[:, :-1]], dim=1)
        left[:, i] = shifted >= prev
        step = la[:, i] + torch.maximum(shifted, prev)
        prev = torch.where((i < ml)[:, None], step, prev)

    out = torch.zeros(B, T, L, dtype=torch.float32, device=dev)
    rows = torch.arange(B, device=dev)
    cur = tl - 1
    for i in range(T - 1, -1, -1):
        active = i < ml
        # row i is still all zero: a miss writes a 0 over a 0 (no host sync)
        out[rows, i, cur.clamp(min=0)] = (active & (cur >= 0)).to(out.dtype)
        if i > 0:
            idx = torch.where(cur < 0, cur + L, cur).clamp(0, L - 1)  # JAX's negative index
            cur = cur - (left[rows, i, idx] & active).to(torch.int64)
    out[:, 0, 0] = torch.where(ml > 0, 1.0, out[:, 0, 0])
    return out * (j[None, None, :] < tl[:, None, None])


def mas(log_attn: torch.Tensor, text_lens: torch.Tensor, mel_lens: torch.Tensor):
    """(B, T, L) float32 log-attention, (B,) int lengths -> (B, T, L) 0/1 float32."""
    if log_attn.dim() != 3:
        raise ValueError(f"log_attn must be (B, T, L), got {tuple(log_attn.shape)}")
    B, T, L = log_attn.shape
    if text_lens.shape != (B,) or mel_lens.shape != (B,):
        raise ValueError(f"text_lens and mel_lens must be ({B},)")
    if log_attn.dtype != torch.float32:
        raise TypeError(f"mas takes float32 only, got {log_attn.dtype}")
    devices = {t.device for t in (log_attn, text_lens, mel_lens)}
    if len(devices) != 1:
        raise ValueError(f"log_attn and the lengths must lie on one device, got {devices}")
    if log_attn.device.type == "cpu":
        return mas_plain(log_attn, text_lens, mel_lens)
    if log_attn.device.type != "cuda":
        raise ValueError(f"mas runs on cpu or cuda, not {log_attn.device}")
    if not log_attn.is_contiguous():
        raise ValueError("mas needs a contiguous log_attn")
    if B == 0 or T == 0 or L == 0:
        return torch.zeros_like(log_attn)
    shared_bytes, fn = _kernel()
    need = shared_bytes(T, L)
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"mas: (T, L) = ({T}, {L}) needs {need} bytes of shared memory, "
                         f"over {MAX_SHARED_BYTES}")
    tl = text_lens.to(torch.int32).contiguous()
    ml = mel_lens.to(torch.int32).contiguous()
    out = torch.empty_like(log_attn)
    stream = torch.cuda.current_stream(log_attn.device).cuda_stream
    with torch.cuda.device(log_attn.device):
        err = fn(log_attn.data_ptr(), tl.data_ptr(), ml.data_ptr(), out.data_ptr(), B, T, L, stream)
    if err != 0:
        raise RuntimeError(f"mas kernel launch failed: cudaError {err}")
    with _LOCK:
        mas.launches += 1
    return out


mas.launches = 0
