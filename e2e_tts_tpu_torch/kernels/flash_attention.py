"""Length-masked flash attention, forward only: the Hopper kernel and its plain
PyTorch version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas kernel of
``e2e_tts_tpu/kernels/flash_attention.py`` (``_flash_fwd_kernel``, launched by
``_fwd_impl``).  It computes ``softmax(q k^T / sqrt(D)) v`` over (BH, T, D)
with the keys at or past ``kv_lens[bh]`` scoring -1e30.  On the H100 it is bound
by float32 operations (about 2,000 flops per byte at the decoder's shapes), and
the float32 path has no tensor cores; the kernel keeps the query tile in shared
memory, loops over key/value tiles inside the block with an online softmax, and
register-tiles both products (see the source's header).

``flash_attention`` is the one entry point.  A CPU tensor goes to
``attention_plain``; a CUDA tensor launches the kernel or raises.  Float32
only: any other dtype, a non-contiguous input or a CPU/CUDA mix raises.
Padded query rows (t >= kv_len) are meaningless, and a row with kv_len = 0
comes out 0.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

NEG_INF = -1e30
MAX_HEAD_DIM = 256

_bound = None


def _kernel():
    global _bound
    if _bound is None:
        from .build import library

        fn = library("flash_attention").flash_attention_fwd_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def attention_plain(q, k, v, kv_lens):
    """The kernel's function in plain PyTorch, float32: key-only mask at -1e30,
    and a row with kv_len = 0 set to 0 as the kernel leaves it."""
    BH, T, D = q.shape
    s = torch.einsum("bqd,bkd->bqk", q * (1.0 / np.sqrt(D)), k)
    lens = kv_lens.to(torch.int64)
    valid = torch.arange(T, device=q.device)[None, :] < lens[:, None]  # (BH, T)
    s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p, v)
    return out * (lens > 0).to(out.dtype)[:, None, None]


def flash_attention(q, k, v, kv_lens):
    """(BH, T, D) float32 q, k, v and (BH,) int kv_lens -> (BH, T, D)."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (BH, T, D) shape: {q.shape}, {k.shape}, {v.shape}")
    BH, T, D = q.shape
    if kv_lens.shape != (BH,):
        raise ValueError(f"kv_lens must be ({BH},), got {tuple(kv_lens.shape)}")
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError(f"flash_attention takes float32 only, got {q.dtype}/{k.dtype}/{v.dtype}")
    devices = {t.device for t in (q, k, v, kv_lens)}
    if len(devices) != 1:
        raise ValueError(f"q, k, v and kv_lens must lie on one device, got {devices}")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_lens)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention needs contiguous q, k, v")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} outside 1..{MAX_HEAD_DIM}")
    lens = kv_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                        out.data_ptr(), BH, T, D, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
