"""Length-masked flash attention, forward only: the Hopper kernel and its plain
PyTorch version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas kernel of
``e2e_tts_tpu/kernels/flash_attention.py`` (``_flash_fwd_kernel``, launched by
``_fwd_impl``).  It computes ``softmax(q k^T / sqrt(D)) v`` over (BH, T, D)
with the keys at or past ``kv_lens[bh]`` scoring -1e30.  On the H100 it is bound
by operations.  Both products run on the tensor cores in 3xTF32 (each operand
split into two TF32 parts, three ``mma.sync`` products per fragment), which
keeps the float32 bar of 2e-5 that a single TF32 product misses.  Each warp
owns 16 query rows with an online softmax over 32-row key/value tiles that a
two-stage ``cp.async`` ring brings in; query rows and key tiles past
``kv_len`` cost no key loop.  A block has up to 8 warps: as many 16-row query
groups as still spread over the SMs, the rest splitting each group's key tiles.
Where the blocks are still few, each head's keys are cut into parts, one block
each, merged by a second small kernel; the wrapper allocates the workspace the
parts need (see the source's header).

``flash_attention`` is the one entry point.  A CPU tensor goes to
``attention_plain``; a CUDA tensor launches the kernel or raises.  Float32
only: any other dtype, a non-contiguous input or a CPU/CUDA mix raises.
Padded query rows (t >= kv_len) are meaningless but finite (zeros at least in
every 16-row group past kv_len), and a head with kv_len = 0 comes out 0.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

NEG_INF = -1e30
MAX_HEAD_DIM = 256

_bound = None
# the binding and the launch count are shared by every thread that serves
_LOCK = threading.Lock()


def _kernel():
    """(workspace_floats, fwd): the library's two C entry points."""
    global _bound
    with _LOCK:
        if _bound is None:
            from .build import library

            lib = library("flash_attention")
            ws = lib.flash_attention_workspace_floats
            ws.argtypes = [ctypes.c_int] * 3
            ws.restype = ctypes.c_longlong
            fwd = lib.flash_attention_fwd_f32
            fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fwd.restype = ctypes.c_int
            _bound = ws, fwd
        return _bound


def _count_launch() -> None:
    """One more launch in ``flash_attention.launches`` (a locked add: ``+=`` on
    an attribute is not atomic across threads)."""
    with _LOCK:
        flash_attention.launches += 1


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
    workspace_floats, fwd = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        n = workspace_floats(BH, T, D)  # where the kernel splits each head's keys
        if n < 0:
            raise RuntimeError("flash_attention: the CUDA device could not be queried")
        ws = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
        err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
                  ws.data_ptr() if n else None, BH, T, D, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    _count_launch()
    return out


flash_attention.launches = 0
