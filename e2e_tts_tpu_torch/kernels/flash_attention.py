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

The Pallas kernel takes blocks of any float dtype, upcasts them and rounds
once, at the output.  So the source has a 16-bit form too (``flash_fwd_16``,
bfloat16 or float16 in and out): both products on the tensor cores in the
input's type (m16n8k16, float32 accumulators), one product for q k^T (a
product of two 16-bit values is exact in float32) and two for p v, with p
split into a 16-bit hi and lo part so that it keeps float32 accuracy; the
scores, the softmax and the accumulator stay float32.  A 16-bit CUDA tensor
launches that form, never the float32 one on upcast inputs; its launches
count in ``flash_attention.launches_16``, the float32 form's in
``flash_attention.launches``.

``flash_attention`` is the one entry point.  A CPU tensor goes to
``attention_plain`` (a 16-bit input upcast, the result rounded to its
dtype); a CUDA tensor launches the kernel or raises.  float32, bfloat16 or
float16, the three alike: any other dtype, mixed dtypes, a non-contiguous
input or a CPU/CUDA mix raises.  Padded query rows (t >= kv_len) are
meaningless but finite (zeros at least in every 16-row group past kv_len),
and a head with kv_len = 0 comes out 0.
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


HALF = (torch.bfloat16, torch.float16)


def _kernel():
    """{form: (workspace_floats, fwd)}: the library's C entry points, the
    16-bit ones with their ``bf16`` flag bound."""
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
            ws16 = lib.flash_attention_workspace_floats_16
            ws16.argtypes = [ctypes.c_int] * 4
            ws16.restype = ctypes.c_longlong
            fwd16 = lib.flash_attention_fwd_16
            fwd16.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fwd16.restype = ctypes.c_int
            _bound = {torch.float32: (ws, fwd)}
            for dtype, flag in ((torch.bfloat16, 1), (torch.float16, 0)):
                _bound[dtype] = (lambda BH, T, D, f=flag: ws16(BH, T, D, f),
                                 lambda *a, f=flag: fwd16(*a[:-1], f, a[-1]))
        return _bound


def _count_launch(counter: str = "launches") -> None:
    """One more launch in ``flash_attention.<counter>`` (a locked add: ``+=``
    on an attribute is not atomic across threads)."""
    with _LOCK:
        setattr(flash_attention, counter, getattr(flash_attention, counter) + 1)


def attention_plain(q, k, v, kv_lens):
    """The kernel's function in plain PyTorch, float32: key-only mask at -1e30,
    and a row with kv_len = 0 set to 0 as the kernel leaves it.  16-bit inputs
    are upcast and the result rounded to their dtype, once, as the kernel
    rounds."""
    if q.dtype in HALF:
        return attention_plain(q.float(), k.float(), v.float(), kv_lens).to(q.dtype)
    BH, T, D = q.shape
    s = torch.einsum("bqd,bkd->bqk", q * (1.0 / np.sqrt(D)), k)
    lens = kv_lens.to(torch.int64)
    valid = torch.arange(T, device=q.device)[None, :] < lens[:, None]  # (BH, T)
    s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p, v)
    return out * (lens > 0).to(out.dtype)[:, None, None]


def _ulp(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The spacing of ``dtype`` at |x| (float64; its subnormal spacing at 0)."""
    info = torch.finfo(dtype)
    x = x.double().abs()
    _, e = torch.frexp(x)
    ulp = torch.ldexp(torch.full_like(x, info.eps), e - 1)
    return torch.where(x > 0, ulp, 0.0).clamp(min=info.smallest_normal * info.eps)


def ulp_error(out, ref, v, kv_lens) -> float:
    """The 16-bit form's bar, held by its tests and the card's checks: the
    largest |out - ref| over the valid rows (t < kv_len) in units of one ulp
    of their dtype at |ref|, or of one float32 ulp at the head's largest
    |v| where that is coarser.  The output is a convex combination of v's
    rows computed in float32, so near 0 (where a bfloat16 ulp falls to
    1e-40) two float32 computations of it differ by float32's resolution at
    v's scale, not at the output's.  At most 1 passes."""
    worst = 0.0
    for b, n in enumerate(kv_lens.tolist()):
        if n > 0:
            floor = float(_ulp(v[b, :n].float().abs().max(), torch.float32))
            d = (out[b, :n].double() - ref[b, :n].double()).abs()
            ulp = torch.clamp(_ulp(ref[b, :n], ref.dtype), min=floor)
            worst = max(worst, float((d / ulp).max()))
    return worst


def flash_attention(q, k, v, kv_lens):
    """(BH, T, D) q, k, v of one dtype (float32, bfloat16 or float16) and
    (BH,) int kv_lens -> (BH, T, D) in that dtype."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (BH, T, D) shape: {q.shape}, {k.shape}, {v.shape}")
    BH, T, D = q.shape
    if kv_lens.shape != (BH,):
        raise ValueError(f"kv_lens must be ({BH},), got {tuple(kv_lens.shape)}")
    if len({q.dtype, k.dtype, v.dtype}) != 1 or q.dtype not in (torch.float32, *HALF):
        raise TypeError("flash_attention takes float32, bfloat16 or float16, the three alike; "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
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
    workspace_floats, fwd = _kernel()[q.dtype]
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
    _count_launch("launches_16" if q.dtype in HALF else "launches")
    return out


flash_attention.launches = 0  # the float32 form's
flash_attention.launches_16 = 0  # the 16-bit form's (bfloat16 and float16)
