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
once, at the output.  So the source has a 16-bit form too (bfloat16 or
float16 in and out) that keeps the scores, the softmax and the accumulator in
float32: one product for q k^T (a product of two 16-bit values is exact in
float32) and three for p v, with p split into three 16-bit parts so that it
keeps float32 accuracy.  That form is bound by the dense 16-bit tensor rate,
at twice the nominal work (the p parts), and has two kernels:

- ``flash_fwd_16_sm90`` (``csrc/flash_attention_sm90.cuh``), where D % 8 == 0
  (every shipped voice): one lane of a producer warpgroup loads the Q tile
  and a two-stage ring of 64-key K/V tiles by TMA (``mbarrier``s, the
  128-byte swizzle), and one or two consumer warpgroups of 64 query rows run
  ``wgmma``: q k^T from shared memory, p v with p's parts from registers;
  ``setmaxnreg`` moves the producer's registers to the consumers.  On the
  H100 it is bound by the tensor rate at twice the nominal work, and it is
  faster than ``flash_fwd_16`` at every measured shape (``PERF.md``).
  TMA needs 16-byte aligned rows, so a misaligned view is copied first.
  Launches count in ``flash_attention.launches_16_sm90``.
- ``flash_fwd_16`` (``mma.sync`` m16n8k16, a ``cp.async`` ring), for D % 8 != 0.
  Launches count in ``flash_attention.launches_16``.

The launch plan (per device, form and shape) picks the kernel
(``flash_attention_kernel_16``); ``kernel="sm90"`` or ``"mma_sync"`` forces
one, for the card's checks.  A 16-bit CUDA tensor launches one of them,
never the float32 form on upcast inputs, and never the other kernel when one
fails.

``flash_attention`` is the one entry point.  A CPU tensor goes to
``attention_plain`` (a 16-bit input upcast, the result rounded to its
dtype); a CUDA tensor launches the kernel or raises.  float32, bfloat16 or
float16, the three alike: any other dtype, mixed dtypes, a non-contiguous
input or a CPU/CUDA mix raises.  Padded query rows (t >= kv_len) are
meaningless but finite (zeros at least in every 16-row group past kv_len),
and a head with kv_len = 0 comes out 0.

A launch made while a CUDA graph captures (``serve/graphs.py``) runs at
each replay and not then: inside ``tallied_launches`` a thread's launches
go to the tally it yields, and the graph adds the tally to the counts at
each replay (``count_launches``).
"""

from __future__ import annotations

import contextlib
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
    """{form: (workspace_floats, fwd)} and {"kernel_16": the plan's 16-bit
    kernel}: the library's C entry points, the 16-bit ones with their
    ``bf16`` flag bound and the kernel (-1 the plan's, 0 ``flash_fwd_16``, 1
    ``flash_fwd_16_sm90``) as an argument before the stream."""
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
            ws16.argtypes = [ctypes.c_int] * 5
            ws16.restype = ctypes.c_longlong
            fwd16 = lib.flash_attention_fwd_16
            fwd16.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fwd16.restype = ctypes.c_int
            which = lib.flash_attention_kernel_16
            which.argtypes = [ctypes.c_int]
            which.restype = ctypes.c_int
            _bound = {torch.float32: (ws, fwd), "kernel_16": which}
            for dtype, flag in ((torch.bfloat16, 1), (torch.float16, 0)):
                _bound[dtype] = (lambda BH, T, D, kern, f=flag: ws16(BH, T, D, f, kern),
                                 lambda *a, f=flag: fwd16(*a[:-2], f, *a[-2:]))
        return _bound


_TALLY = threading.local()  # .counts: the tally of a capture on this thread, or None


def _count_launch(counter: str = "launches") -> None:
    """One more launch in ``flash_attention.<counter>`` (a locked add: ``+=``
    on an attribute is not atomic across threads), or in the tally of the
    thread's capture."""
    tally = getattr(_TALLY, "counts", None)
    if tally is not None:
        tally[counter] = tally.get(counter, 0) + 1
        return
    count_launches({counter: 1})


def count_launches(tally: dict) -> None:
    """Add ``tally`` ({counter: launches}) to the counts."""
    with _LOCK:
        for counter, n in tally.items():
            setattr(flash_attention, counter, getattr(flash_attention, counter) + n)


@contextlib.contextmanager
def tallied_launches():
    """Within: this thread's launches go to the dict yielded, not to the
    counts (a CUDA graph's capture, whose launches run at its replays)."""
    _TALLY.counts = tally = {}
    try:
        yield tally
    finally:
        _TALLY.counts = None


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


KERNELS_16 = {"mma_sync": 0, "sm90": 1}  # the 16-bit form's kernels, by the C side's number
_COUNTERS_16 = ("launches_16", "launches_16_sm90")


def flash_attention(q, k, v, kv_lens, *, kernel: str | None = None):
    """(BH, T, D) q, k, v of one dtype (float32, bfloat16 or float16) and
    (BH,) int kv_lens -> (BH, T, D) in that dtype.  ``kernel`` ("sm90" or
    "mma_sync", 16-bit CUDA inputs only) overrides the plan's kernel."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (BH, T, D) shape: {q.shape}, {k.shape}, {v.shape}")
    BH, T, D = q.shape
    if kv_lens.shape != (BH,):
        raise ValueError(f"kv_lens must be ({BH},), got {tuple(kv_lens.shape)}")
    if len({q.dtype, k.dtype, v.dtype}) != 1 or q.dtype not in (torch.float32, *HALF):
        raise TypeError("flash_attention takes float32, bfloat16 or float16, the three alike; "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if kernel is not None and (kernel not in KERNELS_16 or q.dtype not in HALF):
        raise ValueError(f"kernel={kernel!r}: one of {sorted(KERNELS_16)}, for 16-bit inputs")
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
    return _launch(q, k, v, kv_lens.to(torch.int32).contiguous(), kernel)


def _launch(q, k, v, lens, kernel):
    """One launch on q's device (the checks done): the plan's 16-bit kernel
    unless ``kernel`` names one, the workspace it needs, and the count of the
    kernel launched."""
    BH, T, D = q.shape
    out = torch.empty_like(q)
    bound = _kernel()
    workspace_floats, fwd = bound[q.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if q.dtype in HALF:
            kern = bound["kernel_16"](D) if kernel is None else KERNELS_16[kernel]
            if kern == KERNELS_16["sm90"]:  # TMA reads 16-byte aligned rows
                q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
            args = (BH, T, D, kern)
        else:
            args = (BH, T, D)
        n = workspace_floats(*args)  # where the kernel splits each head's keys
        if n < 0:
            raise RuntimeError(f"flash_attention: no launch plan for {(BH, T, D)} on this device "
                               "(a CUDA error, or the forced kernel takes no such head width)")
        ws = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
        err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
                  ws.data_ptr() if n else None, *args, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    _count_launch(_COUNTERS_16[kern] if q.dtype in HALF else "launches")
    return out


flash_attention.launches = 0  # the float32 form's
flash_attention.launches_16 = 0  # the 16-bit form's flash_fwd_16 (bfloat16 and float16)
flash_attention.launches_16_sm90 = 0  # the 16-bit form's flash_fwd_16_sm90


def plan_kernel_16(D: int) -> str:
    """The 16-bit kernel the launch plan takes for heads of D ("sm90" or
    "mma_sync"), as the library says (needs the CUDA library)."""
    return {n: name for name, n in KERNELS_16.items()}[_kernel()["kernel_16"](D)]


def launches_16() -> int:
    """Launches of either 16-bit kernel."""
    return flash_attention.launches_16 + flash_attention.launches_16_sm90
