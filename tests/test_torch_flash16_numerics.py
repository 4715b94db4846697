"""The 16-bit flash kernel's arithmetic and the wrapper's dispatch between its
two kernels, on the CPU (no JAX).

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Here a plain PyTorch emulation of the arithmetic that
``flash_fwd_16_sm90`` and ``flash_fwd_16`` share is held to
``attention_plain`` at the one-ulp bar (``ulp_error`` <= 1): float32 scores
from 16-bit operands, a running max over 64-key tiles, p = exp2((s - max) *
log2(e) / sqrt(D)), p (times 2^15 for float16) split into three 16-bit parts,
each part times v with float32 sums into a fresh per-tile accumulator (the
small parts first), merged as o = o * alpha + fresh.  With two parts the
outputs near 0 miss the bar.  The shapes are ``chip_smoke.ATTN_SHAPES`` with
T <= 1152, inputs from numpy seeds.
"""

import contextlib
import importlib

import numpy as np
import pytest
import torch

from _torch_one_thread import one_thread  # noqa: F401
from e2e_tts_tpu_torch.kernels.flash_attention import attention_plain, flash_attention, ulp_error

pytestmark = pytest.mark.usefixtures("one_thread")

BN = 64  # keys a K/V tile of flash_fwd_16_sm90 (and flash_fwd_16)
P_SCALE = {torch.bfloat16: 1.0, torch.float16: 32768.0}

SHAPES = [  # (BH, T, D, kv_lens): chip_smoke.ATTN_SHAPES with T <= 1152
    (16, 256, 192, (256, 255, 200, 129, 64, 1, 0, 256, 256, 240, 190, 128, 100, 33, 17, 256)),
    (16, 1024, 192, (1024, 1000, 777, 513, 256, 1, 0, 1024, 900, 640, 384, 129, 1024, 700, 65, 2)),
    (4, 100, 64, (100, 37, 1, 0)),
    (2, 300, 24, (300, 0)),
    (4, 384, 192, (88, 88, 4, 4)),
    (4, 640, 192, (222, 222, 4, 4)),
    (4, 1152, 192, (957, 957, 4, 4)),
]
DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}


def _inputs(seed, BH, T, D, lens, dtype):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy((rng.randn(BH, T, D) * 0.3).astype(np.float32)).to(dtype)
    k = torch.from_numpy((rng.randn(BH, T, D) * 0.3).astype(np.float32)).to(dtype)
    v = torch.from_numpy(rng.randn(BH, T, D).astype(np.float32)).to(dtype)
    return q, k, v, torch.tensor(lens, dtype=torch.int32)


def _split(x, dtype, parts):
    """x (float32) as ``parts`` 16-bit values whose sum is x, the rounded
    value first and then the rounded remainders."""
    out = []
    for _ in range(parts):
        h = x.to(dtype)
        out.append(h)
        x = x - h.float()
    return out


def kernel_16_arithmetic(q, k, v, lens, parts=3, bkv=BN):
    """The 16-bit kernels' arithmetic in PyTorch float32 on the CPU."""
    BH, T, D = q.shape
    dtype = q.dtype
    c = np.float32(np.log2(np.e) / np.sqrt(D))
    scale = P_SCALE[dtype]
    out = torch.zeros(BH, T, D, dtype=dtype)
    for b, n in enumerate(lens.tolist()):
        qb, kb, vb = q[b].float(), k[b].float(), v[b].float()
        m = torch.full((T, 1), -1e30)
        l = torch.zeros(T, 1)
        o = torch.zeros(T, D)
        for j in range(0, n, bkv):
            e = min(j + bkv, n)  # the masked keys of the last tile add exactly 0
            s = qb @ kb[j:e].T  # products of 16-bit values are exact in float32
            m_new = torch.maximum(m, s.max(-1, keepdim=True).values)
            alpha = torch.exp2((m - m_new) * c)
            p = torch.exp2((s - m_new) * c)
            l = l * alpha + p.sum(-1, keepdim=True)
            fresh = torch.zeros(T, D)
            for part in reversed(_split(p * scale, dtype, parts)):  # the small parts first
                fresh = fresh + part.float() @ vb[j:e]
            o = o * alpha + fresh * (1.0 / scale)  # 1 / scale: a power of 2, exact
            m = m_new
        if n:
            out[b] = (o / l).to(dtype)
    return out


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("BH,T,D,lens", SHAPES, ids=[f"{s[0]}x{s[1]}x{s[2]}" for s in SHAPES])
def test_three_parts_hold_the_one_ulp_bar(BH, T, D, lens, dtype):
    q, k, v, kv = _inputs(T + D, BH, T, D, lens, dtype)
    out = kernel_16_arithmetic(q, k, v, kv)
    assert torch.isfinite(out.float()).all()
    for b, n in enumerate(lens):
        if n == 0:
            assert not out[b].any()
    err = ulp_error(out, attention_plain(q, k, v, kv), v, kv)
    assert err <= 1.0, err


def test_two_parts_miss_the_bar_near_zero():
    """Why three parts: p in two bfloat16 parts (~2^-17 of p) leaves outputs
    near 0 (where the bar is float32's ulp at v's scale) several ulps off;
    three hold it.  (Two float16 parts keep 22 bits of p.)"""
    BH, T, D, lens = SHAPES[0]
    q, k, v, kv = _inputs(1, BH, T, D, lens, torch.bfloat16)
    ref = attention_plain(q, k, v, kv)
    assert ulp_error(kernel_16_arithmetic(q, k, v, kv, parts=2), ref, v, kv) > 1.0
    assert ulp_error(kernel_16_arithmetic(q, k, v, kv, parts=3), ref, v, kv) <= 1.0


# --- the wrapper's dispatch between the two 16-bit kernels ---------------------------------

@pytest.fixture
def fake_library(monkeypatch):
    """The library's C entry points as recorders (the plan takes
    flash_fwd_16_sm90 where D % 8 == 0), and a stream and device context
    that CPU tensors can use, so that ``_launch`` runs here as on the card."""
    from e2e_tts_tpu_torch.kernels import build

    fa = importlib.import_module("e2e_tts_tpu_torch.kernels.flash_attention")
    calls = []

    def entry(name, result=0):
        def call(*args):
            calls.append((name, args))
            return result(*args) if callable(result) else result
        return call

    lib = type("Lib", (), {
        "flash_attention_workspace_floats": staticmethod(entry("ws")),
        "flash_attention_fwd_f32": staticmethod(entry("fwd_f32")),
        "flash_attention_workspace_floats_16": staticmethod(entry("ws16")),
        "flash_attention_fwd_16": staticmethod(entry("fwd16")),
        "flash_attention_kernel_16": staticmethod(
            entry("kernel_16", lambda D: int(D % 8 == 0))),
    })()
    monkeypatch.setattr(build, "library", lambda name: lib)
    monkeypatch.setattr(fa, "_bound", None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7})())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    for name in ("launches", "launches_16", "launches_16_sm90"):
        monkeypatch.setattr(flash_attention, name, 0)
    return fa, calls


def _counts():
    return (flash_attention.launches, flash_attention.launches_16,
            flash_attention.launches_16_sm90)


@pytest.mark.parametrize("dtype,flag", [(torch.bfloat16, 1), (torch.float16, 0)],
                         ids=["bf16", "fp16"])
def test_each_16bit_kernel_counts_its_own_launches(fake_library, dtype, flag):
    fa, calls = fake_library
    lens = torch.tensor([5, 3], dtype=torch.int32)

    def launch(D, kernel=None):
        q, k, v = (torch.zeros(2, 8, D, dtype=dtype) for _ in range(3))
        fa._launch(q, k, v, lens, kernel)
        return [c for c in calls[-3:] if c[0] != "kernel_16"]

    # D % 8 == 0: the plan's flash_fwd_16_sm90
    ws, fwd = launch(192)
    assert calls[-3] == ("kernel_16", (192,))
    assert ws == ("ws16", (2, 8, 192, flag, 1)) and fwd[1][6:] == (2, 8, 192, flag, 1, 7)
    assert _counts() == (0, 0, 1)
    # D % 8 != 0: the plan's flash_fwd_16
    ws, fwd = launch(100)
    assert ws == ("ws16", (2, 8, 100, flag, 0)) and fwd[1][6:] == (2, 8, 100, flag, 0, 7)
    assert _counts() == (0, 1, 1)
    # forced, as the card's checks time the two in turns: no plan query
    n = len(calls)
    launch(192, "mma_sync")
    assert [c[0] for c in calls[n:]] == ["ws16", "fwd16"] and calls[-1][1][9:] == (flag, 0, 7)
    launch(192, "sm90")
    assert calls[-1][1][9:] == (flag, 1, 7)
    assert _counts() == (0, 2, 2)


def test_float32_counts_apart_and_takes_no_kernel_choice(fake_library):
    fa, calls = fake_library
    q = torch.zeros(2, 8, 64)
    fa._launch(q, q, q, torch.tensor([8, 1], dtype=torch.int32), None)
    assert [c[0] for c in calls] == ["ws", "fwd_f32"] and calls[-1][1][6:] == (2, 8, 64, 7)
    assert _counts() == (1, 0, 0)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, torch.tensor([8, 1]), kernel="sm90")
    with pytest.raises(ValueError):
        flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16(), torch.tensor([8, 1]),
                        kernel="wgmma")


def test_sm90_gets_16_byte_aligned_rows(fake_library):
    """TMA reads 16-byte aligned rows: a contiguous view that starts off that
    alignment reaches flash_fwd_16_sm90 as an aligned copy,
    and an aligned tensor as itself."""
    fa, calls = fake_library
    base = torch.arange(2 * 8 * 64 + 1, dtype=torch.float32).bfloat16()
    q = base[1:].view(2, 8, 64)  # 2 bytes past an aligned start
    k = base[:-1].view(2, 8, 64)
    assert q.is_contiguous() and q.data_ptr() % 16 and k.data_ptr() % 16 == 0
    fa._launch(q, k, k, torch.tensor([8, 8], dtype=torch.int32), None)
    ptrs = calls[-1][1][:3]
    assert all(p % 16 == 0 for p in ptrs)
    assert ptrs[0] != q.data_ptr() and ptrs[1] == ptrs[2] == k.data_ptr()
    # flash_fwd_16 takes any alignment as it is
    fa._launch(q, k, k, torch.tensor([8, 8], dtype=torch.int32), "mma_sync")
    assert calls[-1][1][0] == q.data_ptr()


def test_sm90_kernel_source_ships_with_the_module():
    """The Hopper kernel's source sits beside the library's and is built
    with it: TMA loads into mbarrier rings, wgmma in both dtypes (A from
    registers for p v, the V tile transposed), setmaxnreg, and libcuda's
    tensor-map encoder reached without -lcuda."""
    import os

    from e2e_tts_tpu_torch.kernels import build

    src = open(os.path.join(build.CSRC, "flash_attention_sm90.cuh")).read()
    main = open(os.path.join(build.CSRC, "flash_attention.cu")).read()
    assert '#include "flash_attention_sm90.cuh"' in main
    assert "flash_attention_kernel_16" in main
    assert "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes" in src
    for t in ("bf16.bf16", "f16.f16"):
        assert f"wgmma.mma_async.sync.aligned.m64n64k16.f32.{t}" in src
    assert "setmaxnreg.inc.sync.aligned.u32" in src and "setmaxnreg.dec.sync.aligned.u32" in src
    assert "cudaGetDriverEntryPoint" in src and "-lcuda" not in " ".join(build.NVCC_FLAGS)
