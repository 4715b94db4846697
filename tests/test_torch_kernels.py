"""The PyTorch port's flash attention against the JAX package's Pallas kernel
(interpret mode) and its plain reference, on the CPU.

On the CPU the wrapper runs the plain version; the CUDA kernel itself is held
to the plain version by ``tests/test_torch_cuda.py`` (skipped without a GPU)
and by ``chip_smoke.py`` on the card.  Bar: max error < 2e-5 on valid query rows
(the JAX kernel test's bar), every row finite, kv_len = 0 included.

The kernel's products run on the tensor cores in 3xTF32; a numpy emulation of
its arithmetic (TF32 rounding of each operand's two parts, three products
summed in float32, the online softmax over its 32-key tiles) shows that this
split holds the bar and that one TF32 product does not.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_one_thread import one_thread  # noqa: F401
from e2e_tts_tpu.kernels import attention_reference
from e2e_tts_tpu.kernels import flash_attention as jax_flash_attention
from e2e_tts_tpu_torch.kernels.flash_attention import attention_plain, flash_attention

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 2e-5

CASES = [  # (seed, BH, T, D, kv_lens): the JAX kernel test's shapes, D=24, kv_len=0
    (0, 4, 256, 192, (256, 200, 129, 64)),
    (1, 2, 100, 64, (100, 37)),
    (2, 3, 130, 24, (130, 0, 1)),
]


def _inputs(seed, BH, T, D, lens, scale=0.3):
    rng = np.random.RandomState(seed)
    q = (rng.randn(BH, T, D) * scale).astype(np.float32)
    k = (rng.randn(BH, T, D) * scale).astype(np.float32)
    v = rng.randn(BH, T, D).astype(np.float32)
    return q, k, v, np.asarray(lens, np.int32)


@pytest.mark.parametrize("seed,BH,T,D,lens", CASES, ids=[f"{c[1]}x{c[2]}x{c[3]}" for c in CASES])
def test_plain_matches_jax_kernel_and_reference(seed, BH, T, D, lens):
    q, k, v, kv = _inputs(seed, BH, T, D, lens)
    ours = attention_plain(*map(torch.from_numpy, (q, k, v, kv))).numpy()
    pallas = np.asarray(jax_flash_attention(*map(jnp.asarray, (q, k, v, kv)), interpret=True))
    ref = np.asarray(attention_reference(*map(jnp.asarray, (q, k, v, kv))))
    assert np.isfinite(ours).all()
    for b, n in enumerate(lens):
        if n:
            assert np.abs(ours[b, :n] - pallas[b, :n]).max() < TOL, b
            assert np.abs(ours[b, :n] - ref[b, :n]).max() < TOL, b
        else:
            assert not ours[b].any()  # no valid key: defined as 0


def test_wrapper_takes_the_plain_version_on_cpu():
    q, k, v, kv = map(torch.from_numpy, _inputs(3, 2, 64, 24, (64, 10)))
    before = flash_attention.launches
    assert torch.equal(flash_attention(q, k, v, kv), attention_plain(q, k, v, kv))
    assert flash_attention.launches == before  # counts kernel launches only


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, kv = map(torch.from_numpy, _inputs(4, 2, 16, 8, (16, 3)))
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double(), kv)
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :8], v, kv)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, kv[:1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
def test_wrapper_takes_the_plain_version_on_cpu_in_16_bits(dtype):
    """A 16-bit CPU tensor: the plain version on the upcast inputs, rounded
    once to the input's dtype; no launch counted."""
    q, k, v, kv = (t.to(dtype) if t.is_floating_point() else t
                   for t in map(torch.from_numpy, _inputs(6, 2, 64, 24, (64, 10))))
    before = (flash_attention.launches, flash_attention.launches_16)
    out = flash_attention(q, k, v, kv)
    assert out.dtype == dtype
    assert torch.equal(out, attention_plain(q.float(), k.float(), v.float(), kv).to(dtype))
    assert torch.equal(out, attention_plain(q, k, v, kv))
    assert (flash_attention.launches, flash_attention.launches_16) == before


def test_wrapper_rejects_mixed_dtypes():
    q, k, v, kv = map(torch.from_numpy, _inputs(7, 2, 16, 8, (16, 3)))
    for a, b in ((torch.bfloat16, torch.float16), (torch.float32, torch.bfloat16)):
        with pytest.raises(TypeError):
            flash_attention(q.to(a), k.to(b), v.to(a), kv)


def test_16bit_inputs_bind_the_16bit_kernel(monkeypatch):
    """No upcast: each dtype binds its own C entry point (the float32 form's
    for float32, the 16-bit form's with its bfloat16 flag and the kernel
    otherwise), as the library is loaded at first CUDA use."""
    import importlib

    from e2e_tts_tpu_torch.kernels import build

    fa = importlib.import_module("e2e_tts_tpu_torch.kernels.flash_attention")
    calls = []

    def entry(name):
        def call(*args):
            calls.append((name, args))
            return 0
        return call

    lib = type("Lib", (), {n: staticmethod(entry(n)) for n in (
        "flash_attention_workspace_floats", "flash_attention_fwd_f32",
        "flash_attention_workspace_floats_16", "flash_attention_fwd_16",
        "flash_attention_kernel_16")})()
    monkeypatch.setattr(build, "library", lambda name: lib)
    monkeypatch.setattr(fa, "_bound", None)
    bound = fa._kernel()
    for dtype, flag in ((torch.bfloat16, 1), (torch.float16, 0)):
        ws, fwd = bound[dtype]
        for kern in (0, 1):
            ws(4, 256, 192, kern)
            fwd(*range(6), 4, 256, 192, kern, "stream")
            assert calls[-2:] == [
                ("flash_attention_workspace_floats_16", (4, 256, 192, flag, kern)),
                ("flash_attention_fwd_16", (*range(6), 4, 256, 192, flag, kern, "stream"))]
    bound["kernel_16"](192)
    assert calls[-1] == ("flash_attention_kernel_16", (192,))
    ws, fwd = bound[torch.float32]
    fwd(*range(6), 4, 256, 192, "stream")
    assert calls[-1] == ("flash_attention_fwd_f32", (*range(6), 4, 256, 192, "stream"))


def test_kernel_sources_ship_with_the_module():
    from e2e_tts_tpu_torch.kernels import build

    src = open(f"{build.CSRC}/flash_attention.cu").read()
    assert src.count("flash_attention_fwd_f32") and src.count("flash_attention_workspace_floats")
    # both products on the tensor cores (3xTF32 mma.sync), K/V tiles by cp.async
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "cp.async.cg.shared.global" in src
    assert "compute_90a,code=sm_90a" in " ".join(build.NVCC_FLAGS)
    # the 16-bit form: m16n8k16 products in bfloat16 and float16, v by ldmatrix
    assert src.count("flash_attention_fwd_16") and src.count("flash_attention_workspace_floats_16")
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32" in src
    assert "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16" in src


def _tf32(x):
    """Round float32 to TF32 (10-bit mantissa), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` does."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_matmul(a, b, products):
    """a @ b with TF32 operands and a float32 sum: big*big alone (1), or with
    the two cross terms of the split x = big + small (3)."""
    a_big, b_big = _tf32(a), _tf32(b)
    if products == 1:
        return a_big @ b_big
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_big @ b_small + a_small @ b_big + a_big @ b_big


def _kernel_arithmetic(q, k, v, lens, products, bkv=32):
    """The CUDA kernel's arithmetic in numpy float32: raw scores, a running
    max over 32-key tiles, exp2 of (s - max) * log2(e) / sqrt(D)."""
    BH, T, D = q.shape
    c = np.float32(np.log2(np.e) / np.sqrt(D))
    out = np.zeros_like(q)
    for b, n in enumerate(lens):
        m = np.full((T, 1), -1e30, np.float32)
        l = np.zeros((T, 1), np.float32)
        o = np.zeros((T, D), np.float32)
        for j in range(0, n, bkv):
            e = min(j + bkv, n)  # the masked keys of the last tile add exactly 0
            s = _tf32_matmul(q[b], k[b, j:e].T, products)
            m_new = np.maximum(m, s.max(-1, keepdims=True))
            alpha = np.exp2((m - m_new) * c)
            p = np.exp2((s - m_new) * c)
            l = l * alpha + p.sum(-1, keepdims=True)
            o = o * alpha + _tf32_matmul(p, v[b, j:e], products)
            m = m_new
        if n:
            out[b] = o / l
    return out


EMULATED = [c + (0.3,) for c in CASES] + [(5, 4, 1152, 192, (957, 957, 4, 4), 2.0)]


@pytest.mark.parametrize("seed,BH,T,D,lens,scale", EMULATED,
                         ids=[f"{c[1]}x{c[2]}x{c[3]}-qk{c[5]}" for c in EMULATED])
def test_3xtf32_holds_the_bar_and_1xtf32_misses_it(seed, BH, T, D, lens, scale):
    q, k, v, kv = _inputs(seed, BH, T, D, lens, scale)
    plain = attention_plain(*map(torch.from_numpy, (q, k, v, kv))).numpy()
    ref = np.asarray(attention_reference(*map(jnp.asarray, (q, k, v, kv))))

    def err(a, b):
        return max(np.abs(a[i, :n] - b[i, :n]).max() for i, n in enumerate(lens) if n)

    three = _kernel_arithmetic(q, k, v, lens, products=3)
    one = _kernel_arithmetic(q, k, v, lens, products=1)
    assert np.isfinite(three).all()
    assert err(three, plain) < TOL and err(three, ref) < TOL, (err(three, plain), err(three, ref))
    assert err(one, plain) >= TOL, err(one, plain)


# --- first use and launch counts from many threads ---------------------------------------

def test_library_builds_once_when_threads_race(monkeypatch, tmp_path):
    """Threads that reach a kernel's first use together: one compile (a stub
    compiler here, slow enough that the threads overlap), one library object
    for all, no temporary file left behind."""
    import threading
    import time

    from e2e_tts_tpu_torch.kernels import build

    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        time.sleep(0.2)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"built")
        return type("Done", (), {"returncode": 0, "stdout": "ptxas info: stub\n"})()

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", fake_run)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("lib", path))
    got = [None] * 6
    start = threading.Barrier(len(got))

    def first_use(i):
        start.wait(timeout=30)
        got[i] = build.library("flash_attention")

    threads = [threading.Thread(target=first_use, args=(i,)) for i in range(len(got))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(calls) == 1
    assert len(set(got)) == 1 and got[0][1].startswith(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(got[0][1]), os.path.basename(got[0][1]) + ".log"])
    assert build.compiler_log("flash_attention") == "ptxas info: stub\n"


def test_launch_counts_from_threads_add_up():
    """Each launch adds one under a lock: counts from many threads, switching
    often, add up to the launches made."""
    import importlib
    import sys
    import threading

    # the module (the package's name ``flash_attention`` is the function)
    fa = importlib.import_module("e2e_tts_tpu_torch.kernels.flash_attention")
    n_threads, n_each = 8, 5000
    before = flash_attention.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [fa._count_launch() for _ in range(n_each)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert flash_attention.launches - before == n_threads * n_each
    # the add waits on the lock (the interpreter may not switch threads inside
    # ``+=``, so the sums above would add up without it)
    with fa._LOCK:
        t = threading.Thread(target=fa._count_launch)
        t.start()
        t.join(timeout=0.2)
        assert t.is_alive() and flash_attention.launches - before == n_threads * n_each
    t.join(timeout=30)
    assert not t.is_alive() and flash_attention.launches - before == n_threads * n_each + 1
    flash_attention.launches = before
