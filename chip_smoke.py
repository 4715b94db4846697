"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. environment: the card's name and power limit, torch/CUDA versions, TF32 off;
2. build: every CUDA kernel of the port, compiled from the sources here, with
   the compiler's register and spill counts;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   main path's shapes, with its time, the plain version's, a library call's
   (yardstick only) and the least time the card could take at the bar's
   precision (``bound_ms``: the lesser of the float32-FMA and the 3xTF32
   tensor-core bound);
4. path parity: the default-width FastSpeech2 stages on CUDA (kernels)
   against the same weights on the CPU (plain versions);
5. serve: ``SynthesisEngine.from_random(seed=0)`` at default width answers a
   few requests; the kernels' launch counts must rise in that run, and each
   kernel is held against its plain version on the very inputs that run gave
   it (one per shape);
6. serve parity: the longest request, which launches the kernels, on CUDA
   against the same engine on the CPU (plain versions), both started from the
   same bucket-estimator state;
7. profile: one long request under ``torch.profiler`` (device busy share,
   the kernels that take most device time, the port's own kernels' time);
8. a JSON line of every kernel, then the JSON result as the last line.

It imports nothing of JAX.  Without CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (dense): float32 outside the tensor cores,
# TF32 on the tensor cores, and HBM3 bandwidth.  They assume the full 700 W
# power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12

ATTN_TOL = 2e-5    # max |kernel - plain| on valid rows (the JAX kernel test's bar)
MEL_TOL = 1e-3     # postnet mel max |CUDA - CPU| at default width
TIE = 1e-4         # a duration may differ only where exp(log_d) - 1 is this close to x.5


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --- 1. environment ----------------------------------------------------------------

def environment() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    # the bundle reader needs both; bundles are not loaded here
    log("bundle reader modules: " + ", ".join(
        f"{m} {'yes' if importlib.util.find_spec(m) else 'no'}" for m in ("yaml", "msgpack")))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# --- 2. build ------------------------------------------------------------------------

KERNELS = ("flash_attention",)


def build() -> None:
    from e2e_tts_tpu_torch.kernels.build import compiler_log, library

    t0 = time.perf_counter()
    for name in KERNELS:
        library(name)
    log(f"build: {len(KERNELS)} kernel(s) in {time.perf_counter() - t0:.1f} s")
    for name in KERNELS:  # ptxas: registers and spills of each instantiation
        for line in compiler_log(name).splitlines():
            if "Compiling entry" in line or "spill" in line or "Used" in line:
                log(f"  {name}: {line.strip()}")


# --- 3. kernels against their plain versions -------------------------------------------

ATTN_SHAPES = (  # (BH, T, D, kv_lens); the first three are the decoder's at default width
    (16, 256, 192, (256, 255, 200, 129, 64, 1, 0, 256, 256, 240, 190, 128, 100, 33, 17, 256)),
    (16, 1024, 192, (1024, 1000, 777, 513, 256, 1, 0, 1024, 900, 640, 384, 129, 1024, 700, 65, 2)),
    (16, 2048, 192, (2048, 2047, 1800, 1537, 1025, 1, 0, 2048, 1900, 1333, 640, 257, 2048, 999, 128, 3)),
    (4, 100, 64, (100, 37, 1, 0)),
    (2, 300, 24, (300, 0)),
    # the serving run's three shapes, with the kv_lens it gave the kernel
    (4, 384, 192, (88, 88, 4, 4)),
    (4, 640, 192, (222, 222, 4, 4)),
    (4, 1152, 192, (957, 957, 4, 4)),
)


def attention_bounds(D, lens):
    """Least time (ms) for the work these inputs need, at the bar's precision.
    Only the valid rows (t < kv_len) mean anything, so: each valid query row
    against its kv_len keys, 2 flops per multiply-add in q k^T and in p v
    (4 D kv_len^2 per head); the valid rows of q, k, v read once and of the
    output written once, and kv_lens read.  Two ways to hold the float32 bar:
    float32 FMAs, or three TF32 tensor-core products per product (3xTF32).
    Returns both bounds and the lesser one with what bounds it."""
    n = np.asarray(lens, np.float64)
    flops = 4.0 * D * float((n * n).sum())
    t_bytes = 4.0 * (4 * D * float(n.sum()) + len(n)) / PEAK_BYTES
    fp32 = max(flops / PEAK_FP32_FLOPS, t_bytes)
    tc = max(3 * flops / PEAK_TF32_FLOPS, t_bytes)
    best = min(fp32, tc)
    return dict(bound_fp32_ms=1e3 * fp32, bound_tc_ms=1e3 * tc, bound_ms=1e3 * best,
                bound_by="bytes" if best == t_bytes else "operations")


def check_attention():
    from e2e_tts_tpu_torch.kernels.flash_attention import attention_plain, flash_attention

    g = torch.Generator().manual_seed(0)
    rows = []
    for BH, T, D, lens in ATTN_SHAPES:
        q = (torch.randn(BH, T, D, generator=g) * 0.3).cuda()
        k = (torch.randn(BH, T, D, generator=g) * 0.3).cuda()
        v = torch.randn(BH, T, D, generator=g).cuda()
        kv = torch.tensor(lens, dtype=torch.int32).cuda()
        out = flash_attention(q, k, v, kv)
        torch.cuda.synchronize()
        ref = attention_plain(q, k, v, kv)
        if not torch.isfinite(out).all():
            raise AssertionError(f"flash_attention: non-finite output at {(BH, T, D)}")
        err = max(float((out[b, :n] - ref[b, :n]).abs().max()) for b, n in enumerate(lens) if n)
        if not err < ATTN_TOL:
            raise AssertionError(f"flash_attention: max err {err} >= {ATTN_TOL} at {(BH, T, D)}")
        mask = (torch.arange(T, device="cuda")[None, :] < kv[:, None])[:, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row = dict(
            shape=(BH, T, D), err=err,
            kernel_ms=time_ms(lambda: flash_attention(q, k, v, kv)),
            plain_ms=time_ms(lambda: attention_plain(q, k, v, kv)),
            library_ms=time_ms(lambda: sdpa(q, k, v, attn_mask=mask)),
        )
        row.update(attention_bounds(D, lens))
        rows.append(row)
        log("flash_attention " + json.dumps(row))
    return rows


# --- 4. path parity at default width -------------------------------------------------------

def path_parity() -> None:
    from e2e_tts_tpu_torch.config import default_config
    from e2e_tts_tpu_torch.models.acoustic import FastSpeech2
    from e2e_tts_tpu_torch.nn.variance import FeatureStats
    from e2e_tts_tpu_torch.ops import sequence_mask
    from e2e_tts_tpu_torch.serve.engine import MAX_MEL_LEN, _mel_bucket
    from e2e_tts_tpu_torch.text.symbols import symbols

    cfg = default_config()
    cpu = FastSpeech2(cfg.models.fastspeech2, len(symbols), 4, cfg.audio.mel.channels,
                      FeatureStats(), use_flash=True, device="cpu", seed=0)
    gpu = copy.deepcopy(cpu).to("cuda")
    rng = np.random.RandomState(0)
    lens = np.array([320, 300, 257, 200, 150, 64, 9, 1])
    texts = np.zeros((8, 320), np.int64)
    for b, n in enumerate(lens):
        texts[b, :n] = rng.randint(1, len(symbols), n)
    spk = np.arange(8) % 4
    args = [torch.from_numpy(a) for a in (spk, texts, lens)]

    x_c, d_c = cpu.synthesize_stage1(*args)
    x_g, d_g = gpu.synthesize_stage1(*(a.cuda() for a in args))
    d_g = d_g.cpu()
    bad = (d_c != d_g).nonzero().tolist()
    if bad:
        # the pre-rounding value on the CPU side: only a rounding tie may differ
        mask = sequence_mask(args[2], 320)
        xe, _ = cpu.encoder(args[1], mask)
        xe = xe + cpu.speaker_emb(args[0])[:, None, :]
        val = torch.exp(cpu.variance_adaptor.duration_predictor(xe, mask)) - 1.0
        for b, i in bad:
            frac = float(val[b, i] - torch.floor(val[b, i]))
            log(f"duration tie at ({b}, {i}): cpu {int(d_c[b, i])} cuda {int(d_g[b, i])} "
                f"value {float(val[b, i]):.6f}")
            if abs(frac - 0.5) >= TIE:
                raise AssertionError(f"duration mismatch off a rounding tie at ({b}, {i})")
    log(f"stage 1: durations equal except {len(bad)} tie(s); "
        f"x max|diff| {float((x_c - x_g.cpu()).abs().max()):.3g}")

    T = _mel_bucket(min(int(d_c.sum(-1).max()), MAX_MEL_LEN))
    if T < 512:
        raise AssertionError(f"path parity wants a mel bucket >= 512, got {T}")
    # the same stage-1 output and durations into both stage-2 runs
    m_c, l_c = cpu.synthesize_stage2(x_c, d_c, T)
    m_g, l_g = gpu.synthesize_stage2(x_c.cuda(), d_c.cuda(), T)
    diff = float((m_c - m_g.cpu()).abs().max())
    if not torch.equal(l_c, l_g.cpu()) or not diff < MEL_TOL:
        raise AssertionError(f"stage 2: postnet mel max|diff| {diff} (bar {MEL_TOL})")
    log(f"stage 2 at T={T}: postnet mel max|diff| {diff:.3g} (bar {MEL_TOL})")


# --- 5. serve ----------------------------------------------------------------------------

REQUESTS = (
    "xin chào việt nam",
    "Hôm nay trời trong xanh, gió nhẹ thổi qua những hàng cây bên hồ, và mọi người cùng nhau "
    "đi dạo, trò chuyện vui vẻ về kỳ nghỉ hè sắp tới của gia đình.",
    "Thành phố về đêm rực rỡ ánh đèn, dòng xe cộ vẫn tấp nập trên những con phố lớn, còn các "
    "quán ăn nhỏ ven đường thì đông khách đến tận khuya.",
    "Sáng sớm, khi mặt trời vừa ló dạng sau rặng núi, người nông dân đã ra đồng chăm sóc lúa; "
    "tiếng chim hót líu lo hòa cùng tiếng suối chảy róc rách tạo nên một bản nhạc thiên nhiên "
    "êm đềm. Buổi trưa, cả làng quây quần bên mâm cơm giản dị, kể cho nhau nghe những câu "
    "chuyện cũ, rồi chiều về lũ trẻ lại nô đùa trên bãi cỏ xanh mướt cạnh con đê dài.",
)


def serve():
    import e2e_tts_tpu_torch.nn.transformer as transformer
    from e2e_tts_tpu_torch.kernels.flash_attention import flash_attention
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

    t0 = time.perf_counter()
    eng = SynthesisEngine.from_random(seed=0)
    log(f"serve: engine built in {time.perf_counter() - t0:.1f} s on {eng.device}")
    gap = int(0.5 * eng.sample_rate)
    for text in REQUESTS:  # warm-up pass, not counted
        eng.synthesize(text)

    # the counted run keeps a copy of the kernel's first inputs at each shape
    seen = {}

    def recording(q, k, v, kv_lens):
        if tuple(q.shape) not in seen:
            seen[tuple(q.shape)] = tuple(t.clone() for t in (q, k, v, kv_lens))
        return flash_attention(q, k, v, kv_lens)

    transformer.flash_attention = recording
    flash_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        for text in REQUESTS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            audio = eng.synthesize(text)
            sec = time.perf_counter() - t0
            n_seqs = len(eng.prepare_request(text)[0])
            body = len(audio) - n_seqs * gap
            if audio.dtype != np.int16 or body <= 0 or body % eng.hop_length:
                raise AssertionError(f"bad audio for {text[:30]!r}: {audio.dtype} {len(audio)}")
            dur = len(audio) / eng.sample_rate
            log("serve " + json.dumps(dict(chars=len(text), chunks=n_seqs, audio_s=round(dur, 3),
                                           seconds=round(sec, 4), rtf=round(sec / dur, 5))))
    finally:
        transformer.flash_attention = flash_attention
    launches = {"flash_attention": flash_attention.launches}
    log(f"serve: launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches["flash_attention"] <= 0:
        raise AssertionError("the serving run never launched flash_attention")
    return eng, launches, check_serving_inputs(seen)


def check_serving_inputs(seen) -> float:
    """The kernel against its plain version on the serving run's own inputs."""
    from e2e_tts_tpu_torch.kernels.flash_attention import attention_plain, flash_attention

    worst = 0.0
    for shape, (q, k, v, kv) in sorted(seen.items()):
        out = flash_attention(q, k, v, kv)
        torch.cuda.synchronize()
        ref = attention_plain(q, k, v, kv)
        lens = kv.tolist()
        if not torch.isfinite(out).all():
            raise AssertionError(f"flash_attention: non-finite output on serving inputs {shape}")
        err = max([float((out[b, :n] - ref[b, :n]).abs().max()) for b, n in enumerate(lens) if n],
                  default=0.0)
        log(f"flash_attention on serving inputs {shape} kv_lens {lens}: max err {err:.3g}")
        if not err < ATTN_TOL:
            raise AssertionError(f"flash_attention: max err {err} >= {ATTN_TOL} at {shape}")
        worst = max(worst, err)
    return worst


def serve_parity(eng) -> None:
    """The longest request, which runs the kernel, on CUDA and on the CPU
    (plain versions), both engines starting from the same bucket-estimator
    state, so that they choose the same buckets."""
    from e2e_tts_tpu_torch.kernels.flash_attention import flash_attention
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

    text = REQUESTS[-1]
    cpu = SynthesisEngine.from_random(seed=0, device="cpu")
    cpu._fpp, cpu._fpp_ema, cpu._fpp_nobs = eng._fpp, eng._fpp_ema, eng._fpp_nobs
    before = flash_attention.launches
    out = eng.synthesize(text)
    if flash_attention.launches <= before:
        raise AssertionError("the parity request never launched flash_attention")
    t0 = time.perf_counter()
    ref = cpu.synthesize(text)
    if len(ref) != len(out):
        raise AssertionError(f"CPU engine length {len(ref)} != CUDA {len(out)}")
    if (cpu._fpp, cpu._fpp_nobs) != (eng._fpp, eng._fpp_nobs):
        raise AssertionError("the CPU and CUDA engines' bucket estimates parted")
    d = np.abs(ref.astype(np.int32) - out.astype(np.int32))
    log(f"serve parity: {len(text)} characters, {flash_attention.launches - before} kernel "
        f"launches on CUDA, vs CPU engine ({time.perf_counter() - t0:.1f} s): "
        f"mean|diff| {d.mean():.4f} LSB, max {d.max()}")
    if not d.mean() < 1.0:
        raise AssertionError(f"serve parity: mean|diff| {d.mean()} LSB >= 1")


def profile(eng, text: str) -> None:
    """Where one request's time goes: device busy share and the kernels that
    take most device time, from ``torch.profiler`` (after the counted run)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.synthesize(text)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    dev_ms = lambda e: getattr(e, "self_device_time_total", 0.0) / 1e3  # noqa: E731
    busy_ms = sum(dev_ms(e) for e in kernels)
    if busy_ms <= 0:
        log("profile: the profiler shows no device time: device busy share not measured")
        return
    top = sorted(kernels, key=dev_ms, reverse=True)[:10]
    ours = [e for e in kernels if "flash_" in e.key]  # the port's kernels, by name
    log("profile " + json.dumps(dict(
        chars=len(text), wall_ms=round(wall_ms, 3), device_busy_ms=round(busy_ms, 3),
        busy_share=round(busy_ms / wall_ms, 4), kernel_launches=sum(e.count for e in kernels),
        port_kernels=[dict(name=e.key[:60], ms=round(dev_ms(e), 3), n=e.count) for e in ours],
        top=[dict(name=e.key[:90], ms=round(dev_ms(e), 3), n=e.count) for e in top])))


def main() -> int:
    environment()
    build()
    attn = check_attention()
    path_parity()
    eng, launches, serve_err = serve()
    serve_parity(eng)
    profile(eng, REQUESTS[-1])
    main_row = attn[2]  # the decoder's largest bucket
    kernels = [dict(
        name="flash_attention", route="cuda",
        source="e2e_tts_tpu_torch/kernels/csrc/flash_attention.cu",
        replaces="e2e_tts_tpu/kernels/flash_attention.py:106",
        launches=launches["flash_attention"],
        max_abs_err=max(serve_err, *(r["err"] for r in attn)),
        ms=main_row["kernel_ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"],
    )]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
