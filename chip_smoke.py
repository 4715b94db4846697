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
   against the same engine on the CPU (plain versions, the same audible
   vocoder), both started from the same bucket-estimator state;
7. audio ops: the log-mel, the STFT energy and the inverse STFT at serving
   size on CUDA against the CPU, the inverse STFT twice bit-equal;
8. iSTFTNet serve: ``from_random(seed=0, vocoder_kind="istft")`` at default
   width answers the requests (launch counts must rise), its RTF beside the
   HiFi-GAN engine's, the longest request against the same engine on the CPU;
9. streaming: ``StreamingVocoder`` against the full vocoder pass, and
   ``stream_synthesize`` of the longest request (launches must rise; time to
   the first chunk and in all) against the same call on the CPU engine;
10. queue: a ``BatchingServer`` given 16 requests from 16 threads at once,
   each result against a solo ``synthesize`` (launches must rise), and its
   throughput and device busy share beside the 16 served one after another;
11. ``Synthesizer`` (its wav read back equals the engine's int16; the speed
   change) and ``synthesize_denoised`` of a request that launches the
   kernels, on CUDA against the CPU;
12. profile: one long request under ``torch.profiler`` (device busy share,
   the kernels that take most device time, the port's own kernels' time);
13. a JSON line of every kernel, then the JSON result as the last line.

Each path that launches kernels (phases 5, 8, 9, 10 and 11) is driven with
the launch counts set to 0 just before it and read just after, and each
kernel is held against its plain version on the first inputs that path gave
it at each shape (``recorded_inputs``).  From phase 6 on, the random
vocoders run with their last convolution scaled so that the waveform is at a
speaking level (``make_audible``): the random weights alone give well under
1 LSB.

It imports nothing of JAX.  Without CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import threading
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
LOGMEL_MAE = 1e-4  # log-mel mean |CUDA - CPU|
ENERGY_TOL = 2e-2  # STFT energy max |CUDA - CPU| (a norm over 513 bins)
ISTFT_TOL = 1e-4   # inverse STFT max |CUDA - CPU|
LSB_TOL = 1.0      # int16 mean |diff| between two runs of one request


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


@contextlib.contextmanager
def recorded_inputs():
    """Set the launch count to 0 and route the model's kernel calls, from any
    thread, through a hook that keeps a copy of the first CUDA inputs at each
    shape; yields those inputs by shape, for ``check_serving_inputs``."""
    import e2e_tts_tpu_torch.nn.transformer as transformer
    from e2e_tts_tpu_torch.kernels.flash_attention import flash_attention

    seen, lock = {}, threading.Lock()

    def recording(q, k, v, kv_lens):
        with lock:
            if q.is_cuda and tuple(q.shape) not in seen:
                seen[tuple(q.shape)] = tuple(t.clone() for t in (q, k, v, kv_lens))
        return flash_attention(q, k, v, kv_lens)

    transformer.flash_attention = recording
    flash_attention.launches = 0
    try:
        yield seen
    finally:
        transformer.flash_attention = flash_attention


def serve():
    from e2e_tts_tpu_torch.kernels.flash_attention import flash_attention
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

    t0 = time.perf_counter()
    eng = SynthesisEngine.from_random(seed=0)
    log(f"serve: engine built in {time.perf_counter() - t0:.1f} s on {eng.device}")
    gap = int(0.5 * eng.sample_rate)
    for text in REQUESTS:  # warm-up pass, not counted
        eng.synthesize(text)

    # the counted run keeps a copy of the kernel's first inputs at each shape
    rows = []
    torch.cuda.reset_peak_memory_stats()
    with recorded_inputs() as seen:
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
            rows.append(dict(chars=len(text), chunks=n_seqs, audio_s=round(dur, 3),
                             seconds=round(sec, 4), rtf=round(sec / dur, 5)))
            log("serve " + json.dumps(rows[-1]))
    launches = {"flash_attention": flash_attention.launches}
    log(f"serve: launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches["flash_attention"] <= 0:
        raise AssertionError("the serving run never launched flash_attention")
    return eng, launches, check_serving_inputs(seen), rows


def check_serving_inputs(seen, path: str = "serving") -> float:
    """The kernel against its plain version on the inputs that one path's
    counted run gave it (``recorded_inputs``)."""
    from e2e_tts_tpu_torch.kernels.flash_attention import attention_plain, flash_attention

    if not seen:
        raise AssertionError(f"the {path} run gave the kernel no CUDA inputs")
    worst = 0.0
    for shape, (q, k, v, kv) in sorted(seen.items()):
        out = flash_attention(q, k, v, kv)
        torch.cuda.synchronize()
        ref = attention_plain(q, k, v, kv)
        lens = kv.tolist()
        if not torch.isfinite(out).all():
            raise AssertionError(f"flash_attention: non-finite output on {path} inputs {shape}")
        err = max([float((out[b, :n] - ref[b, :n]).abs().max()) for b, n in enumerate(lens) if n],
                  default=0.0)
        log(f"flash_attention on {path} inputs {shape} kv_lens {lens}: max err {err:.3g}")
        if not err < ATTN_TOL:
            raise AssertionError(f"flash_attention: max err {err} >= {ATTN_TOL} on {path} "
                                 f"inputs {shape}")
        worst = max(worst, err)
    return worst


def estimator(eng):
    """An engine's bucket-estimator state: copied into another engine (or back
    into the same one), it makes the next request choose the same buckets."""
    return eng._fpp, eng._fpp_ema, eng._fpp_nobs


def set_estimator(eng, state) -> None:
    eng._fpp, eng._fpp_ema, eng._fpp_nobs = state


def lsb_diff(name: str, got, want) -> float:
    """Mean |diff| in LSB of two int16 waveforms of one length; raises past
    LSB_TOL."""
    if len(got) != len(want) or not len(got):
        raise AssertionError(f"{name}: length {len(got)} != {len(want)}")
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    log(f"{name}: mean|diff| {d.mean():.4f} LSB, max {d.max()} "
        f"(signal mean|x| {np.abs(want.astype(np.int32)).mean():.1f} LSB)")
    if not d.mean() < LSB_TOL:
        raise AssertionError(f"{name}: mean|diff| {d.mean()} LSB >= {LSB_TOL}")
    return float(d.mean())


def serve_parity(eng, vocoder_kind: str = "hifigan", gain: bool = False):
    """The longest request, which runs the kernel, on CUDA and on the CPU
    (plain versions), both engines starting from the same bucket-estimator
    state, so that they choose the same buckets.  ``gain``: the CUDA engine
    went through ``make_audible``, so the CPU engine gets its vocoder's
    weights.  Returns the CPU engine."""
    from e2e_tts_tpu_torch.kernels.flash_attention import flash_attention
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

    text = REQUESTS[-1]
    cpu = SynthesisEngine.from_random(seed=0, vocoder_kind=vocoder_kind, device="cpu")
    if gain:
        cpu.vocoder.load_state_dict(eng.vocoder.state_dict())
    set_estimator(cpu, estimator(eng))
    before = flash_attention.launches
    out = eng.synthesize(text)
    if flash_attention.launches <= before:
        raise AssertionError("the parity request never launched flash_attention")
    t0 = time.perf_counter()
    ref = cpu.synthesize(text)
    if (cpu._fpp, cpu._fpp_nobs) != (eng._fpp, eng._fpp_nobs):
        raise AssertionError("the CPU and CUDA engines' bucket estimates parted")
    lsb_diff(f"serve parity ({vocoder_kind}): {len(text)} characters, "
             f"{flash_attention.launches - before} kernel launches on CUDA, vs CPU engine "
             f"({time.perf_counter() - t0:.1f} s)", out, ref)
    return cpu


def make_audible(eng, *copies) -> None:
    """Scale a random vocoder's last convolution so that a served request has
    a real waveform: weights drawn at the JAX package's init give well under
    1 LSB.  HiFi-GAN: the waveform's RMS to 0.1 (about 3,300 LSB; tanh is
    linear that close to 0).  iSTFTNet: the RMS of the log-magnitudes (and
    of the phase head's input) to 0.5, since a flat spectrum windowed by
    Hann gives almost nothing.  ``copies`` (the same weights on the CPU) get
    the same scale.  A check in LSB then sees the waveform, not rounding
    around zero.  The engine's bucket estimator is left as it was."""
    mels = []
    real, state = eng.vocoder, estimator(eng)
    eng.vocoder = lambda mel: (mels.append(mel), real(mel))[1]
    try:
        eng.synthesize(REQUESTS[1])
    finally:
        eng.vocoder = real
        set_estimator(eng, state)

    def level():
        out = real(mels[0])
        x = out if eng.vocoder_kind == "hifigan" else torch.log(out[0])
        return float(x.pow(2).mean().sqrt())

    before = level()
    scale = (0.1 if eng.vocoder_kind == "hifigan" else 0.5) / before
    with torch.no_grad():
        for e in (eng, *copies):
            e.vocoder.conv_post.weight.mul_(scale)
            e.vocoder.conv_post.bias.mul_(scale)
    log(f"vocoder gain ({eng.vocoder_kind}): conv_post x {scale:.4g}: "
        f"rms {before:.3g} -> {level():.3g}")


# --- 7. audio ops --------------------------------------------------------------------------

AUDIO_BATCH, AUDIO_SECONDS = 8, 13  # serving size: a batch of 13-second waveforms


def audio_ops() -> None:
    """The log-mel, the STFT energy and the inverse STFT on CUDA against the
    CPU on the same inputs, and the inverse STFT twice on CUDA, bit-equal."""
    from e2e_tts_tpu_torch.audio import MelParams, inverse_stft, mel_spectrogram

    g = torch.Generator().manual_seed(1)
    n = AUDIO_SECONDS * 22050
    t = torch.arange(n, dtype=torch.float32) / 22050.0
    audio = 0.5 * torch.sin(2 * np.pi * 220.0 * t) + 0.1 * torch.randn(AUDIO_BATCH, n, generator=g)
    p = MelParams()
    gpu = audio.cuda()
    mel_g, e_g = mel_spectrogram(gpu, p, return_energy=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mel_c, e_c = mel_spectrogram(audio, p, return_energy=True)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    mae = float((mel_g.cpu() - mel_c).abs().mean())
    emax = float((e_g.cpu() - e_c).abs().max())
    log("audio mel_spectrogram " + json.dumps(dict(
        shape=list(audio.shape), mae=mae, energy_max_err=emax,
        cuda_ms=round(time_ms(lambda: mel_spectrogram(gpu, p)), 4), cpu_ms=round(cpu_ms, 3))))
    if not (mae < LOGMEL_MAE and emax < ENERGY_TOL):
        raise AssertionError(f"mel_spectrogram: MAE {mae} (bar {LOGMEL_MAE}), energy max "
                             f"{emax} (bar {ENERGY_TOL})")
    for n_fft, hop, win in ((16, 4, 16), (1024, 256, 1024)):
        frames = n // hop + 1
        mag = torch.exp(torch.randn(AUDIO_BATCH, n_fft // 2 + 1, frames, generator=g))
        phase = (torch.rand(mag.shape, generator=g) * 2 - 1) * np.pi
        mg, pg = mag.cuda(), phase.cuda()
        out = inverse_stft(mg, pg, n_fft, hop, win)
        again = inverse_stft(mg, pg, n_fft, hop, win)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = inverse_stft(mag, phase, n_fft, hop, win)
        cpu_ms = 1e3 * (time.perf_counter() - t0)
        err = float((out.cpu() - ref).abs().max()) if out.shape == ref.shape else float("inf")
        same = torch.equal(out, again)
        log("audio inverse_stft " + json.dumps(dict(
            n_fft=n_fft, hop=hop, win=win, shape=list(mag.shape), max_err=err,
            bit_equal_twice=same, cuda_ms=round(time_ms(lambda: inverse_stft(mg, pg, n_fft, hop,
                                                                             win)), 4),
            cpu_ms=round(cpu_ms, 3))))
        if not err < ISTFT_TOL or not same:
            raise AssertionError(f"inverse_stft {(n_fft, hop, win)}: max err {err} (bar "
                                 f"{ISTFT_TOL}), bit-equal twice {same}")


# --- 8. iSTFTNet serve ---------------------------------------------------------------------

def istft_serve(hifigan_rows) -> float:
    """The iSTFTNet engine at default width answers the requests through the
    kernel (held to its plain version on the inputs it got); its RTF beside
    the HiFi-GAN engine's; the longest request against the same engine on the
    CPU.  Returns the kernel's largest error on those inputs."""
    from e2e_tts_tpu_torch.kernels.flash_attention import flash_attention
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

    eng = SynthesisEngine.from_random(seed=0, vocoder_kind="istft")
    make_audible(eng)
    for text in REQUESTS:  # warm-up pass, not counted
        eng.synthesize(text)
    rows = []
    with recorded_inputs() as seen:
        for text in REQUESTS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            audio = eng.synthesize(text)
            sec = time.perf_counter() - t0
            dur = len(audio) / eng.sample_rate
            rows.append(dict(chars=len(text), audio_s=round(dur, 3), seconds=round(sec, 4),
                             rtf=round(sec / dur, 5)))
            log("istft serve " + json.dumps(rows[-1]))
    launches = flash_attention.launches
    log(f"istft serve: launches {{'flash_attention': {launches}}}")
    if launches <= 0:
        raise AssertionError("the iSTFTNet serving run never launched flash_attention")
    err = check_serving_inputs(seen, "iSTFTNet serving")
    for h, i in zip(hifigan_rows, rows):
        log("istft vs hifigan " + json.dumps(dict(
            chars=i["chars"], istft_s=i["seconds"], hifigan_s=h["seconds"], istft_rtf=i["rtf"],
            hifigan_rtf=h["rtf"], ratio=round(i["seconds"] / h["seconds"], 4))))
    serve_parity(eng, "istft", gain=True)
    return err


# --- 9. streaming --------------------------------------------------------------------------

STREAM_CHUNK, STREAM_HALO, STREAM_FRAMES = 64, 16, 600


def streaming(eng, cpu) -> float:
    """``StreamingVocoder`` (chunk 64, halo 16) against the full vocoder pass on
    a 600-frame mel; ``stream_synthesize`` of the longest request, the kernel
    held to its plain version on the inputs it got there (returns the largest
    error), and the streamed audio against the same call on ``cpu``, the
    engine of the same weights on the CPU.

    The full pass runs over the mel and the halo's zero frames after it: the
    last segment holds those zeros past the end, and a convolution over them
    reaches back into the last valid frames, so the full pass of the mel
    alone differs in its last frame or so (logged beside)."""
    from e2e_tts_tpu_torch.kernels.flash_attention import flash_attention
    from e2e_tts_tpu_torch.serve import StreamingVocoder, stream_synthesize

    g = torch.Generator().manual_seed(2)
    mel = (torch.randn(STREAM_FRAMES, 80, generator=g) * 0.5 - 4.0).cuda()
    n = STREAM_FRAMES * eng.hop_length

    def full_pass(m):
        with torch.no_grad():
            a = torch.clamp(eng.vocoder(m[None])[0, :n] * 32767.0, -32768, 32767)
        return a.to(torch.int16).cpu().numpy().astype(np.int32)

    full = full_pass(torch.cat([mel, torch.zeros(STREAM_HALO, 80, device=mel.device)]))
    alone = full_pass(mel)
    streamed = StreamingVocoder(eng.vocoder, eng.hop_length, STREAM_CHUNK, STREAM_HALO).vocode(mel)
    if len(streamed) != len(full):
        raise AssertionError(f"streaming: length {len(streamed)} != {len(full)}")
    d = np.abs(streamed.astype(np.int32) - full)
    d_alone = np.abs(streamed.astype(np.int32) - alone).reshape(STREAM_FRAMES, -1).max(1)
    log(f"streaming vocoder: {STREAM_FRAMES} frames in chunks of {STREAM_CHUNK} (halo "
        f"{STREAM_HALO}) vs the full pass: max|diff| {d.max()} LSB (signal mean|x| "
        f"{np.abs(full).mean():.1f}); vs the pass without the trailing zeros: frames over "
        f"1 LSB {np.flatnonzero(d_alone > 1).tolist()}")
    if d.max() > 1:
        raise AssertionError(f"streaming: max|diff| {d.max()} LSB > 1")

    text = REQUESTS[-1]
    list(stream_synthesize(eng, text))  # warm-up, not counted
    torch.cuda.synchronize()
    with recorded_inputs() as seen:
        t0 = time.perf_counter()
        first, chunks = None, []
        for chunk in stream_synthesize(eng, text):
            if first is None:
                first = time.perf_counter() - t0
            chunks.append(chunk)
        total = time.perf_counter() - t0
    launches = flash_attention.launches
    got = np.concatenate(chunks)
    log("stream_synthesize " + json.dumps(dict(
        chars=len(text), audio_s=round(len(got) / eng.sample_rate, 3), chunks=len(chunks),
        first_chunk_s=round(first, 4), total_s=round(total, 4),
        first_share=round(first / total, 4), launches={"flash_attention": launches})))
    if launches <= 0:
        raise AssertionError("stream_synthesize never launched flash_attention")
    err = check_serving_inputs(seen, "stream_synthesize")
    t0 = time.perf_counter()
    want = np.concatenate(list(stream_synthesize(cpu, text)))
    lsb_diff(f"stream_synthesize, CUDA vs CPU engine ({time.perf_counter() - t0:.1f} s)",
             got, want)
    return err


# --- 10. queue ------------------------------------------------------------------------------

N_CALLERS = 16


def burst(srv, texts):
    """``texts`` submitted to a running BatchingServer from one thread each,
    released together: (results, seconds, dispatch cycles of this burst)."""
    futures = [None] * len(texts)
    barrier = threading.Barrier(len(texts) + 1)

    def go(i):
        barrier.wait(timeout=60)
        futures[i] = srv.submit(texts[i])

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(texts))]
    for th in threads:
        th.start()
    cycles = srv.n_cycles
    torch.cuda.synchronize()
    barrier.wait(timeout=60)
    t0 = time.perf_counter()
    for th in threads:
        th.join(timeout=60)
        if th.is_alive():
            raise AssertionError("queue: a caller thread did not submit")
    outs = [f.result(timeout=300) for f in futures]
    return outs, time.perf_counter() - t0, srv.n_cycles - cycles


def queue(eng) -> float:
    """16 callers at once through a running BatchingServer against the same
    16 requests one after another: each result against its solo run,
    throughput in audio seconds per wall second, and the device busy share of
    each; beside them the queue's one dispatch made on this thread without
    the queue.  The server is warmed by one burst first: its worker thread's
    first kernels (library handles made per thread) are start-up, not
    throughput.  The kernel is held to its plain version on the inputs the
    counted burst gave it; returns the largest error."""
    from e2e_tts_tpu_torch.kernels.flash_attention import flash_attention
    from e2e_tts_tpu_torch.serve import BatchingServer

    texts = [REQUESTS[i % len(REQUESTS)] for i in range(N_CALLERS)]
    with BatchingServer(eng, max_wait_ms=20.0) as srv:
        _, first_s, _ = burst(srv, texts)  # warm-up burst, not counted
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solo = [eng.synthesize(t) for t in texts]
        serial_s = time.perf_counter() - t0

        with recorded_inputs() as seen:
            outs, queue_s, cycles = burst(srv, texts)
        launches = flash_attention.launches
        worst = max(lsb_diff(f"queue request {i} ({len(t)} chars) vs solo", o, s)
                    for i, (t, o, s) in enumerate(zip(texts, outs, solo)))
        if launches <= 0:
            raise AssertionError("the queued run never launched flash_attention")
        err = check_serving_inputs(seen, "queue")
        if not cycles < N_CALLERS:
            raise AssertionError(f"queue: {cycles} dispatch cycles for {N_CALLERS} requests")

        # the queue's dispatch without the queue: the callers' text work,
        # then every chunk through the engine's batched path on this thread
        t0 = time.perf_counter()
        seqs, speakers = [], []
        for t in texts:
            chunks, spk = eng.prepare_request(t)
            seqs += chunks
            speakers += [spk] * len(chunks)
        prepare_s = time.perf_counter() - t0
        batched = lambda: eng._synthesize_sequences(seqs, speakers, 1.0, 1.0, 1.0)  # noqa: E731
        batched()  # its batch shapes once, not counted
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batched()
        batched_s = time.perf_counter() - t0

        profiled = {}
        for name, fn in (("serial", lambda: [eng.synthesize(t) for t in texts]),
                         ("queue", lambda: burst(srv, texts)), ("batched", batched)):
            busy = device_busy(fn)
            if busy is not None:  # the kernel count shows whether the worker's were seen
                kernels, host = busy.pop("kernels"), busy.pop("host")
                profiled[name] = dict(busy, kernel_launches=sum(k[2] for k in kernels),
                                      flash_launches=sum(k[2] for k in kernels
                                                         if "flash_fwd" in k[0]),
                                      host_top=[dict(name=k[0][:40], ms=k[1], n=k[2])
                                                for k in host[:6]])
    audio_s = sum(len(a) for a in solo) / eng.sample_rate
    log("queue " + json.dumps(dict(
        callers=N_CALLERS, audio_s=round(audio_s, 3), cycles=cycles,
        launches={"flash_attention": launches}, worst_mean_lsb=round(worst, 4),
        serial_s=round(serial_s, 4), queue_s=round(queue_s, 4), batched_s=round(batched_s, 4),
        serial_audio_s_per_s=round(audio_s / serial_s, 3),
        queue_audio_s_per_s=round(audio_s / queue_s, 3),
        batched_audio_s_per_s=round(audio_s / batched_s, 3), first_burst_s=round(first_s, 4),
        prepare_s=round(prepare_s, 4), profiled=profiled)))
    return err


# --- 11. Synthesizer and denoiser -------------------------------------------------------------

def synthesizer_and_denoiser(eng, cpu) -> float:
    """The Synthesizer's wav read back equals the engine's int16 for the same
    text and buckets; its speed=1.25 file is about 1/1.25 as long; the
    denoised request, which launches the kernel (held to its plain version
    on the inputs it got; returns the largest error), on CUDA against the CPU
    engine."""
    from e2e_tts_tpu_torch.kernels.flash_attention import flash_attention
    from scipy.io import wavfile

    from e2e_tts_tpu_torch.serve import Synthesizer

    text = REQUESTS[1]
    with tempfile.TemporaryDirectory() as out_dir:
        synth = Synthesizer(eng, output_dir=out_dir)
        state = estimator(eng)
        path = synth.synthesis(text)
        set_estimator(eng, state)
        want = eng.synthesize(synth.normalize(text))
        sr, got = wavfile.read(path)
        if sr != eng.sample_rate or not np.array_equal(got, want):
            raise AssertionError(f"Synthesizer wav ({sr} Hz, {len(got)}) != engine int16 "
                                 f"({len(want)})")
        fast_path = synth.synthesis(text, speed=1.25)
        _, fast = wavfile.read(fast_path)
        ratio = len(fast) * 1.25 / len(got)
        log(f"synthesizer: {os.path.basename(path)} equals the engine's int16 ({len(got)} "
            f"samples); speed 1.25: {len(fast)} samples, x1.25 / plain = {ratio:.4f}")
        if abs(ratio - 1.0) > 0.05:
            raise AssertionError(f"speed 1.25 length ratio {ratio}")

    text = REQUESTS[1]
    set_estimator(cpu, estimator(eng))
    with recorded_inputs() as seen:
        den_g = eng.synthesize_denoised(text)
    launches = flash_attention.launches
    if launches <= 0:
        raise AssertionError("synthesize_denoised never launched flash_attention")
    err = check_serving_inputs(seen, "synthesize_denoised")
    den_c = cpu.synthesize_denoised(text)
    lsb_diff(f"synthesize_denoised ({len(text)} characters, {launches} kernel launches on "
             f"CUDA), CUDA vs CPU", den_g, den_c)
    return err


def device_busy(fn):
    """``fn()`` under ``torch.profiler``: wall ms, device busy ms and share, and
    the kernels' device times by name; None when the profiler shows no device
    time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    dev_ms = lambda e: getattr(e, "self_device_time_total", 0.0) / 1e3  # noqa: E731
    busy_ms = sum(dev_ms(e) for e in kernels)
    if busy_ms <= 0:
        log("profile: the profiler shows no device time: device busy share not measured")
        return None
    host = sorted((e for e in events if str(e.device_type).endswith("CPU")),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    return dict(wall_ms=round(wall_ms, 3), device_busy_ms=round(busy_ms, 3),
                busy_share=round(busy_ms / wall_ms, 4),
                kernels=[(e.key, round(dev_ms(e), 3), e.count) for e in
                         sorted(kernels, key=dev_ms, reverse=True)],
                host=[(e.key, round(e.self_cpu_time_total / 1e3, 3), e.count) for e in host])


def profile(eng, text: str) -> None:
    """Where one request's time goes: device busy share and the kernels that
    take most device time (after the counted runs)."""
    busy = device_busy(lambda: eng.synthesize(text))
    if busy is None:
        return
    kernels = busy.pop("kernels")
    busy.pop("host")
    ours = [k for k in kernels if "flash_" in k[0]]  # the port's kernels, by name
    log("profile " + json.dumps(dict(
        chars=len(text), **busy, kernel_launches=sum(k[2] for k in kernels),
        port_kernels=[dict(name=k[0][:60], ms=k[1], n=k[2]) for k in ours],
        top=[dict(name=k[0][:90], ms=k[1], n=k[2]) for k in kernels[:10]])))


def main() -> int:
    environment()
    build()
    attn = check_attention()
    path_parity()
    eng, launches, serve_err, serve_rows = serve()
    make_audible(eng)
    cpu = serve_parity(eng, gain=True)
    state = estimator(eng)  # phase 12 profiles from here, as before the new phases
    audio_ops()
    path_errs = [serve_err, istft_serve(serve_rows), streaming(eng, cpu), queue(eng),
                 synthesizer_and_denoiser(eng, cpu)]
    set_estimator(eng, state)
    profile(eng, REQUESTS[-1])
    main_row = attn[2]  # the decoder's largest bucket
    kernels = [dict(
        name="flash_attention", route="cuda",
        source="e2e_tts_tpu_torch/kernels/csrc/flash_attention.cu",
        replaces="e2e_tts_tpu/kernels/flash_attention.py:106",
        launches=launches["flash_attention"],
        max_abs_err=max(*path_errs, *(r["err"] for r in attn)),
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
