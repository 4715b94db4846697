"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. environment: the card's name and power limit, torch/CUDA versions, TF32 off;
2. build: every CUDA kernel of the port, compiled from the sources here, with
   the compiler's register and spill counts;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   main paths' shapes, with its time, the plain version's, a library call's
   (yardstick only) and the least time the card could take for the work
   (``bound_ms``; for float32 attention at the bar's precision, the lesser of
   the float32-FMA and the 3xTF32 tensor-core bound); attention also in
   bfloat16 and float16 (the kernel's 16-bit form, within one ulp of the
   plain version: ``ulp_error``; bound at the dense bf16 rate, 2 bytes an
   element; SDPA in the same dtype), where both 16-bit kernels
   (``flash_fwd_16_sm90`` where D % 8 == 0, and ``flash_fwd_16``), each
   forced, are held to the plain version and timed in turns; every time is
   the event time over back-to-back calls beside the device time per call
   from ``torch.profiler`` (``device_ms``); the training kernels (MAS, the CTC
   forward and backward) at the training buckets (32, 128, 768) and (32, 256,
   1024), ragged, with edge rows, beside their serial-depth floor (the
   longest row's frames x one shared-memory-and-barrier round at the
   kernels' block size, timed by a probe kernel: ``barrier_round_ns``);
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
12. training: the default-width FastSpeech2 with its aligner, from
   ``torch.Generator().manual_seed(0)`` and ``use_flash=False``, on a batch of
   32 made with numpy from seed 0 in the JAX ``_collate`` layout at the (128,
   768) bucket: one step on CUDA against one on the CPU (4 rows, dropout 0,
   step 30000: loss terms, gradients, durations); 5 timed ``make_train_step``
   steps at step 0 and 5 at step 30000 with dropout on (finite losses; MAS
   and the CTC forward and backward launched once a step each, and held to
   their plain versions on the inputs the steps gave them); ``make_eval_step``
   twice, equal; one step at step 0 and one at step 30000 under
   ``torch.profiler``, and the kernels whose time differs most between them;
13. vocoder GAN training: HiFi-GAN V1 (512 channels) in its training form,
   MPD and MSD at reference widths and the GAN optimizers, all from torch
   seed 0, on a numpy batch of 16 x 32 frames (8192 samples) of random
   log-mels and speech-level audio: one ``make_vocoder_train_step`` step on
   CUDA against the CPU (2 rows: metrics; every gradient, from Adam's first
   moments, held to the float64 oracle: the same step on the CPU in float64,
   the card no farther from it than max(1e-3, 2 x the CPU's float32)); 5
   timed steps (step ms, audio seconds trained a second,
   peak memory, finite metrics); one step under ``torch.profiler``; then 2
   steps of the iSTFTNet variant;
14. joint e2e fine-tune: phase 12's model and batch with HiFi-GAN V1, MPD/MSD
   and aligned audio: one ``make_e2e_train_step`` step on CUDA against the
   CPU (4 rows, dropout 0, step 30000, the crop starts handed in: metrics,
   and every gradient held to the float64 oracle as in phase 13; the
   acoustic activations' distance from float64, and each operation class
   alone at encoder layer 0 on the float64 run's input: ``op_class_distances``); 5 timed
   steps (MAS and the
   CTC forward and backward once a step each, held to their plain versions
   on the steps' own inputs); one step under ``torch.profiler``;
15. bundle: ``SynthesisEngine.from_checkpoint`` of ``assets/bundles/vie_tiny``
   on CUDA serves the requests, each against the same bundle on the CPU; the
   training generator warm-started from the bundle's vocoder tree gives the
   serving vocoder's waveform;
16. bfloat16 serving: ``from_random(seed=0, dtype=torch.bfloat16)`` at default
   width, at batch 8 and 32, beside the float32 engine of the same batch
   (request seconds, RTF, a profile of the longest request each): the
   launches of ``flash_fwd_16_sm90`` (the plan's kernel at heads of 192)
   must rise and the float32 form's stay 0, and both 16-bit kernels are held
   to the plain version on the inputs the path gave; the longest request
   against the CPU in bfloat16 and float32 on one set of durations (mean LSB
   no more than the CPU's own bf16-vs-f32 gap); ``stream_synthesize`` and 16
   callers through a ``BatchingServer`` over the bfloat16 engine;
17. profile: one long request under ``torch.profiler`` (device busy share,
   the kernels that take most device time, the port's own kernels' time);
18. corpus to voice: a synthetic corpus (2 speakers x 24 sentences, f0
   jitter 0.1, seed 0) through the port's data preparation, its features on
   the card held to the same on the CPU (log-mel MAE and energy at phase 7's
   bars, f0 and pitch equal), bucketed batches of 16, phase 12's parity on
   the first corpus batch, 10 default-width train steps on the corpus
   batches (MAS and the CTC kernels once a step, held to their plain
   versions on the steps' inputs), a checkpoint after step 5 restored into
   a fresh model (Adam moments bit-equal; step 6 within the train bars), 2
   HiFi-GAN V1 GAN steps with MPD/MSD on corpus batches of 16 x 8192
   samples, the trained models written as a bundle and served on the card
   against the CPU (1 LSB mean); the preparation rate, the batcher's host
   ms a batch against the step ms at each bucket, and the checkpoint's
   save and restore ms, each beside the card's name and power limit; then
   ROADMAP C5: the std of ``vie_tiny``'s decoder attention logits on a
   golden text, and the 16-bit kernels' ulp error on those inputs
   (measured, not a bar);
19. the training CLI, corpus to voice: phase 18's corpus through
   ``python -m e2e_tts_tpu_torch.train.cli`` (called in this process) at the
   default width: ``prepare`` -> ``acoustic`` (8 steps, a checkpoint and a
   validation every 4) -> ``vocoder`` (2) -> ``acoustic`` resumed to step 10
   -> ``e2e`` (2, ``--am-lr-scale 0.1 --adv-warmup 2``) -> ``generate-mels``
   -> ``vocoder --predicted-mels`` (resumed, 1) -> ``export``, the voice
   served on the card against the CPU (1 LSB mean; flash launched); MAS and
   the CTC forward and backward once a train step (and MAS and the CTC
   forward once a validation batch), held to their plain versions on the
   steps' inputs; then ``--supervised`` on the corpus labelled with its
   durations (prepare, 4 acoustic steps, 1 GAN step, export, served against
   the CPU; no MAS or CTC launch); each subcommand's seconds, the acoustic
   loop's wall ms a step with its prefetch thread beside the same steps on
   batches made before, and the device busy share of one profiled step of
   the loop, beside the card's name and power limit;
20. block families: the conformer, fastformer, long-short transformer and
   reformer at the default width (the schema's settings of each family, 6 +
   6 layers at hidden 384; weights from seed 0): (a) ``from_random(seed=0,
   config=...)`` on the card serves the four requests (request ms, the
   busy share of the longest), each against the same weights on the CPU
   from one bucket-estimator state: durations equal, the mel within
   MEL_TOL, the shortest request's int16 within LSB_TOL mean (the CPU
   engine runs its vocoder for that one only); flash launched 0 times, as
   the JAX package's families reach no Pallas kernel; (b) phase 12's parity
   step on 4 rows of its batch, CUDA against the CPU with its MAS-tie and
   relu-tie replays, and the BatchNorm statistics after it within
   TRAIN_LOSS_RTOL; one step at B = 32 with ``remat_blocks`` false and one
   with it true, each after a warm-up (step ms, peak memory; MAS and the
   CTC kernels once a step, held to their plain versions on the first
   family's inputs); (c) the bfloat16 engine on the longest request against
   the CPU in bfloat16 and float32 on its durations: the mel's mean |diff|
   from the CPU's bfloat16 within the CPU's own bfloat16-vs-float32 gap
   (phase 16's bar, on the mel), the log-durations at 2 x the model's own
   error, flash 0; (d) ``prepare`` and ``acoustic`` for 2 steps through the
   training CLI on phase 18's corpus with a conformer config;
21. the router, voice conversion, reference import and scoring:
   ``synthesizer.Synthesizer(device="cuda")`` over the three checked-in
   bundles serves one sentence a language (the Vietnamese one at a mel
   bucket >= 256: flash launches must rise), each wav within LSB_TOL mean of
   the same router on the CPU, request seconds and RTF per language
   (``measure_rtf``); ``KnnVoiceConverter`` in ppg mode at prosody weights 0
   and 1 on ``vie_tiny`` and at default width against the CPU on the same
   mels (the share of frames matched to the CPU's target frames, ties within
   VC_TIE apart, >= VC_AGREE; the mel on the frames that agree within
   MEL_TOL, the CPU's converted mel vocoded on both within VC_WAV_MAE;
   ``convert_mel`` and ``convert`` ms, ``convert``
   rendering with the engine's vocoder); random reference-layout
   ``state_dict``s of the default-width transformer and HiFi-GAN V1 saved
   with ``torch.save`` and imported through ``compat`` onto the card and the
   CPU, one request against the CPU (durations equal, mel within MEL_TOL,
   int16 within LSB_TOL mean); ``LearnedMosScorer`` on every anchor within
   MOS_TOL of the CPU (ms a window); one ``device_trace`` of a router request;
22. mixed precision and the engine's serving options: (a) the default-width
   FastSpeech2 built in bfloat16 (float32 parameters): phase 12's parity
   shape on the card, on the CPU in bfloat16 and on the CPU in float64
   (the oracle), every loss term and gradient within max(2 x the CPU
   bfloat16 run's distance, 2**-8) of float64 (``bf16_oracle``; the CPU
   runs on the card's alignment and relu decisions), then phase 12's B = 32
   step timed in turns beside float32 (ms, peak memory, busy share), MAS
   and the CTC forward and backward launched once a step on float32 inputs
   and held to their plain versions; (b) the bfloat16 HiFi-GAN V1 training
   form with MPD/MSD in float32: phase 13's parity rows by the same oracle
   (gradients from Adam's first moments), then phase 13's step in turns
   beside float32; (c) the training CLI with ``train.mixed_precision: true``
   on phase 18's corpus: ``acoustic`` (a bfloat16 model, float32 in its
   checkpoint; the loop's ms a step), ``e2e`` one step with that config and
   with float32 (float32 models both times, the first metrics equal); (d)
   the 343-character request in float32 and bfloat16: ``use_folded_vocoder``
   against the generator (vocoder ms and device ms; int16 within LSB_TOL
   mean), ``transfer_codec="mulaw8"`` against int16 (the device-to-host
   copy ms and bytes, request seconds), ``use_flash=False`` against the
   default (request seconds; flash launches 0 and > 0), the flash kernels
   held to their plain version on the requests' inputs;
23. data parallelism (``data_parallel``): ``torch.cuda.device_count()``; an
   engine with ``serving_devices=1`` gives the longest request bit-equal to
   the default engine, and ``serving_devices=2`` raises ``ValueError`` on
   one card; then two ranks share the card, processes of their own started
   by this phase (``--dp-rank``; gloo, printed, since NCCL takes a card a
   rank, so NCCL is not exercised here): a ``global_mesh`` engine on the
   longest request (the ranks' int16 equal, within LSB_TOL mean of the
   one-process engine; flash held to its plain version on each rank's
   inputs), and one data-parallel step each of phase 12's acoustic step (B =
   32 global at (128, 768), ragged lengths, the postnet's BatchNorm in train
   mode), phase 13's vocoder GAN step and phase 14's e2e step (crop starts
   handed in), dropout off, on each rank's rows, held to the single-process
   step on the whole batch (metrics within TRAIN_LOSS_RTOL; every gradient,
   from Adam's first moments, within TRAIN_GRAD_RTOL of the single-process
   step's, and for the two GAN steps by phase 13's float64 oracle rule with
   the same step in float64 on the card as the oracle and the
   single-process step in the CPU's role); MAS's alignment held to the
   single-process run's off ties; parameters bit-equal on the ranks;
   MAS and the CTC kernels once a step, held to their plain versions on the
   ranks' inputs), and each kind's ms a step beside the single-process
   step's (two ranks on one card measure the code path, not scaling); a rank
   that fails or outlasts DP_TIMEOUT_S fails the run;
24. tensor parallelism (``tensor_parallel``): two ranks share the card at
   (data 1, model 2) (``--tp-rank``; gloo): the default-width acoustic
   model's eval forward on the longest request's first batch, split by
   ``parallelize``, against the unsplit forward (durations equal, mel within
   MEL_TOL, the flash kernel on each rank's local heads, held to its plain
   version on their inputs); then phase 23's three steps on the whole batch
   with the wide weights split (``dp_kind`` with the model axis): metrics
   within TP_LOSS_RTOL, gradients as phase 23 (the shards gathered), each
   update within TRAIN_GRAD_RTOL over the entries whose gradients agree
   within TP_ENTRY_RTOL, the replicated parameters bit-equal on the ranks,
   MAS and the CTC kernels once a step a rank; each rank's step ms beside
   the single-process step's, its parameter counts and peak memory beside
   the single-process step's;
25. a JSON line of every kernel (the flash kernel's float32 form and its two
   16-bit kernels apart), then the JSON result as the last line.

Each path that launches kernels (phases 5, 8, 9, 10, 11, 12, 14, 15, 16, 18,
19, 20, 21, 22, 23 and 24) is driven with the launch counts set to 0 just before it and read
just after, and each kernel is held against its plain version on the first
inputs that path gave it (``recorded_inputs``, ``recorded_train_inputs``); a serving path
runs with its CUDA graphs live, and each module call that replayed one is run again eagerly
on its inputs, to the same bits, which also gives the kernel the replay's inputs.  The kernels' JSON line
counts the serving run's launches of flash attention (phases 5, 21, 22, 23 and 24's of
the float32 form, phase 16's batch-8 run's and phase 22's bfloat16 requests' of
each 16-bit kernel) and phases 12, 14, 18, 19, 20, 22, 23 and 24's of the training
kernels (19, 20 and 22: their train steps'; 23 and 24: both ranks' parallel steps).  From phase 6 on, the random
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
import re
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
PEAK_BF16_FLOPS = 989e12  # dense bfloat16 and float16 on the tensor cores
PEAK_BYTES = 3.35e12

ATTN_TOL = 2e-5    # max |kernel - plain| on valid rows (the JAX kernel test's bar)
MEL_TOL = 1e-3     # postnet mel max |CUDA - CPU| at default width
TIE = 1e-4         # a duration may differ only where exp(log_d) - 1 is this close to x.5
LOGMEL_MAE = 1e-4  # log-mel mean |CUDA - CPU|
ENERGY_TOL = 2e-2  # STFT energy max |CUDA - CPU| (a norm over 513 bins)
ISTFT_TOL = 1e-4   # inverse STFT max |CUDA - CPU|
LSB_TOL = 1.0      # int16 mean |diff| between two runs of one request
CTC_RTOL = 1e-5    # CTC kernel loss against its plain version, relative
CTC_GRAD_TOL = 1e-5  # CTC kernel gradient max |diff| against the plain one, x max |grad|
# CUDA against CPU, one training step at default width: float32 sums in
# another order through 12 layers, and atomics in the embedding and gather
# backward passes (their sums change order from run to run)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
MAS_TIE = 1e-2     # durations may differ only where a MAS decision on the path is this close
RELU_TIE = 1e-4    # a relu may decide otherwise only where its input is this close to 0, x max |input|


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


def device_ms(fn, iters: int = 20, tries: int = 3) -> float:
    """Device time of one call of ``fn``: the durations of the kernels that
    ``torch.profiler`` records over ``iters`` calls (after one warm-up call),
    summed, over ``iters``.  Unlike ``time_ms`` over back-to-back calls, it
    leaves out the host's cost per call, which sets the event time of a
    small kernel.  A profiler run now and then records no kernel at
    all; it is run again, up to ``tries`` times, and then this raises."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if str(e.device_type).endswith("CUDA"))
        if us > 0:
            return us / iters / 1e3
        log(f"device_ms: the profiler recorded no kernel (run {attempt + 1} of {tries})")
    raise AssertionError(f"the profiler shows no device time in {tries} runs")


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

KERNELS = ("flash_attention", "mas", "ctc")  # the sources under kernels/csrc


def build() -> None:
    """Every source at once: one process (one nvcc) each, all started
    together, then each library loaded here."""
    from e2e_tts_tpu_torch.kernels.build import compiler_log, library

    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen([sys.executable, "-c", "import sys; from e2e_tts_tpu_torch.kernels."
                               "build import library; library(sys.argv[1])", name], cwd=here)
             for name in KERNELS]
    failed = [name for name, p in zip(KERNELS, procs) if p.wait() != 0]
    if failed:
        raise RuntimeError(f"build failed for {failed}")
    for name in KERNELS:
        library(name)
    log(f"build: {len(KERNELS)} sources in {time.perf_counter() - t0:.1f} s")
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


def attention_bounds_16(D, lens):
    """The 16-bit form's least time (ms) for the same work: 4 D kv_len^2
    flops a head at the dense bfloat16/float16 rate, or 2 bytes an element
    of the valid rows of q, k, v and out (and kv_lens) at HBM3's rate."""
    n = np.asarray(lens, np.float64)
    flops = 4.0 * D * float((n * n).sum())
    t_bytes = (2.0 * 4 * D * float(n.sum()) + 4.0 * len(n)) / PEAK_BYTES
    t_ops = flops / PEAK_BF16_FLOPS
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def attention_errors(out, ref, v, kv):
    """(max |out - ref| over the valid rows, and for 16-bit inputs the bar's
    ``ulp_error``; None for float32)."""
    from e2e_tts_tpu_torch.kernels.flash_attention import ulp_error

    lens = kv.tolist()
    err = max([float((out[b, :n].float() - ref[b, :n].float()).abs().max())
               for b, n in enumerate(lens) if n], default=0.0)
    return err, (None if out.dtype == torch.float32 else ulp_error(out, ref, v, kv))


def check_attention_result(out, ref, v, kv, where: str) -> float:
    """Raise unless ``out`` holds the bar against ``ref``: max error below
    ATTN_TOL in float32, within one ulp (``ulp_error`` <= 1) in 16 bits.
    Returns the max |error|."""
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"flash_attention: non-finite output {where}")
    err, ulp = attention_errors(out, ref, v, kv)
    if ulp is None and not err < ATTN_TOL:
        raise AssertionError(f"flash_attention: max err {err} >= {ATTN_TOL} {where}")
    if ulp is not None and not ulp <= 1.0:
        raise AssertionError(f"flash_attention ({out.dtype}): {ulp} ulp from the plain version "
                             f"{where}")
    return err


def check_attention():
    """Each shape in float32, bfloat16 and float16.  In 16 bits both kernels
    of the form, each forced, are held to the plain version and timed in
    turns (mma_sync, sm90, sm90, mma_sync; ``flash_fwd_16_sm90`` only where
    D % 8 == 0); ``kernel_ms``/``kernel_dev_ms`` time the kernel the plan
    takes (``kernel``).  Every time is the event time over back-to-back calls
    (``*_ms``) beside the device time per call (``*_dev_ms``)."""
    from e2e_tts_tpu_torch.kernels.flash_attention import (
        HALF, attention_plain, flash_attention, plan_kernel_16)

    g = torch.Generator().manual_seed(0)
    rows = []
    for BH, T, D, lens in ATTN_SHAPES:
        q32 = (torch.randn(BH, T, D, generator=g) * 0.3).cuda()
        k32 = (torch.randn(BH, T, D, generator=g) * 0.3).cuda()
        v32 = torch.randn(BH, T, D, generator=g).cuda()
        kv = torch.tensor(lens, dtype=torch.int32).cuda()
        mask = (torch.arange(T, device="cuda")[None, :] < kv[:, None])[:, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            out = flash_attention(q, k, v, kv)
            torch.cuda.synchronize()
            ref = attention_plain(q, k, v, kv)
            err = check_attention_result(out, ref, v, kv, f"at {(BH, T, D)}")
            call = lambda: flash_attention(q, k, v, kv)  # noqa: E731
            library = lambda: sdpa(q, k, v, attn_mask=mask)  # noqa: E731
            row = dict(
                shape=(BH, T, D), dtype=str(dtype).split(".")[-1], err=err,
                ulp_error=attention_errors(out, ref, v, kv)[1],
                kernel_ms=time_ms(call), kernel_dev_ms=device_ms(call),
                plain_ms=time_ms(lambda: attention_plain(q, k, v, kv)),
                library_ms=time_ms(library), library_dev_ms=device_ms(library),
            )
            if dtype in HALF:
                row["kernel"] = plan_kernel_16(D)
                names = ["mma_sync"] + (["sm90"] if D % 8 == 0 else [])
                for name in names:
                    out = flash_attention(q, k, v, kv, kernel=name)
                    torch.cuda.synchronize()
                    row[f"{name}_err"] = check_attention_result(out, ref, v, kv,
                                                                f"({name}) at {(BH, T, D)}")
                    row[f"{name}_ulp_error"] = attention_errors(out, ref, v, kv)[1]
                times = {}
                for name in names + names[::-1]:
                    forced = lambda: flash_attention(q, k, v, kv, kernel=name)  # noqa: E731
                    times.setdefault(name, []).append((time_ms(forced), device_ms(forced)))
                for name, t in times.items():
                    row[f"{name}_ms"] = float(np.mean([a for a, _ in t]))
                    row[f"{name}_dev_ms"] = float(np.mean([b for _, b in t]))
            row.update(attention_bounds(D, lens) if dtype == torch.float32
                       else attention_bounds_16(D, lens))
            rows.append(row)
            log("flash_attention " + json.dumps(row))
    return rows


TRAIN_KERNEL_SHAPES = ((32, 128, 768), (32, 256, 1024))  # (B, L, T): the training buckets


def ragged_lengths(rng, B, L, T):
    """Text and mel lengths in [L/2, L] and [T/2, T]: row 0 full, then the
    edge rows text_len 1, text_len 0 and mel_len < text_len."""
    tl = rng.randint(L // 2, L + 1, B)
    ml = rng.randint(T // 2, T + 1, B)
    tl[0], ml[0] = L, T
    tl[1], tl[2] = 1, 0
    tl[3], ml[3] = L, L // 2
    return tl, ml


def training_bounds(tl, ml, B, T, L):
    """Least times (ms) of the three training kernels for these lengths, and
    what bounds each.  Only the valid cells count: text_len x mel_len of MAS's
    input, mel_len frames x (text_len + 1) classes of the CTC's, 2 text_len + 1
    states a frame.  Every output is written whole: MAS's (B, T, L) map, the
    backward's (B, T, L + 1) gradient.  Operations at the float32 rate: 2 a
    MAS cell (an add, a max); 12 a CTC state and frame (three exp, a log and
    the adds and maxes of a three-way log-sum-exp), 4 more for the backward's
    occupancy.  The serial depth of mel_len frames is not in these bounds:
    ``check_training_kernels`` logs it beside them (``barrier_round_ns``)."""
    tl = np.asarray(tl, np.float64).clip(0, L)
    ml = np.asarray(ml, np.float64).clip(0, T)
    lens = 8.0 * B

    def bound(nbytes, flops):
        t_b, t_o = nbytes / PEAK_BYTES, flops / PEAK_FP32_FLOPS
        return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"

    states = float((ml * (2 * tl + 1)).sum())
    ctc_in = 4.0 * float((ml * (tl + 1)).sum())
    return dict(
        mas=bound(4.0 * float((tl * ml).sum()) + 4.0 * B * T * L + lens, 2.0 * float((tl * ml).sum())),
        ctc_fwd=bound(ctc_in + 4.0 * B + lens, 12.0 * states),
        ctc_bwd=bound(ctc_in + 4.0 * B * T * (L + 1) + 8.0 * B + lens, 16.0 * states),
    )


# One dependent round of the serial kernels' recurrence: each thread reads its
# and its left neighbour's value of the last row in shared memory, writes its
# own, and the block meets at __syncthreads (mas.cu and ctc.cu do that once a
# frame).  Timed on the card, it gives the serial-depth floor of a frame.
BARRIER_PROBE = r"""
extern "C" __global__ void barrier_rounds(float* out, int rounds) {
  extern __shared__ float rows[];
  const int n = blockDim.x, j = threadIdx.x;
  rows[j] = (float)j;
  __syncthreads();
  for (int i = 1; i <= rounds; ++i) {
    const float* prev = rows + ((i - 1) & 1) * n;
    rows[(i & 1) * n + j] = fmaxf(prev[j], j > 0 ? prev[j - 1] : -1e30f) + 1.0f;
    __syncthreads();
  }
  if (j == 0) out[blockIdx.x] = rows[(rounds & 1) * n];
}

extern "C" int barrier_launch(float* out, int rounds, int blocks, int threads, void* stream) {
  barrier_rounds<<<blocks, threads, 2 * threads * sizeof(float), (cudaStream_t)stream>>>(
      out, rounds);
  return (int)cudaGetLastError();
}
"""
_BARRIER = {}


def barrier_round_ns(blocks: int, threads: int, rounds: int = 4096) -> float:
    """ns of one dependent shared-memory-and-barrier round of a block of
    ``threads`` threads, ``blocks`` blocks at once: (t(rounds) - t(0)) /
    rounds, each t the event time over back-to-back launches."""
    import ctypes
    import shutil

    from e2e_tts_tpu_torch.kernels.build import _nvcc

    if "lib" not in _BARRIER:
        work = tempfile.mkdtemp(prefix="barrier_probe_")
        src, lib = os.path.join(work, "probe.cu"), os.path.join(work, "probe.so")
        with open(src, "w") as f:
            f.write(BARRIER_PROBE)
        subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                        "-Xcompiler", "-fPIC", "-o", lib, src], check=True)
        _BARRIER["lib"] = ctypes.CDLL(lib)
        shutil.rmtree(work, ignore_errors=True)  # the library stays mapped
    fn = _BARRIER["lib"].barrier_launch
    out = torch.empty(blocks, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def run(n):
        if fn(ctypes.c_void_p(out.data_ptr()), n, blocks, threads, stream) != 0:
            raise RuntimeError("the barrier probe did not launch")

    t = {n: time_ms(lambda n=n: run(n)) for n in (0, rounds)}
    return 1e6 * (t[rounds] - t[0]) / rounds


def check_mas(la, tl, ml, where: str) -> float:
    """The MAS kernel against its plain version: bit-equal, or raise."""
    from e2e_tts_tpu_torch.kernels.mas import mas, mas_plain

    out = mas(la, tl, ml)
    torch.cuda.synchronize()
    ref = mas_plain(la, tl, ml)
    if not torch.equal(out, ref):
        n = int((out != ref).sum())
        raise AssertionError(f"mas: {n} cells differ from the plain version on {where}")
    return 0.0


def check_ctc(lp, kl, ql, where: str, g=None, saved=None):
    """The CTC kernels against their plain versions: (loss max abs err, grad
    max abs err), or raise past CTC_RTOL / CTC_GRAD_TOL.  ``g`` is the
    backward's cotangent (1/B each when None, the batch mean's), ``saved`` the
    (alpha, total) the backward kernel is given (the forward kernel's on these
    inputs when None); the plain versions compute their own from ``lp``."""
    from e2e_tts_tpu_torch.kernels.ctc import ctc_bwd, ctc_bwd_plain, ctc_fwd, ctc_fwd_plain

    if g is None:
        g = torch.full((lp.shape[0],), 1.0 / lp.shape[0], device=lp.device)
    loss, alpha, total = ctc_fwd(lp, kl, ql)
    if saved is not None:
        alpha, total = saved
    grad = ctc_bwd(g, lp, kl, ql, alpha, total)
    torch.cuda.synchronize()
    loss_p, alpha_p, total_p = ctc_fwd_plain(lp, kl, ql)
    grad_p = ctc_bwd_plain(g, lp, kl, ql, alpha_p, total_p)
    if not (torch.isfinite(loss).all() and torch.isfinite(grad).all()):
        raise AssertionError(f"ctc: non-finite kernel output on {where}")
    loss_err = float((loss - loss_p).abs().max())
    rel = float(((loss - loss_p).abs() / loss_p.abs().clamp(min=1e-30)).max())
    grad_err = float((grad - grad_p).abs().max())
    gmax = float(grad_p.abs().max())
    log(f"ctc on {where}: loss max rel err {rel:.3g}, grad max err {grad_err:.3g} "
        f"(max |grad| {gmax:.3g})")
    if not (rel < CTC_RTOL and grad_err < CTC_GRAD_TOL * gmax):
        raise AssertionError(f"ctc on {where}: loss rel err {rel} (bar {CTC_RTOL}), grad err "
                             f"{grad_err} (bar {CTC_GRAD_TOL} x {gmax})")
    return loss_err, grad_err


def check_training_kernels():
    """MAS and the CTC forward/backward against their plain versions at the
    training buckets, with ragged lengths and edge rows; their times, the
    plain versions', ``F.ctc_loss`` forward and forward + backward (yardstick
    only; the port never calls it) and the bounds.  Returns one row per shape."""
    from e2e_tts_tpu_torch.kernels.ctc import ctc_bwd, ctc_bwd_plain, ctc_fwd, ctc_fwd_plain
    from e2e_tts_tpu_torch.kernels.mas import mas, mas_plain
    from e2e_tts_tpu_torch.ops.ctc import lattice_log_probs

    rows = []
    for B, L, T in TRAIN_KERNEL_SHAPES:
        rng = np.random.RandomState(L)
        tl_np, ml_np = ragged_lengths(rng, B, L, T)
        tl = torch.from_numpy(tl_np).to(torch.int32).cuda()
        ml = torch.from_numpy(ml_np).to(torch.int32).cuda()
        la = torch.log_softmax(torch.from_numpy(rng.randn(B, T, L).astype(np.float32) * 3), -1).cuda()
        mas_err = check_mas(la, tl, ml, f"({B}, {L}, {T})")
        lp = lattice_log_probs(torch.from_numpy(rng.randn(B, T, L).astype(np.float32) * 2).cuda(), tl)
        loss_err, grad_err = check_ctc(lp, tl, ml, f"({B}, {L}, {T})")
        _, alpha, total = ctc_fwd(lp, tl, ml)
        _, alpha_p, total_p = ctc_fwd_plain(lp, tl, ml)
        g = torch.full((B,), 1.0 / B, device="cuda")

        lp_lib = lp.detach().transpose(0, 1).requires_grad_()
        targets = torch.cat([torch.arange(1, n + 1) for n in tl_np]).cuda()
        tl64, ml64 = tl.long(), ml.long()
        f_ctc = torch.nn.functional.ctc_loss

        def library_ctc():
            return f_ctc(lp_lib, targets, ml64, tl64, blank=0, reduction="mean",
                         zero_infinity=True)

        def library_ctc_fwd():
            with torch.no_grad():
                library_ctc()

        row = dict(
            shape=(B, L, T), text_lens=tl_np.tolist(), mel_lens=ml_np.tolist(),
            mas_err=mas_err, ctc_loss_err=loss_err, ctc_grad_err=grad_err,
            mas_ms=time_ms(lambda: mas(la, tl, ml)),
            mas_plain_ms=time_ms(lambda: mas_plain(la, tl, ml), iters=2),
            ctc_fwd_ms=time_ms(lambda: ctc_fwd(lp, tl, ml)),
            ctc_fwd_plain_ms=time_ms(lambda: ctc_fwd_plain(lp, tl, ml), iters=2),
            ctc_bwd_ms=time_ms(lambda: ctc_bwd(g, lp, tl, ml, alpha, total)),
            ctc_bwd_plain_ms=time_ms(lambda: ctc_bwd_plain(g, lp, tl, ml, alpha_p, total_p),
                                     iters=2),
            ctc_library_fwd_ms=time_ms(library_ctc_fwd),
            ctc_library_ms=time_ms(lambda: library_ctc().backward()),
        )
        for name, (ms, by) in training_bounds(tl_np, ml_np, B, T, L).items():
            row[f"{name}_bound_ms"], row[f"{name}_bound_by"] = ms, by
        # serial depth: the longest row's frames, one barrier round each, at
        # the kernels' own block sizes (mas: L threads; the CTC: 2L + 1 states)
        frames = int(ml_np.max())
        for name, threads in (("mas", L), ("ctc_fwd", 2 * L + 1), ("ctc_bwd", 2 * L + 1)):
            round_ns = barrier_round_ns(B, min(1024, -(-threads // 32) * 32))
            row[f"{name}_round_ns"] = round_ns
            row[f"{name}_serial_ms"] = frames * round_ns * 1e-6
            row[f"{name}_half_serial"] = row[f"{name}_ms"] <= 2 * row[f"{name}_serial_ms"]
        rows.append(row)
        log("training kernels " + json.dumps({k: v for k, v in row.items()
                                              if k not in ("text_lens", "mel_lens")}))
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
        with torch.no_grad():
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
    """Set the launch counts (every kernel's) to 0 and route the model's kernel
    calls, from any thread, through a hook that keeps a copy of the first
    CUDA inputs at each shape; yields those inputs by shape, for
    ``check_serving_inputs``.  The block runs the main path, the engines'
    CUDA graphs live, so the counts read after it are that run's (a replay
    adds its capture's launches).  A replay calls no hook, so the first
    replayed call of each graphed module at each shape is kept, inputs and
    outputs; after the block each runs again eagerly (``graphs._eager``)
    through the kernel's hook, which keeps its inputs, and its outputs must
    equal the replay's bit for bit.  The counts are left at the block's."""
    import e2e_tts_tpu_torch.nn.transformer as transformer
    from e2e_tts_tpu_torch.kernels.flash_attention import flash_attention
    from e2e_tts_tpu_torch.serve import graphs

    seen, replayed, lock, local = {}, {}, threading.Lock(), threading.local()
    replay = graphs._Graph.replay

    def recording(q, k, v, kv_lens):
        with lock:
            if (q.is_cuda and tuple(q.shape) not in seen
                    and not torch.cuda.is_current_stream_capturing()):
                seen[tuple(q.shape)] = tuple(t.clone() for t in (q, k, v, kv_lens))
        return flash_attention(q, k, v, kv_lens)

    def marked(graph, tensors):
        out = replay(graph, tensors)
        local.replayed = True
        return out

    def keep(module, args, out):  # every module's call: keeps the replayed ones
        if not getattr(local, "replayed", False):
            return
        local.replayed = False
        key = (module, tuple((a.shape, a.dtype) if isinstance(a, torch.Tensor) else a
                             for a in args))
        with lock:
            if key not in replayed:
                replayed[key] = (tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                       for a in args),
                                 tuple(o.clone() for o in graphs._outputs(out)))

    transformer.flash_attention = recording
    graphs._Graph.replay = marked
    hook = torch.nn.modules.module.register_module_forward_hook(keep)
    flash_attention.launches = flash_attention.launches_16 = flash_attention.launches_16_sm90 = 0
    try:
        try:
            yield seen
        finally:
            hook.remove()
            graphs._Graph.replay = replay
        counts = (flash_attention.launches, flash_attention.launches_16,
                  flash_attention.launches_16_sm90)
        with torch.no_grad(), graphs._eager():
            for (module, shapes), (args, outs) in replayed.items():
                with torch.cuda.device(next(module.parameters()).device):
                    want = graphs._outputs(module(*args))
                for o, w in zip(outs, want):
                    if not torch.equal(o, w):
                        diff = float((o.double() - w.double()).abs().max())
                        raise AssertionError(f"{type(module).__name__} at {shapes}: the replay "
                                             f"differs from eager by up to {diff:.3g}")
        log(f"graphs: {len(replayed)} replayed module calls (one a module and shape) equal "
            f"eager on their inputs")
        (flash_attention.launches, flash_attention.launches_16,
         flash_attention.launches_16_sm90) = counts
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
    counted run gave it (``recorded_inputs``); 16-bit inputs through each of
    the form's kernels, forced (``flash_fwd_16_sm90`` where D % 8 == 0)."""
    from e2e_tts_tpu_torch.kernels.flash_attention import HALF, attention_plain, flash_attention

    if not seen:
        raise AssertionError(f"the {path} run gave the kernel no CUDA inputs")
    worst = 0.0
    for shape, (q, k, v, kv) in sorted(seen.items()):
        ref = attention_plain(q, k, v, kv)
        kernels = [None]
        if q.dtype in HALF:
            kernels = (["sm90"] if shape[2] % 8 == 0 else []) + ["mma_sync"]
        for kernel in kernels:
            out = flash_attention(q, k, v, kv, kernel=kernel)
            torch.cuda.synchronize()
            name = "" if kernel is None else f" ({kernel})"
            err = check_attention_result(out, ref, v, kv, f"on {path} inputs {shape}{name}")
            ulp = attention_errors(out, ref, v, kv)[1]
            log(f"flash_attention{name} on {path} inputs {shape} {str(q.dtype)[6:]} kv_lens "
                f"{kv.tolist()}: max err {err:.3g}" + ("" if ulp is None else f", {ulp:.3g} ulp (bar 1)"))
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


# --- 12. acoustic training ---------------------------------------------------------------

TRAIN_B, TRAIN_L, TRAIN_T = 32, 128, 768  # TrainConfig.batch_size; the dataset's (128, 768) bucket
TRAIN_STEPS = 5
TRAIN_SPEAKERS = 4
PARITY_ROWS = 4
# gradients 0 by construction (a softmax does not see a shift common to all its
# entries; a training-mode BatchNorm subtracts the batch mean): the attention
# key biases of the transformer and the conformer, the fastformer's pooling
# logit biases, the postnet convolutions' biases
ZERO_BY_CONSTRUCTION = re.compile(r"slf_attn\.w_k\.bias$|mhsa\.key_proj\.bias$|"
                                  r"to_[qk]_attn_logits\.bias$|^postnet\.convs\.\d+\.bias$")


def train_batch(n_symbols: int, B: int = TRAIN_B, L: int = TRAIN_L, T: int = TRAIN_T, seed: int = 0):
    """numpy arrays in the order and layout of the JAX package's ``_collate``
    (e2e_tts_tpu/data/dataset.py): text lengths in [L/2, L], mel lengths in
    [T/2, T], words of 1-4 phonemes, random log-mels, normalised f0 with a
    30% unvoiced share (f0 0 there), pitch, energy, and the beta-binomial
    prior of each row."""
    from e2e_tts_tpu_torch.audio import beta_binomial_prior

    rng = np.random.RandomState(seed)
    tl = rng.randint(L // 2, L + 1, B)
    ml = rng.randint(T // 2, T + 1, B)
    texts, word_ids = np.zeros((B, L), np.int64), np.zeros((B, L), np.int64)
    mel = np.zeros((B, T, 80), np.float32)
    prior = np.zeros((B, T, L), np.float32)
    f0, uv, pitch, energy = (np.zeros((B, T), np.float32) for _ in range(4))
    for b in range(B):
        n, m = tl[b], ml[b]
        texts[b, :n] = rng.randint(1, n_symbols, n)
        word_ids[b, :n] = np.repeat(np.arange(n), rng.randint(1, 5, n))[:n]
        mel[b, :m] = rng.randn(m, 80) * 1.5 - 5.0
        prior[b, :m, :n] = beta_binomial_prior(n, m)
        uv[b, :m] = rng.rand(m) < 0.3
        f0[b, :m] = np.where(uv[b, :m] > 0, 0.0, rng.randn(m))
        pitch[b, :m] = rng.randn(m)
        energy[b, :m] = rng.randn(m)
    return [rng.randint(0, TRAIN_SPEAKERS, B), texts, tl, word_ids, mel, ml, prior,
            np.zeros((B, L), np.float32), f0, uv, pitch, energy]


def forward_losses(model, cfg, batch, step: int, n_words: int, rng):
    from e2e_tts_tpu_torch.models.acoustic_loss import fastspeech2_loss

    out = model(batch.speakers, batch.texts, batch.txt_lens, batch.mel, batch.mel_lens,
                batch.attn_prior, {"f0": batch.f0, "uv": batch.uv}, batch.energy, step, rng)
    return out, fastspeech2_loss(out, batch.mel, batch.txt_lens, batch.mel_lens, batch.word_ids,
                                 n_words, step, cfg.train.fastspeech2_loss)


def mas_margin(attn_soft, tl: int, ml: int, path) -> float:
    """The closest call on a row's MAS path: the least |p[j-1] - p[j]| over the
    backtrack's decisions (float32 scores, as the search computes them)."""
    la = np.log(np.maximum(attn_soft[:ml, :tl].astype(np.float32), np.float32(1e-30)))
    p = np.full(tl, -1e30, np.float32)
    p[0] = la[0, 0]
    rows = [p]
    for i in range(1, ml):
        shifted = np.concatenate([[np.float32(-1e30)], p[:-1]]).astype(np.float32)
        p = (la[i] + np.maximum(shifted, p)).astype(np.float32)
        rows.append(p)
    gaps = [abs(float(rows[i - 1][j - 1]) - float(rows[i - 1][j]))
            for i, j in enumerate(path[:ml]) if i > 0 and j > 0]
    return min(gaps, default=float("inf"))


@contextlib.contextmanager
def relu_calls(record=None, replay=None):
    """Route ``torch.relu`` (the models' call) through a hook: with ``record``
    (a list), append each call's input, detached, on the CPU; with
    ``replay`` (such a list from another run), take each call's decision
    from it: ``x * (recorded x > 0)``, the same branch of the function."""
    real = torch.relu
    calls = iter(replay or ())

    def hooked(x):
        if record is not None:
            record.append(x.detach().cpu())
        if replay is not None:
            return x * (next(calls) > 0).to(x.device, x.dtype)
        return real(x)

    torch.relu = hooked
    try:
        yield
    finally:
        torch.relu = real


def relu_ties(cuda_inputs, cpu_inputs) -> dict:
    """Where the CUDA run's relus decided otherwise than the CPU run's on the
    same call: each such input must lie within RELU_TIE x its call's largest
    |input| of 0 (a tie), else this raises.  Returns the count and the
    largest margin."""
    if len(cuda_inputs) != len(cpu_inputs):
        raise AssertionError(f"relu calls: {len(cuda_inputs)} on CUDA, {len(cpu_inputs)} on the CPU")
    flips, margin = 0, 0.0
    for xg, xc in zip(cuda_inputs, cpu_inputs):
        differ = (xg > 0) != (xc > 0)
        if differ.any():
            m = float(xc[differ].abs().max() / xc.abs().max().clamp(min=1e-30))
            flips, margin = flips + int(differ.sum()), max(margin, m)
            if not m < RELU_TIE:
                raise AssertionError(f"train parity: a relu decides otherwise on CUDA at an input "
                                     f"{m:.3g} x its call's largest from 0 (tie bar {RELU_TIE})")
    return dict(relu_flips=flips, relu_worst_margin=float(f"{margin:.3g}"))


def train_parity(cfg, batch_np, n_symbols: int, n_words: int) -> None:
    """One step's forward and backward on CUDA against the same on the CPU:
    the first rows of the batch, the same weights, dropout 0, step 30000 (hard
    expansion, the bin term at full weight).  Loss terms and each parameter's
    gradient within TRAIN_LOSS_RTOL / TRAIN_GRAD_RTOL; durations equal, or
    the CPU step is rerun with the CUDA alignment where a MAS decision was a
    tie (within MAS_TIE); every relu's decision equal, or the CPU step is
    rerun with the CUDA run's decisions where an input was a tie (within
    RELU_TIE of 0: a single flipped relu moves the gradient of every layer
    below it by ~1e-3, as a MAS tie moves durations)."""
    import e2e_tts_tpu_torch.nn.variance as variance
    from e2e_tts_tpu_torch.train import AcousticBatch, build_acoustic_model

    step = 30000
    cpu = build_acoustic_model(cfg, n_symbols, TRAIN_SPEAKERS, dropout=False, device="cpu")
    gpu = copy.deepcopy(cpu).to("cuda")
    rows = [a[:PARITY_ROWS] for a in batch_np]
    b_c, b_g = AcousticBatch.from_numpy(rows, "cpu"), AcousticBatch.from_numpy(rows, "cuda")
    for m in (cpu, gpu):
        m.train()
    relu_g, relu_c = [], []
    with relu_calls(record=relu_g):
        out_g, loss_g = forward_losses(gpu, cfg, b_g, step, n_words, torch.Generator("cuda"))
    loss_g["total"].backward()
    t0 = time.perf_counter()
    with relu_calls(record=relu_c):
        out_c, loss_c = forward_losses(cpu, cfg, b_c, step, n_words, torch.Generator())
    ties = relu_ties(relu_g, relu_c)
    d_c, d_g = out_c["duration_rounded"], out_g["duration_rounded"].cpu()
    real_align = variance.monotonic_align
    if not torch.equal(d_c, d_g):
        hard_g = out_g["attn_hard"].cpu()
        for b in sorted({int(i) for i in (d_c != d_g).nonzero()[:, 0]}):
            margin = mas_margin(out_c["attn_soft"][b].detach().numpy(), int(rows[2][b]),
                                int(rows[5][b]), out_c["attn_hard"][b].argmax(-1).tolist())
            log(f"train parity: row {b} durations differ; closest MAS decision on the CPU "
                f"path {margin:.4g} (tie bar {MAS_TIE})")
            if not margin < MAS_TIE:
                raise AssertionError(f"train parity: durations differ off a MAS tie in row {b}")
        variance.monotonic_align = lambda *a: hard_g  # the CUDA alignment into the CPU step
    if variance.monotonic_align is not real_align or ties["relu_flips"]:
        try:
            with relu_calls(replay=relu_g):  # the CUDA run's relu decisions into the CPU step
                out_c, loss_c = forward_losses(cpu, cfg, b_c, step, n_words, torch.Generator())
        finally:
            variance.monotonic_align = real_align
    loss_c["total"].backward()
    cpu_s = time.perf_counter() - t0
    worst = {}
    for k, want in loss_c.items():
        w, g = want.item(), loss_g[k].item()
        worst[k] = abs(g - w) / max(abs(w), 1e-12)
        if not worst[k] < TRAIN_LOSS_RTOL:
            raise AssertionError(f"train parity: loss {k} CUDA {g} CPU {w}")
    grads_c = {n: p.grad for n, p in cpu.named_parameters()}
    scale = float(torch.sqrt(sum((g * g).sum() for g in grads_c.values())))
    grad_errs = []
    for n, p in gpu.named_parameters():
        gc, gg = grads_c[n], p.grad.cpu()
        if ZERO_BY_CONSTRUCTION.search(n):  # 0 by construction: noise on both sides
            if not (gc.norm() < 1e-5 * scale and gg.norm() < 1e-5 * scale):
                raise AssertionError(f"train parity: {n} should have a zero gradient")
            continue
        grad_errs.append((float((gg - gc).norm() / gc.norm().clamp(min=1e-30)), n))
    err, name = max(grad_errs)
    log("train parity " + json.dumps(dict(
        rows=PARITY_ROWS, step=step, cpu_s=round(cpu_s, 2),
        durations_equal=bool(torch.equal(d_c, d_g)), **ties,
        loss_rel_err={k: float(f"{v:.3g}") for k, v in worst.items()},
        worst_grad_rel_err=float(f"{err:.3g}"), worst_grad=name, grad_tensors=len(grad_errs))))
    if not err < TRAIN_GRAD_RTOL:
        raise AssertionError(f"train parity: gradient of {name} rel err {err} >= {TRAIN_GRAD_RTOL}")
    return cpu, gpu


@contextlib.contextmanager
def recorded_train_inputs():
    """Set the training kernels' launch counts to 0 and keep a copy of the
    first CUDA inputs each kernel gets (the training path's, for
    ``check_training_inputs``)."""
    import e2e_tts_tpu_torch.ops.ctc as ops_ctc
    import e2e_tts_tpu_torch.ops.mas as ops_mas
    from e2e_tts_tpu_torch.kernels.ctc import ctc_bwd, ctc_fwd
    from e2e_tts_tpu_torch.kernels.mas import mas

    real = {"mas": mas, "ctc_fwd": ctc_fwd, "ctc_bwd": ctc_bwd}
    seen = {}

    def hook(name):
        def call(*args):
            if name not in seen and args[0].is_cuda:
                seen[name] = tuple(a.clone() for a in args)
            return real[name](*args)
        return call

    # the callers' references, as ``recorded_inputs`` hooks the transformer's
    ops_mas.mas, ops_ctc.ctc_fwd, ops_ctc.ctc_bwd = hook("mas"), hook("ctc_fwd"), hook("ctc_bwd")
    for fn in real.values():
        fn.launches = 0
    try:
        yield seen
    finally:
        ops_mas.mas, ops_ctc.ctc_fwd, ops_ctc.ctc_bwd = real["mas"], real["ctc_fwd"], real["ctc_bwd"]


def check_training_inputs(seen) -> dict:
    """Each training kernel against its plain version on the inputs the
    training run gave it first: the largest error of each."""
    if sorted(seen) != ["ctc_bwd", "ctc_fwd", "mas"]:
        raise AssertionError(f"the training run gave the kernels inputs for {sorted(seen)} only")
    la, tl, ml = seen["mas"]
    errs = {"mas": check_mas(la, tl, ml, "the training run's inputs")}
    lp, kl, ql = seen["ctc_fwd"]
    errs["ctc_fwd"], _ = check_ctc(lp, kl, ql, "the training run's forward inputs")
    g, lp, kl, ql, alpha, total = seen["ctc_bwd"]
    _, errs["ctc_bwd"] = check_ctc(lp, kl, ql, "the training run's backward inputs", g,
                                   (alpha, total))
    log(f"mas on the training run's inputs {tuple(la.shape)}: bit-equal to the plain version")
    return errs


def train_steps(cfg, batch_np, n_symbols: int, n_words: int):
    """5 timed train steps at step 0 and 5 at step 30000 on the full batch with
    dropout on (launch counts from 0), the eval step twice, and one step under
    the profiler.  Returns (launches, errors on the run's own inputs)."""
    from e2e_tts_tpu_torch.kernels.ctc import ctc_bwd, ctc_fwd
    from e2e_tts_tpu_torch.kernels.mas import mas
    from e2e_tts_tpu_torch.train import (AcousticBatch, acoustic_optimizer, build_acoustic_model,
                                         init_train_state, make_eval_step, make_train_step)

    model = build_acoustic_model(cfg, n_symbols, TRAIN_SPEAKERS)
    opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer, cfg.models.fastspeech2.encoder_hidden)
    state = init_train_state(model, opt, seed=0)
    train_step = make_train_step(model, cfg, opt, n_words)
    batch = AcousticBatch.from_numpy(batch_np, "cuda")
    frames = int(batch_np[5].sum())
    train_step(state, batch)  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics = []
    with recorded_train_inputs() as seen:
        for start in (0, 30000):
            state.step = start
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TRAIN_STEPS):
                metrics.append(train_step(state, batch)[1])
            torch.cuda.synchronize()
            sec = (time.perf_counter() - t0) / TRAIN_STEPS
            last = {k: round(float(v), 5) for k, v in metrics[-1].items()}
            log("train steps " + json.dumps(dict(
                start_step=start, batch=list(batch.mel.shape[:2]) + [TRAIN_L], steps=TRAIN_STEPS,
                step_ms=round(1e3 * sec, 3), utterances_per_s=round(TRAIN_B / sec, 2),
                mel_frames_per_s=round(frames / sec, 1), last_metrics=last)))
    launches = {"mas": mas.launches, "ctc_fwd": ctc_fwd.launches, "ctc_bwd": ctc_bwd.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"train: launches {launches} in {2 * TRAIN_STEPS} steps; peak device memory "
        f"{peak / 2**30:.2f} GiB ({peak} bytes)")
    if any(n != 2 * TRAIN_STEPS for n in launches.values()):
        raise AssertionError(f"each train step should launch each training kernel once: {launches}")
    bad = [k for m in metrics for k, v in m.items() if not torch.isfinite(v)]
    if bad:
        raise AssertionError(f"train: non-finite metrics {sorted(set(bad))}")
    errs = check_training_inputs(seen)

    eval_step = make_eval_step(model, cfg, n_words)
    first, again = eval_step(state, batch), eval_step(state, batch)
    if any(not torch.equal(first[k], again[k]) for k in first):
        raise AssertionError("make_eval_step gave other metrics the second time")
    log("eval step twice, equal: " + json.dumps({k: round(float(v), 5) for k, v in first.items()}))

    # one step at step 0 (soft expansion through the aligner's attention) beside
    # one at step 30000 (hard expansion, the bin term at full weight): wall,
    # busy, and the kernels whose device time differs most between the two
    profiles = {}
    for start in (0, 30000):
        state.step = start
        train_step(state, batch)  # this branch's shapes once more, not profiled
        state.step = start
        busy = device_busy(lambda: train_step(state, batch))
        if busy is not None:
            profiles[start] = {k[0]: (k[1], k[2]) for k in busy["kernels"]}
        log_profile(f"train step {start}", busy, r"mas_kernel|ctc_")
    if len(profiles) == 2:
        names = set(profiles[0]) | set(profiles[30000])
        delta = sorted(((profiles[0].get(n, (0.0, 0))[0] - profiles[30000].get(n, (0.0, 0))[0], n)
                        for n in names), reverse=True)
        log("train step 0 vs 30000: kernels by device ms at step 0 minus step 30000 " + json.dumps(
            [dict(name=n[:90], ms_delta=round(d, 3), at_0=profiles[0].get(n, (0.0, 0)),
                  at_30000=profiles[30000].get(n, (0.0, 0))) for d, n in delta[:6] + delta[-3:]]))
    return launches, errs


def training():
    """Phase 12: parity, then the timed steps."""
    from e2e_tts_tpu_torch.config import default_config
    from e2e_tts_tpu_torch.text.symbols import symbols

    cfg = default_config()
    n_words = max(cfg.models.fastspeech2.max_seq_len, 256)  # as the JAX training CLI sizes it
    t0 = time.perf_counter()
    batch_np = train_batch(len(symbols))
    log(f"train batch: {TRAIN_B} rows at (L, T) = ({TRAIN_L}, {TRAIN_T}), text lengths "
        f"{int(batch_np[2].min())}-{int(batch_np[2].max())}, mel lengths "
        f"{int(batch_np[5].min())}-{int(batch_np[5].max())}, made in "
        f"{time.perf_counter() - t0:.1f} s")
    train_parity(cfg, batch_np, len(symbols), n_words)
    return train_steps(cfg, batch_np, len(symbols), n_words)


# --- 13. vocoder GAN training ------------------------------------------------------------

VOC_B, VOC_FRAMES = 16, 32  # cmd_vocoder: batch_size // 2 rows of segment_length // 4 samples
VOC_STEPS = 5
VOC_PARITY_ROWS = 2
HOP = 256


def speech(n: int, rng, rows: int = 1):
    """(rows, n) audio at a speaking level: three sines of random phase and
    noise, about 0.25 RMS."""
    t = np.arange(n) / 22050.0
    out = np.empty((rows, n), np.float32)
    for r in range(rows):
        out[r] = sum(0.2 * np.sin(2 * np.pi * f * t + rng.rand() * 6) for f in (140.0, 290.0, 610.0))
        out[r] += 0.02 * rng.randn(n)
    return out


def vocoder_batch(seed: int = 0):
    """(random log-mels (B, 32, 80), aligned audio (B, 32 * 256)) from numpy."""
    rng = np.random.RandomState(seed)
    mel = (rng.randn(VOC_B, VOC_FRAMES, 80) * 1.5 - 5.0).astype(np.float32)
    return mel, speech(VOC_FRAMES * HOP, rng, VOC_B)


def gan_modules(cfg, kind: str = "hifigan", device=None):
    """The training-form generator and MPD/MSD at reference widths, all from
    torch seed 0, on ``device`` (CUDA when None)."""
    from e2e_tts_tpu_torch.models.vocoder import build_generator
    from e2e_tts_tpu_torch.nn.discriminators import build_discriminators

    return (build_generator(cfg, kind, train=True, device=device, seed=0),
            *build_discriminators(device, seed=0))


def adam_names(*modules):
    """The parameter names in the order an optimizer state holds them (the
    discriminators' MPD then MSD, prefixed by their index)."""
    if len(modules) == 1:
        return [n for n, _ in modules[0].named_parameters()]
    return [f"{i}.{n}" for i, m in enumerate(modules) for n, _ in m.named_parameters()]


def metrics_parity(what: str, got: dict, want: dict) -> dict:
    """Each metric on CUDA (``got``) against the CPU within TRAIN_LOSS_RTOL."""
    errs = {}
    for k, w in want.items():
        w, g = w.item(), got[k].item()
        errs[k] = abs(g - w) / max(abs(w), 1e-12)
        if not errs[k] < TRAIN_LOSS_RTOL:
            raise AssertionError(f"{what}: metric {k} CUDA {g} CPU {w}")
    return {k: float(f"{v:.3g}") for k, v in errs.items()}


ORACLE_FACTOR = 2.0  # the card may lie this many times as far from float64 as the CPU does
# Gradients the card puts past the oracle bar, filed as C1 in ROADMAP.md with
# their distances and left standing: logged as a standing failure each run,
# never counted as a pass; any other tensor past the bar fails the run.
ORACLE_FAULTS: dict = {}  # none since the acoustic convolutions train outside cuDNN (C1)


def to_dtype(batch, dtype):
    """A batch (tensors, or NamedTuples of them) with its floating tensors in ``dtype``."""
    if isinstance(batch, torch.Tensor):
        return batch.to(dtype) if batch.is_floating_point() else batch
    return type(batch)(*(to_dtype(t, dtype) for t in batch))


def parity_runs(run, cpu_mods) -> dict:
    """``run(modules, device, dtype) -> (state, metrics)`` from the same
    weights: on CUDA and on the CPU in float32, and the oracle: on the CPU in
    float64 (the modules' ``.double()``; their float islands follow the
    input).  Both CPU runs take the CUDA run's hard alignment (MAS's 0/1
    output), after holding their own to it: equal, or apart only where a
    decision on the path was a tie (``mas_margin`` < MAS_TIE), so that all
    three differentiate one function."""
    import e2e_tts_tpu_torch.nn.variance as variance

    gpu = [copy.deepcopy(m).to("cuda") for m in cpu_mods]
    f64 = [copy.deepcopy(m).double() for m in cpu_mods]
    real, hard = variance.monotonic_align, []
    variance.monotonic_align = lambda *a: hard.append(real(*a)) or hard[-1]

    def replaying():
        cuda = iter(hard)

        def align(attn, tl, ml):
            own, want = real(attn, tl, ml), next(cuda).to(attn.device)
            for b in sorted({int(i) for i in (own != want).nonzero()[:, 0]}):
                margin = mas_margin(attn[b].detach().float().numpy(), int(tl[b]), int(ml[b]),
                                    own[b].argmax(-1).tolist())
                if not margin < MAS_TIE:
                    raise AssertionError(f"parity: row {b}'s alignment differs off a MAS tie")
            return want
        return align

    try:
        out = {"cuda": run(gpu, "cuda", torch.float32)}
        variance.monotonic_align = replaying()
        t0 = time.perf_counter()
        out["cpu"] = run(cpu_mods, "cpu", torch.float32)
        out["cpu_s"] = time.perf_counter() - t0
        variance.monotonic_align = replaying()
        t0 = time.perf_counter()
        out["f64"] = run(f64, "cpu", torch.float64)
        out["f64_s"] = time.perf_counter() - t0
    finally:
        variance.monotonic_align = real
    return out


def moments_parity(what: str, out: dict, groups) -> dict:
    """The gradients of one step read from Adam's first moment after it
    (mu = (1 - b1) times the clipped gradient), held to the float64 oracle:
    for each tensor, with distances relative to the float64 tensor's norm,
    |card_f32 - cpu_f64| <= max(TRAIN_GRAD_RTOL, ORACLE_FACTOR x
    |cpu_f32 - cpu_f64|), i.e. the card no farther from the truth than twice
    the CPU's own float32 error.  ``groups``: (names, the optimizer state's
    attribute, zero pattern or None); a tensor the pattern matches is 0 by
    construction: below 1e-5 of its group's norm on both float32 sides.
    Logs each side's distances (worst tensors first) and raises past the
    bar."""
    rows, zero = [], 0
    for names, attr, pattern in groups:
        cpu, gpu, exact = (getattr(out[k][0], attr).mu for k in ("cpu", "cuda", "f64"))
        scale = float(torch.sqrt(sum((m.double() * m.double()).sum() for m in exact)))
        for name, mc, mg, me in zip(names, cpu, gpu, exact):
            mc, mg = mc.double(), mg.double().cpu()
            if pattern is not None and pattern.search(name):
                if not (mc.norm() < 1e-5 * scale and mg.norm() < 1e-5 * scale):
                    raise AssertionError(f"{what}: {name} should have a zero gradient")
                zero += 1
                continue
            norm = me.norm().clamp(min=1e-300)
            card, host = float((mg - me).norm() / norm), float((mc - me).norm() / norm)
            rows.append((card / max(TRAIN_GRAD_RTOL, ORACLE_FACTOR * host), card, host, name))
    rows.sort(reverse=True)
    cards, hosts = np.array([r[1] for r in rows]), np.array([r[2] for r in rows])
    summary = dict(
        grad_tensors=len(rows), zero_by_construction=zero,
        card_vs_f64=dict(max=float(f"{cards.max():.3g}"), median=float(f"{np.median(cards):.3g}"),
                         over_rtol=int((cards >= TRAIN_GRAD_RTOL).sum())),
        cpu_vs_f64=dict(max=float(f"{hosts.max():.3g}"), median=float(f"{np.median(hosts):.3g}"),
                        over_rtol=int((hosts >= TRAIN_GRAD_RTOL).sum())),
        card_farther_than_cpu=int((cards > hosts).sum()),
        worst=[dict(name=r[3], card_vs_f64=float(f"{r[1]:.3g}"), cpu_vs_f64=float(f"{r[2]:.3g}"),
                    of_bar=round(r[0], 3)) for r in rows[:8]])
    log(f"{what} oracle " + json.dumps(summary))
    filed = ORACLE_FAULTS.get(what, frozenset())
    for r in rows:
        if r[3] in filed:
            log(f"{what}: {r[3]} card {r[1]:.3g} from float64 (CPU {r[2]:.3g}), "
                f"{r[0]:.3g} of the oracle bar: " + ("a standing failure (ROADMAP.md, C1)"
                                                     if r[0] > 1.0 else "within the bar now"))
    over = [r for r in rows if r[0] > 1.0 and r[3] not in filed]
    if over:
        raise AssertionError(f"{what}: {len(over)} gradient(s) farther from float64 than "
                             f"max({TRAIN_GRAD_RTOL}, {ORACLE_FACTOR} x the CPU's): "
                             + ", ".join(f"{r[3]} {r[1]:.3g} (CPU {r[2]:.3g})" for r in over[:10]))
    return dict(grad_tensors=len(rows), worst_card_vs_f64=summary["card_vs_f64"]["max"],
                worst_cpu_vs_f64=summary["cpu_vs_f64"]["max"],
                standing_failures=sum(r[0] > 1.0 for r in rows))


def vocoder_parity(cfg, batch_np) -> None:
    """One ``make_vocoder_train_step`` step of HiFi-GAN V1 with MPD/MSD at
    reference widths on CUDA against the same weights on the CPU, the batch's
    first rows: the metrics, and the discriminators' and the generator's
    gradients from Adam's first moments."""
    from e2e_tts_tpu_torch.train import (VocoderBatch, gan_optimizer, init_vocoder_train_state,
                                         make_vocoder_train_step)

    def run(mods, device, dtype):
        g_opt, d_opt = (gan_optimizer(cfg.train.hifigan_optimizer) for _ in range(2))
        state = init_vocoder_train_state(mods[0], g_opt, d_opt, *mods[1:])
        step = make_vocoder_train_step(mods[0], cfg, g_opt, d_opt, "hifigan", *mods[1:])
        batch = VocoderBatch.from_numpy([a[:VOC_PARITY_ROWS] for a in batch_np], device)
        return step(state, to_dtype(batch, dtype))

    cpu = gan_modules(cfg, device="cpu")
    out = parity_runs(run, cpu)
    errs = metrics_parity("vocoder parity", out["cuda"][1], out["cpu"][1])
    grads = moments_parity("vocoder parity", out, [
        (adam_names(cpu[0]), "g_opt_state", None), (adam_names(*cpu[1:]), "d_opt_state", None)])
    log("vocoder parity " + json.dumps(dict(rows=VOC_PARITY_ROWS, cpu_s=round(out["cpu_s"], 2),
                                            f64_s=round(out["f64_s"], 2), metric_rel_err=errs,
                                            **grads)))


def timed_steps(step, state, batch, n: int) -> tuple:
    """n steps after the one before them: (seconds a step, metrics of each)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = [step(state, batch)[1] for _ in range(n)]
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n, metrics


def check_finite(what: str, metrics) -> dict:
    bad = sorted({k for m in metrics for k, v in m.items() if not torch.isfinite(v)})
    if bad:
        raise AssertionError(f"{what}: non-finite metrics {bad}")
    return {k: round(float(v), 5) for k, v in metrics[-1].items()}


def log_profile(what: str, busy, pattern=None) -> None:
    """A ``device_busy`` result: busy share, the top kernels, the port's own
    (names matching ``pattern``) and the host's top calls."""
    if busy is None:
        return
    kernels, host = busy.pop("kernels"), busy.pop("host")
    ours = [k for k in kernels if pattern and re.search(pattern, k[0])]
    log(f"{what} profile " + json.dumps(dict(
        **busy, kernel_launches=sum(k[2] for k in kernels),
        port_kernels=[dict(name=k[0][:60], ms=k[1], n=k[2]) for k in ours],
        top=[dict(name=k[0][:90], ms=k[1], n=k[2]) for k in kernels[:12]],
        host_top=[dict(name=k[0][:40], ms=k[1], n=k[2]) for k in host[:8]])))


def vocoder_gan() -> None:
    """Phase 13: parity at 2 rows, then 5 timed steps at B = 16, one profiled
    step, and 2 steps of the iSTFTNet variant."""
    from e2e_tts_tpu_torch.config import default_config
    from e2e_tts_tpu_torch.train import (VocoderBatch, gan_optimizer, init_vocoder_train_state,
                                         make_vocoder_train_step)

    cfg = default_config()
    batch_np = vocoder_batch()
    vocoder_parity(cfg, batch_np)
    batch = VocoderBatch.from_numpy(batch_np, "cuda")
    audio_s = VOC_B * VOC_FRAMES * HOP / cfg.audio.signal.sampling_rate
    for kind in ("hifigan", "istft"):
        gen, mpd, msd = gan_modules(cfg, kind)
        g_opt, d_opt = (gan_optimizer(cfg.train.hifigan_optimizer) for _ in range(2))
        state = init_vocoder_train_state(gen, g_opt, d_opt, mpd, msd)
        step = make_vocoder_train_step(gen, cfg, g_opt, d_opt, kind, mpd, msd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = step(state, batch)[1]  # warm-up: cuDNN's choices, cuFFT's plans
        torch.cuda.synchronize()
        first_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.reset_peak_memory_stats()
        n = VOC_STEPS if kind == "hifigan" else 1
        sec, metrics = timed_steps(step, state, batch, n)
        peak = torch.cuda.max_memory_allocated()
        log(f"vocoder steps ({kind}) " + json.dumps(dict(
            batch=[VOC_B, VOC_FRAMES, VOC_FRAMES * HOP], steps=n + 1, first_step_ms=round(first_ms, 3),
            step_ms=round(1e3 * sec, 3), audio_s_per_s=round(audio_s / sec, 2),
            peak_bytes=peak, peak_gib=round(peak / 2**30, 2),
            last_metrics=check_finite(f"vocoder steps ({kind})", [first] + metrics))))
        if kind == "hifigan":
            log_profile("vocoder", device_busy(lambda: step(state, batch)))


# --- 14. joint acoustic + vocoder fine-tune ----------------------------------------------

E2E_SEG = 32  # make_e2e_train_step's segment_frames


def e2e_audio(batch_np, seed: int = 0):
    """(B, T * 256) audio aligned with the batch's mels: speech for each
    row's mel_len frames, zeros after."""
    mel_lens, T = batch_np[5], batch_np[4].shape[1]
    rng = np.random.RandomState(seed)
    audio = np.zeros((len(mel_lens), T * HOP), np.float32)
    for b, m in enumerate(mel_lens):
        audio[b, :m * HOP] = speech(m * HOP, rng)[0]
    return audio


def e2e_modules(cfg, n_symbols: int, device=None, dropout: bool = True):
    """The default-width FastSpeech2 with its aligner, HiFi-GAN V1 and
    MPD/MSD, from torch seed 0."""
    from e2e_tts_tpu_torch.train import build_acoustic_model

    model = build_acoustic_model(cfg, n_symbols, TRAIN_SPEAKERS, dropout=dropout, device=device)
    return (model, *gan_modules(cfg, device=device))


def e2e_step_fn(cfg, mods, n_words: int, seed: int = 0):
    """(state, step) of ``make_e2e_train_step`` over ``mods`` with the
    acoustic and GAN optimizers of the JAX training CLI's e2e command."""
    from e2e_tts_tpu_torch.train import (acoustic_optimizer, gan_optimizer, init_e2e_state,
                                         make_e2e_train_step)

    am_opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer, cfg.models.fastspeech2.encoder_hidden)
    g_opt, d_opt = (gan_optimizer(cfg.train.hifigan_optimizer) for _ in range(2))
    model, gen, mpd, msd = mods
    state = init_e2e_state(model, gen, am_opt, g_opt, d_opt, mpd, msd, seed=seed)
    return state, make_e2e_train_step(model, gen, cfg, am_opt, g_opt, d_opt, n_words, E2E_SEG,
                                      mpd, msd)


# acoustic modules whose outputs the e2e parity compares with float64 (where
# the card's float32 error enters the generator's input)
FORWARD_PROBES = ("encoder.layers.0", "encoder.layers.5", "decoder.layers.5", "mel_linear",
                  "postnet")


# where phase 14 takes each operation class's input (the float64 run's own)
OP_INPUTS = ("encoder.layers.0.slf_attn.w_q", "encoder.layers.0.slf_attn.layer_norm",
             "encoder.layers.0.pos_ffn", "postnet.bns.0")


def without_cudnn(fn):
    """``fn()`` with cuDNN off."""
    with torch.backends.cudnn.flags(enabled=False):
        return fn()


def op_class_distances(model, inputs, devices=("cuda", "cpu")) -> dict:
    """Each operation class of the acoustic forward on its own: the input the
    float64 run gave it (``inputs``, at encoder layer 0, and the postnet's
    first BatchNorm in training mode), rounded to float32, through the op in
    float32 on the card and on the CPU, against the same op in float64 on
    the rounded input (relative norm of the difference).  So each distance
    is the op's own arithmetic, not the error it was handed."""
    named = dict(model.named_modules())
    layer = "encoder.layers.0."
    attn = named[layer + "slf_attn"]
    H, dk = attn.n_head, attn.d_k

    def on(name, device, dtype):
        return copy.deepcopy(named[name]).to(device=device, dtype=dtype)

    def scores(q, k):  # the plain branch's q k^T / sqrt(d_k), per head
        B, T, _ = q.shape
        return torch.einsum("bqhd,bkhd->bhqk", q.view(B, T, H, dk), k.view(B, T, H, dk)) / np.sqrt(dk)

    x = inputs[layer + "slf_attn.w_q"].float().double()
    with torch.no_grad():
        q = on(layer + "slf_attn.w_q", "cpu", torch.float64)(x)
        k = on(layer + "slf_attn.w_k", "cpu", torch.float64)(x)
        s = scores(q, k)
    ops = {  # name: (the op on a device in a dtype, its float64 input)
        "linear (cuBLAS)": (lambda dev, dt: on(layer + "slf_attn.w_q", dev, dt), (x,)),
        "q k^T (cuBLAS)": (lambda dev, dt: scores, (q, k)),
        "attention softmax": (lambda dev, dt: lambda t: torch.softmax(t, dim=-1), (s,)),
        "conv1d k=9 (cuDNN)": (
            lambda dev, dt: lambda t, m=on(layer + "pos_ffn", dev, dt).w_1: m.conv_ncw(
                t.transpose(1, 2)),
            (inputs[layer + "pos_ffn"],)),
        # the same convolution where cuDNN is off: PyTorch's own CUDA
        # convolution (im2col and a cuBLAS product), the CPU's as it is
        "conv1d k=9 (cuDNN off)": (
            lambda dev, dt: lambda t, m=on(layer + "pos_ffn", dev, dt).w_1: without_cudnn(
                lambda: m.conv_ncw(t.transpose(1, 2))),
            (inputs[layer + "pos_ffn"],)),
        "layernorm": (lambda dev, dt: on(layer + "slf_attn.layer_norm", dev, dt),
                      (inputs[layer + "slf_attn.layer_norm"],)),
        "batchnorm train (E[x^2] - E[x]^2)": (
            lambda dev, dt: lambda t, m=on("postnet.bns.0", dev, dt): m(t, True),
            (inputs["postnet.bns.0"],)),
    }
    out = {}
    with torch.no_grad():
        for name, (op, args) in ops.items():
            args = [a.float().double() for a in args]  # the float32 input, exactly
            ref = op("cpu", torch.float64)(*args)
            d = [float((op(dev, torch.float32)(*[a.float().to(dev) for a in args]).double().cpu()
                        - ref).norm() / ref.norm()) for dev in devices]
            out[name] = dict(card=float(f"{d[0]:.3g}"), cpu=float(f"{d[1]:.3g}"),
                             card_over_cpu=float(f"{d[0] / max(d[1], 1e-30):.3g}"))
    return out


def first_tensor(out):
    """A module's output tensor (the first of a tuple)."""
    return out[0] if isinstance(out, tuple) else out


def e2e_parity(cfg, batch_np, audio, n_symbols: int, n_words: int) -> None:
    """One e2e step on CUDA against the CPU: the batch's first rows, the same
    weights, dropout 0, step 30000, the crop starts handed in.  The metrics,
    and the acoustic model's, the generator's and the discriminators'
    gradients from Adam's first moments, held to the float64 oracle; the
    acoustic activations at FORWARD_PROBES of each run beside float64's."""
    from e2e_tts_tpu_torch.train import E2EBatch

    starts = np.random.RandomState(1).randint(0, np.maximum(batch_np[5][:PARITY_ROWS] - E2E_SEG, 0)
                                              + 1)

    forward = []  # each run's acoustic activations at FORWARD_PROBES
    op_inputs = {}  # the float64 run's inputs at OP_INPUTS

    def run(mods, device, dtype):
        state, step = e2e_step_fn(cfg, mods, n_words)
        state.step = 30000
        rows = slice(0, PARITY_ROWS)
        batch = E2EBatch.from_numpy([a[rows] for a in batch_np], audio[rows], device)
        acts, named = {}, dict(mods[0].named_modules())

        def keep(name):
            def hook(module, args, out):  # returns None: the output is not replaced
                if name not in acts:
                    acts[name] = first_tensor(out).detach().double().cpu()
            return hook

        def keep_input(name):
            def hook(module, args):  # returns None: the input is not replaced
                op_inputs.setdefault(name, args[0].detach().clone())
            return hook

        hooks = [named[n].register_forward_hook(keep(n)) for n in FORWARD_PROBES]
        if dtype == torch.float64:
            hooks += [named[n].register_forward_pre_hook(keep_input(n)) for n in OP_INPUTS]
        try:
            return step(state, to_dtype(batch, dtype), torch.from_numpy(starts).to(device))
        finally:
            forward.append(acts)
            for h in hooks:
                h.remove()

    cpu = e2e_modules(cfg, n_symbols, "cpu", dropout=False)
    out = parity_runs(run, cpu)
    (card, host, exact), dist = forward, lambda a, b: float(f"{(a - b).norm() / b.norm():.3g}")
    log("e2e forward vs float64 (the acoustic activations, relative norm) " + json.dumps(
        {n: dict(card=dist(card[n], exact[n]), cpu=dist(host[n], exact[n]))
         for n in FORWARD_PROBES}))
    log("e2e op classes vs float64 (each op alone on the float64 run's input rounded to "
        "float32, relative norm) " + json.dumps(op_class_distances(cpu[0], op_inputs)))
    errs = metrics_parity("e2e parity", out["cuda"][1], out["cpu"][1])
    grads = moments_parity("e2e parity", out, [
        (adam_names(cpu[0]), "am_opt_state", ZERO_BY_CONSTRUCTION),
        (adam_names(cpu[1]), "g_opt_state", None), (adam_names(*cpu[2:]), "d_opt_state", None)])
    log("e2e parity " + json.dumps(dict(rows=PARITY_ROWS, step=30000, starts=starts.tolist(),
                                        cpu_s=round(out["cpu_s"], 2), f64_s=round(out["f64_s"], 2),
                                        metric_rel_err=errs, **grads)))


def joint_e2e():
    """Phase 14: parity at 4 rows, then 5 timed steps at phase 12's B = 32
    batch (launch counts from 0; MAS and the CTC forward and backward once a
    step each, held to their plain versions on the steps' own inputs), one
    profiled step.  Returns (launches, errors on the run's own inputs)."""
    from e2e_tts_tpu_torch.config import default_config
    from e2e_tts_tpu_torch.kernels.ctc import ctc_bwd, ctc_fwd
    from e2e_tts_tpu_torch.kernels.mas import mas
    from e2e_tts_tpu_torch.text.symbols import symbols
    from e2e_tts_tpu_torch.train import E2EBatch

    cfg = default_config()
    n_words = max(cfg.models.fastspeech2.max_seq_len, 256)
    batch_np = train_batch(len(symbols))
    audio = e2e_audio(batch_np)
    e2e_parity(cfg, batch_np, audio, len(symbols), n_words)
    state, step = e2e_step_fn(cfg, e2e_modules(cfg, len(symbols)), n_words)
    batch = E2EBatch.from_numpy(batch_np, audio, "cuda")
    step(state, batch)  # warm-up, not counted
    torch.cuda.reset_peak_memory_stats()
    with recorded_train_inputs() as seen:
        sec, metrics = timed_steps(step, state, batch, TRAIN_STEPS)
    launches = {"mas": mas.launches, "ctc_fwd": ctc_fwd.launches, "ctc_bwd": ctc_bwd.launches}
    peak = torch.cuda.max_memory_allocated()
    log("e2e steps " + json.dumps(dict(
        batch=[TRAIN_B, TRAIN_T, TRAIN_L], segment_frames=E2E_SEG, steps=TRAIN_STEPS,
        step_ms=round(1e3 * sec, 3), utterances_per_s=round(TRAIN_B / sec, 2),
        peak_bytes=peak, peak_gib=round(peak / 2**30, 2), launches=launches,
        last_metrics=check_finite("e2e steps", metrics))))
    if any(n != TRAIN_STEPS for n in launches.values()):
        raise AssertionError(f"each e2e step should launch each training kernel once: {launches}")
    errs = check_training_inputs(seen)
    log_profile("e2e", device_busy(lambda: step(state, batch)), r"mas_kernel|ctc_")
    return launches, errs


# --- 15. a trained bundle on the card ------------------------------------------------------

BUNDLE = "assets/bundles/vie_tiny"
WARM_TOL = 1e-4  # max |training form - serving vocoder| of the warm-started generator, in [-1, 1]


def bundle() -> float:
    """``SynthesisEngine.from_checkpoint`` of the checked-in bundle on CUDA
    serves the requests (launch counts from 0), each within LSB_TOL of the
    same bundle on the CPU; the training generator warm-started from the
    bundle's vocoder tree (as the JAX CLI's ``vocoder --init-from``) gives
    the serving vocoder's waveform.  Returns the kernel's worst error on the
    run's own inputs."""
    from e2e_tts_tpu_torch.convert import load_into
    from e2e_tts_tpu_torch.kernels.flash_attention import flash_attention
    from e2e_tts_tpu_torch.models.vocoder import build_generator
    from e2e_tts_tpu_torch.serve.bundle import load_bundle
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), BUNDLE)
    eng = SynthesisEngine.from_checkpoint(path, device="cuda")
    cpu = SynthesisEngine.from_checkpoint(path, device="cpu")
    for text in REQUESTS:  # warm-up pass, not counted
        eng.synthesize(text)
    with recorded_inputs() as seen:
        for text in REQUESTS:
            set_estimator(cpu, estimator(eng))
            out = eng.synthesize(text)
            lsb_diff(f"bundle {os.path.basename(BUNDLE)}: {len(text)} characters, CUDA vs CPU",
                     out, cpu.synthesize(text))
    launches = flash_attention.launches
    log(f"bundle: launches {{'flash_attention': {launches}}}")
    if launches <= 0:
        raise AssertionError("the bundle run never launched flash_attention")
    err = check_serving_inputs(seen, "bundle")

    mels, real = [], eng.vocoder
    eng.vocoder = lambda mel: (mels.append(mel), real(mel))[1]
    try:
        eng.synthesize(REQUESTS[1])
    finally:
        eng.vocoder = real
    trained = build_generator(eng.config, eng.vocoder_kind, train=True, device="cuda")
    n = load_into(trained, load_bundle(path).vocoder_variables)
    got, want = trained(mels[0]), real(mels[0])
    diff = float((got.detach() - want).abs().max())
    rms = float(want.pow(2).mean().sqrt())
    log(f"bundle warm start: {n} arrays into the training generator (v, g kept); waveform "
        f"{tuple(got.shape)} max|diff| {diff:.3g} from the serving vocoder (bar {WARM_TOL}), "
        f"rms {rms:.3g}")
    if not (got.requires_grad and torch.isfinite(got).all() and diff < WARM_TOL and rms > 1e-3):
        raise AssertionError("bundle warm start: the training generator's waveform is off")
    return err


# --- 16. serving in bfloat16 ---------------------------------------------------------------

BF16_BATCHES = (8, 32)  # the engine's default batch and bench.py's (batch_size=32)
MAX_TIES = 3  # frames a bf16 request may move by when its rows run in other product shapes


@contextlib.contextmanager
def duration_trace(eng, replay=None):
    """Record each stage-1 call of ``eng``: its durations and its
    log-durations (the duration predictor's output); with ``replay`` (the
    trace of another engine) hand on that engine's durations instead of its
    own.  Two engines in another dtype or on another device round some
    durations the other way (a 16-bit log_d a few ulps apart moves a long
    phoneme by a frame, and a frame moves the request's length), so they are
    compared on one set of durations, and their log-durations are held to
    each other (``log_duration_parity``).  Yields the trace: a list of
    durations, with ``.log_d`` and ``.differ`` (own durations that differed
    from those handed on)."""
    acoustic = eng.acoustic
    real = acoustic.synthesize_stage1
    trace = type("Trace", (list,), {})()
    trace.log_d, trace.differ = [], 0
    hook = acoustic.variance_adaptor.duration_predictor.register_forward_hook(
        lambda module, args, out: trace.log_d.append(out.detach().float().cpu()))

    def stage1(*args, **kw):
        x, d = real(*args, **kw)
        if replay is not None:
            want = replay[len(trace)].to(d.device)
            trace.differ += int((d != want).sum())
            d = want
        trace.append(d.cpu())
        return x, d

    acoustic.synthesize_stage1 = stage1
    try:
        yield trace
    finally:
        del acoustic.synthesize_stage1
        hook.remove()


def log_duration_parity(what: str, got, want, f32) -> dict:
    """The log-durations of three traces of one request (``duration_trace``):
    max and mean |got - want| no more than 2 x the same of |want - f32|, the
    16-bit model's own error (the bar of the CPU tests against JAX)."""
    g, w, f = (torch.cat([t.flatten() for t in tr.log_d]) for tr in (got, want, f32))
    ours, theirs = (g - w).abs(), (w - f).abs()
    out = dict(log_d_max=float(f"{ours.max():.3g}"), log_d_mean=float(f"{ours.mean():.3g}"),
               own_max=float(f"{theirs.max():.3g}"), own_mean=float(f"{theirs.mean():.3g}"))
    if not (ours.max() <= 2 * theirs.max() and ours.mean() <= 2 * theirs.mean()):
        raise AssertionError(f"{what}: log-durations {out} past 2 x the bf16 model's own error")
    return out


def timed_requests(engines, what: str):
    """Each request on each engine in turns (a, b, b, a), host clock to the
    int16 on the host: {name: [rows]} with the mean of the two runs."""
    rows = {name: [] for name in engines}
    for text in REQUESTS:
        secs, samples = {name: [] for name in engines}, {}
        for name in list(engines) + list(engines)[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            samples[name] = len(engines[name].synthesize(text))
            secs[name].append(time.perf_counter() - t0)
        for name, eng in engines.items():
            sec, dur = float(np.mean(secs[name])), samples[name] / eng.sample_rate
            rows[name].append(dict(chars=len(text), audio_s=round(dur, 3), seconds=round(sec, 4),
                                   rtf=round(sec / dur, 5)))
    for i, text in enumerate(REQUESTS):
        log(f"{what} " + json.dumps({name: r[i] for name, r in rows.items()}))
    return rows


def bf16_parity(eng, text: str) -> float:
    """``text`` on the bfloat16 CUDA engine against the same weights on the
    CPU in bfloat16 and in float32, all three from the same bucket-estimator
    state and on the CUDA run's durations (``duration_trace``): the CUDA
    waveform's mean |diff| from the CPU bfloat16 one no more than the CPU's
    own bfloat16-against-float32 gap.  Returns that gap in LSB."""
    from e2e_tts_tpu_torch.kernels.flash_attention import launches_16
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

    cpus = {dt: SynthesisEngine.from_random(seed=0, device="cpu", dtype=dt,
                                            batch_size=eng.batch_size)
            for dt in (torch.bfloat16, torch.float32)}
    state = estimator(eng)
    for cpu in cpus.values():
        cpu.vocoder.load_state_dict(eng.vocoder.state_dict())  # the audible scale
        set_estimator(cpu, state)
    before = launches_16()
    with duration_trace(eng) as trace:
        out = eng.synthesize(text)
    if launches_16() <= before:
        raise AssertionError("the bf16 parity request never launched the 16-bit kernel")
    t0 = time.perf_counter()
    refs, traces = {}, {}
    for dt, cpu in cpus.items():
        with duration_trace(cpu, trace) as traces[dt]:
            refs[dt] = cpu.synthesize(text)
    durations = log_duration_parity("bf16 parity", trace, traces[torch.bfloat16],
                                    traces[torch.float32])
    log("bf16 parity: durations handed on from the CUDA run " + json.dumps(dict(
        phonemes=sum(int((d > 0).sum()) for d in trace),
        own_differing={str(dt)[6:]: t.differ for dt, t in traces.items()}, **durations)))
    if not len(out) == len(refs[torch.bfloat16]) == len(refs[torch.float32]):
        raise AssertionError("bf16 parity: lengths differ on one set of durations")
    d = lambda a, b: float(np.abs(a.astype(np.int32) - b.astype(np.int32)).mean())  # noqa: E731
    gap = d(refs[torch.bfloat16], refs[torch.float32])
    ours = d(out, refs[torch.bfloat16])
    log("bf16 parity " + json.dumps(dict(
        chars=len(text), cuda_vs_cpu_bf16_mean_lsb=round(ours, 4),
        cpu_bf16_vs_f32_mean_lsb=round(gap, 4),
        cuda_vs_cpu_bf16_max_lsb=int(np.abs(out.astype(np.int32) - refs[torch.bfloat16]).max()),
        signal_mean_lsb=round(float(np.abs(out.astype(np.int32)).mean()), 1),
        cpu_s=round(time.perf_counter() - t0, 1))))
    if not ours <= gap:
        raise AssertionError(f"bf16 parity: CUDA vs CPU bf16 {ours} LSB > the CPU's own bf16 "
                             f"vs f32 gap {gap}")
    return gap


def flash_counts() -> dict:
    """The flash kernels' launch counts: the float32 form's and each 16-bit
    kernel's."""
    from e2e_tts_tpu_torch.kernels.flash_attention import flash_attention

    return {"flash_attention": flash_attention.launches,
            "flash_attention_16": flash_attention.launches_16,
            "flash_attention_16_sm90": flash_attention.launches_16_sm90}


def check_flash_counts(counts: dict, what: str) -> None:
    """A bfloat16 path at default width (heads of 192) launches the kernel
    the plan takes there, ``flash_fwd_16_sm90``, and never the float32
    form."""
    if counts["flash_attention_16_sm90"] <= 0 or counts["flash_attention"] != 0:
        raise AssertionError(f"{what} launched {counts}: flash_fwd_16_sm90 never, or the "
                             "float32 form")


def serve_bf16(f32_rows):
    """Phase 16: ``from_random(seed=0, dtype=torch.bfloat16)`` at default
    width, at batch 8 and 32, beside the float32 engine of the same batch,
    the four requests in turns (``flash_fwd_16_sm90``'s launches must rise
    and the float32 form's stay 0; both 16-bit kernels held to the plain
    version on the inputs the path gave); the longest request against the
    CPU (``bf16_parity``); a profile of it; ``stream_synthesize`` and 16
    callers through a ``BatchingServer`` over the bfloat16 engine, each
    checked as the engine.  Returns (the launch counts of the counted
    batch-8 run, ``flash_counts``; the kernels' worst error on the paths'
    inputs)."""
    from e2e_tts_tpu_torch.serve import BatchingServer, stream_synthesize
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

    errs, launches = [], None
    for batch in BF16_BATCHES:
        engines = {name: SynthesisEngine.from_random(seed=0, dtype=dt, batch_size=batch)
                   for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
        make_audible(engines["bf16"], engines["f32"])
        for eng in engines.values():  # warm-up passes, not counted: the buckets settle
            for _ in range(2):
                for text in REQUESTS:
                    eng.synthesize(text)
        state = estimator(engines["bf16"])
        with recorded_inputs() as seen:
            for text in REQUESTS:
                engines["bf16"].synthesize(text)
        counted = flash_counts()
        log(f"bf16 serve (batch {batch}): launches {json.dumps(counted)} in the four requests")
        check_flash_counts(counted, f"the bf16 serving run (batch {batch})")
        errs.append(check_serving_inputs(seen, f"bf16 serving (batch {batch})"))
        if batch == BF16_BATCHES[0]:
            launches = counted
        set_estimator(engines["bf16"], state)
        rows = timed_requests(engines, f"bf16 vs f32 serve (batch {batch})")
        for name, eng in engines.items():
            log_profile(f"{name} request (batch {batch}, {len(REQUESTS[-1])} chars)",
                        device_busy(lambda: eng.synthesize(REQUESTS[-1])), "flash_")
        if batch == BF16_BATCHES[0]:
            log("bf16 serve vs phase 5's f32 run (batch 8) " + json.dumps(
                [dict(chars=a["chars"], bf16_s=a["seconds"], f32_phase5_s=b["seconds"])
                 for a, b in zip(rows["bf16"], f32_rows)]))
            bf16 = engines["bf16"]
    gap = bf16_parity(bf16, REQUESTS[-1])

    # stream_synthesize over the bfloat16 engine
    text = REQUESTS[-1]
    list(stream_synthesize(bf16, text))  # warm-up, not counted
    state = estimator(bf16)
    with recorded_inputs() as seen:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first, chunks = None, []
        for chunk in stream_synthesize(bf16, text):
            first = time.perf_counter() - t0 if first is None else first
            chunks.append(chunk)
        total = time.perf_counter() - t0
    streamed_counts = flash_counts()
    check_flash_counts(streamed_counts, "stream_synthesize over the bf16 engine")
    errs.append(check_serving_inputs(seen, "bf16 stream_synthesize"))
    streamed = np.concatenate(chunks)
    set_estimator(bf16, state)
    solo = bf16.synthesize(text)
    # each text chunk alone in a full batch, where the engine batches them:
    # other product shapes, so a duration may round the other way at a tie
    frames = (len(solo) - len(bf16.prepare_request(text)[0]) * bf16.sample_rate // 2
              - len(streamed)) // bf16.hop_length
    log("bf16 stream_synthesize " + json.dumps(dict(
        chars=len(text), chunks=len(chunks), audio_s=round(len(streamed) / bf16.sample_rate, 3),
        first_chunk_s=round(first, 4), total_s=round(total, 4),
        launches=streamed_counts, frames_vs_engine=frames)))
    if streamed.dtype != np.int16 or len(streamed) % bf16.hop_length or abs(frames) > MAX_TIES:
        raise AssertionError(f"bf16 stream_synthesize: {frames} frames from the engine's length")

    # 16 callers at once through a BatchingServer over the bfloat16 engine
    texts = [REQUESTS[i % len(REQUESTS)] for i in range(N_CALLERS)]
    with BatchingServer(bf16, max_wait_ms=20.0) as srv:
        burst(srv, texts)  # warm-up burst, not counted
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solo = [bf16.synthesize(t) for t in texts]
        serial_s = time.perf_counter() - t0
        with recorded_inputs() as seen:
            outs, queue_s, cycles = burst(srv, texts)
        queued_counts = flash_counts()
        check_flash_counts(queued_counts, "the bf16 queued run")
        errs.append(check_serving_inputs(seen, "bf16 queue"))
        busy = device_busy(lambda: burst(srv, texts))
    # a request's rows share batches with other requests' (other product
    # shapes): equal lengths are held to the bf16 gap, and a length may move
    # by the frames of a duration rounded the other way at a tie
    diffs, moved = [], []
    for i, (o, s) in enumerate(zip(outs, solo)):
        if len(o) == len(s):
            diffs.append(float(np.abs(o.astype(np.int32) - s.astype(np.int32)).mean()))
        else:
            moved.append((len(o) - len(s)) // bf16.hop_length)
    if not diffs or any(abs(f) > MAX_TIES for f in moved):
        raise AssertionError(f"bf16 queue: lengths moved by {moved} frames")
    audio_s = sum(len(a) for a in solo) / bf16.sample_rate
    log("bf16 queue " + json.dumps(dict(
        callers=N_CALLERS, audio_s=round(audio_s, 3), cycles=cycles, frames_moved=moved,
        launches=queued_counts, worst_mean_lsb_vs_solo=round(max(diffs), 4),
        serial_s=round(serial_s, 4), queue_s=round(queue_s, 4),
        serial_audio_s_per_s=round(audio_s / serial_s, 3),
        queue_audio_s_per_s=round(audio_s / queue_s, 3),
        busy_share=None if busy is None else busy["busy_share"])))
    if not max(diffs) <= max(LSB_TOL, gap):
        raise AssertionError(f"bf16 queue: a result {max(diffs)} LSB from its solo run, past "
                             f"max({LSB_TOL}, the bf16-vs-f32 gap {gap})")
    return launches, max(errs)


def device_busy(fn):
    """``fn()`` under ``torch.profiler``: wall ms, device busy ms (the union of
    the kernels' intervals: kernels that overlap count once) and share, the
    kernels' summed time, and their device times by name; None when the
    profiler shows no device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return profile_busy(prof, wall_ms)


def profile_busy(prof, wall_ms: float):
    """``device_busy``'s record from a finished ``torch.profiler`` run over a
    window of ``wall_ms``; None when it shows no device time."""
    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    dev_ms = lambda e: getattr(e, "self_device_time_total", 0.0) / 1e3  # noqa: E731
    kernel_ms = sum(dev_ms(e) for e in kernels)
    if kernel_ms <= 0:
        log("profile: the profiler shows no device time: device busy share not measured")
        return None
    busy_ms, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                              if str(e.device_type).endswith("CUDA")):
        busy_ms += max(0.0, stop - max(start, end)) / 1e3
        end = max(end, stop)
    host = sorted((e for e in events if str(e.device_type).endswith("CPU")),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    return dict(wall_ms=round(wall_ms, 3), device_busy_ms=round(busy_ms, 3),
                busy_share=round(busy_ms / wall_ms, 4), kernel_ms=round(kernel_ms, 3),
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


# --- 18. corpus to voice ---------------------------------------------------------------------

CORPUS_SENTENCES = 24  # x the synthetic corpus's 2 speakers
CORPUS_B = 16
CORPUS_STEPS = 10
CKPT_STEP = 5  # the checkpoint: saved after this many steps, restored into a fresh model
VOC_CORPUS_STEPS = 2
GOLDEN = "xin chào việt nam"  # C5: vie_tiny's decoder logits on this text


def decoder_logits(eng, text: str):
    """Serve ``text`` and return, per decoder layer of the engine's acoustic
    model, the std and max |.| of the self-attention logits
    q k^T / sqrt(d_k) over the valid (query, key) pairs, and the layer's
    (q, k, v, kv_lens) folded as the flash kernel takes them (B * H, T, d_k)."""
    layers = []

    def hook(mod, args):
        x, pair_mask, kv_lens = args[0], args[1], args[2]
        B, T, _ = x.shape
        H, dk = mod.n_head, mod.d_k
        with torch.no_grad():
            q, k, v = (w(x).view(B, T, H, dk).float() for w in (mod.w_q, mod.w_k, mod.w_v))
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(dk)
            valid = s[pair_mask[:, None].expand_as(s)]

            def fold(t):
                return t.permute(0, 2, 1, 3).reshape(B * H, T, dk).contiguous()

            layers.append(dict(std=float(valid.std()), max_abs=float(valid.abs().max()),
                               pairs=int(valid.numel()), d_k=dk,
                               inputs=(fold(q), fold(k), fold(v),
                                       torch.repeat_interleave(kv_lens.to(torch.int32), H))))

    hooks = [layer.slf_attn.register_forward_pre_hook(hook)
             for layer in eng.acoustic.decoder.layers]
    try:
        eng.synthesize(text)
    finally:
        for h in hooks:
            h.remove()
    return layers


def corpus_features(cfg, entries, cpu_root):
    """Every utterance's features on the card (timed: mel and energy on the
    card, f0 and pitch on the host), then on the CPU from a copy of the wavs,
    held to each other.  Returns the timing record."""
    import e2e_tts_tpu_torch.data.features as data_features

    spent = {"mel_and_energy": 0.0, "f0_and_pitch": 0.0}

    def timed(name):
        real = getattr(data_features, name)

        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return real, call

    reals = {}
    for name in spent:
        reals[name], wrapped = timed(name)
        setattr(data_features, name, wrapped)
    try:
        data_features.create_utterance_features(entries[0][0], cfg, device="cuda")  # warm-up
        spent.update(mel_and_energy=0.0, f0_and_pitch=0.0)
        t0 = time.perf_counter()
        card = {wav: data_features.create_utterance_features(wav, cfg, overwrite=True,
                                                             device="cuda")
                for wav, *_ in entries}
        wall = time.perf_counter() - t0
    finally:
        for name, real in reals.items():
            setattr(data_features, name, real)
    mel_mae = energy_max = 0.0
    t0 = time.perf_counter()
    for wav, got in card.items():
        want = data_features.create_utterance_features(
            os.path.join(cpu_root, "wavs", os.path.basename(wav)), cfg, device="cpu")
        if any(got[k].shape != want[k].shape for k in want):
            raise AssertionError(f"corpus features: shapes differ for {wav}")
        mel_mae = max(mel_mae, float(np.abs(got["mels"] - want["mels"]).mean()))
        energy_max = max(energy_max, float(np.abs(got["energy"] - want["energy"]).max()))
        if not (np.array_equal(got["f0"], want["f0"]) and np.array_equal(got["pitch"],
                                                                         want["pitch"])):
            raise AssertionError(f"corpus features: f0 or pitch differ from the CPU for {wav}")
    cpu_s = time.perf_counter() - t0
    n = len(entries)
    rec = dict(utterances=n, frames=int(sum(f["mels"].shape[1] for f in card.values())),
               wall_s=round(wall, 4), utterances_per_s=round(n / wall, 2),
               mel_on_card_ms_per_utt=round(1e3 * spent["mel_and_energy"] / n, 3),
               f0_pitch_on_host_ms_per_utt=round(1e3 * spent["f0_and_pitch"] / n, 3),
               cpu_run_s=round(cpu_s, 2), worst_mel_mae=float(f"{mel_mae:.3g}"),
               worst_energy_max=float(f"{energy_max:.3g}"), f0_pitch_equal=True)
    if not (mel_mae < LOGMEL_MAE and energy_max < ENERGY_TOL):
        raise AssertionError(f"corpus features: card vs CPU mel MAE {mel_mae} (bar {LOGMEL_MAE}) "
                             f"energy max {energy_max} (bar {ENERGY_TOL})")
    return rec


def timed_batches(make):
    """Every batch of one pass of the batcher ``make()`` and the host ms each
    took to make (collate and copy to the card)."""
    out, it = [], make()
    while True:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return out
        torch.cuda.synchronize()
        out.append((batch, 1e3 * (time.perf_counter() - t0)))


def resume_parity(cfg, n_symbols, n_speakers, stats, n_words, ckpt, batch, want_metrics,
                  saved, mu_after, opt, names) -> dict:
    """Restore the step-5 checkpoint into a fresh model (other weights and
    dropout stream), check its Adam moments bit-equal to the saved ones, run
    step 6 on the same batch and hold it to step 6 of the run that saved it:
    each loss term within TRAIN_LOSS_RTOL, each gradient (read from Adam's
    first moments) within TRAIN_GRAD_RTOL.  ``saved``: a copy of the Adam
    state at the save; ``mu_after``: the first moments after step 6."""
    from e2e_tts_tpu_torch.train import build_acoustic_model, init_train_state, make_train_step

    model = build_acoustic_model(cfg, n_symbols, n_speakers, stats, device="cuda", seed=1)
    state = init_train_state(model, opt, seed=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.restore(state, step=CKPT_STEP)
    torch.cuda.synchronize()
    restore_ms = 1e3 * (time.perf_counter() - t0)
    got_opt = state.opt_state
    if state.step != CKPT_STEP or got_opt.count != saved.count or not all(
            torch.equal(a, b) for a, b in zip(got_opt.mu + got_opt.nu, saved.mu + saved.nu)):
        raise AssertionError("checkpoint: the restored step or Adam state differs")
    _, got = make_train_step(model, cfg, opt, n_words)(state, batch)
    loss_err = {}
    for k, w in want_metrics.items():
        w, g = float(w), float(got[k])
        loss_err[k] = abs(g - w) / max(abs(w), 1e-12)
        if not loss_err[k] < TRAIN_LOSS_RTOL:
            raise AssertionError(f"resumed step 6: loss {k} {g} against {w}")
    b1, worst = opt.b1, (0.0, "")
    for name, m0, m1, m2 in zip(names, saved.mu, mu_after, state.opt_state.mu):
        if ZERO_BY_CONSTRUCTION.search(name):
            continue
        g_want = (m1 - b1 * m0) / (1 - b1)
        rel = float((m2 - m1).norm() / (1 - b1) / g_want.norm().clamp(min=1e-30))
        worst = max(worst, (rel, name))
    if not worst[0] < TRAIN_GRAD_RTOL:
        raise AssertionError(f"resumed step 6: gradient of {worst[1]} rel err {worst[0]}")
    return dict(restore_ms=round(restore_ms, 3), moments_bit_equal=True,
                loss_rel_err={k: float(f"{v:.3g}") for k, v in loss_err.items()},
                worst_grad_rel_err=float(f"{worst[0]:.3g}"), worst_grad=worst[1])


def corpus_to_voice(smi: str, work: str):
    """Phase 18: a synthetic corpus through the port on the card, from wavs to
    a served voice, in ``work`` (the corpus stays there for phase 19).
    Returns (the training kernels' launches in the 10 steps, their errors on
    the steps' inputs, the flash kernel's error on the served voice's
    inputs)."""
    import shutil

    from e2e_tts_tpu_torch.config import default_config
    from e2e_tts_tpu_torch.data import (AcousticDataset, VocoderDataset, build_speaker_map,
                                        compute_stats, create_unsupervised_filelist,
                                        make_acoustic_batches, make_vocoder_batches,
                                        read_filelist)
    from e2e_tts_tpu_torch.data.synthetic import make_synthetic_corpus
    from e2e_tts_tpu_torch.kernels.ctc import ctc_bwd, ctc_fwd
    from e2e_tts_tpu_torch.kernels.flash_attention import flash_attention
    from e2e_tts_tpu_torch.kernels.mas import mas
    from e2e_tts_tpu_torch.nn.variance import FeatureStats
    from e2e_tts_tpu_torch.serve.bundle import save_bundle
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine
    from e2e_tts_tpu_torch.text.symbols import symbols
    from e2e_tts_tpu_torch.train import (CheckpointManager, VocoderBatch, acoustic_optimizer,
                                         build_acoustic_model, gan_optimizer, init_train_state,
                                         init_vocoder_train_state, make_train_step,
                                         make_vocoder_train_step)

    cfg = default_config()
    n_words = max(cfg.models.fastspeech2.max_seq_len, 256)
    root, cpu_root = os.path.join(work, "corpus"), os.path.join(work, "corpus_cpu")
    t0 = time.perf_counter()
    sentences = make_synthetic_corpus(root, n_sentences=CORPUS_SENTENCES, f0_jitter=0.1,
                                      seed=0)
    corpus_s = time.perf_counter() - t0
    shutil.copytree(os.path.join(root, "wavs"), os.path.join(cpu_root, "wavs"))
    _, skipped = create_unsupervised_filelist([root], os.path.join(work, "list.txt"))
    entries = read_filelist(os.path.join(work, "list.txt"))
    if skipped or len(entries) != 2 * CORPUS_SENTENCES:
        raise AssertionError(f"corpus: {len(entries)} entries, skipped {skipped}")
    prep = corpus_features(cfg, entries, cpu_root)
    log("corpus features " + json.dumps(dict(card=smi, corpus_s=round(corpus_s, 2), **prep)))

    stats = compute_stats(entries)
    speakers = build_speaker_map(entries)
    ds = AcousticDataset(entries, speakers, stats, cfg)
    batches = timed_batches(lambda: make_acoustic_batches(ds, CORPUS_B, seed=0,
                                                          device="cuda"))
    keys = [(int(b.texts.shape[1]), int(b.mel.shape[1])) for b, _ in batches]
    feature_stats = FeatureStats.from_dict(stats)

    # the CUDA-against-CPU step parity on the first corpus batch's rows
    train_parity(cfg, [t.cpu().numpy() for t in batches[0][0]], len(symbols), n_words)

    model = build_acoustic_model(cfg, len(symbols), len(speakers), feature_stats,
                                 device="cuda")
    opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer,
                             cfg.models.fastspeech2.encoder_hidden)
    state = init_train_state(model, opt, seed=0)
    train_step = make_train_step(model, cfg, opt, n_words)
    names = [n for n, _ in model.named_parameters()]
    ckpt = CheckpointManager(os.path.join(work, "ckpt"), max_to_keep=2)
    step_ms, metrics, resume = [], [], {}
    with recorded_train_inputs() as seen:
        for i in range(CORPUS_STEPS):
            batch = batches[i % len(batches)][0]
            if i == CKPT_STEP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ckpt.save(CKPT_STEP, state, wait=True)
                resume["save_ms"] = round(1e3 * (time.perf_counter() - t0), 3)
                saved = copy.deepcopy(state.opt_state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = train_step(state, batch)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            metrics.append(m)
            if i == CKPT_STEP:
                mu_after = [m_.clone() for m_ in state.opt_state.mu]
        launches = {"mas": mas.launches, "ctc_fwd": ctc_fwd.launches,
                    "ctc_bwd": ctc_bwd.launches}
    if any(n != CORPUS_STEPS for n in launches.values()):
        raise AssertionError(f"corpus training: each step should launch each training "
                             f"kernel once: {launches} in {CORPUS_STEPS} steps")
    last = check_finite("corpus training", metrics)
    errs = check_training_inputs(seen)
    by_bucket = {}
    for i, ms in enumerate(step_ms):
        by_bucket.setdefault(str(keys[i % len(batches)]), []).append(round(ms, 3))
    batch_ms = [ms for _, ms in batches]
    log("corpus train steps " + json.dumps(dict(
        card=smi, batches=len(batches), rows=CORPUS_B, buckets=[str(k) for k in keys],
        batch_host_ms=[round(ms, 3) for ms in batch_ms],
        batch_host_ms_mean=round(float(np.mean(batch_ms)), 3),
        step_ms_by_bucket=by_bucket, step_ms_after_first_by_bucket={
            k: round(float(np.median(v[1:] or v)), 3) for k, v in by_bucket.items()},
        launches=launches, last_metrics=last)))
    resume.update(resume_parity(cfg, len(symbols), len(speakers), feature_stats, n_words,
                                ckpt, batches[CKPT_STEP % len(batches)][0],
                                metrics[CKPT_STEP], saved, mu_after, opt, names))
    log("corpus checkpoint " + json.dumps(dict(card=smi, step=CKPT_STEP, **resume)))
    del saved, mu_after

    # 2 GAN steps of HiFi-GAN V1 with MPD/MSD at reference widths on the corpus
    vds = VocoderDataset(entries, cfg)
    voc_batches = timed_batches(lambda: make_vocoder_batches(vds, CORPUS_B, seed=0,
                                                             device="cuda"))
    gen, mpd, msd = gan_modules(cfg, device="cuda")
    g_opt, d_opt = (gan_optimizer(cfg.train.hifigan_optimizer) for _ in range(2))
    vstate = init_vocoder_train_state(gen, g_opt, d_opt, mpd, msd)
    vstep = make_vocoder_train_step(gen, cfg, g_opt, d_opt, "hifigan", mpd, msd)
    voc_ms, voc_metrics = [], []
    for i in range(VOC_CORPUS_STEPS):
        vb = voc_batches[i % len(voc_batches)][0]
        if not isinstance(vb, VocoderBatch) or tuple(vb.audio.shape) != (CORPUS_B, 8192):
            raise AssertionError(f"vocoder batch {tuple(vb.audio.shape)}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        voc_metrics.append(vstep(vstate, vb)[1])
        torch.cuda.synchronize()
        voc_ms.append(round(1e3 * (time.perf_counter() - t0), 3))
    log("corpus vocoder steps " + json.dumps(dict(
        card=smi, batches=len(voc_batches), batch=[CORPUS_B, 8192],
        batch_host_ms=[round(ms, 3) for _, ms in voc_batches], step_ms=voc_ms,
        last_metrics=check_finite("corpus vocoder steps", voc_metrics))))

    # the trained models as a bundle, served on the card against the CPU
    bundle_dir = os.path.join(work, "bundle")
    t0 = time.perf_counter()
    save_bundle(bundle_dir, cfg, model, gen, speakers, feature_stats)
    save_s = time.perf_counter() - t0
    eng = SynthesisEngine.from_checkpoint(bundle_dir, device="cuda")
    cpu = SynthesisEngine.from_checkpoint(bundle_dir, device="cpu")
    text = " ".join(sentences[:8])
    eng.synthesize(text)  # warm-up, not counted
    set_estimator(cpu, estimator(eng))
    with recorded_inputs() as seen_serve:
        out = eng.synthesize(text, speaker_id="nu")
        served = {"flash_attention": flash_attention.launches}
    lsb = lsb_diff(f"corpus voice: {len(text)} characters, bundle written in {save_s:.2f} s, "
                   f"CUDA vs CPU", out, cpu.synthesize(text, speaker_id="nu"))
    if served["flash_attention"] <= 0:
        raise AssertionError("the corpus voice never launched flash_attention")
    serve_err = check_serving_inputs(seen_serve, "corpus voice")
    log("corpus voice " + json.dumps(dict(card=smi, bundle_files=sorted(os.listdir(
        bundle_dir)), bundle_mb=round(sum(os.path.getsize(os.path.join(bundle_dir, f))
                                          for f in os.listdir(bundle_dir)) / 2**20, 2),
        save_bundle_s=round(save_s, 3), samples=len(out), mean_lsb=round(lsb, 4),
        launches=served)))
    return launches, errs, serve_err


def logit_sharpness(smi: str) -> None:
    """ROADMAP C5: the std of vie_tiny's decoder self-attention logits on a
    golden text on the card, and both 16-bit kernels' ulp error on those
    very q, k, v in bfloat16 and float16 (measured, not a bar: phase 3 holds
    the bar)."""
    from e2e_tts_tpu_torch.kernels.flash_attention import (attention_plain, flash_attention,
                                                           ulp_error)
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), BUNDLE)
    layers = decoder_logits(SynthesisEngine.from_checkpoint(path, device="cuda"), GOLDEN)
    ulps = {}
    for i, layer in enumerate(layers):
        q, k, v, kv = layer.pop("inputs")
        for dtype in (torch.bfloat16, torch.float16):
            args = tuple(t.to(dtype) for t in (q, k, v))
            ref = attention_plain(*args, kv)
            for kernel in ("sm90", "mma_sync"):
                out = flash_attention(*args, kv, kernel=kernel)
                key = f"layer{i}_{str(dtype)[6:]}_{kernel}"
                ulps[key] = round(ulp_error(out, ref, args[2], kv), 3)
    log("C5 decoder logits " + json.dumps(dict(
        card=smi, bundle=BUNDLE, text=GOLDEN,
        layers=[{k: (round(v, 4) if isinstance(v, float) else v) for k, v in layer.items()}
                for layer in layers], ulp_16bit=ulps)))


# --- 19. the training CLI: corpus to voice ----------------------------------------------------

CLI_STEPS, CLI_CKPT, CLI_RESUME = 8, 4, 10  # acoustic --steps 8 --ckpt-every 4, then --steps 10
CLI_SUPERVISED_STEPS = 4


def run_cli(seconds: dict, name: str, argv, on_step=None):
    """``python -m e2e_tts_tpu_torch.train.cli`` ``argv`` on the card, in this
    process (so that the launch counts and the recorded inputs see it): its
    printed lines (also logged) and its result; its seconds, from a
    synchronized card to a synchronized card, go into ``seconds[name]``."""
    import io

    from e2e_tts_tpu_torch.train import cli

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = cli.main(list(argv) + ["--device", "cuda"], on_step)
    torch.cuda.synchronize()
    seconds[name] = round(time.perf_counter() - t0, 3)
    out = buf.getvalue()
    for line in out.strip().splitlines():
        log(f"  {line}")
    return out, result


def training_launches() -> dict:
    from e2e_tts_tpu_torch.kernels.ctc import ctc_bwd, ctc_fwd
    from e2e_tts_tpu_torch.kernels.mas import mas

    return {"mas": mas.launches, "ctc_fwd": ctc_fwd.launches, "ctc_bwd": ctc_bwd.launches}


def reset_training_launches() -> None:
    from e2e_tts_tpu_torch.kernels.ctc import ctc_bwd, ctc_fwd
    from e2e_tts_tpu_torch.kernels.mas import mas

    mas.launches = ctc_fwd.launches = ctc_bwd.launches = 0


def expect_launches(what: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{what}: training kernel launches {got}, expected {want}")
    log(f"{what}: launches {got}")


def step_wall_ms(stamps, first: int, last: int) -> float:
    """Mean wall ms a step from the synchronized end of step ``first`` to that
    of step ``last`` (1-based) in ``stamps``."""
    return 1e3 * (stamps[last - 1] - stamps[first - 1]) / (last - first)


def serve_cli_bundle(smi: str, bundle_dir: str, text: str, what: str):
    """The bundle on the card (counted) against the CPU, their vocoders made
    audible alike: returns (mean LSB, flash launches, the kernel's worst
    error on the run's own inputs)."""
    from e2e_tts_tpu_torch.kernels.flash_attention import flash_attention
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

    eng = SynthesisEngine.from_checkpoint(bundle_dir, device="cuda")
    cpu = SynthesisEngine.from_checkpoint(bundle_dir, device="cpu")
    make_audible(eng, cpu)
    eng.synthesize(text)  # warm-up, not counted
    set_estimator(cpu, estimator(eng))
    with recorded_inputs() as seen:
        out = eng.synthesize(text, speaker_id="nu")
        launches = flash_attention.launches
    lsb = lsb_diff(f"{what}: {len(text)} characters, CUDA vs CPU", out,
                   cpu.synthesize(text, speaker_id="nu"))
    if launches <= 0:
        raise AssertionError(f"{what}: serving never launched flash_attention")
    return lsb, launches, check_serving_inputs(seen, what)


def cli_corpus_to_voice(smi: str, work: str):
    """Phase 19: phase 18's corpus through the training CLI on the card, at
    the default width: the unsupervised run (prepare, acoustic with a
    checkpoint and a resume, vocoder, e2e, generate-mels, vocoder on the
    predicted mels, export, the voice served against the CPU) and the
    supervised one on the corpus labelled with its durations.  Measures each
    subcommand's seconds, the acoustic loop's wall ms a step with the
    prefetch thread beside the same steps on batches made before, and the
    device busy share of a profiled window of the loop.  Returns (the
    training kernels' launches in the CLI's train steps, their errors on
    those steps' inputs, the flash kernel's errors on the served voices'
    inputs)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from e2e_tts_tpu_torch.config import default_config
    from e2e_tts_tpu_torch.data import (AcousticDataset, make_acoustic_batches, read_filelist,
                                        split_train_valid)
    from e2e_tts_tpu_torch.data.synthetic import make_sentences, write_duration_labels
    from e2e_tts_tpu_torch.nn.variance import FeatureStats
    from e2e_tts_tpu_torch.text.symbols import symbols
    from e2e_tts_tpu_torch.train import (acoustic_optimizer, build_acoustic_model,
                                         init_train_state, make_train_step)

    cfg = default_config()
    root = os.path.join(work, "corpus")  # phase 18's
    w = os.path.join(work, "cli")
    seconds, launches, errs = {}, {}, {}
    text = " ".join(make_sentences(CORPUS_SENTENCES, seed=0)[:8])

    # --- unsupervised: prepare -> acoustic (checkpoint, resume) -> vocoder -> e2e -> ...
    run_cli(seconds, "prepare", ["prepare", "--corpus", root, "--workdir", w, "--overwrite"])
    entries = read_filelist(os.path.join(w, "file_list.txt"))
    with open(os.path.join(w, "stats.json")) as f:
        stats = json.load(f)
    with open(os.path.join(w, "speakers.json")) as f:
        speakers = json.load(f)
    train_entries, valid_entries = split_train_valid(entries, seed=cfg.train.seed)
    valid_batches = sum(1 for _ in make_acoustic_batches(
        AcousticDataset(valid_entries, speakers, stats, cfg), cfg.train.batch_size,
        shuffle=False, device="cpu"))

    stamps = []

    def stamp(step, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    with recorded_train_inputs() as seen:
        out, step = run_cli(seconds, "acoustic", ["acoustic", "--workdir", w, "--steps",
                                                  str(CLI_STEPS), "--ckpt-every", str(CLI_CKPT)],
                            stamp)
        got = training_launches()
    validations = CLI_STEPS // CLI_CKPT
    expect_launches("CLI acoustic", got, {
        "mas": CLI_STEPS + validations * valid_batches,
        "ctc_fwd": CLI_STEPS + validations * valid_batches, "ctc_bwd": CLI_STEPS})
    if step != CLI_STEPS or "valid_total=" not in out or len(stamps) != CLI_STEPS:
        raise AssertionError(f"CLI acoustic: ended at step {step}, {len(stamps)} steps seen")
    errs["acoustic"] = check_training_inputs(seen)
    launches["acoustic"] = {k: v - validations * valid_batches * (k != "ctc_bwd")
                            for k, v in got.items()}
    # steps 1..4 and 5..8: the checkpoint and the validation after step 4 left out
    prefetch_ms = (step_wall_ms(stamps, 1, CLI_CKPT) * (CLI_CKPT - 1) + step_wall_ms(
        stamps, CLI_CKPT + 1, CLI_STEPS) * (CLI_STEPS - CLI_CKPT - 1)) / (CLI_STEPS - 2)

    # the same steps on batches made before, by the same batcher in this thread
    ds = AcousticDataset(train_entries, speakers, stats, cfg,
                         prior_cache_dir=os.path.join(w, "priors"))
    made, epoch = [], 0
    while len(made) < CLI_STEPS:
        made += timed_batches(lambda: make_acoustic_batches(
            ds, cfg.train.batch_size, seed=cfg.train.seed + epoch, device="cuda"))
        epoch += 1
    model = build_acoustic_model(cfg, len(symbols), len(speakers), FeatureStats.from_dict(stats),
                                 device="cuda", seed=cfg.train.seed)
    opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer,
                             cfg.models.fastspeech2.encoder_hidden)
    state = init_train_state(model, opt, seed=cfg.train.seed)
    train_step = make_train_step(model, cfg, opt, max(cfg.models.fastspeech2.max_seq_len, 256))
    stamps.clear()
    for batch, _ in made[:CLI_STEPS]:
        train_step(state, batch)
        stamp(None, None)
    premade_ms = (step_wall_ms(stamps, 1, CLI_CKPT) * (CLI_CKPT - 1) + step_wall_ms(
        stamps, CLI_CKPT + 1, CLI_STEPS) * (CLI_STEPS - CLI_CKPT - 1)) / (CLI_STEPS - 2)
    del model, opt, state, train_step
    batch_ms = [ms for _, ms in made]

    run_cli(seconds, "vocoder", ["vocoder", "--workdir", w, "--steps", "2"])

    # resume at step 8; the window from the end of step 9 to that of step 10 profiled
    window = {}

    def profiled(step, metrics):
        torch.cuda.synchronize()
        if step == CLI_STEPS + 1:
            window["prof"] = torch_profile(activities=[ProfilerActivity.CPU,
                                                       ProfilerActivity.CUDA])
            window["prof"].start()
            window["t0"] = time.perf_counter()
        elif step == CLI_STEPS + 2:
            window["wall_ms"] = 1e3 * (time.perf_counter() - window["t0"])
            window["prof"].stop()

    reset_training_launches()
    out, step = run_cli(seconds, "acoustic_resume", ["acoustic", "--workdir", w, "--steps",
                                                     str(CLI_RESUME)], profiled)
    if f"[acoustic] resumed from step {CLI_STEPS}" not in out or step != CLI_RESUME:
        raise AssertionError(f"CLI acoustic did not resume at step {CLI_STEPS}: {out!r}")
    n = CLI_RESUME - CLI_STEPS
    expect_launches("CLI acoustic resumed", training_launches(),
                    {"mas": n, "ctc_fwd": n, "ctc_bwd": n})
    launches["acoustic_resume"] = training_launches()
    busy = profile_busy(window["prof"], window["wall_ms"])
    top = []
    if busy is not None:
        top = [dict(name=k[0][:80], ms=k[1], n=k[2]) for k in busy.pop("kernels")[:8]]
        host = busy.pop("host")[:6]
        busy["host_top"] = [dict(name=k[0][:60], ms=k[1], n=k[2]) for k in host]

    e2e_steps = 2
    with recorded_train_inputs() as seen:
        out, step = run_cli(seconds, "e2e", ["e2e", "--workdir", w, "--steps", str(e2e_steps),
                                             "--am-lr-scale", "0.1", "--adv-warmup", "2"])
        got = training_launches()
    expect_launches("CLI e2e", got, {k: e2e_steps for k in got})
    if f"acoustic seeded from step {CLI_RESUME}" not in out or "vocoder seeded from step 2" \
            not in out:
        raise AssertionError(f"CLI e2e did not start from the stages' checkpoints: {out!r}")
    errs["e2e"] = check_training_inputs(seen)
    launches["e2e"] = got

    reset_training_launches()
    _, count = run_cli(seconds, "generate_mels", ["generate-mels", "--workdir", w])
    mels = sorted(os.listdir(os.path.join(root, "predicted_mels")))
    if count < len(entries) or len(mels) != len(entries):  # a batch's tail repeats rows
        raise AssertionError(f"generate-mels wrote {count} mels ({len(mels)} files) for "
                             f"{len(entries)} utterances")
    gen_launches = training_launches()  # MAS once a batch: the teacher-forced aligner
    log(f"CLI generate-mels: launches {gen_launches}")
    out, step = run_cli(seconds, "vocoder_predicted", ["vocoder", "--workdir", w, "--steps", "3",
                                                       "--predicted-mels"])
    if "[vocoder] resumed from step 2" not in out or step != 3:
        raise AssertionError(f"CLI vocoder --predicted-mels did not resume at step 2: {out!r}")
    bundle_dir = os.path.join(work, "cli_bundle")
    out, _ = run_cli(seconds, "export", ["export", "--workdir", w, "--output", bundle_dir])
    if f"using e2e fine-tune step {e2e_steps}" not in out:
        raise AssertionError(f"CLI export did not take the e2e checkpoint: {out!r}")
    t0 = time.perf_counter()
    lsb, flash, serve_errs = serve_cli_bundle(smi, bundle_dir, text, "CLI voice")
    voice = dict(mean_lsb=round(lsb, 4), flash_launches=flash,
                 serve_s=round(time.perf_counter() - t0, 2))

    # --- supervised: the same corpus labelled with its durations
    write_duration_labels(root)
    ws = os.path.join(work, "cli_supervised")
    sup_seconds = {}
    reset_training_launches()
    run_cli(sup_seconds, "prepare", ["prepare", "--corpus", root, "--workdir", ws,
                                     "--supervised"])
    _, step = run_cli(sup_seconds, "acoustic", ["acoustic", "--workdir", ws, "--steps",
                                                str(CLI_SUPERVISED_STEPS), "--supervised"])
    run_cli(sup_seconds, "vocoder", ["vocoder", "--workdir", ws, "--steps", "1"])
    sup_bundle = os.path.join(work, "cli_supervised_bundle")
    run_cli(sup_seconds, "export", ["export", "--workdir", ws, "--output", sup_bundle,
                                    "--supervised"])
    expect_launches("CLI supervised", training_launches(), {"mas": 0, "ctc_fwd": 0,
                                                            "ctc_bwd": 0})
    if step != CLI_SUPERVISED_STEPS:
        raise AssertionError(f"CLI acoustic --supervised ended at step {step}")
    t0 = time.perf_counter()
    sup_lsb, sup_flash, sup_errs = serve_cli_bundle(smi, sup_bundle, text, "CLI supervised voice")
    sup_voice = dict(mean_lsb=round(sup_lsb, 4), flash_launches=sup_flash,
                     serve_s=round(time.perf_counter() - t0, 2))

    log("CLI corpus to voice " + json.dumps(dict(
        card=smi, utterances=len(entries), train=len(train_entries), valid=len(valid_entries),
        valid_batches=valid_batches, subcommand_s=seconds, supervised_subcommand_s=sup_seconds,
        acoustic_step_wall_ms=dict(prefetch_thread=round(prefetch_ms, 3),
                                   premade_batches=round(premade_ms, 3),
                                   ratio=round(prefetch_ms / premade_ms, 4),
                                   batch_host_ms=[round(ms, 3) for ms in batch_ms],
                                   batch_host_ms_mean=round(float(np.mean(batch_ms)), 3)),
        profiled_window=dict(steps=[CLI_STEPS + 1, CLI_STEPS + 2], **(busy or {}), top=top),
        launches=launches, generate_mels_launches=gen_launches, voice=voice,
        supervised_voice=sup_voice)))
    total = {k: sum(run[k] for run in launches.values()) for k in ("mas", "ctc_fwd", "ctc_bwd")}
    worst = {k: max(e[k] for e in errs.values()) for k in total}
    return total, worst, max(serve_errs, sup_errs)


# --- 20. the other block families ------------------------------------------------------------

FAMILIES = ("conformer", "fastformer", "lstransformer", "reformer")
FAMILY_CLI_STEPS = 2


def family_config(family: str):
    """The default config with ``block_type`` ``family`` (the schema's
    defaults of that family at the default width)."""
    from e2e_tts_tpu_torch.config import default_config

    cfg = default_config()
    fs2 = cfg.models.fastspeech2
    return cfg.replace(models=cfg.models.replace(fastspeech2=fs2.replace(
        building_block=fs2.building_block.replace(block_type=family))))


def zero_flash_counts() -> None:
    from e2e_tts_tpu_torch.kernels.flash_attention import flash_attention

    flash_attention.launches = flash_attention.launches_16 = flash_attention.launches_16_sm90 = 0


@contextlib.contextmanager
def captured_mels(eng, stub: bool = False):
    """Keep each mel batch that ``eng`` hands its vocoder (on the host, float32);
    with ``stub`` the vocoder is not run (a silent waveform of the right
    length comes back), for a reference engine whose waveform is not
    compared."""
    mels, real = [], eng._vocode

    def vocode(mel):
        mels.append(mel.float().cpu())
        if stub:
            return torch.zeros(mel.shape[0], mel.shape[1] * eng.hop_length, device=mel.device)
        return real(mel)

    eng._vocode = vocode
    try:
        yield mels
    finally:
        del eng._vocode


def mel_gap(a, b) -> tuple:
    """(max, mean) |a - b| over two lists of mel batches of one shape each."""
    if len(a) != len(b) or any(x.shape != y.shape for x, y in zip(a, b)):
        raise AssertionError(f"mel batches differ in shape: {[tuple(x.shape) for x in a]} vs "
                             f"{[tuple(y.shape) for y in b]}")
    d = torch.cat([(x - y).abs().flatten() for x, y in zip(a, b)])
    return float(d.max()), float(d.mean())


def family_serve(family: str, cfg) -> dict:
    """Phase 20 (a) and (c) for one family: ``from_random(seed=0, config=...)``
    on the card serves the four requests (timed, flash launches 0), each
    against the same weights on the CPU (durations equal, the mel within
    MEL_TOL; the int16 of the shortest and the longest request within
    LSB_TOL mean: the CPU's vocoder is most of its time); the busy share
    of the longest; then the bfloat16 engine on the longest request against
    the CPU in bfloat16 and float32 on its durations (the mel's mean |diff|
    from the CPU bfloat16 no more than the CPU's own bfloat16-vs-float32
    gap, phase 16's bar on the mel; the log-durations at 2 x the model's own
    error)."""
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

    t0 = time.perf_counter()
    eng = SynthesisEngine.from_random(seed=0, config=cfg)
    cpu = SynthesisEngine.from_random(seed=0, config=cfg, device="cpu")
    make_audible(eng, cpu)
    for text in REQUESTS:  # warm-up pass, not counted
        eng.synthesize(text)
    build_s = time.perf_counter() - t0
    state = estimator(eng)
    zero_flash_counts()
    rows = []
    for text in REQUESTS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio = eng.synthesize(text)
        sec = time.perf_counter() - t0
        rows.append(dict(chars=len(text), audio_s=round(len(audio) / eng.sample_rate, 3),
                         ms=round(1e3 * sec, 3), rtf=round(sec * eng.sample_rate / len(audio), 5)))
    busy = device_busy(lambda: eng.synthesize(REQUESTS[-1]))

    # each request on the card against the CPU from one bucket-estimator state
    set_estimator(eng, state)
    t0 = time.perf_counter()
    worst_mel, lsb = 0.0, {}
    for text in REQUESTS:
        vocoded = text is REQUESTS[0] or text is REQUESTS[-1]
        set_estimator(cpu, estimator(eng))
        with duration_trace(eng) as d_g, captured_mels(eng) as m_g:
            out = eng.synthesize(text)
        with duration_trace(cpu) as d_c, captured_mels(cpu, stub=not vocoded) as m_c:
            ref = cpu.synthesize(text)
        if len(d_g) != len(d_c) or not all(torch.equal(a, b) for a, b in zip(d_g, d_c)):
            raise AssertionError(f"{family} serve: durations differ from the CPU's for "
                                 f"{text[:30]!r}")
        worst_mel = max(worst_mel, mel_gap(m_g, m_c)[0])
        if vocoded:
            lsb[len(text)] = round(lsb_diff(
                f"{family} serve parity: {len(text)} characters, CUDA vs CPU", out, ref), 4)
    cpu_s = time.perf_counter() - t0
    counts = flash_counts()
    if any(counts.values()):
        raise AssertionError(f"{family} serving launched the flash kernels: {counts}")
    if not worst_mel < MEL_TOL:
        raise AssertionError(f"{family} serve: mel {worst_mel} from the CPU's (bar {MEL_TOL})")

    # bfloat16: the longest request on the card against the CPU in bf16 and f32
    text = REQUESTS[-1]
    eng16 = SynthesisEngine.from_random(seed=0, config=cfg, dtype=torch.bfloat16)
    cpu16 = SynthesisEngine.from_random(seed=0, config=cfg, device="cpu", dtype=torch.bfloat16)
    eng16.synthesize(text)  # warm-up
    state16 = estimator(eng16)
    zero_flash_counts()
    with duration_trace(eng16) as trace, captured_mels(eng16, stub=True) as m16:
        eng16.synthesize(text)
    refs = {}
    for name, ref_eng in (("bf16", cpu16), ("f32", cpu)):
        set_estimator(ref_eng, state16)
        with duration_trace(ref_eng, trace) as refs[name], \
                captured_mels(ref_eng, stub=True) as refs[name].mels:
            ref_eng.synthesize(text)
    counts16 = flash_counts()
    durations16 = log_duration_parity(f"{family} bf16", trace, refs["bf16"], refs["f32"])
    ours = mel_gap(m16, refs["bf16"].mels)
    gap = mel_gap(refs["bf16"].mels, refs["f32"].mels)
    if any(counts16.values()) or not ours[1] <= gap[1]:
        raise AssertionError(f"{family} bf16: launches {counts16}; mel mean |diff| {ours[1]} "
                             f"from the CPU's bf16, past its own bf16-vs-f32 gap {gap[1]}")
    out = dict(build_and_warmup_s=round(build_s, 2), requests=rows,
               busy_share_343=None if busy is None else busy["busy_share"],
               device_busy_ms_343=None if busy is None else busy["device_busy_ms"],
               durations_equal=True, worst_mel_vs_cpu=float(f"{worst_mel:.3g}"),
               mean_lsb=lsb, parity_cpu_s=round(cpu_s, 2), flash_launches=counts,
               bf16=dict(mel_vs_cpu_bf16=[float(f"{v:.3g}") for v in ours],
                         cpu_bf16_vs_f32=[float(f"{v:.3g}") for v in gap],
                         flash_launches=counts16, **durations16))
    log_profile(f"{family} request ({len(REQUESTS[-1])} chars)", busy)
    return out


def family_training(family: str, cfg, batch_np, n_symbols: int, n_words: int):
    """Phase 20 (b) for one family: phase 12's parity step on 4 rows, CUDA
    against the CPU (with its MAS-tie and relu-tie replays), and the
    BatchNorm statistics after it; then one step at B = 32 with
    ``remat_blocks`` false and one with it true (each after a warm-up
    step, both from seed 0): step ms and peak memory, and the two runs'
    losses (warm-up and timed step) and buffers (BatchNorm statistics)
    within TRAIN_LOSS_RTOL of each other.  Returns (the row, the training
    kernels' launches in the timed steps, the recorded inputs)."""
    from e2e_tts_tpu_torch.train import (AcousticBatch, acoustic_optimizer, build_acoustic_model,
                                         init_train_state, make_train_step)

    t0 = time.perf_counter()
    cpu_model, gpu_model = train_parity(cfg, batch_np, n_symbols, n_words)
    worst_stat, stat_name = 0.0, None
    gpu_bufs = dict(gpu_model.named_buffers())
    for name, b in cpu_model.named_buffers():
        err = float((gpu_bufs[name].cpu() - b).norm() / b.norm().clamp(min=1e-30))
        if err >= worst_stat:
            worst_stat, stat_name = err, name
    if not worst_stat < TRAIN_LOSS_RTOL:
        raise AssertionError(f"{family} train parity: BatchNorm statistic {stat_name} rel err "
                             f"{worst_stat}")
    parity_s = time.perf_counter() - t0
    del cpu_model, gpu_model

    batch = AcousticBatch.from_numpy(batch_np, "cuda")
    row = dict(parity_s=round(parity_s, 2), worst_stat_rel_err=float(f"{worst_stat:.3g}"),
               worst_stat=stat_name, batch=[TRAIN_B, TRAIN_T, TRAIN_L])
    runs = {}
    with recorded_train_inputs() as seen:
        for remat in (False, True):
            fs2 = cfg.models.fastspeech2.replace(remat_blocks=remat)
            c = cfg.replace(models=cfg.models.replace(fastspeech2=fs2))
            model = build_acoustic_model(c, n_symbols, TRAIN_SPEAKERS)
            opt = acoustic_optimizer(c.train.fastspeech2_optimizer, fs2.encoder_hidden)
            state = init_train_state(model, opt, seed=0)
            step = make_train_step(model, c, opt, n_words)
            _, warm = step(state, batch)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            _, metrics = step(state, batch)
            torch.cuda.synchronize()
            key = "remat" if remat else "no_remat"
            row[f"{key}_step_ms"] = round(1e3 * (time.perf_counter() - t0), 3)
            row[f"{key}_peak_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 3)
            check_finite(f"{family} step (remat {remat})", [metrics])
            row[f"{key}_total"] = round(float(metrics["total"]), 5)
            runs[remat] = ([float(warm["total"]), float(metrics["total"])],
                           {n: b.detach().float().cpu() for n, b in model.named_buffers()})
            del model, opt, state, step
        launches = training_launches()
    expect_launches(f"{family} train steps", launches, {k: 4 for k in launches})
    (loss0, bufs0), (loss1, bufs1) = runs[False], runs[True]
    for a, b in zip(loss0, loss1):
        if not abs(a - b) <= TRAIN_LOSS_RTOL * abs(a):
            raise AssertionError(f"{family} remat: losses {loss1} against {loss0} without")
    for name, b in bufs0.items():
        err = float((bufs1[name] - b).norm() / b.norm().clamp(min=1e-30))
        if not err < TRAIN_LOSS_RTOL:
            raise AssertionError(f"{family} remat: buffer {name} rel err {err}")
    return row, launches, seen


def family_cli(root: str, work: str):
    """Phase 20 (d): ``acoustic`` for FAMILY_CLI_STEPS steps with a conformer
    config, on the corpus of phase 18 in a fresh workdir.  Returns the
    training kernels' launches and the recorded inputs."""
    from e2e_tts_tpu_torch.config import save_config

    w = os.path.join(work, "cli_conformer")
    path = os.path.join(w, "conformer.yaml")
    save_config(family_config("conformer"), path)
    seconds = {}
    run_cli(seconds, "prepare", ["prepare", "--corpus", root, "--workdir", w, "--config", path])
    with recorded_train_inputs() as seen:
        _, step = run_cli(seconds, "acoustic", [
            "acoustic", "--workdir", w, "--config", path, "--steps", str(FAMILY_CLI_STEPS),
            "--ckpt-every", "1000"])
        launches = training_launches()
    if step != FAMILY_CLI_STEPS:
        raise AssertionError(f"CLI acoustic (conformer) ended at step {step}")
    expect_launches("CLI acoustic (conformer)", launches,
                    {k: FAMILY_CLI_STEPS for k in launches})
    log("CLI conformer " + json.dumps(dict(subcommand_s=seconds)))
    return launches, seen


def block_families(smi: str, work: str):
    """Phase 20: the conformer, fastformer, long-short transformer and
    reformer at the default width (weights from seed 0): serving on the card
    against the CPU, bfloat16, training (parity, remat), and the training
    CLI with a conformer config.  Returns (the training kernels' launches
    in the counted steps, their errors on the first family's inputs and the
    CLI's)."""
    from e2e_tts_tpu_torch.text.symbols import symbols

    batch_np = train_batch(len(symbols))
    launches = {"mas": 0, "ctc_fwd": 0, "ctc_bwd": 0}
    errs = {}
    for family in FAMILIES:
        t0 = time.perf_counter()
        cfg = family_config(family)
        n_words = max(cfg.models.fastspeech2.max_seq_len, 256)
        served = family_serve(family, cfg)
        row, got, seen = family_training(family, cfg, batch_np, len(symbols), n_words)
        launches = {k: launches[k] + got[k] for k in launches}
        if not errs:
            errs = check_training_inputs(seen)
        log(f"block family {family} " + json.dumps(dict(
            card=smi, serve=served, train=row, seconds=round(time.perf_counter() - t0, 1))))
    got, seen = family_cli(os.path.join(work, "corpus"), work)
    launches = {k: launches[k] + got[k] for k in launches}
    cli_errs = check_training_inputs(seen)
    return launches, {k: max(errs[k], cli_errs[k]) for k in errs}


# --- 21. the router, voice conversion, reference import and scoring -----------------------

ROUTER_TEXTS = {"vie": REQUESTS[-1],  # a mel bucket >= 256 on vie_tiny: the flash kernel
                "eng": "Hello world, this is the English voice of the router.",
                "mya": "မင်္ဂလာပါ၊ ဒီနေ့ ရာသီဥတု သာယာပါတယ်။"}
VC_AGREE = 0.999   # the share of source frames matched as on the CPU, ties apart (VC_TIE)
VC_TIE = 1e-4      # a frame's matches may differ from the CPU's only where their cosine
                   # similarities, on the CPU's features, are this close to its own
VC_WAV_MAE = 1e-5  # one converted mel vocoded on the card and on the CPU
MOS_TOL = 1e-4     # a learned MOS score, CUDA vs CPU


def vc_parity(what: str, gpu_eng, cpu_eng, src_mel, tgt_mel, src_audio, tgt_audio,
              smi: str) -> dict:
    """``KnnVoiceConverter`` in ppg mode on ``gpu_eng`` against the same on
    ``cpu_eng``, on the same mels, at ``prosody_weight`` 0 and 1: the share of
    source frames whose matched target frames equal the CPU's, or differ
    only among frames tied with them (``knn_tie_margin`` <= VC_TIE), at least
    VC_AGREE (the exact share is logged beside it: a trained aligner's sharp
    posteriors, and a random one's flat ones, make many target frames
    equally near); the mel on the frames that agree within MEL_TOL; the
    CPU's converted mel vocoded on both devices within VC_WAV_MAE;
    ``convert_mel``'s ms on the card."""
    from e2e_tts_tpu_torch.serve.voice_conversion import KnnVoiceConverter

    out = {}
    for w in (0.0, 1.0):
        conv = [KnnVoiceConverter(engine=e, feature_mode="ppg", prosody_weight=w)
                for e in (gpu_eng, cpu_eng)]
        tracks = ()
        if w:
            hop = gpu_eng.hop_length
            tracks = (conv[0].prosody_track(src_audio, len(src_mel), gpu_eng.sample_rate, hop),
                      conv[0].prosody_track(tgt_audio, len(tgt_mel), gpu_eng.sample_rate, hop))
        (mel_g, idx_g), (mel_c, idx_c) = (c.convert_mel(src_mel, tgt_mel, *tracks,
                                                        return_indices=True) for c in conv)
        same = (idx_g == idx_c).all(axis=1)
        margin = knn_tie_margin(conv[1], src_mel, tgt_mel, tracks, idx_g, idx_c)
        tied = ~same & (margin <= VC_TIE)
        mel_err = float(np.abs(mel_g[same] - mel_c[same]).max())
        row = dict(frames=len(same), agree=float(f"{same.mean():.6g}"),
                   agree_or_tied=float(f"{(same | tied).mean():.6g}"),
                   worst_untied_margin=float(f"{margin[~same & ~tied].max():.3g}")
                   if (~same & ~tied).any() else 0.0,
                   worst_tied_margin=float(f"{margin[tied].max():.3g}") if tied.any() else 0.0,
                   mel_err_on_agreeing=float(f"{mel_err:.3g}"))
        if not ((same | tied).mean() >= VC_AGREE and mel_err < MEL_TOL):
            raise AssertionError(f"{what} vc (prosody {w}): {row}")
        # the rendering: the CPU's converted mel vocoded on both devices
        wav_g, wav_c = gpu_eng.vocode_mel(mel_c), cpu_eng.vocode_mel(mel_c)
        row["wav_mae"] = float(f"{np.abs(wav_g - wav_c).mean():.3g}")
        if not row["wav_mae"] < VC_WAV_MAE:
            raise AssertionError(f"{what} vc (prosody {w}): {row}")
        row["convert_mel_ms"] = round(1e3 * timed_host(
            lambda: conv[0].convert_mel(src_mel, tgt_mel, *tracks)), 3)
        out[f"prosody_{w:g}"] = row
    log(f"{what} voice conversion ({smi}) " + json.dumps(out))
    return out


def knn_tie_margin(conv, src_mel, tgt_mel, tracks, idx_g, idx_c):
    """For each source frame, how much less similar (cosine, float64, on
    ``conv``'s features: the CPU's) the card's k matched target frames are
    than the CPU's own k: 0 where the two agree, a float error where the two
    picked among tied frames."""
    pn = conv._prosody_rms_norm(*tracks) if tracks else None
    feats = [conv._features(m, t, pn).astype(np.float64)
             for m, t in zip((src_mel, tgt_mel), tracks or (None, None))]
    a, b = (f / np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-6) for f in feats)
    sim = a @ b.T
    rows = np.arange(len(sim))[:, None]
    return np.maximum(sim[rows, idx_c].sum(1) - sim[rows, idx_g].sum(1), 0.0)


def timed_host(fn, iters: int = 5) -> float:
    """Seconds a call of ``fn`` takes on the host clock (after one warm-up
    call), which covers the device work because ``fn`` returns host arrays."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def router_vc_import_scoring(smi: str, eng, cpu, work: str):
    """Phase 21.  (1) ``synthesizer.Synthesizer(device="cuda")`` over the
    three discovered bundles serves one sentence a language (the
    Vietnamese one at a mel bucket >= 256): flash launches must rise, the
    kernel is held to its plain version on the inputs it got, each wav is
    within LSB_TOL mean of the same router on the CPU; request seconds and
    RTF per language from ``measure_rtf``.  (2) ``KnnVoiceConverter`` in ppg
    mode at prosody weights 0 and 1 on the router's ``vie_tiny`` engine (two
    router outputs converted to each other) and on the default-width
    engines ``eng``/``cpu`` (two requests), against the CPU (``vc_parity``);
    ``convert`` through the router's converter, which must render with the
    engine's vocoder.  (3) random reference-layout ``state_dict``s of the
    default-width transformer and HiFi-GAN V1, ``torch.save``d and loaded
    through ``compat.load_torch_state_dict`` onto the card and the CPU: one
    request, durations equal, the mel within MEL_TOL, the int16 within
    LSB_TOL mean.  (4) ``LearnedMosScorer`` on the card against the CPU on
    every anchor (MOS_TOL), ms a window; one ``device_trace`` of a router
    request.  Returns (float32 flash launches, the kernel's largest error on
    the phase's inputs)."""
    import glob

    from scipy.io import wavfile

    from e2e_tts_tpu_torch.audio.wav import read_wav
    from e2e_tts_tpu_torch.compat import load_acoustic, load_torch_state_dict, load_vocoder
    from e2e_tts_tpu_torch.compat.reference_layout import random_reference_state_dict
    from e2e_tts_tpu_torch.config import default_config
    from e2e_tts_tpu_torch.kernels.flash_attention import flash_attention
    from e2e_tts_tpu_torch.models.acoustic import FastSpeech2
    from e2e_tts_tpu_torch.models.mos import MOS_WINDOW
    from e2e_tts_tpu_torch.models.vocoder import build_generator
    from e2e_tts_tpu_torch.nn.variance import FeatureStats
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine
    from e2e_tts_tpu_torch.serve.voice_conversion import KnnVoiceConverter
    from e2e_tts_tpu_torch.synthesizer import Synthesizer
    from e2e_tts_tpu_torch.text.frontends import get_frontend
    from e2e_tts_tpu_torch.utils import device_trace, measure_rtf
    from e2e_tts_tpu_torch.utils.metrics import LearnedMosScorer

    # (1) the router on the card and on the CPU
    routers = {dev: Synthesizer(device=dev, output_dir=os.path.join(work, f"router_{dev}"))
               for dev in ("cuda", "cpu")}
    if routers["cuda"].languages != ["eng", "mya", "vie"]:
        raise AssertionError(f"router languages {routers['cuda'].languages}")
    with recorded_inputs() as seen:
        paths = {lang: routers["cuda"].synthesis(text, language=lang)[0]
                 for lang, text in ROUTER_TEXTS.items()}
    launches = flash_attention.launches
    if launches <= 0:
        raise AssertionError("the router never launched flash_attention")
    err = check_serving_inputs(seen, "router")
    for lang, text in ROUTER_TEXTS.items():
        (sr_g, got), (sr_c, want) = (wavfile.read(p) for p in (
            paths[lang], routers["cpu"].synthesis(text, language=lang)[0]))
        if sr_g != sr_c:
            raise AssertionError(f"router {lang}: {sr_g} Hz vs {sr_c} Hz")
        lsb_diff(f"router {lang} ({len(text)} characters), CUDA vs CPU", got, want)
    rtf = {}
    for lang, text in ROUTER_TEXTS.items():
        model = routers["cuda"].model_dict[lang]
        rep = measure_rtf(lambda: model.synthesize_array(text), model.engine.sample_rate,
                          warmup=1, runs=3)
        rtf[lang] = dict(chars=len(text), request_s=[round(s, 4) for s in rep.per_run_s],
                         audio_s=round(rep.audio_s / rep.runs, 3), rtf=round(rep.rtf, 5))
    log(f"router ({smi}): flash launches {launches} " + json.dumps(rtf))

    # (2) voice conversion: the router's vie_tiny engine, then the default width
    tiny_g, tiny_c = (routers[d].model_dict["vie"].engine for d in ("cuda", "cpu"))
    vc = routers["cuda"].voice_converter
    src_path, tgt_path = paths["vie"], routers["cuda"].synthesis(REQUESTS[1])[0]
    (src, _), (tgt, _) = read_wav(src_path), read_wav(tgt_path)
    src_mel, tgt_mel = vc._mel(src, tiny_g.sample_rate), vc._mel(tgt, tiny_g.sample_rate)
    vc_rows = {"vie_tiny": vc_parity("vie_tiny", tiny_g, tiny_c, src_mel, tgt_mel, src, tgt,
                                     smi)}
    vocoded = []
    real_vocode = tiny_g.vocode_mel
    tiny_g.vocode_mel = lambda mel: vocoded.append(len(mel)) or real_vocode(mel)
    try:
        out_path = os.path.join(work, "vc.wav")
        convert_s = timed_host(lambda: vc.convert(tgt_path, src_path, out_path))
    finally:
        del tiny_g.vocode_mel
    if not vocoded:
        raise AssertionError("convert went to the spectral fallback, not the kNN path")
    vc_rows["vie_tiny"]["convert_ms"] = round(1e3 * convert_s, 3)
    audio = [eng.synthesize(t).astype(np.float32) / 32768.0 for t in REQUESTS[1:3]]
    mels = [KnnVoiceConverter(engine=eng)._mel(a, eng.sample_rate) for a in audio]
    vc_rows["default"] = vc_parity("default width", eng, cpu, mels[0], mels[1], *audio, smi)

    # (3) reference-checkpoint import at default width
    cfg = default_config()
    n_symbols = len(get_frontend("vie").symbols)
    template = FastSpeech2(cfg.models.fastspeech2, n_symbols, 1, cfg.audio.mel.channels,
                           FeatureStats(), device="cpu")
    for name, module in (("acoustic", template),
                         ("generator", build_generator(cfg, "hifigan", device="cpu"))):
        sd = random_reference_state_dict(module, seed=0)
        torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                                   for k, v in sd.items()}}, os.path.join(work, f"{name}.pth"))
    t0 = time.perf_counter()
    imported = {}
    for dev in ("cuda", "cpu"):
        acoustic = load_acoustic(load_torch_state_dict(os.path.join(work, "acoustic.pth")), cfg,
                                 n_symbols, 1, device=dev)
        vocoder = load_vocoder(load_torch_state_dict(os.path.join(work, "generator.pth")), cfg,
                               device=dev)
        imported[dev] = SynthesisEngine(cfg, acoustic, vocoder, {"speaker": 0}, FeatureStats(),
                                        device=dev)
    import_s = time.perf_counter() - t0
    text = REQUESTS[1]
    before = flash_attention.launches
    with duration_trace(imported["cuda"]) as d_g, captured_mels(imported["cuda"]) as m_g:
        got = imported["cuda"].synthesize(text)
    launches += flash_attention.launches - before
    with duration_trace(imported["cpu"]) as d_c, captured_mels(imported["cpu"]) as m_c:
        want = imported["cpu"].synthesize(text)
    if len(d_g) != len(d_c) or not all(torch.equal(a, b) for a, b in zip(d_g, d_c)):
        raise AssertionError("imported voice: durations differ from the CPU's")
    mel_max = mel_gap(m_g, m_c)[0]
    if not mel_max < MEL_TOL:
        raise AssertionError(f"imported voice: mel {mel_max} from the CPU's (bar {MEL_TOL})")
    lsb = lsb_diff(f"imported default-width voice ({len(text)} characters), CUDA vs CPU",
                   got, want)
    log(f"import ({smi}): two state dicts loaded onto both devices in {import_s:.2f} s; "
        f"durations equal, mel max |diff| {mel_max:.3g}, {lsb:.4f} LSB")

    # (4) scoring and a trace
    scorers = {dev: LearnedMosScorer(device=dev) for dev in ("cuda", "cpu")}
    worst, windows, t_card = 0.0, 0, 0.0
    for path in sorted(glob.glob(os.path.join("assets", "mos", "anchors", "*.wav"))):
        a, sr = read_wav(path)
        scores = [scorers[d](a, sr) for d in ("cuda", "cpu")]
        worst = max(worst, abs(scores[0] - scores[1]))
        windows += max(1, len(a) // (MOS_WINDOW * 256))
        t_card += timed_host(lambda: scorers["cuda"](a, sr))
    if not windows or not worst < MOS_TOL:
        raise AssertionError(f"MOS on the card {worst} from the CPU's (bar {MOS_TOL})")
    before = flash_attention.launches
    with device_trace(os.path.join(work, "trace")) as prof:
        routers["cuda"].synthesis(ROUTER_TEXTS["vie"])
    launches += flash_attention.launches - before
    if not os.path.getsize(prof.trace_path):
        raise AssertionError("device_trace wrote an empty trace")
    log(f"scoring ({smi}): {windows} windows of {MOS_WINDOW} frames, worst |card - cpu| "
        f"{worst:.3g}, {1e3 * t_card / windows:.3f} ms a window on the card; trace "
        f"{os.path.getsize(prof.trace_path)} bytes")
    log("router, voice conversion, import and scoring " + json.dumps(dict(
        flash_launches=launches, router=rtf, vc=vc_rows, import_lsb=round(lsb, 4),
        import_mel_max=float(f"{mel_max:.3g}"), mos_worst=float(f"{worst:.3g}"),
        mos_ms_per_window=round(1e3 * t_card / windows, 3))))
    return launches, err


# --- 22. mixed-precision training and the engine's serving options ------------------------

BF16_FLOOR = 2.0 ** -8  # the bfloat16 oracle bar's floor
MP_TURN_STEPS = 3  # timed steps a turn (float32, bfloat16, bfloat16, float32)
MP_CLI_STEPS = 8
CODEC_ITERS = 20


def bf16_oracle(what: str, card: dict, cpu: dict, exact: dict, zero=None) -> dict:
    """For each name: relL2(card - f64) <= max(2 x relL2(cpu - f64), BF16_FLOOR),
    relL2 over the float64 oracle's norm, the CPU bfloat16 run standing where
    the CPU tests put JAX's; names matching ``zero`` (0 by construction) are
    noise on both 16-bit sides, each held below BF16_FLOOR of the oracle's
    global norm.  Logs each side's distances and raises past the bar."""
    scale = float(np.sqrt(sum(float((torch.as_tensor(v, dtype=torch.float64) ** 2).sum())
                              for v in exact.values())))
    rows, zeros = [], 0
    for name, want in exact.items():
        want = torch.as_tensor(want, dtype=torch.float64)
        c = torch.as_tensor(card[name], dtype=torch.float64).cpu()
        h = torch.as_tensor(cpu[name], dtype=torch.float64)
        if zero is not None and zero.search(name):
            if not (c.norm() < BF16_FLOOR * scale and h.norm() < BF16_FLOOR * scale):
                raise AssertionError(f"{what}: {name} should be 0 by construction")
            zeros += 1
            continue
        norm = float(want.norm()) or 1e-300
        dc, dh = float((c - want).norm()) / norm, float((h - want).norm()) / norm
        rows.append((dc / max(2.0 * dh, BF16_FLOOR), dc, dh, name))
    rows.sort(reverse=True)
    log(f"{what} bf16 oracle " + json.dumps(dict(
        tensors=len(rows), zero_by_construction=zeros,
        worst=[dict(name=r[3], card_vs_f64=float(f"{r[1]:.3g}"), cpu_vs_f64=float(f"{r[2]:.3g}"),
                    of_bar=round(r[0], 3)) for r in rows[:6]])))
    over = [r for r in rows if r[0] > 1.0]
    if over:
        raise AssertionError(f"{what}: {len(over)} past max(2 x the CPU bf16's, 2**-8): "
                             + ", ".join(f"{r[3]} {r[1]:.3g} (CPU {r[2]:.3g})" for r in over))
    return dict(tensors=len(rows), worst_of_bar=round(rows[0][0], 4) if rows else 0.0)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |x|."""
    e = torch.floor(torch.log2(x.abs().clamp(min=torch.finfo(torch.float32).tiny)))
    return torch.exp2(e - 7)


def bf16_acoustic_parity(cfg, batch_np, n_symbols: int, n_words: int) -> dict:
    """A bfloat16 step's forward and backward at phase 12's parity shape (4
    rows, dropout 0, step 30000) on the card, on the CPU in bfloat16 and, the
    oracle, on the CPU in float64 (``.double()`` of the float32 twin): every
    loss term and gradient by ``bf16_oracle``.  The CPU runs take the card's
    MAS alignment (its durations equal the CPU bfloat16 run's own, or differ
    only where the two MAS inputs lie within one bfloat16 ulp) and the CPU
    bfloat16 run takes the card's relu decisions, so that the three
    differentiate one function."""
    import e2e_tts_tpu_torch.nn.variance as variance
    from e2e_tts_tpu_torch.train import AcousticBatch, build_acoustic_model

    step = 30000
    cpu = build_acoustic_model(cfg, n_symbols, TRAIN_SPEAKERS, dropout=False, device="cpu",
                               dtype=torch.bfloat16)
    gpu = copy.deepcopy(cpu).to("cuda")
    f64 = build_acoustic_model(cfg, n_symbols, TRAIN_SPEAKERS, dropout=False, device="cpu")
    f64.load_state_dict(cpu.state_dict())
    f64 = f64.double()
    rows = [a[:PARITY_ROWS] for a in batch_np]
    relu_g = []

    def run(model, device, dtype, hard=None, relu=None):
        b = AcousticBatch.from_numpy(rows, device)
        if dtype == torch.float64:
            b = to_dtype(b, dtype)
        model.train()
        real = variance.monotonic_align
        own = []

        def align(attn, tl, ml):
            own.append(real(attn, tl, ml))
            return own[-1] if hard is None else hard.to(attn.device, attn.dtype)
        variance.monotonic_align = align
        try:
            with relu_calls(record=relu if device == "cuda" else None,
                            replay=relu if device != "cuda" and dtype != torch.float64 else None):
                out, losses = forward_losses(model, cfg, b, step, n_words,
                                             torch.Generator(device))
        finally:
            variance.monotonic_align = real
        losses["total"].backward()
        grads = {n: p.grad.detach() for n, p in model.named_parameters()}
        return out, own[0], {k: v.item() for k, v in losses.items()}, grads

    t0 = time.perf_counter()
    out_g, hard_g, loss_g, grad_g = run(gpu, "cuda", torch.bfloat16, relu=relu_g)
    out_c, own_c, loss_c, grad_c = run(cpu, "cpu", torch.bfloat16, hard_g.cpu(), relu_g)
    differ = (own_c != hard_g.cpu())
    if differ.any():
        lg = out_g["attn_logprob"].detach().float().cpu()[differ]
        lc = out_c["attn_logprob"].detach().float()[differ]
        if not bool(((lg - lc).abs() <= bf16_ulp(lc)).all()):
            raise AssertionError("bf16 parity: the card's alignment differs from the CPU's off a "
                                 "bfloat16 tie")
    _, _, loss_x, grad_x = run(f64, "cpu", torch.float64, hard_g.cpu())
    losses = bf16_oracle("bf16 acoustic losses", loss_g, loss_c, loss_x)
    grads = bf16_oracle("bf16 acoustic gradients", grad_g, grad_c, grad_x, ZERO_BY_CONSTRUCTION)
    return dict(rows=PARITY_ROWS, step=step, cpu_s=round(time.perf_counter() - t0, 2),
                alignment_cells_differing=int(differ.sum()), losses=losses, gradients=grads)


def train_turns(make_step, what: str, pattern=None) -> dict:
    """Each dtype's step ``make_step[dtype]()`` -> step fn, timed in turns
    (float32, bfloat16, bfloat16, float32; MP_TURN_STEPS steps a turn after
    one warm-up each): ms a step, peak memory, and a profiled step's busy
    share."""
    steps = {dt: make_step[dt]() for dt in make_step}
    for fn in steps.values():
        fn()  # warm-up: cuDNN's choices
    secs = {dt: [] for dt in steps}
    peaks = {}
    for dt in ("float32", "bfloat16", "bfloat16", "float32"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(MP_TURN_STEPS):
            steps[dt]()
        torch.cuda.synchronize()
        secs[dt].append((time.perf_counter() - t0) / MP_TURN_STEPS)
        peaks[dt] = max(peaks.get(dt, 0), torch.cuda.max_memory_allocated())
    out = {}
    for dt, fn in steps.items():
        busy = device_busy(fn)
        out[dt] = dict(step_ms=round(1e3 * float(np.mean(secs[dt])), 3),
                       turns_ms=[round(1e3 * s, 3) for s in secs[dt]],
                       peak_gib=round(peaks[dt] / 2**30, 3),
                       busy_share=None if busy is None else busy["busy_share"])
        if busy is not None:
            log_profile(f"{what} {dt}", busy, pattern)
    out["bf16_over_f32"] = round(out["bfloat16"]["step_ms"] / out["float32"]["step_ms"], 4)
    return out


def bf16_acoustic(smi: str):
    """Phase 22 (a): the bfloat16 acoustic step at phase 12's shape, timed in
    turns beside float32, MAS and the CTC forward and backward counted (and
    their inputs float32), and the parity above.  Returns (launches, the
    kernels' errors on the bfloat16 steps' inputs)."""
    from e2e_tts_tpu_torch.config import default_config
    from e2e_tts_tpu_torch.text.symbols import symbols
    from e2e_tts_tpu_torch.train import (AcousticBatch, acoustic_optimizer, build_acoustic_model,
                                         init_train_state, make_train_step)

    cfg = default_config()
    n_words = max(cfg.models.fastspeech2.max_seq_len, 256)
    batch_np = train_batch(len(symbols))
    parity = bf16_acoustic_parity(cfg, batch_np, len(symbols), n_words)
    batch = AcousticBatch.from_numpy(batch_np, "cuda")

    def maker(dtype):
        def make():
            model = build_acoustic_model(cfg, len(symbols), TRAIN_SPEAKERS, dtype=dtype)
            opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer,
                                     cfg.models.fastspeech2.encoder_hidden)
            state, step = init_train_state(model, opt), make_train_step(model, cfg, opt, n_words)
            return lambda: step(state, batch)
        return make

    timing = train_turns({"float32": maker(torch.float32), "bfloat16": maker(torch.bfloat16)},
                         "bf16 acoustic step", r"mas_kernel|ctc_")
    model = build_acoustic_model(cfg, len(symbols), TRAIN_SPEAKERS, dtype=torch.bfloat16)
    opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer, cfg.models.fastspeech2.encoder_hidden)
    state, step = init_train_state(model, opt), make_train_step(model, cfg, opt, n_words)
    step(state, batch)
    with recorded_train_inputs() as seen:
        metrics = [step(state, batch)[1] for _ in range(MP_TURN_STEPS)]
        launches = training_launches()
    expect_launches("bf16 acoustic steps", launches, {k: MP_TURN_STEPS for k in launches})
    dtypes = {k: str(v[0].dtype) if k != "ctc_bwd" else str(v[1].dtype) for k, v in seen.items()}
    if set(dtypes.values()) != {"torch.float32"}:
        raise AssertionError(f"bf16 acoustic steps handed the kernels {dtypes}")
    if not all(p.dtype == torch.float32 for p in model.parameters()) or not all(
            m.dtype == torch.float32 for m in state.opt_state.mu):
        raise AssertionError("bf16 acoustic steps: master parameters or moments not float32")
    errs = check_training_inputs(seen)
    log("bf16 acoustic step " + json.dumps(dict(
        card=smi, batch=[TRAIN_B, TRAIN_T, TRAIN_L], parity=parity, timing=timing,
        kernel_input_dtypes=dtypes, last_metrics=check_finite("bf16 acoustic steps", metrics))))
    return launches, errs


def bf16_vocoder(smi: str) -> None:
    """Phase 22 (b): the bfloat16 HiFi-GAN V1 training form with MPD/MSD in
    float32 at phase 13's shape: one step at phase 13's 2 parity rows on the
    card, on the CPU in bfloat16 and on the CPU in float64, the metrics and
    every gradient (from Adam's first moments) by ``bf16_oracle``; then the
    step timed in turns beside float32."""
    from e2e_tts_tpu_torch.config import default_config
    from e2e_tts_tpu_torch.models.vocoder import build_generator
    from e2e_tts_tpu_torch.nn.discriminators import build_discriminators
    from e2e_tts_tpu_torch.train import (VocoderBatch, gan_optimizer, init_vocoder_train_state,
                                         make_vocoder_train_step)

    cfg = default_config()
    batch_np = vocoder_batch()

    def modules(dtype, device):
        return (build_generator(cfg, "hifigan", train=True, device=device, seed=0, dtype=dtype),
                *build_discriminators(device, seed=0))

    def run(mods, device, rows=VOC_PARITY_ROWS):
        g_opt, d_opt = (gan_optimizer(cfg.train.hifigan_optimizer) for _ in range(2))
        state = init_vocoder_train_state(mods[0], g_opt, d_opt, *mods[1:])
        step = make_vocoder_train_step(mods[0], cfg, g_opt, d_opt, "hifigan", *mods[1:])
        batch = VocoderBatch.from_numpy([a[:rows] for a in batch_np], device)
        if next(mods[0].parameters()).dtype == torch.float64:
            batch = to_dtype(batch, torch.float64)
        return state, step, batch

    t0 = time.perf_counter()
    cpu = modules(torch.bfloat16, "cpu")
    gpu = [copy.deepcopy(m).to("cuda") for m in cpu]
    f64 = [m.double() for m in modules(torch.float32, "cpu")]
    for m, src in zip(f64, cpu):
        m.load_state_dict(src.state_dict())
    names = adam_names(cpu[0]) + adam_names(*cpu[1:])
    out = {}
    for key, mods, device in (("card", gpu, "cuda"), ("cpu", cpu, "cpu"), ("f64", f64, "cpu")):
        state, step, batch = run(mods, device)
        state, metrics = step(state, batch)
        out[key] = ({k: v.item() for k, v in metrics.items()},
                    dict(zip(names, state.g_opt_state.mu + state.d_opt_state.mu)))
    metrics = bf16_oracle("bf16 vocoder metrics", *(out[k][0] for k in ("card", "cpu", "f64")))
    grads = bf16_oracle("bf16 vocoder gradients", *(out[k][1] for k in ("card", "cpu", "f64")))
    parity_s = time.perf_counter() - t0

    def maker(dtype):
        def make():
            state, step, batch = run(modules(dtype, "cuda"), "cuda", VOC_B)
            return lambda: step(state, batch)
        return make

    timing = train_turns({"float32": maker(torch.float32), "bfloat16": maker(torch.bfloat16)},
                         "bf16 vocoder step")
    log("bf16 vocoder step " + json.dumps(dict(
        card=smi, batch=[VOC_B, VOC_FRAMES, VOC_FRAMES * HOP], parity_rows=VOC_PARITY_ROWS,
        parity_s=round(parity_s, 2), metrics=metrics, gradients=grads, timing=timing)))


def mixed_precision_cli(smi: str, work: str):
    """Phase 22 (c): the training CLI on phase 18's corpus (phase 19's
    prepared workdir files) with ``train.mixed_precision: true``: ``acoustic``
    for MP_CLI_STEPS steps builds its model in bfloat16 (float32 in the
    checkpoint), the loop's wall ms a step; ``e2e`` one step with that
    config and with the float32 one, fresh workdirs, its first metrics equal.
    Returns (the training kernels' launches, the recorded inputs)."""
    import shutil

    import e2e_tts_tpu_torch.train.acoustic_step as acoustic_step
    from e2e_tts_tpu_torch.config import default_config, save_config
    from e2e_tts_tpu_torch.text.symbols import symbols
    from e2e_tts_tpu_torch.train.checkpoint import CheckpointManager

    prepared = os.path.join(work, "cli")  # phase 19's
    cfg = default_config()
    paths = {}
    for name, mixed in (("f32", False), ("mixed", True)):
        paths[name] = os.path.join(work, f"mp_{name}.yaml")
        save_config(cfg.replace(train=cfg.train.replace(mixed_precision=mixed)), paths[name])

    def workdir(name):
        w = os.path.join(work, f"mp_{name}")
        os.makedirs(w)
        for f in ("file_list.txt", "stats.json", "speakers.json"):
            shutil.copy(os.path.join(prepared, f), w)
        return w

    built = []
    real_build = acoustic_step.build_acoustic_model

    def spy(*a, **k):
        built.append(k.get("dtype", torch.float32))
        return real_build(*a, **k)

    acoustic_step.build_acoustic_model = spy
    seconds, stamps, firsts = {}, [], {}
    try:
        w = workdir("acoustic")
        with recorded_train_inputs() as seen:
            _, step = run_cli(seconds, "acoustic", [
                "acoustic", "--workdir", w, "--config", paths["mixed"], "--steps",
                str(MP_CLI_STEPS), "--ckpt-every", "1000"],  # no validation: train steps only
                on_step=lambda s, m: (torch.cuda.synchronize(), stamps.append(time.perf_counter())))
            launches = training_launches()
        for name in ("f32", "mixed"):
            got = []
            run_cli(seconds, f"e2e_{name}", ["e2e", "--workdir", workdir(f"e2e_{name}"), "--config",
                                             paths[name], "--steps", "1"],
                    on_step=lambda s, m: got.append({k: v.item() for k, v in m.items()}))
            firsts[name] = got[0]
    finally:
        acoustic_step.build_acoustic_model = real_build
    if step != MP_CLI_STEPS or built[0] != torch.bfloat16 or built[1:] != [torch.float32] * 2:
        raise AssertionError(f"CLI mixed precision: step {step}, models built in {built}")
    expect_launches("CLI acoustic (mixed precision)", launches,
                    {k: MP_CLI_STEPS for k in launches})
    with open(os.path.join(w, "speakers.json")) as f:
        n_speakers = len(json.load(f))
    tree = CheckpointManager(os.path.join(w, "acoustic_ckpt")).restore(
        {"step": 0, "model": real_build(cfg, len(symbols), n_speakers)})
    if not all(p.dtype == torch.float32 for p in tree["model"].parameters()):
        raise AssertionError("CLI mixed precision: the checkpoint's parameters are not float32")
    # the same float32 step twice: equal but for the card's unordered sums
    e2e_diff = max(abs(firsts["mixed"][k] - v) / max(abs(v), 1e-12)
                   for k, v in firsts["f32"].items())
    if sorted(firsts["mixed"]) != sorted(firsts["f32"]) or not e2e_diff < TRAIN_LOSS_RTOL:
        raise AssertionError(f"CLI e2e: mixed_precision changed the first step's metrics: "
                             f"{firsts['mixed']} vs {firsts['f32']}")
    log("CLI mixed precision " + json.dumps(dict(
        card=smi, subcommand_s=seconds, acoustic_steps=MP_CLI_STEPS,
        loop_ms_a_step=round(step_wall_ms(stamps, 1, MP_CLI_STEPS), 3),  # as phase 19's
        e2e_first_metrics_max_rel_diff=e2e_diff, checkpoint_step=tree["step"])))
    return launches, seen


def captured_vocoder_input(eng, text: str):
    """The mel the engine's vocoder got for ``text``'s first batch."""
    mels, real = [], eng._vocode
    eng._vocode = lambda mel: (mels.append(mel), real(mel))[1]
    try:
        eng.synthesize(text)
    finally:
        del eng._vocode
    return mels[0]


def d2h_ms(codes) -> float:
    """Host-clock ms of one device-to-host copy of ``codes`` (median)."""
    out = []
    for _ in range(CODEC_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codes.cpu()
        out.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(out))


def serving_options(smi: str, eng) -> dict:
    """Phase 22 (d): the 343-character request in float32 (phase 5's audible
    engine) and bfloat16 (the same weights): the folded tail against the
    generator (vocoder device ms, int16 within LSB_TOL mean), ``mulaw8``
    against int16 (the device-to-host copy ms, request seconds), and
    ``use_flash=False`` against the default (request seconds, flash launches
    0 and > 0); the flash kernels held to their plain version on the
    inputs those requests gave.  Returns ({dtype: the flash kernels' launch
    counts in the counted requests}, {dtype: their worst error there})."""
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

    text = REQUESTS[-1]
    state = estimator(eng)
    out, counts, errs = {}, {}, {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        base = eng if dt == torch.float32 else SynthesisEngine.from_random(seed=0, dtype=dt)
        if base is not eng:
            base.vocoder.load_state_dict(eng.vocoder.state_dict())  # the audible scale
        share = lambda **kw: SynthesisEngine(  # noqa: E731
            base.config, base.acoustic, base.vocoder, base.speakers, base.stats, device="cuda",
            dtype=dt, **kw)
        engines = {"default": base, "folded": share(use_folded_vocoder=True),
                   "mulaw8": share(transfer_codec="mulaw8")}
        noflash = SynthesisEngine.from_random(seed=0, dtype=dt, use_flash=False)
        noflash.vocoder.load_state_dict(eng.vocoder.state_dict())
        engines["no_flash"] = noflash
        for e in engines.values():
            set_estimator(e, state)
            e.synthesize(text)  # warm-up
        audio, secs, flash = {}, {k: [] for k in engines}, {k: 0 for k in engines}
        with recorded_inputs() as seen:
            for k in list(engines) + list(engines)[::-1]:
                set_estimator(engines[k], state)
                before = sum(flash_counts().values())
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                audio[k] = engines[k].synthesize(text)
                secs[k].append(time.perf_counter() - t0)
                flash[k] += sum(flash_counts().values()) - before
            counts[name] = flash_counts()
        if flash["no_flash"] != 0 or flash["default"] <= 0:
            raise AssertionError(f"{name}: flash launches {flash} with use_flash False / default")
        if dt == torch.bfloat16:
            check_flash_counts(counts[name], f"{name} serving options")
        errs[name] = check_serving_inputs(seen, f"{name} serving options")
        folded_lsb = lsb_diff(f"{name} folded vs unfolded vocoder", audio["folded"],
                              audio["default"])
        mel = captured_vocoder_input(base, text)
        wave = base._vocode(mel)
        codes = {c: engines[k]._encode_transfer(wave) for c, k in (("int16", "default"),
                                                                   ("mulaw8", "mulaw8"))}
        out[name] = dict(
            request_s={k: round(float(np.mean(v)), 4) for k, v in secs.items()},
            flash_launches=flash, folded_vs_unfolded_mean_lsb=folded_lsb,
            vocoder_ms={"unfolded": round(time_ms(lambda: base._vocode(mel)), 4),
                        "folded": round(time_ms(lambda: engines["folded"]._vocode(mel)), 4)},
            vocoder_device_ms={
                "unfolded": round(device_ms(lambda: base._vocode(mel)), 4),
                "folded": round(device_ms(lambda: engines["folded"]._vocode(mel)), 4)},
            vocoder_batch=list(mel.shape),
            d2h_ms={c: round(d2h_ms(v), 4) for c, v in codes.items()},
            d2h_bytes={c: int(v.numel() * v.element_size()) for c, v in codes.items()})
    set_estimator(eng, state)
    log("serving options (343 characters) " + json.dumps(dict(card=smi, **out)))
    return counts, errs


def mixed_precision_and_options(smi: str, eng, work: str):
    """Phase 22: bfloat16 acoustic and vocoder training, the CLI under
    ``mixed_precision``, the engine's folded tail, codec and flash switch.
    Returns (the training kernels' launches, their errors on
    the phase's inputs, the flash kernels' launches and errors in its counted
    requests by dtype)."""
    launches, errs = bf16_acoustic(smi)
    bf16_vocoder(smi)
    cli_launches, seen = mixed_precision_cli(smi, work)
    cli_errs = check_training_inputs(seen)
    flash, flash_errs = serving_options(smi, eng)
    return ({k: launches[k] + cli_launches[k] for k in launches},
            {k: max(errs[k], cli_errs[k]) for k in errs}, flash, flash_errs)


# --- 23. data parallelism ------------------------------------------------------------------

DP_WORLD = 2
DP_TIMED = 3        # timed steps of each kind, single-process and data-parallel
DP_TIMEOUT_S = 600  # a rank, or a collective, that takes longer fails the run
DP_STEP = 30000     # the acoustic and e2e steps' count: hard expansion, the bin term on
TP_MODEL = 2        # phase 24's model axis: (data 1, model 2), the layout one card allows
TP_LOSS_RTOL = 1e-5  # a tensor-parallel step's metrics against the single-process step's
TP_NOISE = 1e-5     # an update entry whose first moment is below this share of its tensor's max
TP_ENTRY_RTOL = 1e-3  # ... or whose first moments in the two steps are further apart, relative


@contextlib.contextmanager
def alignments(hard: list, rows=None):
    """Record MAS's hard alignments in ``hard`` (``rows`` None), or hand on
    ``rows`` of the recorded ones in order after running MAS (its kernel) on
    the rank's own inputs: equal, or apart only where a decision on the path
    was a tie (``mas_margin`` < MAS_TIE), so that the single-process step and
    the data-parallel one differentiate one function."""
    import e2e_tts_tpu_torch.nn.variance as variance

    real, it = variance.monotonic_align, iter(list(hard))

    def record(*a):
        hard.append(real(*a))
        return hard[-1]

    def replay(attn, tl, ml):
        own, want = real(attn, tl, ml), next(it)[rows].to(attn.device)
        for b in sorted({int(i) for i in (own != want).nonzero()[:, 0]}):
            margin = mas_margin(attn[b].detach().float().cpu().numpy(), int(tl[b]), int(ml[b]),
                                own[b].argmax(-1).tolist())
            if not margin < MAS_TIE:
                raise AssertionError(f"data parallel: row {b}'s alignment differs off a MAS tie")
        return want

    variance.monotonic_align = record if rows is None else replay
    try:
        yield
    finally:
        variance.monotonic_align = real


def dp_grads_parity(what: str, groups, oracle: bool) -> dict:
    """The data-parallel step's gradients (Adam's first moments) against the
    single-process step's on the global batch, by PERF.md's card bars: each
    tensor within TRAIN_GRAD_RTOL of the single-process tensor (relative to
    its norm), or for a GAN step (``oracle``) the float64 oracle's rule,
    |dp - f64| <= max(TRAIN_GRAD_RTOL, ORACLE_FACTOR x |single - f64|), the
    same step in float64 on the card in ``moments_parity``'s CPU float64
    role.  A tensor 0 by construction below 1e-5 of its group's norm on
    every side.  ``groups``: (names, dp, single, float64 or None, zero
    pattern or None).  Logs the worst tensors; raises past the bar."""
    rows, zero = [], 0
    for names, dp, single, exact, pattern in groups:
        ref = exact if oracle else single
        scale = float(torch.sqrt(sum((m.double() ** 2).sum() for m in ref)))
        for k, (name, a, b) in enumerate(zip(names, dp, single)):
            a, b = a.double(), b.double()
            e = exact[k].double() if oracle else b
            if pattern is not None and pattern.search(name):
                if not all(t.norm() < 1e-5 * scale for t in (a, b)):
                    raise AssertionError(f"{what}: {name} should have a zero gradient")
                zero += 1
                continue
            norm = e.norm().clamp(min=1e-300)
            got, single_err = float((a - e).norm() / norm), float((b - e).norm() / norm)
            bar = max(TRAIN_GRAD_RTOL, ORACLE_FACTOR * single_err) if oracle else TRAIN_GRAD_RTOL
            rows.append((got / bar, got, single_err, name))
    rows.sort(reverse=True)
    worst = [dict(name=r[3], dp=float(f"{r[1]:.3g}"), single=float(f"{r[2]:.3g}"),
                  of_bar=round(r[0], 3)) for r in rows[:5]]
    log(f"{what}: gradients against the " + ("float64 step" if oracle else "single-process step")
        + " " + json.dumps(dict(tensors=len(rows), zero_by_construction=zero, worst=worst)))
    over = [r for r in rows if r[0] > 1.0]
    if over:
        raise AssertionError(f"{what}: {len(over)} gradient(s) past the bar: " + ", ".join(
            f"{r[3]} {r[1]:.3g} (single-process {r[2]:.3g})" for r in over[:8]))
    return dict(grad_rel_worst=max(r[1] for r in rows), grad_worst_of_bar=rows[0][0],
                zero_by_construction=zero, oracle=oracle)


@contextlib.contextmanager
def ctc_on_the_host():
    """The CTC forward and backward of ``ops.ctc`` through their plain
    versions on the CPU (the kernels take float32; the float64 oracle does
    not)."""
    import e2e_tts_tpu_torch.ops.ctc as ops_ctc

    real = ops_ctc.ctc_fwd, ops_ctc.ctc_bwd

    def host(fn):
        def call(*args):
            dev, out = args[0].device, fn(*(a.cpu() for a in args))
            return out.to(dev) if isinstance(out, torch.Tensor) else tuple(t.to(dev) for t in out)
        return call

    ops_ctc.ctc_fwd, ops_ctc.ctc_bwd = host(real[0]), host(real[1])
    try:
        yield
    finally:
        ops_ctc.ctc_fwd, ops_ctc.ctc_bwd = real


def dp_same_on_ranks(modules) -> bool:
    """Every parameter of ``modules`` (modules, or lists of parameters)
    bit-equal to rank 0's (all of them in one broadcast from it), on every
    rank."""
    import torch.distributed as dist

    mine = torch.cat([p.detach().reshape(-1) for m in modules
                      for p in (m.parameters() if isinstance(m, torch.nn.Module) else m)])
    theirs = mine.clone()
    dist.broadcast(theirs, 0)
    same = torch.tensor(float(torch.equal(theirs, mine)))  # on the host: gloo's MIN
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    return bool(same.item())


def tp_full(params, tensors, mesh) -> list:
    """Each of ``tensors`` (a parameter's shard, or a moment of it, in
    ``params``' order) made whole on every rank: a split one gathered over
    the model group on its split dim, the others as they are."""
    from e2e_tts_tpu_torch.parallel.mesh import model_group
    from e2e_tts_tpu_torch.parallel.tensor_parallel import SPLIT, gather_from_model, role

    group = model_group(mesh)
    with torch.no_grad():
        return [gather_from_model(t.detach(), p.tp_dim, group) if role(p) == SPLIT
                else t.detach() for p, t in zip(params, tensors)]


def tp_update_parity(what: str, groups, before, single_after, tp_after) -> dict:
    """The tensor-parallel step's update of each parameter (made whole)
    against the single-process step's, within TRAIN_GRAD_RTOL relative norm,
    over the entries whose gradient the two steps agree on: the
    single-process step's first moment at least TP_NOISE x its tensor's
    largest, and its distance from the tensor-parallel step's within
    TP_ENTRY_RTOL of it.  Adam's first update is lr x g / (|g| + eps) of the
    clipped gradient g: a sign where |g| >> eps, so that an entry whose
    gradient is within the card's float noise of 0 flips it, and where |g|
    is near eps (small entries after the clip) it moves with g's float
    noise; ``dp_grads_parity`` holds the gradients themselves per tensor.  A tensor
    0 by construction is skipped.  ``groups`` as ``dp_grads_parity``'s.
    Logs the worst and the share of entries held; raises past the bar."""
    rows, k, held, total = [], 0, 0, 0
    for names, tp_mu, single_mu, _, pattern in groups:
        for name, mu_t, mu_s in zip(names, tp_mu, single_mu):
            b, a, t = before[k].double(), single_after[k].double(), tp_after[k].double()
            k += 1
            if pattern is not None and pattern.search(name):
                continue
            mu_s, mu_t = mu_s.double().cpu(), mu_t.double().cpu()
            signal = ((mu_s.abs() >= TP_NOISE * mu_s.abs().max())
                      & ((mu_t - mu_s).abs() <= TP_ENTRY_RTOL * mu_s.abs()))
            held, total = held + int(signal.sum()), total + signal.numel()
            want, got = (a - b)[signal], (t.cpu() - b)[signal]
            rows.append((float((got - want).norm() / want.norm().clamp(min=1e-300)), name))
    rows.sort(reverse=True)
    log(f"{what}: updates against the single-process step " + json.dumps(dict(
        tensors=len(rows), entries_held=held, entries=total,
        worst=[dict(name=n, rel=float(f"{r:.3g}")) for r, n in rows[:5]])))
    over = [r for r in rows if r[0] > TRAIN_GRAD_RTOL]
    if over:
        raise AssertionError(f"{what}: {len(over)} update(s) past the bar: " + ", ".join(
            f"{n} {r:.3g}" for r, n in over[:8]))
    return dict(update_rel_worst=rows[0][0], update_entries_held=round(held / total, 6))


def param_counts(mods) -> dict:
    """A rank's parameters: elements held, their bytes, and how many of them
    are split shards or replicas."""
    from e2e_tts_tpu_torch.parallel.tensor_parallel import SPLIT, role

    ps = [p for m in mods for p in m.parameters()]
    split = sum(p.numel() for p in ps if role(p) == SPLIT)
    held = sum(p.numel() for p in ps)
    return dict(held=held, bytes=sum(p.numel() * p.element_size() for p in ps),
                split_shards=split, replicated=held - split)


def dp_kind(kind: str, rank: int, build, make_step, batches, rows, model_parallel: int = 1):
    """One kind of step.  Rank 0 runs the single-process step on the global
    batch (MAS's alignment recorded), times DP_TIMED more, and for a GAN
    step runs it once more in float64 (the oracle, ``dp_grads_parity``) while
    the other ranks wait; then every rank runs the
    data-parallel step on its rows (launch counts from 0, the training
    kernels' inputs recorded; MAS's alignment held to the single-process
    run's), rank 0 holds it to the single-process step (metrics within
    TRAIN_LOSS_RTOL, gradients by ``dp_grads_parity``), every rank holds its
    metrics and parameters bit-equal to rank 0's, and all time DP_TIMED
    data-parallel steps.  ``build()`` makes the modules; ``make_step(modules,
    group, model_group)`` gives (step, state, moments of the state as
    (names, tensors, pattern, parameters)); ``batches``: (global step
    arguments, this rank's, the global batch's rows).

    With ``model_parallel`` 2 (phase 24) the mesh is (data 1, model 2): every
    rank takes the whole batch, its modules are split by ``parallelize``, and
    the step is the tensor-parallel one.  Then the metrics are held within
    TP_LOSS_RTOL, the shards are gathered on every rank (``tp_full``) before
    rank 0 holds the gradients and the updates (``tp_update_parity``) to the
    single-process step, only the replicated parameters must be bit-equal
    on the ranks, and the rank's parameter counts and peak memory are kept.
    Returns the rank's result."""
    import torch.distributed as dist

    from e2e_tts_tpu_torch.parallel import make_data_mesh
    from e2e_tts_tpu_torch.parallel.data_parallel import data_group
    from e2e_tts_tpu_torch.parallel.distributed import barrier
    from e2e_tts_tpu_torch.parallel.mesh import model_group
    from e2e_tts_tpu_torch.parallel.tensor_parallel import SPLIT, parallelize, role

    hard, out, B = [], {}, batches[2]
    mesh = make_data_mesh(B, model_parallel)
    group, tp = data_group(mesh), model_group(mesh)
    train, oracle = kind != "vocoder", kind != "acoustic"
    what = f"{'tensor' if tp is not None else 'data'}-parallel {kind}"
    if rank == 0:
        mods = build()
        step, state, moments = make_step(mods, None, None)
        params = [p for *_, ps in moments(state) for p in ps] if model_parallel > 1 else []
        before = [p.detach().cpu().clone() for p in params]  # for the update's check
        torch.cuda.reset_peak_memory_stats()
        with alignments(hard):
            _, single = step(state, *batches[0])
        if model_parallel > 1:
            out["single_max_memory_allocated_gib"] = round(
                torch.cuda.max_memory_allocated() / 2 ** 30, 3)
        single = {k: v.item() for k, v in single.items()}
        single_mu = [(n, [t.clone() for t in mu], pattern)
                     for n, mu, pattern, _ in moments(state)]
        single_after = [p.detach().cpu().clone() for p in params]
        del params
        sec, _ = timed_steps(lambda s, b: step(s, *b), state, batches[0], DP_TIMED)
        out["single_step_ms"] = round(1e3 * sec, 3)
        del mods, step, state
        exact = [None] * len(single_mu)
        if oracle:  # the same step in float64 on the card, on the recorded alignment
            t0 = time.perf_counter()
            mods = tuple(m.double() for m in build())
            step, state, moments = make_step(mods, None, None)
            with alignments(hard, slice(None)) if hard else contextlib.nullcontext(), \
                    ctc_on_the_host():
                step(state, *[to_dtype(a, torch.float64) for a in batches[0]])
            exact = [[t.clone() for t in mu] for _, mu, _, _ in moments(state)]
            out["float64_step_s"] = round(time.perf_counter() - t0, 2)
            del mods, step, state
        torch.cuda.empty_cache()
    box = [hard[0].cpu() if hard else None]
    dist.broadcast_object_list(box, src=0)
    hard = [box[0]] if box[0] is not None else []
    mods = build()
    for m in mods:
        parallelize(m, mesh)
    step, state, moments = make_step(mods, group, tp)
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        if train:
            stack.enter_context(alignments(hard, rows))
            seen = stack.enter_context(recorded_train_inputs())
        _, dp = step(state, *batches[1])
        out["launches"] = training_launches() if train else {}
    out["errs"] = check_training_inputs(seen) if train else {}
    dp = {k: v.item() for k, v in dp.items()}
    box = [dp]
    dist.broadcast_object_list(box, src=0)
    if box[0] != dp:
        raise AssertionError(f"{what}: rank {rank}'s metrics differ from rank 0's")
    out["params_equal_on_ranks"] = dp_same_on_ranks(
        [[p for m in mods for p in m.parameters() if role(p) != SPLIT]])
    if not out["params_equal_on_ranks"]:
        raise AssertionError(f"{what}: the ranks' {'replicated ' if tp else ''}parameters parted")
    groups = moments(state)
    if tp is not None:  # the shards made whole on every rank
        groups = [(n, tp_full(ps, mu, mesh), pattern, ps) for n, mu, pattern, ps in groups]
        tp_after = tp_full([p for *_, ps in groups for p in ps],
                           [p for *_, ps in groups for p in ps], mesh)
        out["params"] = param_counts(mods)
    if rank == 0:
        bar = TRAIN_LOSS_RTOL if tp is None else TP_LOSS_RTOL
        out["metric_rel_err"] = {}
        for k, w in single.items():
            out["metric_rel_err"][k] = float(f"{abs(dp[k] - w) / max(abs(w), 1e-12):.3g}")
            if not abs(dp[k] - w) <= bar * max(abs(w), 1e-12):
                raise AssertionError(f"{what}: metric {k} {dp[k]}, the single-process "
                                     f"step's {w}")
        pairs = [(n, mu, single_mu[i][1], exact[i], p)
                 for i, (n, mu, p, _) in enumerate(groups)]
        out.update(dp_grads_parity(what, pairs, oracle))
        if tp is not None:
            out.update(tp_update_parity(what, pairs, before, single_after, tp_after))
    if tp is not None:
        del groups, tp_after
    torch.cuda.synchronize()
    barrier()
    sec, metrics = timed_steps(lambda s, b: step(s, *b), state, batches[1], DP_TIMED)
    out["dp_step_ms"] = round(1e3 * sec, 3)
    if tp is not None:
        out["max_memory_allocated_gib"] = round(torch.cuda.max_memory_allocated() / 2 ** 30, 3)
    check_finite(what, metrics)
    del mods, step, state
    torch.cuda.empty_cache()
    log(f"[rank {rank}] {what} " + json.dumps(out))
    return out


def start_rank(rank: int, world: int, port: int) -> dict:
    """A rank of phase 23 or 24: TF32 off, the kernels (built by the parent
    process) loaded, ``torch.distributed`` started on the card."""
    from e2e_tts_tpu_torch.kernels.build import library
    from e2e_tts_tpu_torch.parallel import initialize
    from e2e_tts_tpu_torch.parallel.distributed import backend

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in KERNELS:
        library(name)
    if not initialize(f"127.0.0.1:{port}", world, rank, timeout_s=DP_TIMEOUT_S):
        raise AssertionError("torch.distributed did not start")
    out = {"backend": backend(), "device": f"cuda:{torch.cuda.current_device()}"}
    log(f"[rank {rank}] backend {out['backend']} on {out['device']}")
    return out


def dp_rank(rank: int, world: int, port: int, work: str) -> int:
    """One rank of phase 23 (a process of its own): ``global_mesh`` serving,
    then one acoustic, vocoder and e2e step each, data-parallel, held to the
    single-process step.  Writes its result to ``work/rank_<rank>.json``."""
    import torch.distributed as dist

    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

    out = start_rank(rank, world, port)
    eng = SynthesisEngine.from_random(seed=0, global_mesh=True)
    eng.vocoder.load_state_dict(torch.load(os.path.join(work, "vocoder.pt")))
    with recorded_inputs() as seen:
        audio = eng.synthesize(REQUESTS[-1])
        out["flash"] = flash_counts()
    out["flash_err"] = check_serving_inputs(seen, f"rank {rank} global_mesh")
    out["n_devices"] = eng.n_devices
    np.save(os.path.join(work, f"audio_{rank}.npy"), audio)
    del eng
    torch.cuda.empty_cache()
    out.update(rank_steps(rank, world))
    with open(os.path.join(work, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    log(f"[rank {rank}] " + json.dumps(out))
    dist.destroy_process_group()
    return 0


def rank_steps(rank: int, world: int, model_parallel: int = 1) -> dict:
    """One acoustic, vocoder GAN and e2e step (``dp_kind``) at default width
    on phase 12, 13 and 14's batches over a (world / model_parallel,
    model_parallel) mesh: each rank takes its data coordinate's rows."""
    from e2e_tts_tpu_torch.config import default_config
    from e2e_tts_tpu_torch.text.symbols import symbols
    from e2e_tts_tpu_torch.train import (AcousticBatch, E2EBatch, VocoderBatch, acoustic_optimizer,
                                         build_acoustic_model, gan_optimizer, init_train_state,
                                         init_vocoder_train_state, make_train_step,
                                         make_vocoder_train_step)
    from e2e_tts_tpu_torch.train.vocoder_step import discriminator_params

    out = {}
    cfg = default_config()
    n_words = max(cfg.models.fastspeech2.max_seq_len, 256)
    n_symbols = len(symbols)
    batch_np = train_batch(n_symbols)
    n_data, coord = world // model_parallel, rank // model_parallel
    mine = slice(coord * TRAIN_B // n_data, (coord + 1) * TRAIN_B // n_data)

    def acoustic_step(mods, group, tp):
        model, = mods
        opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer,
                                 cfg.models.fastspeech2.encoder_hidden)
        state = init_train_state(model, opt, group=group)
        state.step = DP_STEP
        names, params = adam_names(model), list(model.parameters())
        return (make_train_step(model, cfg, opt, n_words, group=group, model_group=tp), state,
                lambda s: [(names, s.opt_state.mu, ZERO_BY_CONSTRUCTION, params)])

    batch = AcousticBatch.from_numpy(batch_np, "cuda")
    out["acoustic"] = dp_kind(
        "acoustic", rank,
        lambda: (build_acoustic_model(cfg, n_symbols, TRAIN_SPEAKERS, dropout=False),),
        acoustic_step, ((batch,), (AcousticBatch(*(t[mine] for t in batch)),), TRAIN_B), mine,
        model_parallel)

    def vocoder_step(mods, group, tp):
        gen, mpd, msd = mods
        g_opt, d_opt = (gan_optimizer(cfg.train.hifigan_optimizer) for _ in range(2))
        state = init_vocoder_train_state(gen, g_opt, d_opt, mpd, msd)
        names = (adam_names(gen), adam_names(mpd, msd))
        params = (list(gen.parameters()), discriminator_params(mpd, msd))
        return (make_vocoder_train_step(gen, cfg, g_opt, d_opt, "hifigan", mpd, msd, group=group,
                                        model_group=tp),
                state, lambda s: [(names[0], s.g_opt_state.mu, None, params[0]),
                                  (names[1], s.d_opt_state.mu, None, params[1])])

    vb = VocoderBatch.from_numpy(vocoder_batch(), "cuda")
    vrows = slice(coord * VOC_B // n_data, (coord + 1) * VOC_B // n_data)
    out["vocoder"] = dp_kind("vocoder", rank, lambda: gan_modules(cfg), vocoder_step,
                             ((vb,), (VocoderBatch(*(t[vrows] for t in vb)),), VOC_B), vrows,
                             model_parallel)

    def e2e_step(mods, group, tp):
        from e2e_tts_tpu_torch.train import init_e2e_state, make_e2e_train_step

        model, gen, mpd, msd = mods
        am_opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer,
                                    cfg.models.fastspeech2.encoder_hidden)
        g_opt, d_opt = (gan_optimizer(cfg.train.hifigan_optimizer) for _ in range(2))
        state = init_e2e_state(model, gen, am_opt, g_opt, d_opt, mpd, msd, group=group)
        state.step = DP_STEP
        names = (adam_names(model), adam_names(gen), adam_names(mpd, msd))
        params = (list(model.parameters()), list(gen.parameters()),
                  discriminator_params(mpd, msd))
        step = make_e2e_train_step(model, gen, cfg, am_opt, g_opt, d_opt, n_words, E2E_SEG,
                                   mpd, msd, group=group, model_group=tp)
        return (step, state, lambda s: [(names[0], s.am_opt_state.mu, ZERO_BY_CONSTRUCTION,
                                         params[0]),
                                        (names[1], s.g_opt_state.mu, None, params[1]),
                                        (names[2], s.d_opt_state.mu, None, params[2])])

    audio_np = e2e_audio(batch_np)
    starts = torch.from_numpy(np.random.RandomState(1).randint(
        0, np.maximum(batch_np[5] - E2E_SEG, 0) + 1)).cuda()
    eb = E2EBatch.from_numpy(batch_np, audio_np, "cuda")
    out["e2e"] = dp_kind(
        "e2e", rank, lambda: e2e_modules(cfg, n_symbols, "cuda", dropout=False), e2e_step,
        ((eb, starts), (E2EBatch(AcousticBatch(*(t[mine] for t in eb.acoustic)), eb.audio[mine]),
                        starts[mine]), TRAIN_B), mine, model_parallel)
    return out


def tp_forward(rank: int) -> dict:
    """Phase 24's split eval forward: the default-width acoustic model
    (``SynthesisEngine.from_random(seed=0)``) on the 343-character request's
    first batch (the engine's own stage-1 inputs and stage-2 bucket),
    unsplit and then split by ``parallelize`` over (data 1, model 2); the
    durations equal, the mel within MEL_TOL, and the flash kernel launched
    on the rank's local heads, held to its plain version on their inputs."""
    from e2e_tts_tpu_torch.parallel import make_mesh
    from e2e_tts_tpu_torch.parallel.tensor_parallel import parallelize
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

    eng = SynthesisEngine.from_random(seed=0)
    model, calls = eng.acoustic, {}
    real1, real2 = model.synthesize_stage1, model.synthesize_stage2

    def stage1(*a, **k):
        calls.setdefault(1, (a, k))
        return real1(*a, **k)

    def stage2(*a, **k):
        calls.setdefault(2, k["max_mel_len"])
        return real2(*a, **k)

    model.synthesize_stage1, model.synthesize_stage2 = stage1, stage2
    try:
        eng.synthesize(REQUESTS[-1])
    finally:
        del model.synthesize_stage1, model.synthesize_stage2
    (args, kw), T = calls[1], calls[2]

    def run():
        x, durations = model.synthesize_stage1(*args, **kw)
        mel, _ = model.synthesize_stage2(x, durations, T)
        return durations, mel

    durations, mel = run()
    parallelize(model, make_mesh(model_parallel=TP_MODEL))
    with recorded_inputs() as seen:
        split_durations, split_mel = run()
        torch.cuda.synchronize()
        flash = flash_counts()["flash_attention"]
    if not torch.equal(split_durations, durations):
        raise AssertionError(f"rank {rank} split forward: the durations differ")
    gap = float((split_mel - mel).abs().max())
    if not gap < MEL_TOL:
        raise AssertionError(f"rank {rank} split forward: mel max |diff| {gap} (bar {MEL_TOL})")
    if not flash:
        raise AssertionError(f"rank {rank} split forward: the flash kernel did not launch")
    heads = model.decoder.layers[0].slf_attn
    out = dict(batch=list(args[1].shape), T=T, mel_max_abs=float(f"{gap:.3g}"), flash=flash,
               flash_shapes=sorted(seen), local_rows_of_w_q=heads.w_q.weight.shape[0],
               flash_err=check_serving_inputs(seen, f"rank {rank} split forward"))
    log(f"[rank {rank}] split eval forward " + json.dumps(out))
    del eng, model
    torch.cuda.empty_cache()
    return out


def tp_rank(rank: int, world: int, port: int, work: str) -> int:
    """One rank of phase 24 (a process of its own): the split eval forward,
    then one acoustic, vocoder and e2e step each over (data 1, model 2),
    held to the single-process step.  Writes ``work/rank_<rank>.json``."""
    import torch.distributed as dist

    out = start_rank(rank, world, port)
    out["forward"] = tp_forward(rank)
    out.update(rank_steps(rank, world, TP_MODEL))
    with open(os.path.join(work, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    log(f"[rank {rank}] " + json.dumps(out))
    dist.destroy_process_group()
    return 0


def run_rank_processes(what: str, flag: str, work: str) -> list:
    """DP_WORLD ranks of this script (``flag``: ``--dp-rank`` or
    ``--tp-rank``) on 127.0.0.1, their logs' ends printed; a rank that fails,
    or that has not ended within DP_TIMEOUT_S, fails the run.  Each rank's
    JSON result."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logs = [open(os.path.join(work, f"rank_{r}.log"), "w+") for r in range(DP_WORLD)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, str(r),
                               str(DP_WORLD), str(port), work], stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(DP_WORLD)]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, DP_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise AssertionError(f"{what}: a rank did not end within {DP_TIMEOUT_S} s")
    finally:
        for r, f in enumerate(logs):
            f.seek(0)
            for line in f.read().splitlines()[-60:]:
                log(f"  rank {r}: {line}")
            f.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise AssertionError(f"{what}: rank(s) {failed} failed")
    results = []
    for r in range(DP_WORLD):
        with open(os.path.join(work, f"rank_{r}.json")) as f:
            results.append(json.load(f))
    return results


def rank_launches(results, what: str):
    """The training kernels' launches and worst errors over the ranks'
    acoustic and e2e steps; each rank must launch each kernel once a step."""
    launches = {k: 0 for k in ("mas", "ctc_fwd", "ctc_bwd")}
    errs = dict(launches)
    for r in results:
        for kind in ("acoustic", "e2e"):
            expect_launches(f"{what} {kind} step", r[kind]["launches"],
                            {"mas": 1, "ctc_fwd": 1, "ctc_bwd": 1})
            for k in launches:
                launches[k] += r[kind]["launches"][k]
                errs[k] = max(errs[k], r[kind]["errs"][k])
    return launches, errs


def tensor_parallel(smi: str):
    """Phase 24: tensor parallelism.  Two ranks share the card at (data 1,
    model 2) (processes of their own, ``tp_rank``; gloo): the split eval
    forward (``tp_forward``), then one acoustic, vocoder and e2e step each
    on the whole of phase 12, 13 and 14's batches with the wide weights
    split (``dp_kind`` with the model axis), held to the single-process
    step.  Returns (flash launches, the flash kernel's worst error on the
    phase's inputs, training launches, their worst errors)."""
    log(f"tensor parallel: {smi}; two ranks on one card over gloo (NCCL and more than one "
        "card are not exercised here)")
    work = tempfile.mkdtemp(prefix="tensor_parallel_")
    t0 = time.perf_counter()
    results = run_rank_processes("tensor parallel", "--tp-rank", work)
    launches, errs = rank_launches(results, "tensor-parallel")
    kinds = ("acoustic", "vocoder", "e2e")
    summary = {kind: dict(
        single_step_ms=results[0][kind]["single_step_ms"],
        tp_step_ms=[r[kind]["dp_step_ms"] for r in results],
        params=[r[kind]["params"] for r in results],
        max_memory_allocated_gib=[r[kind]["max_memory_allocated_gib"] for r in results],
        single_max_memory_allocated_gib=results[0][kind]["single_max_memory_allocated_gib"],
        metric_rel_err_worst=max(results[0][kind]["metric_rel_err"].values()),
        **{k: results[0][kind].get(k) for k in (
            "grad_rel_worst", "grad_worst_of_bar", "update_rel_worst", "oracle",
            "float64_step_s")}) for kind in kinds}
    forward = [r["forward"] for r in results]
    log("tensor parallel " + json.dumps(dict(
        card=smi, ranks=DP_WORLD, mesh={"data": 1, "model": TP_MODEL},
        backend=results[0]["backend"], devices=[r["device"] for r in results],
        seconds=round(time.perf_counter() - t0, 1),
        forward=dict(mel_max_abs=[f["mel_max_abs"] for f in forward],
                     flash=[f["flash"] for f in forward], T=forward[0]["T"],
                     batch=forward[0]["batch"]),
        training_launches=[{kind: r[kind]["launches"] for kind in ("acoustic", "e2e")}
                           for r in results],
        note="two ranks on one card measure the code path, not scaling", **summary)))
    return (sum(f["flash"] for f in forward), max(f["flash_err"] for f in forward), launches,
            errs)


def data_parallel(smi: str, eng):
    """Phase 23: data parallelism.  On the one card: an engine with
    ``serving_devices=1`` gives the longest request bit-equal to the default
    engine (``eng``, from one bucket-estimator state), and
    ``serving_devices=2`` raises.  Then two ranks share the card (processes
    of their own, ``dp_rank``; gloo, since NCCL takes one rank a card): a
    ``global_mesh`` engine (both ranks' int16 equal, within LSB_TOL mean of
    ``eng``), and one acoustic, vocoder and e2e step each on their rows of
    phase 12, 13 and 14's batches, held to the single-process step on the
    whole batch (``dp_kind``).  A rank that fails, or that has not ended
    within DP_TIMEOUT_S, fails the run.  Returns (flash launches, the flash
    kernel's worst error on the phase's inputs, training launches, their
    worst errors)."""
    from e2e_tts_tpu_torch.serve.engine import FRAMES_PER_PHONEME_EST, SynthesisEngine

    log(f"data parallel: {smi}; torch.cuda.device_count() = {torch.cuda.device_count()}")
    log("data parallel: NCCL is not exercised on this machine: it has one card, and two ranks "
        "on one card run over gloo")
    text = REQUESTS[-1]
    saved = estimator(eng)
    fresh = (float(FRAMES_PER_PHONEME_EST), float(FRAMES_PER_PHONEME_EST), 0)
    set_estimator(eng, fresh)
    ref = eng.synthesize(text)
    set_estimator(eng, saved)
    one = SynthesisEngine.from_random(seed=0, serving_devices=1)
    one.vocoder.load_state_dict(eng.vocoder.state_dict())
    set_estimator(one, fresh)
    with recorded_inputs() as seen:
        got = one.synthesize(text)
        flash = flash_counts()["flash_attention"]
    if not np.array_equal(got, ref):
        raise AssertionError("serving_devices=1: the request differs from the default engine's")
    flash_err = check_serving_inputs(seen, "serving_devices=1")
    log(f"data parallel: serving_devices=1, {len(text)} characters: bit-equal to the default "
        f"engine ({flash} flash launches)")
    del one
    try:
        SynthesisEngine.from_random(seed=0, serving_devices=2)
    except ValueError as e:
        log(f"data parallel: serving_devices=2 on {torch.cuda.device_count()} card(s) raises: {e}")
    else:
        raise AssertionError("serving_devices=2 on one card did not raise")
    torch.cuda.empty_cache()

    work = tempfile.mkdtemp(prefix="data_parallel_")
    torch.save(eng.vocoder.state_dict(), os.path.join(work, "vocoder.pt"))
    t0 = time.perf_counter()
    results = run_rank_processes("data parallel", "--dp-rank", work)
    audios = [np.load(os.path.join(work, f"audio_{r}.npy")) for r in range(DP_WORLD)]
    if not all(np.array_equal(a, audios[0]) for a in audios):
        raise AssertionError("global_mesh: the ranks returned other waveforms")
    lsb_diff(f"global_mesh on {DP_WORLD} ranks ({results[0]['backend']}), {len(text)} characters, "
             "vs the one-process engine", audios[0], ref)
    flash += sum(r["flash"]["flash_attention"] for r in results)
    flash_err = max([flash_err] + [r["flash_err"] for r in results])
    launches, errs = rank_launches(results, "data-parallel")
    summary = {kind: dict(single_step_ms=results[0][kind]["single_step_ms"],
                          dp_step_ms=[r[kind]["dp_step_ms"] for r in results],
                          metric_rel_err_worst=max(results[0][kind]["metric_rel_err"].values()),
                          **{k: results[0][kind].get(k) for k in (
                              "grad_rel_worst", "grad_worst_of_bar", "oracle", "float64_step_s")})
               for kind in ("acoustic", "vocoder", "e2e")}
    log("data parallel " + json.dumps(dict(
        card=smi, ranks=DP_WORLD, backend=results[0]["backend"],
        devices=[r["device"] for r in results], seconds=round(time.perf_counter() - t0, 1),
        note="two ranks on one card measure the code path, not scaling", **summary)))
    return flash, flash_err, launches, errs


def main() -> int:
    if sys.argv[1:2] == ["--dp-rank"]:  # one rank of phase 23, started by the phase
        return dp_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    if sys.argv[1:2] == ["--tp-rank"]:  # one rank of phase 24, started by the phase
        return tp_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    smi = environment()
    build()
    attn = check_attention()
    train_kernels = check_training_kernels()
    path_parity()
    eng, launches, serve_err, serve_rows = serve()
    make_audible(eng)
    cpu = serve_parity(eng, gain=True)
    state = estimator(eng)  # phase 16 profiles from here, as before the phases after 6
    audio_ops()
    path_errs = [serve_err, istft_serve(serve_rows), streaming(eng, cpu), queue(eng),
                 synthesizer_and_denoiser(eng, cpu)]
    t0 = time.perf_counter()
    train_launches, train_errs = training()
    log(f"training phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    vocoder_gan()
    log(f"vocoder GAN phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    e2e_launches, e2e_errs = joint_e2e()
    log(f"e2e phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    path_errs.append(bundle())
    log(f"bundle phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts, bf16_err = serve_bf16(serve_rows)
    log(f"bf16 serving phase: {time.perf_counter() - t0:.1f} s")
    set_estimator(eng, state)
    profile(eng, REQUESTS[-1])
    import shutil

    work = tempfile.mkdtemp(prefix="corpus_to_voice_")
    try:
        t0 = time.perf_counter()
        corpus_launches, corpus_errs, corpus_serve_err = corpus_to_voice(smi, work)
        path_errs.append(corpus_serve_err)
        logit_sharpness(smi)
        log(f"corpus to voice phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cli_launches, cli_errs, cli_serve_err = cli_corpus_to_voice(smi, work)
        path_errs.append(cli_serve_err)
        log(f"CLI corpus to voice phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        family_launches, family_errs = block_families(smi, work)
        log(f"block families phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        router_launches, router_err = router_vc_import_scoring(smi, eng, cpu, work)
        path_errs.append(router_err)
        log(f"router, voice conversion, import and scoring phase: "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        mp_launches, mp_errs, options_flash, options_errs = mixed_precision_and_options(
            smi, eng, work)
        path_errs.append(options_errs["float32"])
        log(f"mixed precision and serving options phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        dp_flash, dp_flash_err, dp_launches, dp_errs = data_parallel(smi, eng)
        path_errs.append(dp_flash_err)
        log(f"data parallelism phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        tp_flash, tp_flash_err, tp_launches, tp_errs = tensor_parallel(smi)
        path_errs.append(tp_flash_err)
        log(f"tensor parallelism phase: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    kernels = []
    source = "e2e_tts_tpu_torch/kernels/csrc/flash_attention.cu"
    for name, dtypes, prefix, src, n, errs in (
            ("flash_attention", ("float32",), "kernel", source,
             launches["flash_attention"] + router_launches
             + options_flash["float32"]["flash_attention"] + dp_flash + tp_flash, path_errs),
            # the 16-bit kernels: timed in bfloat16, the serving dtype, forced
            # in turns; the error in the dtype's values (within one ulp of the
            # plain version, phase 3); launches in phase 16's batch-8 run,
            # where the plan takes flash_fwd_16_sm90 (heads of 192): the
            # mma.sync kernel runs there only where D % 8 != 0
            ("flash_attention_16", ("bfloat16", "float16"), "mma_sync", source,
             counts["flash_attention_16"] + options_flash["bfloat16"]["flash_attention_16"],
             [bf16_err, options_errs["bfloat16"]]),
            ("flash_attention_16_sm90", ("bfloat16", "float16"), "sm90",
             "e2e_tts_tpu_torch/kernels/csrc/flash_attention_sm90.cuh",
             counts["flash_attention_16_sm90"]
             + options_flash["bfloat16"]["flash_attention_16_sm90"],
             [bf16_err, options_errs["bfloat16"]])):
        rows = [r for r in attn if r["dtype"] in dtypes and f"{prefix}_ms" in r]
        main_row = next(r for r in rows if r["shape"] == (16, 2048, 192)
                        and r["dtype"] == dtypes[0])  # the decoder's largest bucket
        kernels.append(dict(
            name=name, route="cuda", source=src,
            replaces="e2e_tts_tpu/kernels/flash_attention.py:106", launches=n,
            max_abs_err=max(*errs, *(r["err" if prefix == "kernel" else f"{prefix}_err"]
                                     for r in rows)),
            ms=main_row[f"{prefix}_ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"]))
    train_row = train_kernels[0]  # the training bucket of the phase 12 and 14 batch
    for name, replaces, library_ms in (
            ("mas", "e2e_tts_tpu/ops/mas.py:21", None),
            ("ctc_fwd", "e2e_tts_tpu/ops/ctc.py:30", train_row["ctc_library_fwd_ms"]),
            # F.ctc_loss forward and backward: no PyTorch call runs the backward alone
            ("ctc_bwd", "e2e_tts_tpu/ops/ctc.py:30", train_row["ctc_library_ms"])):
        errs = [train_errs[name], e2e_errs[name], corpus_errs[name], cli_errs[name],
                family_errs[name], mp_errs[name], dp_errs[name], tp_errs[name]] + [
            r[{"mas": "mas_err", "ctc_fwd": "ctc_loss_err", "ctc_bwd": "ctc_grad_err"}[name]]
            for r in train_kernels]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"e2e_tts_tpu_torch/kernels/csrc/{'mas' if name == 'mas' else 'ctc'}.cu",
            replaces=replaces,
            launches=(train_launches[name] + e2e_launches[name] + corpus_launches[name]
                      + cli_launches[name] + family_launches[name] + mp_launches[name]
                      + dp_launches[name] + tp_launches[name]),
            max_abs_err=max(errs),
            ms=train_row[f"{name}_ms"], plain_ms=train_row[f"{name}_plain_ms"],
            bound_ms=train_row[f"{name}_bound_ms"], bound_by=train_row[f"{name}_bound_by"],
            library_ms=library_ms))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
