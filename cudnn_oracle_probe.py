"""The e2e step's one gradient past the float64 oracle's bar
(``trunk.resblocks.0.0.convs1.0.v``, ``chip_smoke.ORACLE_FAULTS``) under
each cuDNN setting, on one NVIDIA GPU.

    python3 cudnn_oracle_probe.py

Builds the port's kernels (MAS and CTC run in the step), then, on
``chip_smoke`` phase 14's batch and modules:

1. the cuDNN kernels that this convolution (256 channels, k = 3) launches
   forward and backward at the parity step's shape, by the profiler's
   names, under each setting;
2. the parity step (4 rows, dropout 0, step 30000, the crop starts handed
   in) on the card under each setting, beside one CPU float32 run and one
   float64 run (every run on the first card run's hard alignment): the
   tensor's relative distance from float64 on the card and on the CPU, its
   bar max(1e-3, 2 x the CPU's), and the worst ratio to the bar over every
   other gradient;
3. the B = 32 e2e step under each setting, ms a step over 5 steps after a
   warm-up, settings in turns.

The settings: ``default`` (cuDNN's benchmark and deterministic off, as
PyTorch starts), ``deterministic``, ``benchmark``, and ``port_wgrad``: the
default with the training-form convolutions' weight gradient taken out of
cuDNN's wgrad kernel (``_Conv1dWeightGrad``: each utterance's unfolded
product through cuBLAS, the batch's partials summed in float64); TF32 off
throughout.  Step 3 runs the settings in turns (default, deterministic,
benchmark, port_wgrad, default), and phase 13's vocoder step (B = 16 x 8192
samples) is timed under default and port_wgrad in turns.  One JSON line per
setting.  Without CUDA it exits non-zero.
"""

from __future__ import annotations

import contextlib
import copy
import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke as cs

TENSOR = "trunk.resblocks.0.0.convs1.0.v"
SETTINGS = {"default": dict(benchmark=False, deterministic=False),
            "deterministic": dict(benchmark=False, deterministic=True),
            "benchmark": dict(benchmark=True, deterministic=False),
            "port_wgrad": dict(benchmark=False, deterministic=False)}


class _Conv1dWeightGrad(torch.autograd.Function):
    """``F.conv1d`` whose weight gradient does not come from cuDNN's wgrad
    kernel: each utterance's partial gradient is one product of its
    unfolded input (``F.unfold``) with its output gradient (a batched
    ``torch.matmul`` in float32), and the B partials are summed in float64
    and rounded once to float32.  The forward and the input's gradient stay
    on cuDNN.  On the card cuDNN's float32 wgrad put one e2e gradient past
    the float64 oracle's bar (ROADMAP.md, C1)."""

    @staticmethod
    def forward(ctx, x, w, b, stride: int, padding: int, dilation: int, groups: int):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups)
        ctx.has_bias = b is not None
        return F.conv1d(x, w, b, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv1d_input(x.shape, w, gy, stride, padding, dilation, groups)
        if ctx.needs_input_grad[1]:
            B, T_out = gy.shape[0], gy.shape[-1]
            c_out, c_in, k = w.shape
            cols = F.unfold(x.unsqueeze(2), (1, k), dilation=(1, dilation), padding=(0, padding),
                            stride=(1, stride))  # (B, C_in * k, T_out), channel-major
            part = torch.matmul(gy.reshape(B, groups, c_out // groups, T_out),
                                cols.view(B, groups, c_in * k, T_out).transpose(-1, -2))
            gw = part.double().sum(0).to(w.dtype).view(c_out, c_in, k)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = gy.sum((0, 2))
        return gx, gw, gb, None, None, None, None


@contextlib.contextmanager
def cudnn(setting: str):
    """cuDNN's flags of ``setting``; under ``port_wgrad`` every float32
    ``WNConv1d`` under autograd goes through ``_Conv1dWeightGrad``."""
    from e2e_tts_tpu_torch.nn.common import WNConv1d

    real = WNConv1d.conv_ncw

    def conv_ncw(self, x):
        if x.dtype != torch.float32 or not torch.is_grad_enabled():
            return real(self, x)
        left, right = (_same_pads(self, x) if self.padding == "SAME" else self.padding)
        if left != right:
            x, left = F.pad(x, (left, right)), 0
        return _Conv1dWeightGrad.apply(x, self.weight(), self.bias, self.stride, left,
                                       self.dilation, self.groups)

    if setting == "port_wgrad":
        WNConv1d.conv_ncw = conv_ncw
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False, **SETTINGS[setting]):
            yield
    finally:
        WNConv1d.conv_ncw = real


def _same_pads(conv, x):
    from e2e_tts_tpu_torch.nn.common import same_padding

    return same_padding(x.shape[-1], conv.kernel_size, conv.stride, conv.dilation)


def conv_kernels(gen, rows: int, setting: str) -> list:
    """(kernel name, count) of the convolution's forward and backward at the
    e2e step's shape: E2E_SEG frames x 8 after the first upsampling."""
    from torch.profiler import ProfilerActivity, profile

    conv = copy.deepcopy(gen.get_submodule(TENSOR[:-2])).cuda()
    x = torch.randn(rows, 256, cs.E2E_SEG * 8, device="cuda", requires_grad=True)
    with cudnn(setting):
        conv.conv_ncw(x).square().sum().backward()  # warm-up (benchmark searches here)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            conv.conv_ncw(x).square().sum().backward()
            torch.cuda.synchronize()
    return sorted(((e.key, e.count) for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")), key=lambda k: k[0])


def distances(state, cpu_state, f64_state, names, pattern) -> dict:
    """Each gradient's relative distance from float64 (Adam's first moments)
    on the card and on the CPU, and its ratio to the oracle's bar."""
    exact = [m.double() for m in f64_state.mu]
    out = {}
    for name, mg, mc, me in zip(names, state.mu, cpu_state.mu, exact):
        mg, mc = mg.double().cpu(), mc.double()
        if pattern is not None and pattern.search(name):
            continue  # 0 by construction: float noise on every side
        norm = me.norm().clamp(min=1e-300)
        card, host = float((mg - me).norm() / norm), float((mc - me).norm() / norm)
        out[name] = (card, host, card / max(cs.TRAIN_GRAD_RTOL, cs.ORACLE_FACTOR * host))
    return out


@contextlib.contextmanager
def alignment(hard: list, record: bool):
    """Record MAS's hard alignments (``record``), or hand on the recorded
    ones in order, so that every run differentiates one function."""
    import e2e_tts_tpu_torch.nn.variance as variance

    real = variance.monotonic_align
    if record:
        variance.monotonic_align = lambda *a: hard.append(real(*a)) or hard[-1]
    else:
        it = iter(list(hard))
        variance.monotonic_align = lambda attn, tl, ml: next(it).to(attn.device)
    try:
        yield
    finally:
        variance.monotonic_align = real


def main() -> int:
    from e2e_tts_tpu_torch.config import default_config
    from e2e_tts_tpu_torch.text.symbols import symbols
    from e2e_tts_tpu_torch.train import E2EBatch

    smi = cs.environment()
    cs.build()
    cfg = default_config()
    n_words = max(cfg.models.fastspeech2.max_seq_len, 256)
    batch_np = cs.train_batch(len(symbols))
    audio = cs.e2e_audio(batch_np)
    rows = slice(0, cs.PARITY_ROWS)
    starts = np.random.RandomState(1).randint(
        0, np.maximum(batch_np[5][rows] - cs.E2E_SEG, 0) + 1)

    def run(mods, device, dtype):
        state, step = cs.e2e_step_fn(cfg, mods, n_words)
        state.step = 30000
        batch = E2EBatch.from_numpy([a[rows] for a in batch_np], audio[rows], device)
        return step(state, cs.to_dtype(batch, dtype), torch.from_numpy(starts).to(device))[0]

    cpu = cs.e2e_modules(cfg, len(symbols), "cpu", dropout=False)
    names = {"g_opt_state": cs.adam_names(cpu[1]), "am_opt_state": cs.adam_names(cpu[0]),
             "d_opt_state": cs.adam_names(*cpu[2:])}
    f64 = [copy.deepcopy(m).double() for m in cpu]  # before the CPU run updates ``cpu``
    hard, states = [], {}
    for i, setting in enumerate(SETTINGS):
        with cudnn(setting), alignment(hard, record=i == 0):
            states[setting] = run([copy.deepcopy(m).to("cuda") for m in cpu], "cuda",
                                  torch.float32)
    t0 = time.perf_counter()
    with alignment(hard, record=False):
        host = run(cpu, "cpu", torch.float32)
    with alignment(hard, record=False):
        exact = run(f64, "cpu", torch.float64)
    cpu_s = time.perf_counter() - t0

    timed = {}
    state, step = cs.e2e_step_fn(cfg, cs.e2e_modules(cfg, len(symbols)), n_words)
    batch = E2EBatch.from_numpy(batch_np, audio, "cuda")
    for setting in ("default", "deterministic", "benchmark", "port_wgrad", "default"):
        with cudnn(setting):
            step(state, batch)  # warm-up
            sec, _ = cs.timed_steps(step, state, batch, cs.TRAIN_STEPS)
        timed.setdefault(setting, []).append(round(1e3 * sec, 3))
    vocoder_ms = vocoder_step_ms(cfg)

    for setting in SETTINGS:
        d = {}
        for attr, pattern in (("g_opt_state", None), ("am_opt_state", cs.ZERO_BY_CONSTRUCTION),
                              ("d_opt_state", None)):
            d.update(distances(getattr(states[setting], attr), getattr(host, attr),
                               getattr(exact, attr), names[attr], pattern))
        card, cpu_d, ratio = d.pop(TENSOR)
        worst = max(d.items(), key=lambda kv: kv[1][2])
        print(json.dumps(dict(
            setting=setting, card=smi, cudnn=SETTINGS[setting],
            kernels=conv_kernels(cpu[1], cs.PARITY_ROWS, setting),
            tensor=TENSOR, card_vs_f64=float(f"{card:.4g}"), cpu_vs_f64=float(f"{cpu_d:.4g}"),
            bar=float(f"{max(cs.TRAIN_GRAD_RTOL, cs.ORACLE_FACTOR * cpu_d):.4g}"),
            of_bar=round(ratio, 4), other_over_bar=sum(v[2] > 1.0 for v in d.values()),
            worst_other=dict(name=worst[0], of_bar=round(worst[1][2], 4)),
            e2e_step_ms_b32=timed[setting], vocoder_step_ms_b16=vocoder_ms.get(setting),
            cpu_runs_s=round(cpu_s, 2))), flush=True)
    return 0


def vocoder_step_ms(cfg) -> dict:
    """Phase 13's vocoder GAN step (HiFi-GAN V1, MPD/MSD, B = 16 x 8192
    samples), ms a step over 5 steps after a warm-up, under default and
    port_wgrad in turns."""
    from e2e_tts_tpu_torch.train import (VocoderBatch, gan_optimizer, init_vocoder_train_state,
                                         make_vocoder_train_step)

    gen, mpd, msd = cs.gan_modules(cfg)
    g_opt, d_opt = (gan_optimizer(cfg.train.hifigan_optimizer) for _ in range(2))
    state = init_vocoder_train_state(gen, g_opt, d_opt, mpd, msd)
    step = make_vocoder_train_step(gen, cfg, g_opt, d_opt, "hifigan", mpd, msd)
    batch = VocoderBatch.from_numpy(cs.vocoder_batch(), "cuda")
    out = {}
    for setting in ("default", "port_wgrad", "port_wgrad", "default"):
        with cudnn(setting):
            step(state, batch)  # warm-up
            sec, _ = cs.timed_steps(step, state, batch, cs.VOC_STEPS)
        out.setdefault(setting, []).append(round(1e3 * sec, 3))
    return out


if __name__ == "__main__":
    sys.exit(main())
