"""The training CLI's ``acoustic`` subcommand, in this process, through
``e2e_tts_tpu_torch.train.cli.main(argv, on_step=...)``.

Set-up writes a feature workdir from the seed (``gen/corpus.py``) under
``TMPDIR`` and runs the first epoch: it fills ``workdir/priors`` and runs
every bucket of the corpus once, as a long job has done by then.  The
window opens when the loop asks the batcher for the second epoch and
closes at the first step that ends ``--seconds`` later, once the window
has run the mix's ``reference_steps`` steps (from ``on_step``, so no
checkpoint is written).  Rows trained are the real rows of the
window's batches: a row that repeats an utterance to fill a partial batch
does not count.

The benchmark reads the loop through public surfaces only: a wrapper
around ``data.make_acoustic_batches`` (the batches' host time, in the
prefetch thread), ``AcousticBatch.from_numpy`` (each batch's lengths and
real rows, on the host), ``acoustic_step.make_train_step`` (which puts the
benchmark's seeded weights into the model before the optimizer state is
made, and keeps for the check the batches, metrics and optimizer moments
of the loop's first steps from the seed and of the window's first steps,
with the training state as the window found it) and a forward hook on the
model (its hard alignments).
"""

from __future__ import annotations

import collections
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from ..gen.corpus import write_workdir
from ..gen.weights import load, seeded_weights
from .outcome import Outcome

BIG = str(10 ** 9)


class WindowClosed(Exception):
    pass


def _real_rows(texts: np.ndarray, mel_lens: np.ndarray) -> int:
    return len({(int(m), t.tobytes()) for t, m in zip(texts, mel_lens)})


class Segment:
    """Steps in a row that the reference follows: the state they start
    from (``weights``, the optimizer's moments and count, the step number,
    the dropout generator's state; ``opt`` None for a fresh optimizer) and
    what the program did on them."""

    def __init__(self, weights, first_step, opt=None, rng_state=None):
        self.weights, self.first_step, self.opt, self.rng_state = weights, first_step, opt, rng_state
        self.steps = []                     # (batch, metrics)
        self.hards = []
        self.grad_norms = self.delta_norms = None


class Capture:
    """What the wrappers see of the loop."""

    def __init__(self, weights_of, ref_steps):
        self.weights_of = weights_of
        self.ref_steps = ref_steps
        self.meta = collections.deque()     # per batch made: (real rows, txt_lens, mel_lens, L, T)
        self.weights = None
        self.first = None                   # Segment: the first steps, from the seed
        self.win = None                     # Segment: the window's first steps
        self.hard_sink = None
        self.names = None
        self.calls = 0                      # make_acoustic_batches calls (epochs)
        self.steps = 0
        self.window = False
        self.rows = 0
        self.window_meta = []
        self.batch_ms = []
        self.spans = []


def run(run) -> Outcome:
    import e2e_tts_tpu_torch.data as data_mod
    from e2e_tts_tpu_torch.train import acoustic_step, cli

    mix, cfg = run.mix, run.config_file
    config = cfg["config"]
    root = tempfile.mkdtemp(prefix="port_bench_train_", dir=os.environ.get("TMPDIR") or None)
    cap = Capture(lambda model: seeded_weights(model, cfg["init"], run.seed, run.device),
                  mix["reference_steps"])
    b1 = config["train"]["fastspeech2_optimizer"]["betas"][0]
    orig_batches = data_mod.make_acoustic_batches
    batch_cls = acoustic_step.AcousticBatch
    orig_from_numpy_attr = vars(batch_cls)["from_numpy"]
    orig_from_numpy = batch_cls.from_numpy
    orig_make_step = acoustic_step.make_train_step

    def make_batches(*a, **k):
        cap.calls += 1
        if cap.calls == 2:
            run.begin_window()
            cap.window = True
        it = orig_batches(*a, **k)

        def timed():
            while True:
                t0 = time.perf_counter_ns()
                try:
                    b = next(it)
                except StopIteration:
                    return
                if cap.window:
                    cap.batch_ms.append((time.perf_counter_ns() - t0) / 1e6)
                yield b
        return timed()

    def from_numpy(arrays, device):
        arrays = list(arrays)
        texts, txt_lens, mel_lens = (np.asarray(arrays[i]) for i in (1, 2, 5))
        cap.meta.append((_real_rows(texts, mel_lens), txt_lens.copy(), mel_lens.copy(),
                         texts.shape[1], np.asarray(arrays[4]).shape[1]))
        return orig_from_numpy(arrays, device)

    def make_train_step(model, config_obj, optimizer, n_words, group=None, model_group=None):
        cap.weights = cap.weights_of(model)
        load(model, cap.weights)
        cap.names = [n for n, _ in model.named_parameters()]
        cap.first = Segment(cap.weights, 0)
        model.register_forward_hook(
            lambda m, a, o: cap.hard_sink.append(o["attn_hard"]) if cap.hard_sink is not None
            else None)
        step = orig_make_step(model, config_obj, optimizer, n_words, group=group,
                              model_group=model_group)
        params = list(model.parameters())

        def wrapped(state, batch):
            meta = cap.meta.popleft()
            window = cap.window
            if window and cap.win is None:
                with torch.no_grad():  # the state as the window finds it
                    opt = state.opt_state
                    cap.win = Segment({n: p.detach().clone() for n, p in zip(cap.names, params)},
                                      state.step, ([m.clone() for m in opt.mu],
                                                   [v.clone() for v in opt.nu], opt.count),
                                      state.rng.get_state())
            seg = cap.win if window else cap.first
            seg = seg if len(seg.steps) < cap.ref_steps else None
            cap.hard_sink = seg.hards if seg is not None else None
            t0 = time.time_ns()
            state, metrics = step(state, batch)
            cap.hard_sink = None
            if cap.window:
                cap.spans.append((t0, time.time_ns(), "train.step"))
                cap.rows += meta[0]
                cap.window_meta.append(meta)
            cap.steps += 1
            if seg is not None:
                with torch.no_grad():
                    seg.steps.append((batch, metrics))
                    if len(seg.steps) == 1:  # the gradient as Adam got it, from its first moment
                        mu = state.opt_state.mu
                        if seg.opt is not None:
                            mu = torch._foreach_sub(mu, torch._foreach_mul(seg.opt[0], b1))
                        seg.grad_norms = torch.stack(torch._foreach_norm(mu)) / (1 - b1)
                    if len(seg.steps) == cap.ref_steps:
                        seg.delta_norms = torch.stack([torch.linalg.vector_norm(p - seg.weights[n])
                                                       for n, p in zip(cap.names, params)])
            return state, metrics

        return wrapped

    def on_step(step, metrics):
        if (cap.win is not None and len(cap.win.steps) >= cap.ref_steps
                and time.perf_counter() - run.t0 >= run.seconds):
            run.end_window()
            raise WindowClosed

    import yaml

    cfg_path = os.path.join(root, "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config, f)
    records = write_workdir(root, mix, config, run.seed)
    data_mod.make_acoustic_batches = make_batches
    batch_cls.from_numpy = from_numpy
    acoustic_step.make_train_step = make_train_step
    try:
        cli.main(["acoustic", "--workdir", root, "--config", cfg_path, "--steps", BIG,
                  "--ckpt-every", BIG, "--device", run.device.type], on_step=on_step)
    except WindowClosed:
        pass
    finally:
        data_mod.make_acoustic_batches = orig_batches
        batch_cls.from_numpy = orig_from_numpy_attr
        acoustic_step.make_train_step = orig_make_step
    if run.window_s is None:
        raise RuntimeError("the training loop ended before its window closed")

    from ..counts import kernels, model as model_counts

    counters = {"batch_host_ms": cap.batch_ms, "rows": cap.rows, "steps": len(cap.window_meta)}
    flops = mas_f = mas_b = ctc_f = ctc_b = 0.0
    for rows, tl, ml, L, T in cap.window_meta:
        for t, m in zip(tl.tolist(), ml.tolist()):  # every row the step computes
            flops += model_counts.train_row(t, m, config)
        f, b = kernels.mas(tl, ml, T, L)
        mas_f, mas_b = mas_f + f, mas_b + b
        f, b = kernels.ctc(tl, ml, T, L)
        ctc_f, ctc_b = ctc_f + f, ctc_b + b
    counters.update(model_flops=flops, mas_flops=mas_f, mas_bytes=mas_b, ctc_flops=ctc_f,
                    ctc_bytes=ctc_b)
    run.note(f"window: {len(cap.window_meta)} steps, {cap.rows} real rows, "
             f"{run.window_s:.3f} s; set-up {run.setup_s:.3f} s over {cap.steps - len(cap.window_meta)} steps")

    def check(control=None):
        from ..compare.training import compare_steps

        return compare_steps(run, cfg, root, records, cap, control)

    return Outcome(metrics={"train_utt_per_s": cap.rows / run.window_s},
                   attempted=len(cap.window_meta), failed=0, counters=counters, spans=cap.spans,
                   check=check, close=lambda: shutil.rmtree(root, ignore_errors=True))
