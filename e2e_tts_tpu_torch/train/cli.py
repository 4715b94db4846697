"""Training command line of the port (port of ``e2e_tts_tpu/train/cli.py``):
a corpus on disk to a served voice, on one card or data-parallel on several.

    python -m e2e_tts_tpu_torch.train.cli prepare  --corpus DIR [...] --workdir OUT
    python -m e2e_tts_tpu_torch.train.cli acoustic --workdir OUT [--steps N] [--supervised]
    python -m e2e_tts_tpu_torch.train.cli vocoder  --workdir OUT [--steps N] [--istft]
    python -m e2e_tts_tpu_torch.train.cli e2e      --workdir OUT [--steps N]
    python -m e2e_tts_tpu_torch.train.cli generate-mels --workdir OUT
    python -m e2e_tts_tpu_torch.train.cli export   --workdir OUT --output BUNDLE

Every subcommand has the JAX CLI's flags and defaults, and ``--device``
(default ``cuda``; without a card it raises, and ``--device cpu`` runs on
the CPU): the JAX CLI picks its platform through ``JAX_PLATFORMS``.  The
JAX CLI's XLA compilation cache has no counterpart (the port compiles
nothing through XLA; its kernels' build directory keeps what ``nvcc`` made).

``acoustic``, ``vocoder`` and ``e2e`` train data-parallel where the world
has more than one process, as JAX's train on every visible device:

    torchrun --nproc-per-node N -m e2e_tts_tpu_torch.train.cli acoustic --workdir OUT

Each process calls ``parallel.initialize()`` (torchrun's ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``, or JAX's
``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and ``PROCESS_ID``) and computes
on ``cuda:LOCAL_RANK`` (or the CPU under ``--device cpu``), builds
``make_data_mesh`` from the global batch (the vocoder's is
``train.batch_size // 2``), makes every global batch from the same seed and
keeps its rows (``parallel.shard_batch``), and runs the global step
(``parallel/data_parallel``).  Validation losses are the group's; logs,
checkpoints and bundles are written by rank 0 alone, and every rank
restores the checkpoint onto its own device.  Ranks that the data axis
leaves out (it shrinks to a divisor of the batch) wait at the end.  One
process is the one-card run, unchanged.  Checkpoints are the port's (``train/checkpoint.py``):
``acoustic_ckpt`` holds the ``AcousticTrainState``, ``vocoder_<kind>_ckpt``
the generator, MPD, MSD and the ``VocoderTrainState``, ``e2e_ckpt`` the
acoustic model, the generator, the discriminators and the ``E2EState``.
Bundles are the format both packages serve.

``main(argv, on_step=None)``: ``on_step(step, metrics)`` is called after
each train step of ``acoustic``, ``vocoder`` and ``e2e``, before the
step's logging, checkpoint and validation (for instrumentation).  In
``acoustic`` the logging (its ``float`` reads of the step's metrics wait
for the card) and the checkpoints with validation are ``train.log`` and
``train.checkpoint`` spans of ``utils/tracing``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..utils import tracing

LANGS = ["vie", "eng", "mya"]
_WAV_CACHE_MAX = 2048  # e2e: wavs kept in host memory before the cache is cleared


def _lang_symbols(lang: str):
    """(n_symbols, symbol_table) for a frontend language."""
    from ..text.frontends import get_frontend

    fe = get_frontend(lang)
    # the Vietnamese table is the dataset default; None keeps that path
    return len(fe.symbols), (None if lang == "vie" else fe.symbol_to_id)


def _device(args) -> torch.device:
    """``--device``: CUDA unless the caller names another; raises without a
    card, never falling back to the CPU."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return device


def _parallel(args, batch_size: int):
    """(device, data mesh, data group) of this process: ``initialize()`` from
    the environment, a mesh whose data axis divides ``batch_size``, its group.
    One process has neither mesh nor group (None, None): its mesh would be
    1 x 1."""
    from ..parallel import initialize, make_data_mesh
    from ..parallel.data_parallel import data_group
    from ..parallel.distributed import device

    if not initialize(device="cpu" if args.device == "cpu" else None):
        return _device(args), None, None
    mesh = make_data_mesh(batch_size)
    return device(), mesh, data_group(mesh)


def _outside(mesh, name: str) -> bool:
    """A rank that the data axis leaves out waits at the end, as JAX leaves
    its device idle."""
    from ..parallel.distributed import barrier, process_index

    if mesh is None or mesh.get_coordinate() is not None:
        return False
    print(f"[{name}] rank {process_index()} is outside the data axis "
          f"{tuple(mesh.shape)}: waiting", flush=True)
    barrier()
    return True


def _say(*a) -> None:
    """Print on rank 0 only."""
    from ..parallel import is_primary

    if is_primary():
        print(*a, flush=True)


class _NoLog:
    """The loggers' calls on ranks other than 0: nothing is written."""

    def __getattr__(self, name):
        return lambda *a, **k: None


def _logger(cls, logdir: str):
    from ..parallel import is_primary

    return cls(logdir) if is_primary() else _NoLog()


def _config(args):
    from ..config import default_config, load_config

    config = load_config(args.config) if args.config else default_config()
    return _apply_supervised(config) if getattr(args, "supervised", False) else config


def _apply_supervised(config):
    """MFA-duration mode: ``learn_alignment: false`` changes the duration
    predictor and drops the aligner, so every command that rebuilds the model
    from the config (acoustic, e2e, generate-mels, export) applies the same
    rewrite, or a checkpoint's tree does not match."""
    fs2 = config.models.fastspeech2
    dm = fs2.variance.duration_modelling.replace(learn_alignment=False)
    return config.replace(models=config.models.replace(fastspeech2=fs2.replace(
        variance=fs2.variance.replace(duration_modelling=dm))))


def _load_workdir(workdir: str):
    from ..data import read_filelist

    entries = read_filelist(os.path.join(workdir, "file_list.txt"))
    with open(os.path.join(workdir, "stats.json")) as f:
        stats = json.load(f)
    with open(os.path.join(workdir, "speakers.json")) as f:
        speakers = json.load(f)
    return entries, stats, speakers


def _acoustic_model(config, args, speakers, stats, device, dtype=torch.float32):
    """The acoustic model, in float32 unless ``dtype`` says otherwise: as in
    the JAX CLI, only ``acoustic`` reads ``train.mixed_precision``; ``e2e``,
    ``generate-mels`` and ``export`` build in float32 whatever it says."""
    from ..nn.variance import FeatureStats
    from .acoustic_step import build_acoustic_model

    n_symbols, _ = _lang_symbols(args.lang)
    return build_acoustic_model(config, n_symbols, len(speakers), FeatureStats.from_dict(stats),
                                device=device, seed=config.train.seed, dtype=dtype)


def _acoustic_dataset(config, args, entries, speakers, stats):
    from ..data import AcousticDataset

    return AcousticDataset(entries, speakers, stats, config,
                           supervised=getattr(args, "supervised", False),
                           prior_cache_dir=os.path.join(args.workdir, "priors"),
                           symbol_table=_lang_symbols(args.lang)[1])


def _load_bundle_vocoder(generator, bundle_dir: str) -> None:
    """A bundle's vocoder tree into a training generator (its (v, g) kept)."""
    from ..convert import load_into
    from ..serve.bundle import read_msgpack

    load_into(generator, read_msgpack(os.path.join(bundle_dir, "vocoder.msgpack")))


def cmd_prepare(args, on_step=None):
    from ..data import (build_speaker_map, compute_stats, create_supervised_filelist,
                        create_unsupervised_filelist, create_utterance_features, read_filelist)

    config = _config(args)
    device = _device(args)
    os.makedirs(args.workdir, exist_ok=True)
    filelist = os.path.join(args.workdir, "file_list.txt")
    if args.supervised:
        create_supervised_filelist(args.corpus, filelist)
    else:
        _, skipped = create_unsupervised_filelist(args.corpus, filelist, lang=args.lang)
        if skipped:
            print(f"[prepare] skipped {len(skipped)} OOV utterances", flush=True)

    entries = read_filelist(filelist)
    t0 = time.time()
    for i, (wav, *_rest) in enumerate(entries):
        create_utterance_features(wav, config, overwrite=args.overwrite, device=device)
        if (i + 1) % 100 == 0:
            print(f"[prepare] features {i + 1}/{len(entries)} ({time.time() - t0:.0f}s)",
                  flush=True)

    with open(os.path.join(args.workdir, "stats.json"), "w") as f:
        json.dump(compute_stats(entries), f, indent=1)
    speakers = build_speaker_map(entries)
    with open(os.path.join(args.workdir, "speakers.json"), "w") as f:
        json.dump(speakers, f, ensure_ascii=False, indent=1)
    print(f"[prepare] {len(entries)} utterances, {len(speakers)} speakers -> {args.workdir}",
          flush=True)


def cmd_acoustic(args, on_step: Optional[Callable] = None):
    from ..data import make_acoustic_batches, split_train_valid
    from ..utils.logging import AcousticLogger
    from ..utils.prefetch import prefetch_iterator
    from .acoustic_step import init_train_state, make_eval_step, make_train_step
    from .checkpoint import CheckpointManager, warm_start_params
    from .optim import acoustic_optimizer

    from ..parallel import shard_batch
    from ..parallel.distributed import barrier

    config = _config(args)
    device, mesh, group = _parallel(args, config.train.batch_size)
    if _outside(mesh, "acoustic"):
        return None
    grad_accum = max(int(config.train.grad_acc_step), 1)
    entries, stats, speakers = _load_workdir(args.workdir)
    train_entries, valid_entries = split_train_valid(entries, seed=config.train.seed)
    dataset = _acoustic_dataset(config, args, train_entries, speakers, stats)
    valid_dataset = _acoustic_dataset(config, args, valid_entries, speakers, stats)
    # bfloat16 compute over float32 parameters (gradients, moments and
    # checkpoints float32), as the JAX CLI trains with mixed_precision
    model = _acoustic_model(config, args, speakers, stats, device,
                            torch.bfloat16 if config.train.mixed_precision else torch.float32)
    optimizer = acoustic_optimizer(config.train.fastspeech2_optimizer,
                                   config.models.fastspeech2.encoder_hidden)
    n_words = max(config.models.fastspeech2.max_seq_len, 256)
    train_step = make_train_step(model, config, optimizer, n_words, group=group)
    eval_step = make_eval_step(model, config, n_words, group=group)
    state = init_train_state(model, optimizer, seed=config.train.seed, group=group)

    ckpt = CheckpointManager(os.path.join(args.workdir, "acoustic_ckpt"), group=group)
    if args.init_from and ckpt.latest_step() is None:
        warm_start_params(model, args.init_from)
        _say(f"[acoustic] warm-started from bundle {args.init_from}")
    if ckpt.latest_step() is not None:
        ckpt.restore(state)
        print(f"[acoustic] resumed from step {state.step}", flush=True)

    def rows(batches):
        """This rank's rows of each global batch (all of them in one process)."""
        return (shard_batch(b, mesh, grad_accum) for b in batches)

    def run_validation():
        """Eval losses averaged over the held-out split: dropout off, no
        gradient, no optimizer; the group's losses."""
        totals, n = {}, 0
        for vb in rows(make_acoustic_batches(valid_dataset, config.train.batch_size,
                                             shuffle=False, device=device)):
            for k, v in eval_step(state, vb).items():
                totals[k] = totals.get(k, 0.0) + float(v)
            n += 1
        return {f"valid_{k}": v / max(n, 1) for k, v in totals.items()}

    logger = _logger(AcousticLogger, os.path.join(args.workdir, "logs", "acoustic"))
    step, epoch, t0 = state.step, 0, time.time()
    while step < args.steps:
        for batch in prefetch_iterator(rows(
                make_acoustic_batches(dataset, config.train.batch_size,
                                      seed=config.train.seed + epoch, device=device)), size=2):
            state, metrics = train_step(state, batch)
            step = state.step
            if on_step is not None:
                on_step(step, metrics)
            if step % config.train.log_step == 0:
                with tracing.span("train.log"):
                    m = {k: float(v) for k, v in metrics.items()}
                    logger.log(step, m, lr=optimizer.schedule(step))
                    _say(f"[acoustic] step {step} total={m['total']:.4f} mel={m['mel']:.4f} "
                         f"({time.time() - t0:.0f}s)")
            if step % args.ckpt_every == 0:
                with tracing.span("train.checkpoint"):
                    ckpt.save(step, state)
                    logger.log_params(step, model)
                    if valid_entries:
                        vm = run_validation()
                        logger.log(step, vm)
                        _say(f"[acoustic] step {step} valid_total="
                             f"{vm.get('valid_total', float('nan')):.4f}")
            if step >= args.steps:
                break
        epoch += 1
    ckpt.save(step, state, wait=True)
    logger.close()
    _say(f"[acoustic] done at step {step}")
    barrier()
    return step


def _vocoder_modules(config, kind: str, device):
    """The training-form generator and MPD/MSD at the reference widths."""
    from ..models.vocoder import build_generator
    from ..nn.discriminators import build_discriminators

    return (build_generator(config, kind, train=True, device=device, seed=0),
            *build_discriminators(device, seed=0))


def cmd_vocoder(args, on_step: Optional[Callable] = None):
    from ..data import VocoderDataset, make_vocoder_batches, split_train_valid
    from ..utils.logging import ScalarWriter
    from ..utils.prefetch import prefetch_iterator
    from .checkpoint import CheckpointManager
    from .optim import gan_optimizer
    from .vocoder_step import init_vocoder_train_state, make_vocoder_train_step

    from ..parallel import shard_batch
    from ..parallel.distributed import barrier

    config = _config(args)
    batch_size = config.train.batch_size // 2
    device, mesh, group = _parallel(args, batch_size)
    if _outside(mesh, "vocoder"):
        return None
    entries, _, _ = _load_workdir(args.workdir)
    train_entries, _ = split_train_valid(entries, seed=config.train.seed)
    kind = "istft" if args.istft else "hifigan"
    gen, mpd, msd = _vocoder_modules(config, kind, device)
    g_opt = gan_optimizer(config.train.hifigan_optimizer)
    d_opt = gan_optimizer(config.train.hifigan_optimizer)
    step_fn = make_vocoder_train_step(gen, config, g_opt, d_opt, kind, mpd, msd, group=group)
    state = init_vocoder_train_state(gen, g_opt, d_opt, mpd, msd)
    tree = {"state": state, "generator": gen, "mpd": mpd, "msd": msd}

    ckpt = CheckpointManager(os.path.join(args.workdir, f"vocoder_{kind}_ckpt"), group=group)
    if args.init_from and ckpt.latest_step() is None:
        _load_bundle_vocoder(gen, args.init_from)
        _say(f"[vocoder] warm-started generator from {args.init_from}")
    if ckpt.latest_step() is not None:
        ckpt.restore(tree)
        print(f"[vocoder] resumed from step {state.step}", flush=True)

    dataset = VocoderDataset(train_entries, config,
                             segment_size=config.audio.signal.segment_length // 4,
                             mel_dir="predicted_mels" if args.predicted_mels else "mels")
    writer = _logger(ScalarWriter, os.path.join(args.workdir, "logs", f"vocoder_{kind}"))
    step, epoch, t0 = state.step, 0, time.time()
    while step < args.steps:
        step_at_epoch_start = step
        batches = make_vocoder_batches(dataset, batch_size, seed=epoch, device=device)
        for batch in prefetch_iterator((shard_batch(b, mesh) for b in batches), size=2):
            state, metrics = step_fn(state, batch)
            step = state.step
            if on_step is not None:
                on_step(step, metrics)
            if step % config.train.log_step == 0:
                for k, v in metrics.items():
                    writer.scalar(f"vocoder/{k}", float(v), step)
                _say(f"[vocoder] step {step} g={float(metrics['g_total']):.3f} "
                     f"d={float(metrics['d_total']):.3f} ({time.time() - t0:.0f}s)")
            if step % args.ckpt_every == 0:
                ckpt.save(step, tree)
            if step >= args.steps:
                break
        if step == step_at_epoch_start:
            # an epoch with no batches would spin this loop forever
            raise RuntimeError("vocoder training epoch produced no batches "
                               f"({len(dataset)} utterances, batch_size {batch_size})")
        epoch += 1
    ckpt.save(step, tree, wait=True)
    writer.close()
    _say(f"[vocoder] done at step {step}")
    barrier()
    return step


def cmd_e2e(args, on_step: Optional[Callable] = None):
    """Joint acoustic + vocoder GAN fine-tune (``train/e2e_step.py``)."""
    from ..audio.wav import read_wav
    from ..data import make_acoustic_batches, split_train_valid
    from ..utils.logging import E2ELogger
    from ..utils.prefetch import prefetch_iterator
    from .checkpoint import CheckpointManager, warm_start_params
    from .e2e_step import E2EBatch, init_e2e_state, make_e2e_train_step
    from .optim import e2e_optimizers

    from ..parallel import local_rows, shard_batch
    from ..parallel.distributed import barrier

    config = _config(args)
    device, mesh, group = _parallel(args, config.train.batch_size)
    if _outside(mesh, "e2e"):
        return None
    entries, stats, speakers = _load_workdir(args.workdir)
    train_entries, _ = split_train_valid(entries, seed=config.train.seed)
    dataset = _acoustic_dataset(config, args, train_entries, speakers, stats)
    model = _acoustic_model(config, args, speakers, stats, device)
    gen, mpd, msd = _vocoder_modules(config, "hifigan", device)
    # the acoustic (and discriminator) updates scaled for fine-tuning: the
    # Noam schedule restarts at step 0, so an unscaled fine-tune soon runs at
    # its peak rate over trained weights; --adv-warmup ramps the adversarial
    # weight in while the discriminators calibrate on the current voice
    am_opt, g_opt, d_opt = e2e_optimizers(config, am_scale=args.am_lr_scale,
                                          d_scale=args.d_lr_scale)
    n_words = max(config.models.fastspeech2.max_seq_len, 256)
    step_fn = make_e2e_train_step(model, gen, config, am_opt, g_opt, d_opt, n_words, mpd=mpd,
                                  msd=msd, adv_warmup_steps=args.adv_warmup, group=group)
    state = init_e2e_state(model, gen, am_opt, g_opt, d_opt, mpd, msd, seed=config.train.seed,
                           group=group)
    tree = {"state": state, "acoustic": model, "generator": gen, "mpd": mpd, "msd": msd}

    ckpt = CheckpointManager(os.path.join(args.workdir, "e2e_ckpt"), group=group)
    if ckpt.latest_step() is not None:
        ckpt.restore(tree)
        print(f"[e2e] resumed from step {state.step}", flush=True)
    elif args.init_from:
        warm_start_params(model, args.init_from)
        _load_bundle_vocoder(gen, args.init_from)
        _say(f"[e2e] warm-started from bundle {args.init_from}")
    else:
        # a joint fine-tune continues the separately trained stages: take the
        # workdir's acoustic and vocoder checkpoints where there are any
        # (their weights; the optimizers start afresh)
        ack = CheckpointManager(os.path.join(args.workdir, "acoustic_ckpt"))
        if ack.latest_step() is not None:
            seeded = ack.restore({"step": 0, "model": model})
            _say(f"[e2e] acoustic seeded from step {seeded['step']}")
        vck = CheckpointManager(os.path.join(args.workdir, "vocoder_hifigan_ckpt"))
        if vck.latest_step() is not None:
            seeded = vck.restore({"state": {"step": 0}, "generator": gen, "mpd": mpd, "msd": msd})
            _say(f"[e2e] vocoder seeded from step {seeded['state']['step']}")

    hop = config.audio.stft.hop_length
    wav_by_path = {}  # bounded: cleared past _WAV_CACHE_MAX entries

    def host_batches(ep):
        """Batches with their aligned audio, made in the prefetch thread so
        that they overlap the step."""
        for batch, paths in make_acoustic_batches(dataset, config.train.batch_size,
                                                  seed=config.train.seed + ep, with_paths=True,
                                                  device=device):
            T = batch.mel.shape[1]
            audio = np.zeros((batch.mel.shape[0], T * hop), np.float32)
            for row, p in enumerate(paths):
                if p not in wav_by_path:
                    if len(wav_by_path) >= _WAV_CACHE_MAX:
                        wav_by_path.clear()
                    wav_by_path[p], _ = read_wav(p)
                w = wav_by_path[p][: T * hop]
                audio[row, : len(w)] = w
            mine = local_rows(len(audio), mesh)
            yield E2EBatch(shard_batch(batch, mesh), torch.from_numpy(audio[mine]).to(device))

    logger = _logger(E2ELogger, os.path.join(args.workdir, "logs", "e2e"))
    step, epoch, t0 = state.step, 0, time.time()
    while step < args.steps:
        for eb in prefetch_iterator(host_batches(epoch)):
            state, metrics = step_fn(state, eb)
            step = state.step
            if on_step is not None:
                on_step(step, metrics)
            if step % config.train.log_step == 0:
                logger.log(step, {k: float(v) for k, v in metrics.items()})
                _say(f"[e2e] step {step} total={float(metrics['total']):.3f} "
                     f"d={float(metrics['discriminator']):.3f} ({time.time() - t0:.0f}s)")
            if step % args.ckpt_every == 0:
                ckpt.save(step, tree)
            if step >= args.steps:
                break
        epoch += 1
    ckpt.save(step, tree, wait=True)
    logger.close()
    _say(f"[e2e] done at step {step}")
    barrier()
    return step


def cmd_generate_mels(args, on_step=None):
    """Acoustic inference with the corpus's own durations (the aligner's, or
    the given ones with ``--supervised``) -> ``predicted_mels/*.npy`` beside
    each corpus's ``wavs/``, (n_mels, T) as the reference lays them out, for
    the vocoder's fine-tune (``vocoder --predicted-mels``)."""
    from ..data import make_acoustic_batches
    from .acoustic_step import forward_inputs
    from .checkpoint import CheckpointManager

    config = _config(args)
    device = _device(args)
    entries, stats, speakers = _load_workdir(args.workdir)
    dataset = _acoustic_dataset(config, args, entries, speakers, stats)
    model = _acoustic_model(config, args, speakers, stats, device)
    ckpt = CheckpointManager(os.path.join(args.workdir, "acoustic_ckpt"))
    if ckpt.latest_step() is None:
        raise SystemExit(f"[generate-mels] no acoustic checkpoint in {args.workdir}/acoustic_ckpt")
    ckpt.restore({"model": model})

    # the teacher-forced training graph at the checkpoint's weights, as JAX
    # runs it: dropout on from a fixed seed, BatchNorm on each batch's statistics
    model.train()
    count = 0
    for batch, paths in make_acoustic_batches(dataset, config.train.batch_size, shuffle=False,
                                              with_paths=True, device=device):
        with torch.no_grad():
            out = model(batch.speakers, batch.texts, batch.txt_lens, batch.mel, batch.mel_lens,
                        step=10 ** 9, rng=torch.Generator(device=device).manual_seed(0),
                        **forward_inputs(config, batch))
        mels, lens = out["postnet_mel"].cpu().numpy(), out["mel_lens"].cpu().numpy()
        for row, wav in enumerate(paths):
            base = os.path.splitext(os.path.basename(wav))[0]
            outdir = os.path.join(os.path.dirname(os.path.dirname(wav)), "predicted_mels")
            os.makedirs(outdir, exist_ok=True)
            np.save(os.path.join(outdir, f"{base}.npy"), mels[row, : lens[row]].T)
            count += 1
    print(f"[generate-mels] wrote {count} predicted mels", flush=True)
    return count


def cmd_export(args, on_step=None):
    """Write the serving bundle from the trained checkpoints."""
    from ..nn.variance import FeatureStats
    from ..serve.bundle import save_bundle
    from .checkpoint import CheckpointManager

    config = _config(args)
    device = _device(args)
    _, stats, speakers = _load_workdir(args.workdir)
    model = _acoustic_model(config, args, speakers, stats, device)
    a_ckpt = CheckpointManager(os.path.join(args.workdir, "acoustic_ckpt"))
    if a_ckpt.latest_step() is None:
        raise SystemExit(f"[export] no acoustic checkpoint in {args.workdir}/acoustic_ckpt"
                         " — exporting would write RANDOM weights")
    kind = "istft" if args.istft else "hifigan"
    v_dir = os.path.join(args.workdir, f"vocoder_{kind}_ckpt")
    v_ckpt = CheckpointManager(v_dir)
    if v_ckpt.latest_step() is None:
        raise SystemExit(f"[export] no vocoder checkpoint in {v_dir}"
                         " — exporting would write RANDOM weights")
    a_ckpt.restore({"model": model})
    gen, _, _ = _vocoder_modules(config, kind, device)
    v_ckpt.restore({"generator": gen})

    # a joint e2e fine-tune supersedes the per-stage checkpoints (HiFi-GAN
    # only: the e2e loop trains that kind); --no-e2e exports the stages
    e2e_dir = os.path.join(args.workdir, "e2e_ckpt")
    if kind == "hifigan" and not args.no_e2e and os.path.isdir(e2e_dir):
        e_ckpt = CheckpointManager(e2e_dir)
        if e_ckpt.latest_step() is not None:
            e = e_ckpt.restore({"state": {"step": 0}, "acoustic": model, "generator": gen})
            print(f"[export] using e2e fine-tune step {e['state']['step']} "
                  "(pass --no-e2e for the per-stage checkpoints)", flush=True)

    save_bundle(args.output, config, model, gen, speakers, FeatureStats.from_dict(stats), kind,
                language=args.lang)
    print(f"[export] bundle -> {args.output}", flush=True)


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's subcommands, flags and defaults, and ``--device``."""
    p = argparse.ArgumentParser(prog="python -m e2e_tts_tpu_torch.train.cli")
    sub = p.add_subparsers(dest="cmd", required=True)

    def command(name, fn):
        sp = sub.add_parser(name)
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs on the CPU)")
        sp.set_defaults(fn=fn)
        return sp

    pp = command("prepare", cmd_prepare)
    pp.add_argument("--corpus", nargs="+", required=True)
    pp.add_argument("--workdir", required=True)
    pp.add_argument("--config")
    pp.add_argument("--lang", default="vie", choices=LANGS)
    pp.add_argument("--supervised", action="store_true")
    pp.add_argument("--overwrite", action="store_true")

    pa = command("acoustic", cmd_acoustic)
    pa.add_argument("--workdir", required=True)
    pa.add_argument("--config")
    pa.add_argument("--lang", default="vie", choices=LANGS)
    pa.add_argument("--steps", type=int, default=600000)
    pa.add_argument("--ckpt-every", type=int, default=5000)
    pa.add_argument("--supervised", action="store_true")
    pa.add_argument("--init-from", dest="init_from",
                    help="warm-start from a deploy bundle (fine-tune on a new voice)")

    pv = command("vocoder", cmd_vocoder)
    pv.add_argument("--workdir", required=True)
    pv.add_argument("--config")
    pv.add_argument("--steps", type=int, default=400000)
    pv.add_argument("--ckpt-every", type=int, default=5000)
    pv.add_argument("--istft", action="store_true")
    pv.add_argument("--init-from", dest="init_from",
                    help="warm-start the generator from a deploy bundle")
    pv.add_argument("--predicted-mels", action="store_true")

    pj = command("e2e", cmd_e2e)
    pj.add_argument("--workdir", required=True)
    pj.add_argument("--config")
    pj.add_argument("--supervised", action="store_true")
    pj.add_argument("--lang", default="vie", choices=LANGS)
    pj.add_argument("--steps", type=int, default=100000)
    pj.add_argument("--ckpt-every", type=int, default=5000)
    pj.add_argument("--init-from", dest="init_from",
                    help="warm-start acoustic+vocoder from a deploy bundle")
    pj.add_argument("--adv-warmup", dest="adv_warmup", type=int, default=0,
                    help="ramp adversarial+fm weight 0->1 over N steps")
    pj.add_argument("--am-lr-scale", dest="am_lr_scale", type=float, default=1.0,
                    help="scale on the acoustic Noam LR for fine-tuning")
    pj.add_argument("--d-lr-scale", dest="d_lr_scale", type=float, default=1.0,
                    help="scale on the discriminator LR")

    pg = command("generate-mels", cmd_generate_mels)
    pg.add_argument("--workdir", required=True)
    pg.add_argument("--config")
    pg.add_argument("--supervised", action="store_true")
    pg.add_argument("--lang", default="vie", choices=LANGS)

    pe = command("export", cmd_export)
    pe.add_argument("--workdir", required=True)
    pe.add_argument("--output", required=True)
    pe.add_argument("--config")
    pe.add_argument("--supervised", action="store_true")
    pe.add_argument("--lang", default="vie", choices=LANGS)
    pe.add_argument("--istft", action="store_true")
    pe.add_argument("--no-e2e", action="store_true",
                    help="ignore an e2e fine-tune checkpoint; export the raw stages")
    return p


def main(argv=None, on_step: Optional[Callable] = None):
    """Parse ``argv`` (the command line when None) and run the subcommand;
    returns what it returns (the last step of a training command)."""
    args = build_parser().parse_args(argv)
    return args.fn(args, on_step)


if __name__ == "__main__":
    main()
