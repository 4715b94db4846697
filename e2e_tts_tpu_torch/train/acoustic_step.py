"""Acoustic-model train and eval steps (port of
``e2e_tts_tpu/train/acoustic_step.py``), eager PyTorch on one device, or
data-parallel over a process group.

``build_acoustic_model(config, n_symbols, n_speakers)`` makes the model as
the JAX package trains it, on CUDA unless the caller passes a device;
``make_train_step(model, config, optimizer, n_words)`` returns
``train_step(state, batch) -> (state, metrics)``: forward in training mode
(dropout from the state's generator, BatchNorm on batch statistics), the
FastSpeech2 losses, backward (MAS and the forward-sum CTC through their
kernels on CUDA), one ``ScheduledAdam`` update.  With ``grad_acc_step`` N > 1 the
batch splits into N microbatches whose gradients are summed and scaled by
1/N before the one update, as the JAX step does.  ``make_eval_step`` is the
deterministic pass: eval mode, no gradient.

The state holds what JAX threads through its step: the step count, the model
(parameters and BatchNorm statistics, updated in place), the optimizer state
and the dropout generator (a ``torch.Generator`` on the model's device, in
place of JAX's rng key).  Metrics are device scalars (no host sync).

Data parallelism: ``make_train_step(..., group=)`` takes the data group
(``parallel/data_parallel.data_group``; None is one process, and the step is
then today's exactly).  Each rank passes its rows of the global batch
(``parallel/sharding.shard_batch``); its losses are its shares of the global
batch's, the gradients are summed over the group before clipping and Adam,
the model's BatchNorms take the global batch's statistics, and the metrics
are the global ones, so every rank holds the parameters of JAX's sharded
step.  The step's phases are spans of ``utils/tracing``: ``step.forward``
(the model and its losses), ``step.backward``, ``step.reduce`` (with a data
or model group) and ``step.optimizer``.  ``init_train_state(..., group=)`` seeds each rank's dropout
generator with the seed plus its rank in the data group.

Tensor parallelism: a model split by ``parallel/tensor_parallel.parallelize``
over the mesh's model axis trains with ``make_train_step(...,
model_group=)`` (``parallel.mesh.model_group``): each rank holds its shards
of the split weights (Adam's moments take their local shapes: build the
state after ``parallelize``), the gradients are made whole over the model
group before the data group's sum, and the clip takes the whole model's
norm.  The aligner, MAS and the CTC are replicated: every model rank runs
them on the same tensors.

Mixed precision is the model's compute dtype, as in JAX: a model built in
``torch.bfloat16`` (``build_acoustic_model(..., dtype=)``) casts its float32
parameters per call under autograd (``nn/common.cast_param``), so the
gradients, the Adam moments and the updates stay float32.  The aligner's
attention reaches MAS and the CTC in float32 (its log prior promotes it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import torch

from ..models.acoustic import FastSpeech2
from ..models.acoustic_loss import fastspeech2_loss
from ..nn.variance import FeatureStats
from ..parallel.data_parallel import (rank_seed, reduce_gradients, reduce_metrics,
                                      set_batchnorm_group)
from ..parallel.tensor_parallel import reduce_model_gradients
from ..utils import tracing
from .optim import AdamState, ScheduledAdam


class AcousticBatch(NamedTuple):
    """One padded training batch, laid out as the JAX package's ``_collate``."""

    speakers: torch.Tensor         # (B,)
    texts: torch.Tensor            # (B, L)
    txt_lens: torch.Tensor         # (B,)
    word_ids: torch.Tensor         # (B, L)
    mel: torch.Tensor              # (B, T, n_mels)
    mel_lens: torch.Tensor         # (B,)
    attn_prior: torch.Tensor       # (B, T, L)
    duration_target: torch.Tensor  # (B, L): MFA durations; zeros where the aligner gives them
    f0: torch.Tensor               # (B, T)
    uv: torch.Tensor               # (B, T)
    pitch: torch.Tensor            # (B, T)
    energy: torch.Tensor           # (B, T)

    @classmethod
    def from_numpy(cls, arrays, device) -> "AcousticBatch":
        """From numpy arrays (an ``AcousticBatch`` of them, or any sequence of
        the 12 in order): integers as int64, the rest float32, on ``device``
        (a ``data.copy`` span: from pageable memory the copy waits behind the
        work queued on the card)."""
        def move(a):
            t = torch.as_tensor(a)
            t = t.long() if not t.is_floating_point() else t.float()
            return t.to(device)

        with tracing.span("data.copy", tracing.DEVICE_WAIT):
            return cls(*(move(a) for a in arrays))


def build_acoustic_model(config, n_symbols: int, n_speakers: int,
                         stats: Optional[FeatureStats] = None, *, dropout: bool = True,
                         device=None, seed: int = 0, dtype=torch.float32) -> FastSpeech2:
    """The FastSpeech2 of ``config`` (a full ``Config``) as the JAX package
    trains it: attention through plain matmul/softmax (``use_flash=False``),
    weights from ``torch.Generator().manual_seed(seed)``, on ``device`` (CUDA
    when None, which raises without a card), computing in ``dtype``
    (``torch.bfloat16`` for ``train.mixed_precision``, as the JAX CLI builds
    it; the parameters stay float32 either way).  ``dropout=False`` zeroes
    every dropout rate (the active block family's, the predictors', the
    postnet's hard-coded 0.5)."""
    fs2 = config.models.fastspeech2
    if not dropout:
        bb = fs2.building_block
        blk = bb.active().replace(encoder_dropout=0.0, decoder_dropout=0.0)
        fs2 = fs2.replace(
            building_block=bb.replace(**{bb.block_type: blk}),
            variance=fs2.variance.replace(
                variance_predictor=fs2.variance.variance_predictor.replace(dropout=0.0)))
    model = FastSpeech2(fs2, n_symbols, n_speakers, config.audio.mel.channels,
                        stats if stats is not None else FeatureStats(), use_flash=False,
                        device=device, generator=torch.Generator().manual_seed(seed),
                        dtype=dtype)
    if not dropout:
        model.postnet.dropout = 0.0
    return model


@dataclass
class AcousticTrainState:
    step: int
    model: FastSpeech2
    opt_state: AdamState
    rng: torch.Generator


def init_train_state(model: FastSpeech2, optimizer: ScheduledAdam, seed: int = 0,
                     group=None) -> AcousticTrainState:
    """Step 0, fresh moments, and a dropout generator on the model's device
    (seeded with ``seed`` plus the rank in ``group``)."""
    device = next(model.parameters()).device
    rng = torch.Generator(device=device).manual_seed(rank_seed(seed, group))
    return AcousticTrainState(0, model, optimizer.init(list(model.parameters())), rng)


def forward_inputs(config, batch: AcousticBatch) -> dict:
    """The keyword inputs of ``FastSpeech2.forward`` from a batch as the JAX
    steps choose them: pitch as {f0, uv} or the pitch contour (``use_uv``),
    and the aligner's prior or, without the aligner (``learn_alignment:
    false``), the batch's durations."""
    v = config.models.fastspeech2.variance
    kw = dict(pitch_target={"f0": batch.f0, "uv": batch.uv} if v.variance_embedding.use_uv
              else batch.pitch, energy_target=batch.energy, attn_prior=None)
    if v.duration_modelling.learn_alignment:
        kw["attn_prior"] = batch.attn_prior
    else:
        kw["duration_target"] = batch.duration_target
    return kw


def _losses(model, config, batch: AcousticBatch, step: int, n_words: int, rng=None,
            group=None):
    v = config.models.fastspeech2.variance
    learn_alignment = v.duration_modelling.learn_alignment
    out = model(batch.speakers, batch.texts, batch.txt_lens, batch.mel, batch.mel_lens,
                step=step, rng=rng, **forward_inputs(config, batch))
    return fastspeech2_loss(out, batch.mel, batch.txt_lens, batch.mel_lens, batch.word_ids,
                            n_words, step, config.train.fastspeech2_loss,
                            use_uv=v.variance_embedding.use_uv, learn_alignment=learn_alignment,
                            duration_target=None if learn_alignment else batch.duration_target,
                            group=group)


def make_train_step(model: FastSpeech2, config, optimizer: ScheduledAdam, n_words: int,
                    group=None, model_group=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state is
    updated in place and returned.  Metrics: every loss term, ``total`` and
    ``grad_norm`` (before clipping).  ``group``: the data group (module
    docstring); with ``grad_acc_step`` N each rank's rows hold its shard of
    each of the N microbatches in turn (``shard_batch(..., grad_accum=N)``).
    ``model_group``: the model group of a parallelized model."""
    grad_accum = max(int(config.train.grad_acc_step), 1)
    params = list(model.parameters())
    if group is not None:
        set_batchnorm_group(model, group)
    grouped = group is not None or model_group is not None

    def train_step(state: AcousticTrainState, batch: AcousticBatch):
        model.train()
        for p in params:
            p.grad = None
        B = batch.speakers.shape[0]
        if B % grad_accum:
            raise ValueError(f"batch size {B} not divisible by grad_acc_step {grad_accum}")
        micro = B // grad_accum
        sums: Dict[str, torch.Tensor] = {}
        for i in range(grad_accum):
            mb = AcousticBatch(*(t[i * micro:(i + 1) * micro] for t in batch))
            with tracing.span("step.forward"):
                losses = _losses(model, config, mb, state.step, n_words, state.rng, group)
            with tracing.span("step.backward"):
                losses["total"].backward()  # gradients add up in p.grad
            for k, v in losses.items():
                v = v.detach()
                sums[k] = v if k not in sums else sums[k] + v
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if grad_accum > 1:
            grads = [g * (1.0 / grad_accum) for g in grads]
            sums = {k: v * (1.0 / grad_accum) for k, v in sums.items()}
        with tracing.span("step.reduce") if grouped else tracing.NOOP:
            grads = reduce_gradients(reduce_model_gradients(params, grads, model_group), group)
            sums = reduce_metrics(sums, group)
        with tracing.span("step.optimizer"):
            sums["grad_norm"] = optimizer.apply(params, grads, state.opt_state, model_group)
        for p in params:
            p.grad = None
        state.step += 1
        return state, sums

    return train_step


def make_eval_step(model: FastSpeech2, config, n_words: int, group=None):
    """Returns ``eval_step(state, batch) -> metrics``: eval mode (no dropout,
    BatchNorm on its running statistics), no gradient, no optimizer; with a
    data ``group``, each rank passes its rows and gets the global batch's
    losses."""

    @torch.no_grad()
    def eval_step(state: AcousticTrainState, batch: AcousticBatch):
        was_training = model.training
        model.eval()
        try:
            return reduce_metrics(_losses(model, config, batch, state.step, n_words,
                                          group=group), group)
        finally:
            model.train(was_training)

    return eval_step
