"""HiFi-GAN adversarial train step (port of
``e2e_tts_tpu/train/vocoder_step.py``), eager PyTorch on one device, or
data-parallel over a process group.

``make_vocoder_train_step(generator, config, g_opt, d_opt, vocoder_kind)``
returns ``train_step(state, batch) -> (state, metrics)``: the discriminators
(MPD and MSD) are updated first against the current generator, then the
generator against the updated discriminators, as the JAX step orders them.
The generator (a training form: ``build_generator(config, kind, train=True)``)
runs once: the generator has no dropout and its parameters do not change
between its two uses, so the discriminator step reads its output detached.
Each update takes its gradients by ``torch.autograd.grad`` over its own
parameters only, so neither loss leaves gradients in the other's.  The mel
loss is the log-mel L1 on the device, at ``MelParams.from_config(audio,
loss=True)``, weighted by 45.

The modules hold the parameters; the state holds the update count and the
two optimizers' moments.  Metrics are device scalars (no host sync).

``group`` (the data group, ``parallel/data_parallel``; None is one process)
makes the step the global one over the ranks' rows: every loss is a mean
over rows, so each rank's loss is its share (the mean over its rows over the
group's size), the gradients of both updates are summed over the group
before Adam, and the metrics are the global ones.

``model_group`` (tensor parallelism, ``parallel/tensor_parallel``) trains a
generator split by ``parallelize`` (``conv_pre`` and the upsampling
convolutions on their output channels); MPD and MSD stay replicated, as JAX
applies its rules to the generator's parameters only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..audio.mel import MelParams, mel_spectrogram
from ..models.vocoder import istft_to_audio
from ..nn.discriminators import (build_discriminators, discriminator_loss, feature_loss,
                                 generator_adv_loss)
from ..parallel.data_parallel import reduce_gradients, reduce_metrics, share
from ..parallel.tensor_parallel import reduce_model_gradients
from .optim import AdamState, ScheduledAdam

MEL_LOSS_WEIGHT = 45.0  # HiFi-GAN's lambda_mel


class VocoderBatch(NamedTuple):
    mel: torch.Tensor    # (B, T, n_mels)
    audio: torch.Tensor  # (B, T * hop), aligned with the mel

    @classmethod
    def from_numpy(cls, arrays, device) -> "VocoderBatch":
        return cls(*(torch.as_tensor(a).float().to(device) for a in arrays))


@dataclass
class VocoderTrainState:
    step: int
    g_opt_state: AdamState
    d_opt_state: AdamState


def discriminator_params(mpd, msd):
    """MPD's parameters, then MSD's: one tree for one optimizer."""
    return list(mpd.parameters()) + list(msd.parameters())


def init_vocoder_train_state(generator, g_optimizer: ScheduledAdam, d_optimizer: ScheduledAdam,
                             mpd, msd) -> VocoderTrainState:
    """Step 0 and fresh moments for the generator and the discriminators."""
    return VocoderTrainState(0, g_optimizer.init(list(generator.parameters())),
                             d_optimizer.init(discriminator_params(mpd, msd)))


def gan_generator_losses(mpd, msd, y, y_hat, mel_params: MelParams):
    """The generator's GAN terms against (mpd, msd): (adversarial, feature
    matching, mel L1).  The real audio's logits and feature maps carry no
    gradient."""
    loss_mel = torch.mean(torch.abs(mel_spectrogram(y_hat, mel_params)
                                    - mel_spectrogram(y, mel_params)))
    loss_fm = loss_adv = 0.0
    for d in (mpd, msd):
        with torch.no_grad():
            _, real_fmaps = d.discriminate(y)
        fake_logits, fake_fmaps = d.discriminate(y_hat)
        loss_fm = loss_fm + feature_loss(real_fmaps, fake_fmaps)
        loss_adv = loss_adv + generator_adv_loss(fake_logits)
    return loss_adv, loss_fm, loss_mel


def gan_discriminator_losses(mpd, msd, y, y_hat):
    """The discriminators' LS-GAN losses on real ``y`` and fake ``y_hat``:
    (MPD's, MSD's)."""
    losses = []
    for d in (mpd, msd):
        real, fake, _, _ = d(y, y_hat)
        losses.append(discriminator_loss(real, fake))
    return losses[0], losses[1]


def _grads(loss, params, group=None, model_group=None):
    """d loss / d params, zeros where a parameter does not reach the loss,
    made whole over ``model_group`` and summed over ``group``."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    return reduce_gradients(reduce_model_gradients(params, grads, model_group), group)


def make_vocoder_train_step(generator, config, g_optimizer: ScheduledAdam,
                            d_optimizer: ScheduledAdam, vocoder_kind: str = "hifigan",
                            mpd=None, msd=None, group=None, model_group=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the modules
    and the state are updated in place.  ``mpd`` / ``msd`` default to the
    reference widths on the generator's device (``build_discriminators``);
    the step keeps them as ``train_step.mpd`` and ``train_step.msd``.
    Metrics: ``d_total, d_mpd, d_msd, g_total, g_adv, g_fm, g_mel``.
    ``group``: the data group, ``model_group`` the model group (module
    docstring)."""
    if vocoder_kind not in ("hifigan", "istft"):
        raise ValueError(f"unknown vocoder kind {vocoder_kind!r}")
    if mpd is None or msd is None:
        mpd, msd = build_discriminators(next(generator.parameters()).device)
    mel_params = MelParams.from_config(config.audio, loss=True)
    g_params = list(generator.parameters())
    d_params = discriminator_params(mpd, msd)

    def generate(mel):
        if vocoder_kind == "hifigan":
            return generator(mel)
        spec, phase = generator(mel)
        return istft_to_audio(spec, phase, config.models.istft)

    def train_step(state: VocoderTrainState, batch: VocoderBatch):
        y_hat = generate(batch.mel)
        n = min(y_hat.shape[-1], batch.audio.shape[-1])
        y, y_hat = batch.audio[..., :n], y_hat[..., :n]

        # the discriminators, against the current generator
        d_mpd, d_msd = (share(v, group)
                        for v in gan_discriminator_losses(mpd, msd, y, y_hat.detach()))
        d_total = d_mpd + d_msd
        d_optimizer.apply(d_params, _grads(d_total, d_params, group, model_group),
                          state.d_opt_state)

        # the generator, against the updated discriminators
        g_adv, g_fm, g_mel = (share(v, group)
                              for v in gan_generator_losses(mpd, msd, y, y_hat, mel_params))
        g_total = g_adv + g_fm + MEL_LOSS_WEIGHT * g_mel
        g_optimizer.apply(g_params, _grads(g_total, g_params, group, model_group),
                          state.g_opt_state, model_group)

        state.step += 1
        metrics = dict(d_total=d_total, d_mpd=d_mpd, d_msd=d_msd, g_total=g_total,
                       g_adv=g_adv, g_fm=g_fm, g_mel=g_mel)
        return state, reduce_metrics({k: v.detach() for k, v in metrics.items()}, group)

    train_step.mpd, train_step.msd = mpd, msd
    return train_step
