"""Joint acoustic + vocoder (GAN) fine-tune step (port of
``e2e_tts_tpu/train/e2e_step.py``), eager PyTorch on one device, or
data-parallel over a process group.

acoustic forward (training mode, its aligner: MAS and the forward-sum CTC
through their kernels on CUDA; or, with ``learn_alignment: false``, the
batch's durations and no aligner) -> predicted mel -> a random aligned segment
of ``segment_frames`` frames -> HiFi-GAN -> waveform.  The acoustic model and
the generator are updated together, the gradient of the GAN terms flowing
through the vocoder into the acoustic model, against the discriminators as
they were; then the discriminators are updated on the (real, fake) pair from
before the generator's update: the reverse of the vocoder step's order.

``group`` (the data group, ``parallel/data_parallel``; None is one process,
and the step is then today's exactly) makes it the global step over the
ranks' rows, as the acoustic and vocoder steps do: losses as shares,
gradients summed before Adam, the acoustic model's BatchNorms on the global
batch, global metrics.  The crop starts are one draw for the whole batch:
``init_e2e_state(..., group=)`` gives the state a crop generator with the
same seed on every rank (``crop_rng``), drawn at the global batch's size and
cut to the rank's rows, beside the dropout generator of seed plus rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..audio.mel import MelParams
from ..models.acoustic_loss import fastspeech2_loss
from ..nn.discriminators import build_discriminators
from ..parallel.data_parallel import (global_rows, group_size, rank_seed, reduce_metrics,
                                      set_batchnorm_group, share)
from .acoustic_step import AcousticBatch, forward_inputs
from .optim import AdamState, ScheduledAdam
from .vocoder_step import (MEL_LOSS_WEIGHT, _grads, discriminator_params,
                           gan_discriminator_losses, gan_generator_losses)


class E2EBatch(NamedTuple):
    acoustic: AcousticBatch
    audio: torch.Tensor  # (B, T_mel * hop), aligned with the ground-truth mel

    @classmethod
    def from_numpy(cls, acoustic_arrays, audio, device) -> "E2EBatch":
        return cls(AcousticBatch.from_numpy(acoustic_arrays, device),
                   torch.as_tensor(audio).float().to(device))


@dataclass
class E2EState:
    step: int
    am_opt_state: AdamState
    g_opt_state: AdamState
    d_opt_state: AdamState
    rng: torch.Generator  # dropout (and the crop starts in one process), on the model's device
    crop_rng: Optional[torch.Generator] = None  # the crop starts of a data group


def init_e2e_state(model, generator, am_optimizer: ScheduledAdam, g_optimizer: ScheduledAdam,
                   d_optimizer: ScheduledAdam, mpd, msd, seed: int = 0, group=None) -> E2EState:
    """Step 0, fresh moments, and a generator for dropout and the crop on the
    model's device; in a data ``group`` the dropout generator's seed is
    ``seed`` plus the rank, and the crop has its own of ``seed``."""
    device = next(model.parameters()).device
    return E2EState(0, am_optimizer.init(list(model.parameters())),
                    g_optimizer.init(list(generator.parameters())),
                    d_optimizer.init(discriminator_params(mpd, msd)),
                    torch.Generator(device=device).manual_seed(rank_seed(seed, group)),
                    None if group is None else torch.Generator(device=device).manual_seed(seed))


def crop_starts(mel_lens: torch.Tensor, segment_frames: int, rng: torch.Generator, group=None):
    """floor(u * (max(mel_len - segment_frames, 0) + 1)), u uniform in [0, 1);
    in a data ``group`` the u of the global batch are drawn and this rank's
    rows kept."""
    B = mel_lens.shape[0]
    u = torch.rand((B * group_size(group),), generator=rng, device=mel_lens.device)
    u = u[global_rows(B, group)]
    max_start = torch.clamp(mel_lens - segment_frames, min=0)
    return (u * (max_start + 1).float()).long()


def crop(mel, audio, starts, segment_frames: int, hop: int):
    """Aligned (B, segment_frames, n_mels) and (B, segment_frames * hop)
    segments at ``starts``, each start clamped into its array as JAX's
    ``dynamic_slice`` clamps it."""
    s = torch.clamp(starts, 0, mel.shape[1] - segment_frames)
    idx = s[:, None] + torch.arange(segment_frames, device=mel.device)
    mel_seg = torch.gather(mel, 1, idx[..., None].expand(-1, -1, mel.shape[2]))
    n = segment_frames * hop
    a = torch.clamp(starts * hop, 0, audio.shape[1] - n)
    audio_seg = torch.gather(audio, 1, a[:, None] + torch.arange(n, device=audio.device))
    return mel_seg, audio_seg


def make_e2e_train_step(model, generator, config, am_optimizer: ScheduledAdam,
                        g_optimizer: ScheduledAdam, d_optimizer: ScheduledAdam, n_words: int,
                        segment_frames: int = 32, mpd=None, msd=None,
                        adv_warmup_steps: int = 0, group=None):
    """Returns ``train_step(state, batch, starts=None) -> (state, metrics)``;
    the modules and the state are updated in place.  ``starts`` (B,) are the
    crop's first frames, drawn from the state's generator when None.
    ``adv_warmup_steps`` ramps the adversarial and feature-matching weight
    as clip(step / adv_warmup_steps, 0, 1).  ``mpd`` / ``msd`` default to the
    reference widths on the model's device; the step keeps them as
    ``train_step.mpd`` and ``train_step.msd``.  Metrics: ``total, generator,
    fm, mel, variance, duration, pitch, energy, postnet, ctc, bin,
    discriminator, mpd, msd``.  ``group``: the data group (module docstring);
    ``starts`` are then this rank's rows of the global batch's."""
    if mpd is None or msd is None:
        mpd, msd = build_discriminators(next(model.parameters()).device)
    mel_params = MelParams.from_config(config.audio, loss=True)
    hop = config.audio.stft.hop_length
    use_uv = config.models.fastspeech2.variance.variance_embedding.use_uv
    learn_alignment = config.models.fastspeech2.variance.duration_modelling.learn_alignment
    loss_cfg = config.train.fastspeech2_loss
    am_params = list(model.parameters())
    g_params = list(generator.parameters())
    d_params = discriminator_params(mpd, msd)
    if group is not None:
        set_batchnorm_group(model, group)

    def train_step(state: E2EState, batch: E2EBatch, starts: Optional[torch.Tensor] = None):
        a = batch.acoustic
        model.train()
        out = model(a.speakers, a.texts, a.txt_lens, a.mel, a.mel_lens, step=state.step,
                    rng=state.rng, **forward_inputs(config, a))
        var = fastspeech2_loss(out, a.mel, a.txt_lens, a.mel_lens, a.word_ids, n_words,
                               state.step, loss_cfg, use_uv=use_uv,
                               learn_alignment=learn_alignment, group=group)
        if starts is None:
            starts = crop_starts(a.mel_lens, segment_frames,
                                 state.rng if group is None else state.crop_rng, group)
        mel_seg, audio_seg = crop(out["postnet_mel"], batch.audio, starts, segment_frames, hop)
        y_hat = generator(mel_seg)
        n = min(y_hat.shape[-1], audio_seg.shape[-1])
        y, y_hat = audio_seg[..., :n], y_hat[..., :n]

        # the acoustic model and the generator, against the discriminators as they are
        g_adv, g_fm, g_mel = (share(v, group)
                              for v in gan_generator_losses(mpd, msd, y, y_hat, mel_params))
        adv_w = min(max(state.step / adv_warmup_steps, 0.0), 1.0) if adv_warmup_steps > 0 else 1.0
        total = adv_w * (g_adv + g_fm) + MEL_LOSS_WEIGHT * g_mel + var["total"]
        grads = _grads(total, am_params + g_params, group)
        am_optimizer.apply(am_params, grads[:len(am_params)], state.am_opt_state)
        g_optimizer.apply(g_params, grads[len(am_params):], state.g_opt_state)

        # the discriminators, on the pair from before the generator's update
        d_mpd, d_msd = (share(v, group)
                        for v in gan_discriminator_losses(mpd, msd, y, y_hat.detach()))
        d_total = d_mpd + d_msd
        d_optimizer.apply(d_params, _grads(d_total, d_params, group), state.d_opt_state)

        state.step += 1
        zero = torch.zeros((), device=total.device)
        metrics = dict(total=total, generator=g_adv, fm=g_fm, mel=g_mel, variance=var["total"],
                       duration=var["pdur"], pitch=var.get("f0", var.get("pitch")),
                       energy=var["energy"], postnet=var["postnet"], ctc=var.get("ctc", zero),
                       bin=var.get("bin", zero), discriminator=d_total, mpd=d_mpd, msd=d_msd)
        return state, reduce_metrics({k: v.detach() for k, v in metrics.items()}, group)

    train_step.mpd, train_step.msd = mpd, msd
    return train_step
