"""FastSpeech2 training losses (port of ``e2e_tts_tpu/models/acoustic_loss.py``).

- mel and postnet masked L1;
- duration MSE at phoneme, word and sentence level (word sums by a one-hot
  product);
- alignment (with the aligner only): forward-sum CTC (``ops/ctc.py``, the
  CTC kernels) and the soft/hard "bin" term, ramped in from
  ``binarization_loss_enable_steps`` over ``binarization_loss_warmup_steps``;
  supervised training (``learn_alignment=False``) has neither, and its
  duration loss reads the given durations;
- pitch: f0 MSE over voiced phonemes + uv BCE (use_uv), or plain MSE;
- energy MSE.

Every reduction is a masked mean; targets carry no gradient.

With a data group (``group``, ``parallel/data_parallel``) each rank's
loss is its share of the global batch's: the masked sums over the group's
total counts (all of them summed in one ``all_reduce``) and the means over
rows divided by the group's size, so that the ranks' shares add up to the
loss of the whole batch.  ``group=None`` is one process.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..nn.common import island
from ..ops import forward_sum_loss, sum_by_words
from ..parallel.data_parallel import group_size, reduce_counts

_PREDICTIONS = ("log_duration_prediction", "pitch_prediction", "energy_prediction")


def masked_mean(x: torch.Tensor, mask: torch.Tensor, count=None) -> torch.Tensor:
    """sum(x * mask) over the mask's count (``count``: the global one) times
    the features a masked position holds."""
    mask = mask.to(x.dtype)
    while mask.dim() < x.dim():
        mask = mask[..., None]
    n = mask.sum() if count is None else count
    denom = torch.clamp(n * (x.numel() / mask.numel()), min=1.0)
    return torch.sum(x * mask) / denom


def _row_mean(x: torch.Tensor, world: int) -> torch.Tensor:
    """A mean over the rows as this rank's share of ``world`` ranks' mean."""
    m = torch.mean(x)
    return m if world == 1 else m / world


def _targets(duration_targets, txt_mask):
    return duration_targets.detach().float() * txt_mask.float()


def duration_losses(log_duration_predictions, duration_targets, word_ids, n_words: int,
                    txt_mask, loss_cfg, word_count=None, world: int = 1
                    ) -> Dict[str, torch.Tensor]:
    nonpad = txt_mask.float()
    dur_t = _targets(duration_targets, txt_mask)
    dur_p = torch.clamp(torch.exp(log_duration_predictions) - 1.0, min=0.0)
    zero = log_duration_predictions.new_zeros(())
    out = {"pdur": _row_mean((log_duration_predictions - torch.log(dur_t + 1.0)) ** 2, world)}
    if loss_cfg.wdur_lambda > 0:
        wp = sum_by_words(dur_p * nonpad, word_ids, n_words)
        wt = sum_by_words(dur_t, word_ids, n_words)
        werr = (torch.log(wp + 1.0) - torch.log(wt + 1.0)) ** 2
        # masked by the TARGET word duration, as the JAX package does (the
        # reference masks by the prediction, which lets a collapsed word escape)
        wmask = (wt > 0).float()
        n = wmask.sum() if word_count is None else word_count
        out["wdur"] = torch.sum(werr * wmask) / torch.clamp(n, min=1.0)
    else:
        out["wdur"] = zero
    if loss_cfg.sdur_lambda > 0:
        sp, st = dur_p.sum(-1), dur_t.sum(-1)
        out["sdur"] = _row_mean((torch.log(sp + 1.0) - torch.log(st + 1.0)) ** 2, world)
    else:
        out["sdur"] = zero
    return out


def align_losses(attn_soft, attn_hard, attn_logprob, txt_lens, mel_lens, step: int,
                 loss_cfg, hard_count=None, world: int = 1) -> Dict[str, torch.Tensor]:
    ctc = forward_sum_loss(attn_logprob, txt_lens, mel_lens)
    out = {"ctc": ctc if world == 1 else ctc / world}
    w = min(max((step - loss_cfg.binarization_loss_enable_steps)
                / loss_cfg.binarization_loss_warmup_steps, 0.0), 1.0)
    hard = attn_hard.detach()
    log_soft = torch.log(torch.clamp(attn_soft, min=1e-12))
    n = hard.sum() if hard_count is None else hard_count
    out["bin"] = (-torch.sum(log_soft * hard) / torch.clamp(n, min=1.0)) * w
    return out


def _voiced(pitch_targets, mask):
    return mask.float() * (pitch_targets["uv"].detach() == 0)


def pitch_losses(pitch_predictions, pitch_targets, mask, use_uv: bool, txt_count=None,
                 voiced_count=None) -> Dict[str, torch.Tensor]:
    if use_uv:
        f0_t = pitch_targets["f0"].detach()
        uv_t = pitch_targets["uv"].detach()
        nonpad = mask.float()
        uv_p = pitch_predictions[..., 1]
        bce = torch.clamp(uv_p, min=0) - uv_p * uv_t + torch.log1p(torch.exp(-torch.abs(uv_p)))
        voiced = _voiced(pitch_targets, mask)
        f0_p = pitch_predictions[..., 0]
        n_txt = nonpad.sum() if txt_count is None else txt_count
        n_voiced = voiced.sum() if voiced_count is None else voiced_count
        return {
            "uv": torch.sum(bce * nonpad) / torch.clamp(n_txt, min=1.0),
            "f0": torch.sum(((f0_p - f0_t) ** 2) * voiced) / torch.clamp(n_voiced, min=1.0),
        }
    return {"pitch": masked_mean((pitch_predictions - pitch_targets.detach()) ** 2, mask,
                                 txt_count)}


def energy_loss(energy_predictions, energy_targets, mask, count=None) -> torch.Tensor:
    return masked_mean((energy_predictions - energy_targets.detach()) ** 2, mask, count)


def mel_losses(mel_predictions, postnet_mel_predictions, mel_targets,
               mel_mask, count=None) -> Dict[str, torch.Tensor]:
    t = mel_targets.detach()
    return {
        "mel": masked_mean(torch.abs(mel_predictions - t), mel_mask, count),
        "postnet": masked_mean(torch.abs(postnet_mel_predictions - t), mel_mask, count),
    }


def _global_counts(outputs, dur_target, word_ids, n_words, loss_cfg, use_uv, aligned,
                   group) -> Dict[str, torch.Tensor]:
    """The loss's normalising counts summed over ``group`` (one
    ``all_reduce``): valid frames, phonemes, voiced phonemes, target words
    and alignment cells."""
    txt_mask, dtype = outputs["txt_mask"], outputs["mel"].dtype
    local = {"mel": outputs["mel_mask"].to(dtype).sum(), "txt": txt_mask.to(dtype).sum()}
    if use_uv:
        local["voiced"] = _voiced(outputs["pitch_target"], txt_mask).to(dtype).sum()
    if loss_cfg.wdur_lambda > 0:
        wt = sum_by_words(_targets(dur_target, txt_mask), word_ids, n_words)
        local["words"] = (wt > 0).to(dtype).sum()
    if aligned:
        local["hard"] = outputs["attn_hard"].detach().to(dtype).sum()
    return dict(zip(local, reduce_counts(list(local.values()), group)))


def fastspeech2_loss(outputs: Dict, mel_target, txt_lens, mel_lens, word_ids, n_words: int,
                     step: int, loss_cfg, use_uv: bool = True, learn_alignment: bool = True,
                     duration_target=None, group=None) -> Dict[str, torch.Tensor]:
    """The loss dict and its ``total`` from ``FastSpeech2.forward``'s outputs;
    ``step`` is the training step (an int) that ramps the bin term in.  The
    duration loss reads ``duration_target`` where given, else the durations
    the forward used; the ``ctc`` and ``bin`` terms are there only with
    ``learn_alignment`` and an aligner's outputs.  With a data ``group``
    every term is this rank's share of the global batch's (module
    docstring)."""
    # a 16-bit model's predictions enter the loss in float32: every term is
    # float32, as JAX promotes them against the float32 targets (and the
    # few that JAX keeps in bfloat16, the duration's exp and the uv
    # softplus, are float32 here too)
    outputs = {k: island(v) if k in _PREDICTIONS and v is not None else v
               for k, v in outputs.items()}
    txt_mask, mel_mask = outputs["txt_mask"], outputs["mel_mask"]
    dur_target = duration_target if duration_target is not None else outputs["duration_rounded"]
    aligned = learn_alignment and outputs["attn_soft"] is not None
    world = group_size(group)
    n = {} if world == 1 else _global_counts(outputs, dur_target, word_ids, n_words, loss_cfg,
                                             use_uv, aligned, group)
    losses = mel_losses(outputs["mel"], outputs["postnet_mel"], mel_target, mel_mask,
                        n.get("mel"))
    losses.update(duration_losses(outputs["log_duration_prediction"], dur_target,
                                  word_ids, n_words, txt_mask, loss_cfg, n.get("words"), world))
    if aligned:
        losses.update(align_losses(outputs["attn_soft"], outputs["attn_hard"],
                                   outputs["attn_logprob"], txt_lens, mel_lens, step, loss_cfg,
                                   n.get("hard"), world))
    losses.update(pitch_losses(outputs["pitch_prediction"], outputs["pitch_target"], txt_mask,
                               use_uv, n.get("txt"), n.get("voiced")))
    losses["energy"] = energy_loss(outputs["energy_prediction"], outputs["energy_target"], txt_mask,
                                   n.get("txt"))
    total = (losses["mel"] + losses["postnet"] + loss_cfg.pdur_lambda * losses["pdur"]
             + loss_cfg.wdur_lambda * losses["wdur"] + loss_cfg.sdur_lambda * losses["sdur"])
    for name in ("ctc", "bin", "uv", "f0", "pitch"):
        if name in losses:
            total = total + losses[name]
    losses["total"] = total + losses["energy"]
    return losses
