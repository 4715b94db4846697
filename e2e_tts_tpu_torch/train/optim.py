"""Optimizers (port of ``e2e_tts_tpu/train/optim.py``): the acoustic
model's Adam with a Noam warm-up/decay scaled by encoder_hidden^-0.5,
annealed by ``anneal_rate`` past each milestone, and the vocoder GAN's Adam
with a continuous exponential learning-rate decay; both after global-norm
gradient clipping.

Each is the JAX package's optax chain written out on torch tensors:
``clip_by_global_norm`` (scaled by max_norm / norm where the global norm is
not below max_norm), ``scale_by_adam`` (bias-corrected, eps outside the
square root), ``add_decayed_weights`` when weight_decay is set,
``scale_by_schedule`` (the schedule read at the update count, from 0),
``scale(-1)`` and, where ``scale`` is given, optax's ``scale(scale)`` last
(``e2e_optimizers``: the joint fine-tune's acoustic and discriminator
optimizers).  The moments are float32 tensors beside each parameter; the
parameters are updated in place, by multi-tensor (``_foreach``) ops.  The
order of the float operations differs from optax's in the last bit (a
product by max_norm / norm, fused adds).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence

import torch

from ..parallel.tensor_parallel import global_norm


def noam_schedule(encoder_hidden: int, warmup_steps: int, anneal_steps: Sequence[int] = (),
                  anneal_rate: float = 0.3) -> Callable[[int], float]:
    """lr(step) = hidden^-0.5 * min(s^-0.5, s * warmup^-1.5), s = max(step, 1),
    times ``anneal_rate`` for each milestone that s is past."""
    init_lr = encoder_hidden ** -0.5

    def schedule(step: int) -> float:
        s = float(max(int(step), 1))
        lr = init_lr * min(s ** -0.5, s * warmup_steps ** -1.5)
        for m in anneal_steps:
            if s > m:
                lr *= anneal_rate
        return lr

    return schedule


@dataclass
class AdamState:
    """Updates applied so far, and the first and second moments."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class ScheduledAdam:
    """Clip -> Adam -> (weight decay) -> schedule -> descend (-> scale), as
    optax chains them.  The clip's global norm runs over every tensor given to one
    ``apply``: for the discriminators, MPD's and MSD's together.  ``init(params)`` makes the state; ``apply(params, grads, state)``
    updates the parameters in place and returns the global norm of ``grads``
    (before clipping) as a device scalar, with no host sync."""

    def __init__(self, schedule: Callable[[int], float], b1: float, b2: float, eps: float,
                 max_norm: float, weight_decay: float = 0.0, scale: float = 1.0):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.max_norm = max_norm
        self.weight_decay = weight_decay
        self.scale = scale

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def apply(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              state: AdamState, model_group=None) -> torch.Tensor:
        """One update for all tensors at once (``torch._foreach_*``: a few
        launches, not a dozen a tensor).  Over a ``model_group`` (tensor
        parallelism) the parameters are this rank's shards and the clip's
        norm is the whole model's (``tensor_parallel.global_norm``)."""
        params, grads = list(params), list(grads)
        if model_group is None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        else:
            norm = global_norm(params, torch._foreach_norm(grads), model_group)
        # optax scales by max_norm / norm only where the norm reaches max_norm
        clip = torch.where(norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm)
        g = torch._foreach_mul(grads, clip)
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, g, g, value=1.0 - b2)
        denom = torch._foreach_div(state.nu, 1.0 - b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(state.mu, 1.0 - b1 ** count)
        torch._foreach_div_(u, denom)
        if self.weight_decay:
            torch._foreach_add_(u, params, alpha=self.weight_decay)
        torch._foreach_mul_(u, self.schedule(state.count) * self.scale)
        torch._foreach_sub_(params, u)
        state.count = count
        return norm


NoamAdam = ScheduledAdam  # the acoustic optimizer's earlier name, kept importable


def acoustic_optimizer(cfg, encoder_hidden: int) -> ScheduledAdam:
    """Noam-scheduled Adam for FastSpeech2 from an ``OptimizerConfig``."""
    sched = noam_schedule(encoder_hidden, cfg.warm_up_step, cfg.anneal_steps, cfg.anneal_rate)
    return ScheduledAdam(sched, cfg.betas[0], cfg.betas[1], cfg.eps, cfg.grad_clip_thresh,
                         cfg.weight_decay)


def exponential_decay(init_value: float, decay_rate: float,
                      transition_steps: int = 1000) -> Callable[[int], float]:
    """optax's ``exponential_decay`` without staircase:
    lr(count) = init_value * decay_rate ** (count / transition_steps)."""

    def schedule(count: int) -> float:
        return init_value * decay_rate ** (int(count) / transition_steps)

    return schedule


def gan_optimizer(cfg, decay_gamma: float = 0.999) -> ScheduledAdam:
    """Adam for the vocoder's generator or discriminators from an
    ``OptimizerConfig``: clip at ``grad_clip_thresh``, Adam with ``betas`` and
    ``eps``, the learning rate decayed by ``decay_gamma`` every 1000 updates
    (continuously).  No weight decay: the config's ``weight_decay`` slot of
    ``hifigan_optimizer`` holds 0.999, the reference's decay gamma, and is
    not read here."""
    return ScheduledAdam(exponential_decay(cfg.learning_rate, decay_gamma), cfg.betas[0],
                         cfg.betas[1], cfg.eps, cfg.grad_clip_thresh)


def e2e_optimizers(config, am_scale: float = 1.0, d_scale: float = 1.0):
    """(acoustic, generator, discriminator) optimizers of the joint e2e
    fine-tune: the acoustic model's Noam Adam with its updates scaled by
    ``am_scale``, the generator's GAN Adam, and the discriminators' with
    theirs scaled by ``d_scale`` (optax's ``chain(..., scale(s))`` in the JAX
    package).  The scale is a number on the optimizer, not state: an e2e
    checkpoint holds the same tree whatever the scales were."""
    am = acoustic_optimizer(config.train.fastspeech2_optimizer,
                            config.models.fastspeech2.encoder_hidden)
    am.scale = am_scale
    d = gan_optimizer(config.train.hifigan_optimizer)
    d.scale = d_scale
    return am, gan_optimizer(config.train.hifigan_optimizer), d
