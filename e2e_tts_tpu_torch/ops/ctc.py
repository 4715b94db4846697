"""Forward-sum (CTC) alignment loss (port of ``e2e_tts_tpu/ops/ctc.py``).

The target of every utterance is the strictly increasing 1..K, so CTC is a
fixed 2K + 1-state lattice; its forward and backward recursions run as
kernels (``kernels/ctc.py``; their plain versions on CPU tensors).  Per-item
loss divided by the text length, 0 where the alignment cannot be made, then
the batch mean: ``torch.nn.functional.ctc_loss(zero_infinity=True,
reduction="mean")`` on that lattice, with JAX's -1e30 sentinels.
"""

from __future__ import annotations

import torch

from ..kernels.ctc import NEG_INF, ctc_bwd, ctc_fwd

BLANK_LOGPROB = -1.0  # the blank's log-energy before the log-softmax


class ForwardSumCTC(torch.autograd.Function):
    """Per-item forward-sum loss (B,) of log_probs (B, T, K + 1), differentiable
    in log_probs: the CTC forward wrapper, which keeps alpha for the backward
    wrapper (kernels on CUDA tensors, plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, log_probs, key_lens, query_lens):
        loss, alpha, total = ctc_fwd(log_probs, key_lens, query_lens)
        ctx.save_for_backward(log_probs, key_lens, query_lens, alpha, total)
        return loss

    @staticmethod
    def backward(ctx, grad_loss):
        log_probs, key_lens, query_lens, alpha, total = ctx.saved_tensors
        grad = ctc_bwd(grad_loss.contiguous(), log_probs, key_lens, query_lens, alpha, total)
        return grad, None, None


def lattice_log_probs(attn_logprob: torch.Tensor, text_lens: torch.Tensor) -> torch.Tensor:
    """(B, T_mel, T_text) alignment log-energies -> (B, T_mel, T_text + 1)
    log-probabilities over the blank (class 0) and the phonemes, classes past
    text_len at -1e30 before the log-softmax: what the CTC kernels take."""
    B, T, K = attn_logprob.shape
    classes = torch.cat([attn_logprob.new_full((B, T, 1), BLANK_LOGPROB), attn_logprob], dim=-1)
    valid = torch.arange(K + 1, device=attn_logprob.device)[None, :] <= text_lens[:, None]
    classes = torch.where(valid[:, None, :], classes, torch.full_like(classes, NEG_INF))
    return torch.log_softmax(classes, dim=-1).contiguous()


def forward_sum_loss(attn_logprob: torch.Tensor, text_lens: torch.Tensor,
                     mel_lens: torch.Tensor) -> torch.Tensor:
    """attn_logprob: (B, T_mel, T_text) unnormalised alignment log-energies
    (the aligner's pre-softmax output).  Returns the scalar mean loss."""
    log_probs = lattice_log_probs(attn_logprob, text_lens)
    return ForwardSumCTC.apply(log_probs, text_lens, mel_lens).mean()
