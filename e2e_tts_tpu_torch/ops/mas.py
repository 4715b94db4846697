"""Monotonic alignment search on the device (port of ``e2e_tts_tpu/ops/mas.py``).

The width-1 search runs in one kernel launch for the batch
(``kernels/mas.py``; its plain version on CPU tensors).  The hard alignment
is a training target: no gradient flows through it.
"""

from __future__ import annotations

import torch

from ..kernels.mas import mas


def monotonic_align(attn: torch.Tensor, text_lens: torch.Tensor,
                    mel_lens: torch.Tensor) -> torch.Tensor:
    """Batched width-1 MAS.

    attn: (B, T_mel, T_text) soft attention (probabilities).  Returns the hard
    alignment (B, T_mel, T_text) float32, whose sum over the mel axis gives
    each phoneme's duration; columns at or past text_len are 0 (``mas``
    zeroes them).
    """
    with torch.no_grad():
        log_attn = torch.log(torch.clamp(attn.float(), min=1e-30))
        return mas(log_attn.contiguous(), text_lens, mel_lens)
