"""Length/mask utilities (port of ``e2e_tts_tpu/ops/masking.py``).

Masks are boolean with True = valid position.
"""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) bool mask, True where index < length."""
    ids = torch.arange(max_len, dtype=lengths.dtype, device=lengths.device)
    return ids[None, :] < lengths[:, None]
