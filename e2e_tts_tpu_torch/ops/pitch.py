"""Pitch quantization (port of ``e2e_tts_tpu/ops/pitch.py``)."""

from __future__ import annotations

import math

import torch

F0_BIN = 256
F0_MIN = 50.0
F0_MAX = 1100.0
_F0_MEL_MIN = 1127.0 * math.log(1 + F0_MIN / 700.0)
_F0_MEL_MAX = 1127.0 * math.log(1 + F0_MAX / 700.0)


def f0_to_coarse(f0: torch.Tensor) -> torch.Tensor:
    """Quantize f0 in Hz to 256 mel-spaced bins; 0 Hz (unvoiced) -> bin 1."""
    f0_mel = 1127.0 * torch.log(1 + torch.clamp(f0, min=0.0) / 700.0)
    scaled = (f0_mel - _F0_MEL_MIN) * (F0_BIN - 2) / (_F0_MEL_MAX - _F0_MEL_MIN) + 1
    scaled = torch.where(f0_mel > 0, scaled, torch.ones_like(scaled))
    scaled = torch.clamp(scaled, 1.0, F0_BIN - 1)
    return torch.floor(scaled + 0.5).to(torch.int32)


def bucketize(x: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """Number of boundaries strictly below x: a value exactly ON a boundary
    belongs to the LOWER bin (searchsorted side="left")."""
    return torch.bucketize(x, boundaries, right=False, out_int32=True)
