"""Length regulation, phoneme -> frame expansion as a gather (port of
``e2e_tts_tpu/ops/length_regulator.py``):

    mel2ph[t] = #{ j : cumsum(dur)[j] <= t }        (searchsorted, right)
    x_mel[t]  = x_phon[mel2ph[t]]

Frames past the total duration point at the last phoneme and are zeroed.
The training pools (frames to phonemes, phonemes to words) are one-hot
products, as in JAX.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def durations_to_mel2ph(durations: torch.Tensor, max_mel_len: int) -> torch.Tensor:
    """(B, L) int durations -> (B, T) int64 phoneme index per mel frame."""
    cs = torch.cumsum(durations.to(torch.int32), dim=-1).contiguous()  # (B, L)
    t = torch.arange(max_mel_len, dtype=torch.int32, device=durations.device)
    t = t[None, :].expand(cs.shape[0], -1).contiguous()
    mel2ph = torch.searchsorted(cs, t, right=True)
    return torch.clamp(mel2ph, max=durations.shape[-1] - 1)


def regulate_length(
    x: torch.Tensor, durations: torch.Tensor, max_mel_len: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expand (B, L, H) phoneme features by (B, L) durations.

    Returns (x_mel (B, T, H), mel_lens (B,) int32, mel2ph (B, T)).
    """
    mel2ph = durations_to_mel2ph(durations, max_mel_len)
    x_mel = torch.gather(x, 1, mel2ph[..., None].expand(-1, -1, x.shape[-1]))
    mel_lens = torch.clamp(durations.sum(dim=-1), max=max_mel_len).to(torch.int32)
    t = torch.arange(max_mel_len, dtype=torch.int32, device=x.device)
    valid = t[None, :] < mel_lens[:, None]
    return x_mel * valid[..., None].to(x_mel.dtype), mel_lens, mel2ph


def average_by_segments(frame_feature: torch.Tensor, mel2ph: torch.Tensor,
                        mel_lens: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Frame level -> phoneme level, the mean over each phoneme's frames: (B, T)
    features and segment ids -> (B, n_segments), a one-hot product."""
    t = torch.arange(mel2ph.shape[-1], device=mel2ph.device)
    valid = (t[None, :] < mel_lens[:, None]).to(frame_feature.dtype)
    onehot = F.one_hot(mel2ph.long(), n_segments).to(frame_feature.dtype) * valid[..., None]
    sums = torch.einsum("btl,bt->bl", onehot, frame_feature)
    return sums / torch.clamp(onehot.sum(dim=1), min=1.0)


def sum_by_words(phoneme_values: torch.Tensor, word_ids: torch.Tensor,
                 n_words: int) -> torch.Tensor:
    """Phoneme level -> word level by summing: (B, L) values and word ids ->
    (B, n_words), a one-hot product."""
    onehot = F.one_hot(word_ids.long(), n_words).to(phoneme_values.dtype)
    return torch.einsum("blw,bl->bw", onehot, phoneme_values)
