"""Training-data features (a copy of what the port needs from
``e2e_tts_tpu/audio/features.py``): the aligner's beta-binomial prior, which
an ``AcousticBatch`` carries as ``attn_prior``.  Pitch extraction and the rest
of data preparation are queued (ROADMAP.md, A9)."""

from __future__ import annotations

import numpy as np


def beta_binomial_prior(phoneme_count: int, mel_count: int,
                        scaling_factor: float = 1.0) -> np.ndarray:
    """Beta-binomial alignment prior, shape (mel_count, phoneme_count)
    ("One TTS Alignment To Rule Them All"): row i is the pmf over phonemes of
    BetaBinom(P, s * i, s * (M + 1 - i)), i = 1..M.  One broadcast call
    instead of the JAX package's row loop, which takes seconds at M = 768."""
    from scipy.stats import betabinom

    P, M = phoneme_count, mel_count
    i = np.arange(1, M + 1, dtype=np.float64)[:, None]
    return betabinom(P, scaling_factor * i, scaling_factor * (M + 1 - i)).pmf(np.arange(P)[None, :])
