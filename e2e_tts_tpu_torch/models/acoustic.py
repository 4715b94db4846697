"""FastSpeech2 acoustic model (port of ``e2e_tts_tpu/models/acoustic.py``):
``forward`` (the JAX ``__call__``, training and its eval pass),
``content_features`` (the aligner's phoneme posteriorgram) and the serving
stages ``synthesize_stage1`` and ``synthesize_stage2``.

``forward`` follows the module's mode: in training mode the BatchNorms (the
postnet's, and the conformer's) use and update batch statistics and dropout
draws from ``rng`` (a ``torch.Generator`` on the model's device); in eval
mode both are off.
The serving stages run under ``torch.no_grad()``.

``dtype`` is the compute dtype (``nn/common.py``; float32, bfloat16 or
float16), as the JAX model's: the encoder, the variance adaptor and the
decoder run in it, the speaker embedding is cast to it, and ``mel_linear``
and the postnet are float32 islands (float64 under ``.double()``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config import FastSpeech2Config
from ..device import resolve_device
from ..nn.common import Embedding, Linear, compute_dtype, island
from ..nn.postnet import Postnet
from ..nn.variance import FeatureStats, VarianceAdaptor
from ..ops import regulate_length, sequence_mask
from .blocks import build_decoder, build_encoder


class FastSpeech2(nn.Module):
    """FastSpeech2 on ``device`` (CUDA when None, which raises without a
    card), weights drawn from ``generator`` (a CPU ``torch.Generator``;
    ``seed`` makes one when none is given).  It starts in eval mode, as
    serving wants it."""

    def __init__(self, config: FastSpeech2Config, n_symbols: int, n_speakers: int,
                 n_mel_channels: int, stats: FeatureStats, use_flash: bool = False, *,
                 device=None, generator: Optional[torch.Generator] = None, seed: int = 0,
                 dtype=torch.float32):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(seed)
        kw = dict(generator=g, device=resolve_device(device))
        self.config = config
        self.n_symbols = n_symbols
        self.n_mel_channels = n_mel_channels
        self.dtype = compute_dtype(dtype)
        self.encoder = build_encoder(config, n_symbols, use_flash, dtype=dtype, **kw)
        self.decoder = build_decoder(config, use_flash, dtype=dtype, **kw)
        self.variance_adaptor = VarianceAdaptor(
            n_mel_channels, config.encoder_hidden, stats, config.variance.variance_predictor,
            config.variance.variance_embedding, config.variance.duration_modelling, dtype=dtype,
            **kw)
        self.mel_linear = Linear(config.decoder_hidden, n_mel_channels, **kw)
        self.postnet = Postnet(n_mel_channels, config.postnet.embedding_dim,
                               config.postnet.conv_layers, config.postnet.kernel_size, **kw)
        self.speaker_emb = Embedding(n_speakers, config.encoder_hidden, dtype=dtype, **kw)
        self.eval()

    def forward(self, speakers, texts, txt_lens, mel, mel_lens, attn_prior, pitch_target,
                energy_target, step: int, rng: Optional[torch.Generator] = None,
                duration_target=None) -> Dict:
        """The JAX ``__call__`` with a mel target (the train and eval passes) at
        ``max_mel_len = mel.shape[1]``: returns the same dict (mel,
        postnet_mel, log_duration_prediction, duration_rounded, pitch/energy
        predictions and pooled targets, txt_mask, mel_lens, mel_mask,
        attn_soft, attn_hard, attn_logprob).  ``rng`` is used only in
        training mode, which needs one.  A model without the aligner
        (``learn_alignment: false``) takes its durations from
        ``duration_target`` (B, L) and ignores ``attn_prior`` (None will do);
        its ``attn_*`` entries are None."""
        if not self.training:
            rng = None
        elif rng is None:
            raise ValueError("a FastSpeech2 in training mode needs a dropout generator (rng)")
        txt_mask = sequence_mask(txt_lens, texts.shape[1])
        x, txt_emb = self.encoder(texts, txt_mask, rng, self.training)
        va = self.variance_adaptor(x, txt_emb, txt_lens, txt_mask, self.speaker_emb(speakers),
                                   mel, mel_lens, attn_prior, pitch_target, energy_target, step,
                                   rng, duration_target)
        dec, mel_mask = self.decoder(va["x"], va["mel_mask"], rng, self.training)
        mel_out = self.mel_linear(island(dec))
        postnet_out = self.postnet(mel_out, self.training, rng) + mel_out
        return {
            "mel": mel_out,
            "postnet_mel": postnet_out,
            "log_duration_prediction": va["log_duration_prediction"],
            "duration_rounded": va["duration_rounded"],
            "pitch_prediction": va["pitch_prediction"],
            "energy_prediction": va["energy_prediction"],
            "txt_mask": txt_mask,
            "mel_lens": va["mel_lens"],
            "mel_mask": mel_mask,
            "attn_soft": va["attn_soft"],
            "attn_hard": va["attn_hard"],
            "attn_logprob": va["attn_logprob"],
            "pitch_target": va["pitch_target"],
            "energy_target": va["energy_target"],
        }

    def content_features(self, mel, speakers=None):
        """Phoneme posteriorgram (B, T, n_symbols) of a mel (B, T, n_mels): the
        aligner's soft attention of each frame over the whole symbol
        inventory's raw embeddings (what the JAX version takes from its
        encoder call), with the speaker's projections.  A model without the
        aligner (``learn_alignment: false``) has none to give and raises."""
        if self.variance_adaptor.aligner is None:
            raise ValueError("content features come from the aligner, and a model with "
                             "learn_alignment: false has none")
        B = mel.shape[0]
        ids = torch.arange(self.n_symbols, device=mel.device)[None]
        sym_emb = self.encoder.src_word_emb(ids).expand(B, -1, -1)
        if speakers is None:
            speakers = torch.zeros(B, dtype=torch.int64, device=mel.device)
        full = torch.ones(B, self.n_symbols, dtype=torch.bool, device=mel.device)
        attn_soft, _ = self.variance_adaptor.aligner(mel, sym_emb, full,
                                                     spk_emb=self.speaker_emb(speakers))
        return attn_soft

    @torch.no_grad()
    def synthesize_stage1(self, speakers, texts, txt_lens, p_control: float = 1.0,
                          e_control: float = 1.0, d_control: float = 1.0):
        """Phoneme rate: encoder + speaker + durations + phoneme-level
        pitch/energy embeddings.  Returns (x (B, L, H), durations (B, L) int32)."""
        va = self.variance_adaptor
        txt_mask = sequence_mask(txt_lens, texts.shape[1])
        x, _ = self.encoder(texts, txt_mask)
        x = x + self.speaker_emb(speakers)[:, None, :]

        log_d = va.duration_predictor(x, txt_mask)
        durations = torch.clamp(torch.round(torch.exp(log_d) - 1.0) * d_control, min=0.0)
        durations = (durations * txt_mask).to(torch.int32)
        x, _, _ = va.add_prosody(x, "phoneme_level", p_control=p_control, e_control=e_control)
        return x, durations

    @torch.no_grad()
    def synthesize_stage2(self, x, durations, max_mel_len: int, p_control: float = 1.0,
                          e_control: float = 1.0):
        """Frame rate at a fixed mel bucket: length regulation + frame-level
        prosody (if configured) + decoder + mel projection + postnet.
        Returns (postnet_mel (B, T, n_mels), mel_lens (B,) int32)."""
        va = self.variance_adaptor
        x, mel_lens, _ = regulate_length(x, durations, max_mel_len)
        mel_mask = sequence_mask(mel_lens, max_mel_len)
        x, _, _ = va.add_prosody(x, "frame_level", p_control=p_control, e_control=e_control)
        dec, _ = self.decoder(x, mel_mask)
        mel = self.mel_linear(island(dec))
        return self.postnet(mel) + mel, mel_lens
