"""FastSpeech2 acoustic model, serving stages (port of
``e2e_tts_tpu/models/acoustic.py``: ``synthesize_stage1`` and
``synthesize_stage2``).  Training (``__call__``) and ``content_features``
wait for the training slice (ROADMAP.md, A7).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import FastSpeech2Config
from ..nn.common import Embedding, Linear
from ..nn.postnet import Postnet
from ..nn.variance import FeatureStats, VarianceAdaptor
from ..ops import regulate_length, sequence_mask
from .blocks import build_decoder, build_encoder


class FastSpeech2(nn.Module):
    """Eval-mode FastSpeech2 on ``device``, weights drawn from ``generator``
    (a CPU ``torch.Generator``; ``seed`` makes one when none is given)."""

    def __init__(self, config: FastSpeech2Config, n_symbols: int, n_speakers: int,
                 n_mel_channels: int, stats: FeatureStats, use_flash: bool = False, *,
                 device=None, generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        if not config.variance.duration_modelling.learn_alignment:
            raise NotImplementedError(
                "the supervised-duration predictor (ming024 style) is not ported yet")
        g = generator if generator is not None else torch.Generator().manual_seed(seed)
        kw = dict(generator=g, device=device)
        self.config = config
        self.n_symbols = n_symbols
        self.n_mel_channels = n_mel_channels
        self.encoder = build_encoder(config, n_symbols, use_flash, **kw)
        self.decoder = build_decoder(config, use_flash, **kw)
        self.variance_adaptor = VarianceAdaptor(
            n_mel_channels, config.encoder_hidden, stats, config.variance.variance_predictor,
            config.variance.variance_embedding, **kw)
        self.mel_linear = Linear(config.decoder_hidden, n_mel_channels, **kw)
        self.postnet = Postnet(n_mel_channels, config.postnet.embedding_dim,
                               config.postnet.conv_layers, config.postnet.kernel_size, **kw)
        self.speaker_emb = Embedding(n_speakers, config.encoder_hidden, **kw)
        self.eval()
        self.requires_grad_(False)

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

        x_base = x
        if va.pitch_feature == "phoneme_level":
            x = x + va.pitch_embed(x_base, p_control)
        if va.energy_feature == "phoneme_level":
            x = x + va.energy_embed(x_base, e_control)
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

        x_base = x
        if va.pitch_feature == "frame_level":
            x = x + va.pitch_embed(x_base, p_control)
        if va.energy_feature == "frame_level":
            x = x + va.energy_embed(x_base, e_control)

        dec, _ = self.decoder(x, mel_mask)
        mel = self.mel_linear(dec.float())
        return self.postnet(mel) + mel, mel_lens
