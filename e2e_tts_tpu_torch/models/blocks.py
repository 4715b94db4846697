"""Encoder/decoder building blocks by ``building_block.block_type`` (port of
``e2e_tts_tpu/models/blocks.py``).  The port has the transformer family; the
other four families are queued in ROADMAP.md (A10).

    encoder(token_ids, mask) -> (x, raw_embeddings)
    decoder(x, mask) -> (x, mask)
"""

from __future__ import annotations

import torch

from ..config import FastSpeech2Config

BLOCK_TYPES = ("transformer", "conformer", "fastformer", "lstransformer", "reformer")


def _check(cfg: FastSpeech2Config) -> None:
    bt = cfg.building_block.block_type
    if bt == "transformer":
        return
    if bt in BLOCK_TYPES:
        raise NotImplementedError(
            f"block_type {bt!r} is not ported yet (ROADMAP.md, Queue A, A10)"
        )
    raise ValueError(f"unknown block_type {bt!r}; have {list(BLOCK_TYPES)}")


def build_encoder(cfg: FastSpeech2Config, n_symbols: int, use_flash: bool = False, *,
                  generator: torch.Generator, device=None):
    from ..nn.transformer import TransformerEncoder

    _check(cfg)
    b = cfg.building_block.transformer
    return TransformerEncoder(
        n_symbols=n_symbols,
        n_layers=cfg.encoder_layers,
        d_model=cfg.encoder_hidden,
        n_head=b.encoder_head,
        d_inner=b.conv_filter_size,
        kernel_sizes=tuple(b.conv_kernel_size),
        use_flash=use_flash,
        generator=generator,
        device=device,
    )


def build_decoder(cfg: FastSpeech2Config, use_flash: bool = False, *,
                  generator: torch.Generator, device=None):
    from ..nn.transformer import TransformerDecoder

    _check(cfg)
    b = cfg.building_block.transformer
    return TransformerDecoder(
        n_layers=cfg.decoder_layers,
        d_model=cfg.decoder_hidden,
        n_head=b.decoder_head,
        d_inner=b.conv_filter_size,
        kernel_sizes=tuple(b.conv_kernel_size),
        use_flash=use_flash,
        generator=generator,
        device=device,
    )
