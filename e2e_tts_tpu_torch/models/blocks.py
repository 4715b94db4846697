"""Encoder/decoder building blocks by ``building_block.block_type`` (port of
``e2e_tts_tpu/models/blocks.py``): the five families of the JAX package,
with its mappings of each family's config (``reference_compat`` and
``mask_attention``).

    encoder(token_ids, mask, rng=None, train=False) -> (x, raw_embeddings)
    decoder(x, mask, rng=None, train=False) -> (x, mask)

``rng`` is the dropout generator (None: deterministic); ``train`` puts the
conformer's BatchNorm on batch statistics (the JAX ``deterministic=False``);
``dtype`` is the compute dtype (``nn/common.py``).  ``use_flash`` reaches
the transformer only, as in the JAX package, whose other four families
compute their attention with plain einsums and softmaxes and so reach no
Pallas kernel.  ``remat_blocks`` recomputes each layer in the backward
pass; the reformer always does.
"""

from __future__ import annotations

import torch

from ..config import FastSpeech2Config

BLOCK_TYPES = ("transformer", "conformer", "fastformer", "lstransformer", "reformer")


def _family(cfg: FastSpeech2Config):
    bt = cfg.building_block.block_type
    if bt not in BLOCK_TYPES:
        raise ValueError(f"unknown block_type {bt!r}; have {list(BLOCK_TYPES)}")
    return bt, cfg.building_block.active()


def _build(cfg: FastSpeech2Config, side: str, n_symbols, use_flash: bool, kw: dict):
    """The encoder (``side`` "encoder", with ``n_symbols``) or the decoder."""
    bt, b = _family(cfg)
    enc = side == "encoder"
    head = b.encoder_head if enc else b.decoder_head
    rate = b.encoder_dropout if enc else b.decoder_dropout
    d_model = cfg.encoder_hidden if enc else cfg.decoder_hidden
    n_layers = cfg.encoder_layers if enc else cfg.decoder_layers
    first = (n_symbols,) if enc else ()
    if bt == "transformer":
        from ..nn.transformer import TransformerDecoder, TransformerEncoder

        cls = TransformerEncoder if enc else TransformerDecoder
        return cls(*first, n_layers, d_model, head, b.conv_filter_size,
                   tuple(b.conv_kernel_size), use_flash, rate, remat=cfg.remat_blocks, **kw)
    if bt == "conformer":
        from ..nn.conformer import ConformerDecoder, ConformerEncoder

        cls = ConformerEncoder if enc else ConformerDecoder
        return cls(*first, n_layers, d_model, head, b.ffn_expansion_factor, b.conv_kernel_size,
                   b.conv_expansion_factor, b.half_step_residual, rate, b.mask_attention,
                   cfg.remat_blocks, **kw)
    if bt == "fastformer":
        from ..nn.fastformer import FastformerDecoder, FastformerEncoder

        cls = FastformerEncoder if enc else FastformerDecoder
        compat = b.reference_compat  # the reference runs d_model // head heads of size head
        return cls(*first, n_layers, d_model, d_model // head if compat else head,
                   b.conv_filter_size, tuple(b.conv_kernel_size), rate, pre_zero=not compat,
                   invert_mask=compat, remat=cfg.remat_blocks, **kw)
    if bt == "lstransformer":
        from ..nn.lstransformer import LSTransformerDecoder, LSTransformerEncoder

        cls = LSTransformerEncoder if enc else LSTransformerDecoder
        compat = b.reference_compat
        return cls(*first, n_layers, d_model, head, b.conv_filter_size,
                   tuple(b.conv_kernel_size), b.window_size, 1 if compat else b.r, rate,
                   pre_zero=not compat, rotary_interleaved=compat, invert_mask=compat,
                   remat=cfg.remat_blocks, **kw)
    from ..nn.reformer import ReformerDecoder, ReformerEncoder

    cls = ReformerEncoder if enc else ReformerDecoder
    return cls(*first, n_layers, d_model, head, b.bucket_size, b.n_hashes, rate, **kw)


def build_encoder(cfg: FastSpeech2Config, n_symbols: int, use_flash: bool = False, *,
                  generator: torch.Generator, device=None, dtype=None):
    return _build(cfg, "encoder", n_symbols, use_flash,
                  dict(generator=generator, device=device, dtype=dtype))


def build_decoder(cfg: FastSpeech2Config, use_flash: bool = False, *,
                  generator: torch.Generator, device=None, dtype=None):
    return _build(cfg, "decoder", None, use_flash,
                  dict(generator=generator, device=device, dtype=dtype))
