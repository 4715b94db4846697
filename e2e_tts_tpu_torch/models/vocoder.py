"""Vocoder wiring (port of ``e2e_tts_tpu/models/vocoder.py``): generator
selection, the iSTFTNet head's inverse STFT, and weight-norm fusing."""

from __future__ import annotations

import numpy as np

from ..audio.mel import inverse_stft
from ..config import Config, IstftNetConfig
from ..nn.common import fuse_weight_norm as _fuse
from ..device import resolve_device
from ..nn.hifigan import (HifiGanGenerator, IstftNetGenerator, TrainableHifiGan,
                          TrainableIstftNet, fuse_generator)


def build_generator(config: Config, kind: str = "hifigan", train: bool = False, **kw):
    """kind "hifigan" or "istft"; ``kw`` (device, generator, seed, and the
    serving form's compute dtype) go to the module.  ``train``: the training
    form (weight norm as parameters, autograd on; ``fuse_generator`` gives
    its serving form), on CUDA unless ``device`` says otherwise; the serving
    form otherwise."""
    if kind not in ("hifigan", "istft"):
        raise ValueError(f"unknown vocoder kind {kind!r}")
    cfg = config.models.hifigan if kind == "hifigan" else config.models.istft
    if train:
        kw["device"] = resolve_device(kw.get("device"))
        cls = TrainableHifiGan if kind == "hifigan" else TrainableIstftNet
    else:
        cls = HifiGanGenerator if kind == "hifigan" else IstftNetGenerator
    return cls.from_config(cfg, config.audio.mel.channels, **kw)


def istft_to_audio(spec, phase, cfg: IstftNetConfig):
    """(B, bins, T), (B, bins, T) -> (B, samples)."""
    return inverse_stft(spec, phase, n_fft=cfg.gen_istft_n_fft,
                        hop_length=cfg.gen_istft_hop_size, win_length=cfg.gen_istft_win_size)


def vocode(generator, mel, config: Config, kind: str = "hifigan"):
    """mel (B, T, n_mels) -> audio (B, samples)."""
    if kind == "hifigan":
        return generator(mel)
    spec, phase = generator(mel)
    return istft_to_audio(spec, phase, config.models.istft)


def fuse_weight_norm(params):
    """Canonicalize every {v, g} pair of a numpy parameter tree so that v holds
    the fused kernel and g its norm (the serving-time remove_weight_norm)."""
    if not isinstance(params, dict):
        return params
    if "v" in params and "g" in params:
        w = _fuse(params["v"], params["g"])
        out = dict(params)
        out["v"] = w
        out["g"] = np.linalg.norm(w.reshape(-1, w.shape[-1]), axis=0).astype(np.float32)
        return out
    return {k: fuse_weight_norm(v) for k, v in params.items()}
