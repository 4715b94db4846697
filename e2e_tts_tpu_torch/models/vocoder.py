"""Vocoder wiring (port of ``e2e_tts_tpu/models/vocoder.py``): generator
selection and weight-norm fusing.  The iSTFTNet head waits (ROADMAP.md, A4)."""

from __future__ import annotations

import numpy as np

from ..config import Config
from ..nn.common import fuse_weight_norm as _fuse
from ..nn.hifigan import HifiGanGenerator


def build_generator(config: Config, kind: str = "hifigan", **kw):
    """kind "hifigan"; ``kw`` (device, generator, seed) go to the module."""
    if kind == "hifigan":
        return HifiGanGenerator.from_config(config.models.hifigan,
                                            config.audio.mel.channels, **kw)
    if kind == "istft":
        raise NotImplementedError("the iSTFTNet vocoder is not ported yet (ROADMAP.md, A4)")
    raise ValueError(f"unknown vocoder kind {kind!r}")


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
