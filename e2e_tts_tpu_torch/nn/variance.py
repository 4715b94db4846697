"""Variance adaptor, inference half (port of ``e2e_tts_tpu/nn/variance.py``):
corpus statistics, the duration predictor (espnet style, the unsupervised
tree the shipped voices use) and the pitch/energy predictors with their
embeddings.  The aligner and the training branch wait for the training slice
(ROADMAP.md, A7).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..ops import bucketize, f0_to_coarse
from .common import Conv1d, Embedding, LayerNorm, Linear, t2t_sinusoid


@dataclass(frozen=True)
class FeatureStats:
    """Corpus statistics bundle (the deploy-time stats.json)."""

    pitch_min: float = 0.0
    pitch_max: float = 800.0
    pitch_mean: float = 200.0
    pitch_std: float = 50.0
    energy_min: float = 0.0
    energy_max: float = 100.0
    energy_mean: float = 30.0
    energy_std: float = 15.0
    f0_mean: float = 200.0
    f0_std: float = 50.0

    @classmethod
    def from_dict(cls, d: Dict) -> "FeatureStats":
        def g(k, f, default):
            return float(d.get(k, {}).get(f, default))

        return cls(
            pitch_min=g("pitch", "min", 0.0),
            pitch_max=g("pitch", "max", 800.0),
            pitch_mean=g("pitch", "mean", 200.0),
            pitch_std=g("pitch", "std", 50.0),
            energy_min=g("energy", "min", 0.0),
            energy_max=g("energy", "max", 100.0),
            energy_mean=g("energy", "mean", 30.0),
            energy_std=g("energy", "std", 15.0),
            f0_mean=g("f0", "mean", 200.0),
            f0_std=g("f0", "std", 50.0),
        )

    def to_dict(self) -> Dict:
        return {
            "pitch": {
                "min": self.pitch_min, "max": self.pitch_max,
                "mean": self.pitch_mean, "std": self.pitch_std,
            },
            "energy": {
                "min": self.energy_min, "max": self.energy_max,
                "mean": self.energy_mean, "std": self.energy_std,
            },
            "f0": {"mean": self.f0_mean, "std": self.f0_std},
        }


class ConvPredictorStack(nn.Module):
    """N x (conv -> relu -> LayerNorm [-> mask]) -> linear head."""

    def __init__(self, d_in: int, n_chans: int, n_layers: int, kernel_size: int, odim: int,
                 head_bias_init: float = 0.0, ln_eps: float = 1e-12, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.convs = nn.ModuleList(
            Conv1d(d_in if i == 0 else n_chans, n_chans, kernel_size, **kw)
            for i in range(n_layers)
        )
        self.norms = nn.ModuleList(LayerNorm(n_chans, ln_eps, device=device)
                                   for _ in range(n_layers))
        self.linear = Linear(n_chans, odim, bias_init=head_bias_init, **kw)

    def forward(self, x, mask=None):
        for conv, norm in zip(self.convs, self.norms):
            x = norm(torch.relu(conv(x)))
            if mask is not None:
                x = x * mask[..., None]
        return self.linear(x)


class DurationPredictor(nn.Module):
    """Log-domain duration predictor, espnet style: n_chans = n_mels, masks
    between layers, LayerNorm eps 1e-12, head bias log(5 + 1)."""

    def __init__(self, d_in: int, n_chans: int, n_layers: int = 2, kernel_size: int = 3, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.stack = ConvPredictorStack(d_in, n_chans, n_layers, kernel_size, 1,
                                        head_bias_init=1.7918, ln_eps=1e-12,
                                        generator=generator, device=device)

    def forward(self, x, mask):
        return (self.stack(x, mask) * mask[..., None])[..., 0]


class VariancePredictor(nn.Module):
    """Pitch/energy predictor with t2t sinusoidal positions scaled by
    ``pos_alpha``.  Positions count every row whose features are not all
    zero; padded rows carry the speaker embedding by now, so they count
    through the padding exactly as the JAX package and the reference do."""

    def __init__(self, d_in: int, n_chans: int, n_layers: int, kernel_size: int, odim: int, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.pos_alpha = nn.Parameter(torch.ones(1, device=device))
        self.stack = ConvPredictorStack(d_in, n_chans, n_layers, kernel_size, odim,
                                        generator=generator, device=device)

    def forward(self, x):
        T = x.shape[1]
        pos = torch.from_numpy(t2t_sinusoid(T + 1, x.shape[-1])).to(x.device)
        nonpad = (x.abs().sum(-1) > 0).to(torch.int64)
        positions = torch.cumsum(nonpad, dim=1) * nonpad
        return self.stack(x + self.pos_alpha * pos[positions])


def _bins(lo: float, hi: float, n: int, log: bool) -> np.ndarray:
    if log:
        return np.exp(np.linspace(np.log(max(lo, 1e-4)), np.log(hi), n)).astype(np.float32)
    return np.linspace(lo, hi, n).astype(np.float32)


class VarianceAdaptor(nn.Module):
    """Duration + phoneme- or frame-level pitch/energy, inference only."""

    def __init__(self, n_mel_channels: int, hidden_dim: int, stats: FeatureStats, vp, ve, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        if vp.ffn_padding != "SAME":
            raise NotImplementedError("only SAME predictor padding is ported")
        kw = dict(generator=generator, device=device)
        self.stats = stats
        self.predictor_grad = vp.predictor_grad
        self.use_uv = ve.use_uv
        self.pitch_feature = ve.pitch_feature
        self.energy_feature = ve.energy_feature
        self.pitch_log = ve.pitch_quantization == "log"
        self.duration_predictor = DurationPredictor(
            hidden_dim, n_mel_channels, vp.dur_predictor_layers, vp.dur_predictor_kernel, **kw)
        self.pitch_predictor = VariancePredictor(
            hidden_dim, vp.filter_size, vp.pit_predictor_layers, vp.pit_predictor_kernel,
            2 if ve.use_uv else 1, **kw)
        self.pitch_embedding = Embedding(ve.n_bins if ve.use_uv else ve.f0_bins, hidden_dim, **kw)
        self.energy_predictor = VariancePredictor(
            hidden_dim, vp.filter_size, vp.ener_predictor_layers, vp.ener_predictor_kernel, 1,
            **kw)
        self.energy_embedding = Embedding(ve.n_bins, hidden_dim, **kw)
        self.register_buffer("pitch_bins", torch.from_numpy(_bins(
            stats.pitch_min, stats.pitch_max, ve.n_bins - 1, self.pitch_log)).to(device),
            persistent=False)
        self.register_buffer("energy_bins", torch.from_numpy(_bins(
            stats.energy_min, stats.energy_max, ve.n_bins - 1,
            ve.energy_quantization == "log")).to(device), persistent=False)

    def _predictor_input(self, x):
        # the JAX package's grad_scale: identity in value, but computed as
        # x * (1 - a) + a * x, which can move the last bit of x
        a = self.predictor_grad
        return x * (1.0 - a) + a * x

    def pitch_embed(self, x, control: float):
        pred = self.pitch_predictor(self._predictor_input(x))
        if self.use_uv:
            pred = pred * control
            f0s, uvs = pred[..., 0], pred[..., 1] > 0
            if self.pitch_log:
                f0 = 2.0 ** f0s
            else:
                f0 = f0s * self.stats.f0_std + self.stats.f0_mean
            f0 = torch.where(uvs, torch.zeros_like(f0), f0)
            return self.pitch_embedding(f0_to_coarse(f0).long())
        return self.pitch_embedding(bucketize(pred[..., 0] * control, self.pitch_bins).long())

    def energy_embed(self, x, control: float):
        pred = self.energy_predictor(self._predictor_input(x))[..., 0]
        return self.energy_embedding(bucketize(pred * control, self.energy_bins).long())
