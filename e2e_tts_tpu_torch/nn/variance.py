"""Variance adaptor (port of ``e2e_tts_tpu/nn/variance.py``): corpus
statistics, the duration predictor in both of the reference's styles
(espnet, the unsupervised tree the shipped voices use; ming024, the
supervised tree of ``learn_alignment: false``), the pitch/energy predictors
with their embeddings, the Gaussian-distance aligner, and the adaptor's
training branch: durations from the aligner and MAS, or given
(``duration_target``, MFA durations); targets pooled per phoneme; with the
aligner, soft expansion through the soft attention before
``binarization_start_steps`` and hard after, with given durations hard.

Dropout draws from the generator passed as ``rng`` (None: deterministic).
In a 16-bit compute ``dtype`` the predictors and the aligner run in it, and
the prosody arithmetic follows the prediction's type as in JAX (the pitch
and energy bins stay float32; the embeddings come out in the dtype).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..ops import (
    average_by_segments,
    bucketize,
    durations_to_mel2ph,
    f0_to_coarse,
    monotonic_align,
    regulate_length,
    sequence_mask,
)
from .common import (HALF, Conv1d, Embedding, LayerNorm, Linear, compute_dtype, dropout,
                     grad_scale, t2t_sinusoid, weak)
from .transformer import _Positions

NEG_INF = -1e9


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
    """N x (conv -> relu -> LayerNorm -> dropout [-> mask]) -> linear head.
    ``padding`` other than "SAME" makes the convolutions causal, as the JAX
    stack maps ``ffn_padding``."""

    def __init__(self, d_in: int, n_chans: int, n_layers: int, kernel_size: int, odim: int,
                 head_bias_init: float = 0.0, ln_eps: float = 1e-12, dropout: float = 0.5, *,
                 padding: str = "SAME", generator: torch.Generator, device=None, dtype=None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.dropout = dropout
        self.convs = nn.ModuleList(
            Conv1d(d_in if i == 0 else n_chans, n_chans, kernel_size,
                   padding="SAME" if padding == "SAME" else "CAUSAL", **kw)
            for i in range(n_layers)
        )
        self.norms = nn.ModuleList(LayerNorm(n_chans, ln_eps, device=device, dtype=dtype)
                                   for _ in range(n_layers))
        self.linear = Linear(n_chans, odim, bias_init=head_bias_init, **kw)

    def forward(self, x, mask=None, rng: Optional[torch.Generator] = None):
        for conv, norm in zip(self.convs, self.norms):
            x = dropout(norm(torch.relu(conv(x))), self.dropout, rng)
            if mask is not None:
                x = x * mask[..., None]
        return self.linear(x)


class DurationPredictor(nn.Module):
    """Log-domain duration predictor with head bias log(5 + 1), in one of the
    reference's two styles: "espnet" (the unsupervised tree: n_chans = n_mels,
    masks between layers, LayerNorm eps 1e-12) or "ming024" (the supervised
    tree: n_chans = filter_size, no mask between layers, eps 1e-5).  The
    output is masked in both."""

    graph_safe = True  # serve/graphs.py may capture its call

    def __init__(self, d_in: int, n_chans: int, n_layers: int = 2, kernel_size: int = 3,
                 dropout: float = 0.5, padding: str = "SAME", style: str = "espnet", *,
                 generator: torch.Generator, device=None, dtype=None):
        super().__init__()
        if style not in ("espnet", "ming024"):
            raise ValueError(f"duration predictor style must be espnet or ming024, not {style!r}")
        self.mask_between = style == "espnet"
        self.stack = ConvPredictorStack(d_in, n_chans, n_layers, kernel_size, 1,
                                        head_bias_init=1.7918,
                                        ln_eps=1e-12 if self.mask_between else 1e-5,
                                        dropout=dropout, padding=padding, generator=generator,
                                        device=device, dtype=dtype)

    def forward(self, x, mask, rng: Optional[torch.Generator] = None):
        out = self.stack(x, mask if self.mask_between else None, rng)
        return (out * mask[..., None])[..., 0]


class VariancePredictor(nn.Module):
    """Pitch/energy predictor with t2t sinusoidal positions scaled by
    ``pos_alpha``.  Positions count every row whose features are not all
    zero; padded rows carry the speaker embedding by now, so they count
    through the padding exactly as the JAX package and the reference do.
    The table is in the compute dtype; scaled by the float32 ``pos_alpha``
    the sum is float32 until the first convolution casts it, as in JAX."""

    graph_safe = True  # serve/graphs.py may capture its call

    def __init__(self, d_in: int, n_chans: int, n_layers: int, kernel_size: int, odim: int,
                 dropout: float = 0.5, *, generator: torch.Generator, device=None, dtype=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.pos_alpha = nn.Parameter(torch.ones(1, device=device))
        self.stack = ConvPredictorStack(d_in, n_chans, n_layers, kernel_size, odim,
                                        dropout=dropout, generator=generator, device=device,
                                        dtype=dtype)
        self._pos = _Positions(d_in, self.dtype, t2t_sinusoid)

    def forward(self, x, rng: Optional[torch.Generator] = None):
        pos = self._pos(x.shape[1] + 1, x.device)
        nonpad = (x.abs().sum(-1) > 0).to(torch.int64)
        positions = torch.cumsum(nonpad, dim=1) * nonpad
        return self.stack(x + self.pos_alpha * pos[positions], None, rng)


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``log_softmax`` over the last axis; in a 16-bit dtype as
    ``jax.nn.log_softmax`` composes it, each step rounded to the dtype
    (torch's fused kernel rounds once)."""
    if x.dtype not in HALF:
        return torch.log_softmax(x, dim=-1)
    shifted = x - x.max(dim=-1, keepdim=True).values.detach()
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


class AlignmentEncoder(nn.Module):
    """Gaussian-distance text/mel aligner.  ``forward`` returns (attn_soft,
    attn_logprob), both (B, T_mel, T_text): the scaled negative squared
    distance between query (mel) and key (text) projections, plus the log of
    the prior where one is given; the soft attention is its softmax over the
    valid text positions."""

    def __init__(self, d_text: int, n_mels: int, n_att_channels: int, temperature: float, *,
                 generator: torch.Generator, device=None, dtype=None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.temperature = temperature
        self.key_spk_proj = Linear(d_text, d_text, bias=False, **kw)
        self.query_spk_proj = Linear(d_text, n_mels, bias=False, **kw)
        self.key_conv1 = Conv1d(d_text, 2 * d_text, 3, **kw)
        self.key_conv2 = Conv1d(2 * d_text, n_att_channels, 1, **kw)
        self.query_conv1 = Conv1d(n_mels, 2 * n_mels, 3, **kw)
        self.query_conv2 = Conv1d(2 * n_mels, n_mels, 1, **kw)
        self.query_conv3 = Conv1d(n_mels, n_att_channels, 1, **kw)

    def forward(self, mel, txt_emb, txt_mask, attn_prior=None, spk_emb=None):
        if spk_emb is not None:
            txt_emb = txt_emb + self.key_spk_proj(spk_emb)[:, None, :]
            mel = mel + self.query_spk_proj(spk_emb)[:, None, :]
        k = self.key_conv2(torch.relu(self.key_conv1(txt_emb)))
        q = self.query_conv3(torch.relu(self.query_conv2(torch.relu(self.query_conv1(mel)))))
        q2 = torch.sum(q * q, dim=-1)[:, :, None]
        k2 = torch.sum(k * k, dim=-1)[:, None, :]
        qk = torch.einsum("bqc,bkc->bqk", q, k)
        attn = weak(-self.temperature, q.dtype) * (q2 + k2 - 2.0 * qk)
        if attn_prior is not None:
            attn = _log_softmax(attn) + torch.log(attn_prior + 1e-8)
        attn_logprob = attn
        attn = torch.where(txt_mask[:, None, :], attn, torch.full_like(attn, NEG_INF))
        return torch.softmax(attn, dim=-1), attn_logprob


def _bins(lo: float, hi: float, n: int, log: bool) -> np.ndarray:
    if log:
        return np.exp(np.linspace(np.log(max(lo, 1e-4)), np.log(hi), n)).astype(np.float32)
    return np.linspace(lo, hi, n).astype(np.float32)


class VarianceAdaptor(nn.Module):
    """Duration + phoneme- or frame-level pitch/energy, and the aligner where
    ``dm.learn_alignment`` (``aligner`` is None without it: the durations
    come from the batch)."""

    def __init__(self, n_mel_channels: int, hidden_dim: int, stats: FeatureStats, vp, ve, dm, *,
                 generator: torch.Generator, device=None, dtype=None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.stats = stats
        self.predictor_grad = vp.predictor_grad
        self.use_uv = ve.use_uv
        self.pitch_feature = ve.pitch_feature
        self.energy_feature = ve.energy_feature
        self.pitch_log = ve.pitch_quantization == "log"
        self.binarization_start_steps = dm.binarization_start_steps
        # each reference tree has its own duration predictor: follow the mode's
        if dm.learn_alignment:
            self.duration_predictor = DurationPredictor(
                hidden_dim, n_mel_channels, vp.dur_predictor_layers, vp.dur_predictor_kernel,
                vp.dropout, vp.ffn_padding, "espnet", **kw)
            self.aligner = AlignmentEncoder(hidden_dim, n_mel_channels, n_mel_channels,
                                            dm.aligner_temperature, **kw)
        else:
            self.duration_predictor = DurationPredictor(
                hidden_dim, vp.filter_size, 2, vp.dur_predictor_kernel, vp.dropout,
                vp.ffn_padding, "ming024", **kw)
            self.aligner = None
        self.pitch_predictor = VariancePredictor(
            hidden_dim, vp.filter_size, vp.pit_predictor_layers, vp.pit_predictor_kernel,
            2 if ve.use_uv else 1, vp.dropout, **kw)
        self.pitch_embedding = Embedding(ve.n_bins if ve.use_uv else ve.f0_bins, hidden_dim, **kw)
        self.energy_predictor = VariancePredictor(
            hidden_dim, vp.filter_size, vp.ener_predictor_layers, vp.ener_predictor_kernel, 1,
            vp.dropout, **kw)
        self.energy_embedding = Embedding(ve.n_bins, hidden_dim, **kw)
        self.register_buffer("pitch_bins", torch.from_numpy(_bins(
            stats.pitch_min, stats.pitch_max, ve.n_bins - 1, self.pitch_log)).to(device),
            persistent=False)
        self.register_buffer("energy_bins", torch.from_numpy(_bins(
            stats.energy_min, stats.energy_max, ve.n_bins - 1,
            ve.energy_quantization == "log")).to(device), persistent=False)

    def pitch_embed(self, x, control: float, target=None, rng: Optional[torch.Generator] = None):
        """(prediction, embedding): the embedding of ``target`` ({"f0", "uv"}
        with use_uv, else the pitch) where given, else of the prediction
        scaled by ``control``."""
        pred = self.pitch_predictor(grad_scale(x, self.predictor_grad), rng)
        if self.use_uv:
            if target is not None:
                f0s, uvs = target["f0"], target["uv"] > 0
            else:
                pred = pred * control
                f0s, uvs = pred[..., 0], pred[..., 1] > 0
            if self.pitch_log:
                f0 = 2.0 ** f0s
            else:
                f0 = f0s * self.stats.f0_std + self.stats.f0_mean
            f0 = torch.where(uvs, torch.zeros_like(f0), f0)
            return pred, self.pitch_embedding(f0_to_coarse(f0).long())
        pred = pred[..., 0]
        pitch = target if target is not None else pred * control
        return pred, self.pitch_embedding(bucketize(pitch, self.pitch_bins).long())

    def energy_embed(self, x, control: float, target=None, rng: Optional[torch.Generator] = None):
        pred = self.energy_predictor(grad_scale(x, self.predictor_grad), rng)[..., 0]
        energy = target if target is not None else pred * control
        return pred, self.energy_embedding(bucketize(energy, self.energy_bins).long())

    def add_prosody(self, x, level: str, targets=(None, None), p_control: float = 1.0,
                  e_control: float = 1.0, rng: Optional[torch.Generator] = None):
        """The pitch and energy embeddings at ``level`` added to ``x``: both
        predictors read the same base features.  Returns (x, pitch
        prediction, energy prediction), None for a feature at another level."""
        x_base, pitch_pred, energy_pred = x, None, None
        if self.pitch_feature == level:
            pitch_pred, emb = self.pitch_embed(x_base, p_control, targets[0], rng)
            x = x + emb
        if self.energy_feature == level:
            energy_pred, emb = self.energy_embed(x_base, e_control, targets[1], rng)
            x = x + emb
        return x, pitch_pred, energy_pred

    def forward(self, x, txt_emb, txt_lens, txt_mask, spk_emb, mel, mel_lens, attn_prior,
                pitch_target, energy_target, step: int,
                rng: Optional[torch.Generator] = None, duration_target=None) -> Dict:
        """The JAX adaptor's ``__call__`` with a mel target (the train and eval
        passes): the durations are ``duration_target`` (B, L) where given,
        else the aligner's through MAS; the targets are pooled per phoneme
        where the features are; with the aligner's durations the phonemes
        expand through the soft attention before ``binarization_start_steps``
        and by the hard durations after, with given durations by those.
        ``attn_soft``, ``attn_hard`` and ``attn_logprob`` are None without
        the aligner."""
        x = x + spk_emb[:, None, :]
        log_duration_prediction = self.duration_predictor(
            grad_scale(x, self.predictor_grad), txt_mask, rng)
        attn_soft = attn_hard = attn_logprob = None
        if duration_target is not None:
            duration_rounded = duration_target
        elif self.aligner is None:
            raise ValueError("a model without the aligner (learn_alignment: false) trains on "
                             "given durations: pass duration_target")
        else:
            attn_soft, attn_logprob = self.aligner(mel, txt_emb, txt_mask, attn_prior, spk_emb)
            attn_hard = monotonic_align(attn_soft, txt_lens, mel_lens)
            duration_rounded = attn_hard.sum(dim=1)
        dur_int = duration_rounded.to(torch.int32)
        T = mel.shape[1]

        pitch_prediction = energy_prediction = None
        if "phoneme_level" in (self.pitch_feature, self.energy_feature):
            mel2ph = durations_to_mel2ph(dur_int, T)

            def pool(f):
                return average_by_segments(f, mel2ph, mel_lens, x.shape[1])

            if isinstance(pitch_target, dict):
                # a phoneme is unvoiced only when all its frames are
                pitch_target = {"f0": pool(pitch_target["f0"]),
                                "uv": (pool(pitch_target["uv"]) >= 1.0 - 1e-6).float()}
            else:
                pitch_target = pool(pitch_target)
            energy_target = pool(energy_target)
            x, pitch_prediction, energy_prediction = self.add_prosody(
                x, "phoneme_level", (pitch_target, energy_target), rng=rng)

        if attn_soft is not None and step < self.binarization_start_steps:
            # soft expansion while the aligner warms up
            x = torch.einsum("btl,blh->bth", attn_soft, x.to(attn_soft.dtype))
        else:
            x, _, _ = regulate_length(x, dur_int, T)
        if attn_soft is not None:
            # JAX selects between both expansions with ``jnp.where``, which
            # promotes a 16-bit x to the attention's float32 either way
            x = x.to(torch.promote_types(x.dtype, attn_soft.dtype))
        mel_mask = sequence_mask(mel_lens, T)

        if "frame_level" in (self.pitch_feature, self.energy_feature):
            x, p, e = self.add_prosody(x, "frame_level", (pitch_target, energy_target), rng=rng)
            pitch_prediction = p if p is not None else pitch_prediction
            energy_prediction = e if e is not None else energy_prediction

        return {
            "x": x,
            "log_duration_prediction": log_duration_prediction,
            "duration_rounded": duration_rounded,
            "pitch_prediction": pitch_prediction,
            "energy_prediction": energy_prediction,
            "mel_lens": mel_lens,
            "mel_mask": mel_mask,
            "attn_soft": attn_soft,
            "attn_hard": attn_hard,
            "attn_logprob": attn_logprob,
            "pitch_target": pitch_target,
            "energy_target": energy_target,
        }
