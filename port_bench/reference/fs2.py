"""Plain-PyTorch FastSpeech2 (Ren et al., arXiv:2006.04558) as the
configuration files state it: an encoder and a decoder of the
configuration's block family (the transformer's FFT blocks here: post-LN
multi-head self-attention, then a two-convolution feed-forward network;
any other family's stack in ``blocks/<block_type>.py``, found by name),
phoneme-level pitch (f0 with a voiced/unvoiced
logit) and energy from convolutional predictors with sinusoidal positions,
a log-duration predictor, a 5-layer convolutional postnet, and for
training the unsupervised aligner of "One TTS Alignment To Rule Them All"
(Badlani et al., arXiv:2108.10447).

Functions of a weight dict ``P`` (names as the configuration's parameter
layout), float32, with no kernel, cache or batching of the program: the
attention is a softmax over masked scores, the convolutions ``F.conv1d``.
``Dropout`` draws ``torch.rand`` masks from the generator it is given, in
the layers' order (encoder, duration, pitch, energy, decoder, postnet), so
that a generator seeded as the training state's gives the same masks.
"""

from __future__ import annotations

import importlib
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e9
F0_BIN, F0_MIN, F0_MAX = 256, 50.0, 1100.0
_F0_MEL_MIN = 1127.0 * math.log(1 + F0_MIN / 700.0)
_F0_MEL_MAX = 1127.0 * math.log(1 + F0_MAX / 700.0)


def sinusoid_table(n: int, d: int) -> np.ndarray:
    pos = np.arange(n)[:, None].astype(np.float64)
    dim = np.arange(d)[None, :]
    angle = pos / np.power(10000.0, 2 * (dim // 2) / d)
    table = np.zeros((n, d), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def t2t_sinusoid(n: int, d: int) -> np.ndarray:
    half = d // 2
    emb = np.exp(np.arange(half) * -(np.log(10000.0) / (half - 1)))
    ang = np.arange(n)[:, None] * emb[None, :]
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    table[0] = 0.0
    return table.astype(np.float32)


class Dropout:
    """Inverted dropout drawing from ``rng``; the identity when rng is None."""

    def __init__(self, rng: Optional[torch.Generator]):
        self.rng = rng

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.rng is None or rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.rng, device=x.device) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def linear(P, name, x, bias=True):
    return F.linear(x, P[f"{name}.weight"], P.get(f"{name}.bias") if bias else None)


def conv(P, name, x_nct, dilation=1):
    """SAME convolution of (B, C, T): pad (t // 2, t - t // 2), t = (k - 1) d."""
    w = P[f"{name}.weight"]
    t = (w.shape[-1] - 1) * dilation
    return F.conv1d(F.pad(x_nct, (t // 2, t - t // 2)), w, P.get(f"{name}.bias"),
                    dilation=dilation)


def layer_norm(P, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"], P[f"{name}.bias"], eps)


def fft_block(P, name, x, mask, heads, rate, drop):
    B, T, D = x.shape
    dk = D // heads
    pair = mask[:, :, None] & mask[:, None, :]
    a = f"{name}.slf_attn"
    q, k, v = (linear(P, f"{a}.{w}", x).view(B, T, heads, dk) for w in ("w_q", "w_k", "w_v"))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dk)
    s = torch.where(pair[:, None], s, torch.full_like(s, NEG_INF))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v).reshape(B, T, D)
    h = drop(linear(P, f"{a}.fc", o), rate)
    x = layer_norm(P, f"{a}.layer_norm", h + x, 1e-5) * mask[..., None]
    f = f"{name}.pos_ffn"
    h = conv(P, f"{f}.w_2", torch.relu(conv(P, f"{f}.w_1", x.transpose(1, 2)))).transpose(1, 2)
    h = drop(h, rate)
    return layer_norm(P, f"{f}.layer_norm", h + x, 1e-5) * mask[..., None]


def transformer_stack(P, prefix, x, mask, blk, n_layers, side, drop, train):
    """The transformer family: sinusoid positions added, padded rows zeroed,
    then ``fft_block`` layer by layer (no BatchNorm: ``train`` changes
    nothing)."""
    pos = torch.from_numpy(sinusoid_table(x.shape[1], x.shape[2])).to(x.device)
    x = (x + pos[None]) * mask[..., None]
    for i in range(n_layers):
        x = fft_block(P, f"{prefix}.layers.{i}", x, mask, blk[f"{side}_head"],
                      blk[f"{side}_dropout"], drop)
    return x


def block_stack(block_type: str):
    """The encoder and decoder stack of a block family: the transformer's
    here, any other's ``stack`` in ``blocks/<block_type>.py``."""
    if block_type == "transformer":
        return transformer_stack
    return importlib.import_module(f"{__package__}.blocks.{block_type}").stack


def predictor(P, name, x, n_layers, rate, drop, eps, mask=None):
    """conv -> relu -> LayerNorm -> dropout (-> mask) per layer, then a linear head."""
    for i in range(n_layers):
        x = conv(P, f"{name}.convs.{i}", x.transpose(1, 2)).transpose(1, 2)
        x = drop(layer_norm(P, f"{name}.norms.{i}", torch.relu(x), eps), rate)
        if mask is not None:
            x = x * mask[..., None]
    return linear(P, f"{name}.linear", x)


def f0_to_coarse(f0):
    f0_mel = 1127.0 * torch.log(1 + torch.clamp(f0, min=0.0) / 700.0)
    scaled = (f0_mel - _F0_MEL_MIN) * (F0_BIN - 2) / (_F0_MEL_MAX - _F0_MEL_MIN) + 1
    scaled = torch.where(f0_mel > 0, scaled, torch.ones_like(scaled))
    return torch.floor(torch.clamp(scaled, 1.0, F0_BIN - 1) + 0.5).long()


def bins(lo, hi, n):
    return torch.from_numpy(np.linspace(lo, hi, n).astype(np.float32))


class FastSpeech2:
    """The model of one configuration file on the weights ``P``."""

    def __init__(self, P: Dict[str, torch.Tensor], config: dict, stats: dict):
        self.P = P
        fs2 = config["models"]["fastspeech2"]
        block_type = fs2["building_block"]["block_type"]
        self.blk = fs2["building_block"][block_type]
        self.stack = block_stack(block_type)
        var = fs2["variance"]
        self.layers = (fs2["encoder_layers"], fs2["decoder_layers"])
        vp = var["variance_predictor"]
        self.vp = vp
        self.temperature = var["duration_modelling"]["aligner_temperature"]
        self.binarization_start = var["duration_modelling"]["binarization_start_steps"]
        self.predictor_grad = vp["predictor_grad"]
        self.n_post = fs2["postnet"]["conv_layers"]
        self.stats = stats
        ve = var["variance_embedding"]
        dev = P["mel_linear.weight"].device
        self.energy_bins = bins(stats["energy"]["min"], stats["energy"]["max"],
                                ve["n_bins"] - 1).to(dev)

    # --- blocks ------------------------------------------------------------------

    def encode(self, tokens, mask, drop, train):
        """(the encoder's output, the token embeddings the aligner reads)."""
        emb = F.embedding(tokens, self.P["encoder.src_word_emb.weight"])
        return self.stack(self.P, "encoder", emb, mask, self.blk, self.layers[0], "encoder", drop,
                          train), emb

    def decode(self, x, mask, drop, train):
        return self.stack(self.P, "decoder", x, mask, self.blk, self.layers[1], "decoder", drop,
                          train)

    def postnet(self, mel, drop, train=False):
        P, x = self.P, mel.transpose(1, 2)
        for i in range(self.n_post):
            x = conv(P, f"postnet.convs.{i}", x)
            b = f"postnet.bns.{i}"
            if train:
                mean = x.mean(dim=(0, 2))
                var = torch.clamp((x * x).mean(dim=(0, 2)) - mean * mean, min=0.0)
            else:
                mean, var = P[f"{b}.running_mean"], P[f"{b}.running_var"]
            x = ((x - mean[None, :, None]) * (torch.rsqrt(var + 1e-5) * P[f"{b}.weight"])[None, :, None]
                 + P[f"{b}.bias"][None, :, None])
            if i != self.n_post - 1:
                x = torch.tanh(x)
            x = drop(x, 0.5)
        return x.transpose(1, 2) + mel

    def durations(self, x, mask, drop):
        vp = self.vp
        return (predictor(self.P, "variance_adaptor.duration_predictor.stack", x,
                          vp["dur_predictor_layers"], vp["dropout"], drop, 1e-12, mask)
                * mask[..., None])[..., 0]

    def variance(self, name, x, drop):
        vp, P = self.vp, self.P
        pos = torch.from_numpy(t2t_sinusoid(x.shape[1] + 1, x.shape[2])).to(x.device)
        nonpad = (x.abs().sum(-1) > 0).long()
        positions = torch.cumsum(nonpad, 1) * nonpad
        x = x + P[f"variance_adaptor.{name}_predictor.pos_alpha"] * pos[positions]
        n = vp["pit_predictor_layers"] if name == "pitch" else vp["ener_predictor_layers"]
        return predictor(P, f"variance_adaptor.{name}_predictor.stack", x, n, vp["dropout"], drop,
                         1e-12)

    def pitch_index(self, f0s, uv):
        """The pitch embedding's row of normalised f0 ``f0s`` (0 where ``uv``)."""
        f0 = f0s * self.stats["f0"]["std"] + self.stats["f0"]["mean"]
        return f0_to_coarse(torch.where(uv, torch.zeros_like(f0), f0))

    def energy_index(self, energy):
        return torch.bucketize(energy, self.energy_bins, right=False)

    def pitch_embedding(self, f0s, uv):
        return F.embedding(self.pitch_index(f0s, uv),
                           self.P["variance_adaptor.pitch_embedding.weight"])

    def energy_embedding(self, energy):
        return F.embedding(self.energy_index(energy),
                           self.P["variance_adaptor.energy_embedding.weight"])

    # --- serving -----------------------------------------------------------------

    @torch.no_grad()
    def stage1(self, tokens, speakers):
        """(x after the speaker embedding (B, L, H), log durations (B, L),
        pitch prediction (B, L, 2), energy prediction (B, L), mask)."""
        lens = (tokens != 0).sum(-1)
        mask = torch.arange(tokens.shape[1], device=tokens.device)[None] < lens[:, None]
        nodrop = Dropout(None)
        x, _ = self.encode(tokens, mask, nodrop, train=False)
        x = x + F.embedding(speakers, self.P["speaker_emb.weight"])[:, None]
        log_d = self.durations(x, mask, nodrop)
        # the predictors read x through the gradient scaling, equal in value
        g = self.predictor_grad
        scaled = x * (1.0 - g) + g * x
        return (x, log_d, self.variance("pitch", scaled, nodrop),
                self.variance("energy", scaled, nodrop)[..., 0], mask)

    @torch.no_grad()
    def stage2(self, x, pitch_pred, energy_pred, durations, T):
        """x (B, L, H) with the phoneme-level pitch and energy of the given
        predictions, expanded by ``durations`` to T frames, decoded: the
        postnet mel (B, T, n_mels) and the mel lengths."""
        x = x + self.pitch_embedding(pitch_pred[..., 0], pitch_pred[..., 1] > 0)
        x = x + self.energy_embedding(energy_pred)
        cs = torch.cumsum(durations, -1)
        t = torch.arange(T, device=x.device)[None].expand(x.shape[0], -1).contiguous()
        mel2ph = torch.clamp(torch.searchsorted(cs.contiguous(), t, right=True), max=x.shape[1] - 1)
        xm = torch.gather(x, 1, mel2ph[..., None].expand(-1, -1, x.shape[-1]))
        mel_lens = torch.clamp(durations.sum(-1), max=T)
        mask = t < mel_lens[:, None]
        nodrop = Dropout(None)
        dec = self.decode(xm * mask[..., None], mask, nodrop, train=False)
        mel = linear(self.P, "mel_linear", dec)
        return self.postnet(mel, nodrop), mel_lens

    # --- training ----------------------------------------------------------------

    def aligner(self, mel, txt_emb, txt_mask, prior, spk):
        P, a = self.P, "variance_adaptor.aligner"
        txt_emb = txt_emb + F.linear(spk, P[f"{a}.key_spk_proj.weight"])[:, None]
        mel = mel + F.linear(spk, P[f"{a}.query_spk_proj.weight"])[:, None]
        k = conv(P, f"{a}.key_conv2", torch.relu(conv(P, f"{a}.key_conv1", txt_emb.transpose(1, 2))))
        q = conv(P, f"{a}.query_conv1", mel.transpose(1, 2))
        q = conv(P, f"{a}.query_conv3", torch.relu(conv(P, f"{a}.query_conv2", torch.relu(q))))
        k, q = k.transpose(1, 2), q.transpose(1, 2)
        dist = (q * q).sum(-1)[:, :, None] + (k * k).sum(-1)[:, None, :] - 2.0 * torch.einsum(
            "bqc,bkc->bqk", q, k)
        logprob = torch.log_softmax(-self.temperature * dist, -1) + torch.log(prior + 1e-8)
        soft = torch.softmax(torch.where(txt_mask[:, None], logprob,
                                         torch.full_like(logprob, NEG_INF)), -1)
        return soft, logprob

    def train_forward(self, batch, step, rng, hard):
        """The training pass of one batch: the outputs the losses read.
        ``hard`` (B, T, L) is the hard alignment the durations come from (None:
        the reference's own)."""
        P, drop = self.P, Dropout(rng)
        dev = batch["mel"].device
        txt_mask = torch.arange(batch["texts"].shape[1], device=dev)[None] < batch["txt_lens"][:, None]
        T = batch["mel"].shape[1]
        mel_mask = torch.arange(T, device=dev)[None] < batch["mel_lens"][:, None]
        x, emb = self.encode(batch["texts"], txt_mask, drop, train=True)
        spk = F.embedding(batch["speakers"], P["speaker_emb.weight"])
        x = x + spk[:, None]
        g = self.predictor_grad
        scaled = x.detach() * (1.0 - g) + g * x
        log_d = self.durations(scaled, txt_mask, drop)
        soft, logprob = self.aligner(batch["mel"], emb, txt_mask, batch["prior"], spk)
        if hard is None:
            from .training import monotonic_alignment

            hard = monotonic_alignment(soft.detach(), batch["txt_lens"], batch["mel_lens"])
        dur = hard.sum(1)
        cs = torch.cumsum(dur.long(), -1)
        t = torch.arange(T, device=x.device)[None].expand(x.shape[0], -1).contiguous()
        mel2ph = torch.clamp(torch.searchsorted(cs.contiguous(), t, right=True), max=x.shape[1] - 1)
        onehot = F.one_hot(mel2ph, x.shape[1]).float() * mel_mask[..., None].float()
        count = torch.clamp(onehot.sum(1), min=1.0)

        def pool(f):
            return torch.einsum("btl,bt->bl", onehot, f) / count

        f0_t = pool(batch["f0"])
        uv_t = (pool(batch["uv"]) >= 1.0 - 1e-6).float()
        energy_t = pool(batch["energy"])
        pitch_pred = self.variance("pitch", scaled, drop)
        x = x + self.pitch_embedding(f0_t, uv_t > 0)
        energy_pred = self.variance("energy", scaled, drop)[..., 0]
        x = x + self.energy_embedding(energy_t)
        if step < self.binarization_start:
            x = torch.einsum("btl,blh->bth", soft, x)
        else:
            x = torch.gather(x, 1, mel2ph[..., None].expand(-1, -1, x.shape[-1])) * mel_mask[..., None]
        dec = self.decode(x, mel_mask, drop, train=True)
        mel = linear(P, "mel_linear", dec)
        post = self.postnet(mel, drop, train=True)
        return dict(mel=mel, postnet=post, log_d=log_d, dur=dur, pitch=pitch_pred, energy=energy_pred,
                    f0_t=f0_t, uv_t=uv_t, energy_t=energy_t, soft=soft, logprob=logprob, hard=hard,
                    txt_mask=txt_mask, mel_mask=mel_mask)
