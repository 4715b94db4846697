"""HiFi-GAN and iSTFTNet generators (port of ``e2e_tts_tpu/nn/hifigan.py``).

Two forms of each.  The serving form (``HifiGanGenerator``,
``IstftNetGenerator``) holds plain kernels with the weight norm fused (by
``convert.py`` or ``fuse_generator``), runs under ``torch.no_grad()`` and
has no trainable parameter.  The training form (``TrainableHifiGan``,
``TrainableIstftNet``) holds the weight norm's (v, g) as parameters, one for
one with the JAX tree, and records autograd; ``fuse_generator`` turns it into
the serving form.  Both draw their weights in the same order from the same
generator, so a training form fused at init is its seed's serving form.  The
stack runs channels-first inside; the public ``forward`` takes
(B, T, n_mels) like the JAX package.

Both forms take a compute ``dtype`` (``nn/common.py``), as the JAX
generators do: the trunk runs in it, and ``conv_post`` with what follows is
a float32 island (float64 under ``.double()``).  The training form's (v, g)
stay float32 in any dtype, so its gradients and Adam moments are float32,
as JAX trains ``build_generator(config, kind, dtype=jnp.bfloat16)``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import (Conv1d, ConvTranspose1d, WNConv1d, WNConvTranspose1d, _WeightNorm,
                     compute_dtype, island, weak)

LRELU_SLOPE = 0.1
# the reference's final activation uses torch's default slope, not LRELU_SLOPE
FINAL_SLOPE = 0.01
WN_STD = 0.01  # the JAX package's weight-norm init: v ~ normal(0.01), w = v


def _lrelu(x, slope: float = LRELU_SLOPE):
    # the slope in x's dtype, as JAX's weakly typed constant
    return F.leaky_relu(x, weak(slope, x.dtype))


def _conv(weight_norm: bool, d_in: int, d_out: int, kernel_size: int, dilation: int = 1,
          dtype=None, **kw):
    """A stride-1 SAME convolution in ``dtype``: weight-normalised (training)
    or plain (serving)."""
    if weight_norm:
        return WNConv1d(d_in, d_out, kernel_size, dilation=dilation, dtype=dtype, **kw)
    return Conv1d(d_in, d_out, kernel_size, dilation, std=WN_STD, dtype=dtype, **kw)


class ResBlock1(nn.Module):
    """2-conv residual unit x len(dilations)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5), *, generator, device=None,
                 weight_norm: bool = False, dtype=None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.convs1 = nn.ModuleList(_conv(weight_norm, channels, channels, kernel_size, d, **kw)
                                    for d in dilations)
        self.convs2 = nn.ModuleList(_conv(weight_norm, channels, channels, kernel_size, 1, **kw)
                                    for _ in dilations)

    def forward(self, x):
        """(B, C, T) -> (B, C, T)."""
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2.conv_ncw(_lrelu(c1.conv_ncw(_lrelu(x))))
        return x


class ResBlock2(nn.Module):
    """1-conv residual unit x len(dilations)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3), *, generator, device=None,
                 weight_norm: bool = False, dtype=None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.convs = nn.ModuleList(_conv(weight_norm, channels, channels, kernel_size, d, **kw)
                                   for d in dilations)

    def forward(self, x):
        for c in self.convs:
            x = x + c.conv_ncw(_lrelu(x))
        return x


class _GeneratorTrunk(nn.Module):
    """conv_pre + upsample/resblock pyramid; the resblocks of a stage are averaged."""

    def __init__(self, n_mels: int, upsample_rates, upsample_kernel_sizes,
                 upsample_initial_channel: int, resblock_kernel_sizes,
                 resblock_dilation_sizes, resblock_type: int = 1, *, generator, device=None,
                 weight_norm: bool = False, dtype=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        Res = ResBlock1 if resblock_type == 1 else ResBlock2
        self.conv_pre = _conv(weight_norm, n_mels, upsample_initial_channel, 7, dtype=dtype, **kw)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch_in = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(WNConvTranspose1d(ch_in, ch, k, u, dtype=dtype, **kw) if weight_norm
                            else ConvTranspose1d(ch_in, ch, k, u, std=WN_STD, dtype=dtype, **kw))
            self.resblocks.append(nn.ModuleList(
                Res(ch, rk, tuple(rd), weight_norm=weight_norm, dtype=dtype, **kw)
                for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes)))
            ch_in = ch
        self.out_channels = ch_in

    def forward(self, x):
        """(B, n_mels, T) -> (B, C, T * prod(rates))."""
        x = self.conv_pre.conv_ncw(x)
        for up, blocks in zip(self.ups, self.resblocks):
            x = up.conv_ncw(_lrelu(x))
            acc = None
            for block in blocks:
                h = block(x)
                acc = h if acc is None else acc + h
            x = acc / len(blocks)
        return x


class HifiGanGenerator(nn.Module):
    """mel (B, T, n_mels) -> waveform (B, T * prod(rates)) in [-1, 1]."""

    graph_safe = True  # serve/graphs.py may capture its call

    weight_norm = False

    def __init__(self, n_mels: int = 80, upsample_rates: Tuple[int, ...] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4),
                 upsample_initial_channel: int = 512,
                 resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11),
                 resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 resblock_type: int = 1, *, device=None,
                 generator: Optional[torch.Generator] = None, seed: int = 0,
                 dtype=torch.float32):
        super().__init__()
        self.hparams = dict(n_mels=n_mels, upsample_rates=upsample_rates,
                            upsample_kernel_sizes=upsample_kernel_sizes,
                            upsample_initial_channel=upsample_initial_channel,
                            resblock_kernel_sizes=resblock_kernel_sizes,
                            resblock_dilation_sizes=resblock_dilation_sizes,
                            resblock_type=resblock_type)
        self.dtype = compute_dtype(dtype)
        g = generator if generator is not None else torch.Generator().manual_seed(seed)
        kw = dict(generator=g, device=device)
        self.trunk = _GeneratorTrunk(n_mels, upsample_rates, upsample_kernel_sizes,
                                     upsample_initial_channel, resblock_kernel_sizes,
                                     resblock_dilation_sizes, resblock_type,
                                     weight_norm=self.weight_norm, dtype=dtype, **kw)
        self.conv_post = _conv(self.weight_norm, self.trunk.out_channels, 1, 7, **kw)
        if not self.weight_norm:
            self.eval()
            self.requires_grad_(False)

    @classmethod
    def from_config(cls, cfg, n_mels: int = 80, **kw):
        return cls(n_mels, tuple(cfg.upsample_rates), tuple(cfg.upsample_kernel_sizes),
                   cfg.upsample_initial_channel, tuple(cfg.resblock_kernel_sizes),
                   tuple(tuple(d) for d in cfg.resblock_dilation_sizes), cfg.resblock, **kw)

    def generate(self, mel):
        x = self.trunk(mel.transpose(1, 2))
        x = self.conv_post.conv_ncw(island(_lrelu(x, FINAL_SLOPE)))
        return torch.tanh(x)[:, 0, :]

    @torch.no_grad()
    def forward(self, mel):
        return self.generate(mel)


class IstftNetGenerator(nn.Module):
    """iSTFTNet head: the trunk's two upsample stages, then a per-frame
    spectrum, magnitude ``exp`` and phase ``sin``, which
    ``models.vocoder.istft_to_audio`` inverts.  mel (B, T, n_mels) ->
    (spec, phase), each (B, n_fft // 2 + 1, T * prod(rates) + 1)."""

    graph_safe = True  # serve/graphs.py may capture its call

    weight_norm = False

    def __init__(self, n_mels: int = 80, gen_istft_n_fft: int = 16,
                 upsample_rates: Tuple[int, ...] = (8, 8),
                 upsample_kernel_sizes: Tuple[int, ...] = (16, 16),
                 upsample_initial_channel: int = 512,
                 resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11),
                 resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 resblock_type: int = 1, *, device=None,
                 generator: Optional[torch.Generator] = None, seed: int = 0,
                 dtype=torch.float32):
        super().__init__()
        self.hparams = dict(n_mels=n_mels, gen_istft_n_fft=gen_istft_n_fft,
                            upsample_rates=upsample_rates,
                            upsample_kernel_sizes=upsample_kernel_sizes,
                            upsample_initial_channel=upsample_initial_channel,
                            resblock_kernel_sizes=resblock_kernel_sizes,
                            resblock_dilation_sizes=resblock_dilation_sizes,
                            resblock_type=resblock_type)
        self.dtype = compute_dtype(dtype)
        g = generator if generator is not None else torch.Generator().manual_seed(seed)
        kw = dict(generator=g, device=device)
        self.n_fft = gen_istft_n_fft
        self.trunk = _GeneratorTrunk(n_mels, upsample_rates, upsample_kernel_sizes,
                                     upsample_initial_channel, resblock_kernel_sizes,
                                     resblock_dilation_sizes, resblock_type,
                                     weight_norm=self.weight_norm, dtype=dtype, **kw)
        self.conv_post = _conv(self.weight_norm, self.trunk.out_channels, gen_istft_n_fft + 2,
                               7, **kw)
        if not self.weight_norm:
            self.eval()
            self.requires_grad_(False)

    @classmethod
    def from_config(cls, cfg, n_mels: int = 80, **kw):
        return cls(n_mels, cfg.gen_istft_n_fft, tuple(cfg.upsample_rates),
                   tuple(cfg.upsample_kernel_sizes), cfg.upsample_initial_channel,
                   tuple(cfg.resblock_kernel_sizes),
                   tuple(tuple(d) for d in cfg.resblock_dilation_sizes), cfg.resblock, **kw)

    def generate(self, mel):
        x = island(_lrelu(self.trunk(mel.transpose(1, 2)), FINAL_SLOPE))
        # the reference's reflection pad (1, 0) on time: sample 1 in front
        x = torch.cat([x[..., 1:2], x], dim=-1)
        x = self.conv_post.conv_ncw(x)
        half = self.n_fft // 2 + 1
        return torch.exp(x[:, :half]), torch.sin(x[:, half:])

    @torch.no_grad()
    def forward(self, mel):
        return self.generate(mel)


class TrainableHifiGan(HifiGanGenerator):
    """The HiFi-GAN generator's training form: weight-normalised
    convolutions whose (v, g, bias) are parameters, a forward that records
    autograd."""

    weight_norm = True

    def forward(self, mel):
        return self.generate(mel)


class TrainableIstftNet(IstftNetGenerator):
    """The iSTFTNet generator's training form (see ``TrainableHifiGan``)."""

    weight_norm = True

    def forward(self, mel):
        return self.generate(mel)


_SERVING = {TrainableHifiGan: HifiGanGenerator, TrainableIstftNet: IstftNetGenerator}


@torch.no_grad()
def fuse_generator(trained: nn.Module) -> nn.Module:
    """The serving form of a training-form generator, on its device: each
    weight-normalised convolution's ``g * v / max(||v||, 1e-12)`` becomes the
    plain kernel (the JAX package's ``fuse_weight_norm``), biases copied."""
    device = next(trained.parameters()).device
    serving = _SERVING[type(trained)](**trained.hparams, device=device)
    state = {}
    for name, module in trained.named_modules():
        if isinstance(module, _WeightNorm):
            state[f"{name}.weight"] = module.weight()
            state[f"{name}.bias"] = module.bias
    serving.load_state_dict(state)  # strict: every kernel and bias placed
    return serving
