"""Shared nn primitives (port of ``e2e_tts_tpu/nn/common.py``).

Public modules take and return (B, T, C) like the JAX package; convolutions
also offer ``conv_ncw`` for callers that keep (B, C, T) inside a stack.
Parameters are created on ``device`` from an explicit ``torch.Generator``
(on the CPU, so one seed gives the same weights on every device).

``dtype`` is the compute type, as flax's: the parameters stay float32, and
with ``torch.bfloat16`` or ``torch.float16`` a module computes with its
input and its weights in that type (a product rounds once, the bias is
added in the type, as flax's ``Dense`` and ``Conv``; ``cast_param`` keeps
the cast weights while serving); ``LayerNorm`` takes its statistics in
float32 and rounds the result.  With float32 (the default) nothing is cast,
so a module computes in its parameters' own type: float32, or float64 after
``.double()``.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.tensor_parallel import copy_to_model, gather_from_model


HALF = (torch.bfloat16, torch.float16)


def compute_dtype(dtype) -> Optional[torch.dtype]:
    """What a module casts its input and weights to: None (the parameters'
    own type) for float32 or None, else the 16-bit ``dtype``."""
    if dtype in (None, torch.float32):
        return None
    if dtype not in HALF:
        raise TypeError(f"compute dtype must be float32, bfloat16 or float16, not {dtype}")
    return dtype


def cast(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` in the compute dtype (unchanged for None)."""
    return x if dtype is None else x.to(dtype)


def cast_param(module: nn.Module, name: str) -> Optional[torch.Tensor]:
    """The parameter ``name`` of ``module`` in its compute dtype.  Without
    autograd (serving) the cast copy is kept and made again only when the
    parameter changes (its storage or its version: a load or an in-place
    update), so a request does not cast every weight anew; with autograd the
    cast is made at each call, so that gradients reach the float32 parameter."""
    p = getattr(module, name)
    if p is None or module.dtype is None:
        return p
    if torch.is_grad_enabled():
        return p.to(module.dtype)
    key = (p.data_ptr(), p._version, module.dtype)
    cache = module.__dict__.setdefault("_cast_cache", {})
    hit = cache.get(name)
    if hit is None or hit[0] != key:
        hit = cache[name] = (key, p.detach().to(module.dtype))
    return hit[1]


def weak(c: float, dtype: torch.dtype) -> float:
    """The Python constant ``c`` as JAX applies it to an array of ``dtype``:
    a weakly typed scalar takes the array's type, so next to a bfloat16
    array 0.9 is 0.8984375 (torch would keep it in float32)."""
    return torch.tensor(c, dtype=dtype).item()


def island(x: torch.Tensor) -> torch.Tensor:
    """``x`` in at least float32: the JAX package's float32 islands under a
    16-bit compute dtype (``mel_linear``, the postnet, the vocoders' last
    convolution); float64 stays float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def grad_scale(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """Identity in value; the gradient reaches ``x`` scaled by ``alpha``.  On
    a 16-bit ``x`` it is the JAX package's arithmetic as XLA runs it: both
    products rounded to the dtype with the constants in the dtype
    (``weak``), their sum left in float32 for the consumer to cast."""
    if x.dtype not in HALF:
        return x.detach() * (1.0 - alpha) + alpha * x
    return (island(x.detach() * weak(1.0 - alpha, x.dtype))
            + island(x * weak(alpha, x.dtype)))


def dropout(x: torch.Tensor, rate: float, rng: Optional[torch.Generator]) -> torch.Tensor:
    """flax's Dropout: each element kept where a uniform draw from ``rng`` (a
    generator on ``x``'s device) falls below 1 - rate, and scaled by
    1 / (1 - rate).  The identity when ``rng`` is None (deterministic) or the
    rate is 0."""
    if rng is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=rng, device=x.device) < keep_prob
    return torch.where(keep, x / weak(keep_prob, x.dtype), torch.zeros_like(x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu``: the tanh approximation (torch's default is the erf
    form)."""
    return F.gelu(x, approximate="tanh")


_RECOMPUTE = threading.local()


def recomputing() -> bool:
    """True while ``remat`` recomputes a layer in the backward pass: a
    BatchNorm then leaves its running statistics alone (the forward pass
    moved them once already)."""
    return getattr(_RECOMPUTE, "on", False)


@contextlib.contextmanager
def _recompute(rng: Optional[torch.Generator], state: Optional[torch.Tensor]):
    before = None
    if rng is not None:
        before = rng.get_state()
        rng.set_state(state)
    was = recomputing()
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = was
        if rng is not None:
            rng.set_state(before)


def remat(fn, *args, rng: Optional[torch.Generator] = None):
    """``fn(*args)`` with its activations recomputed in the backward pass
    instead of kept (``torch.utils.checkpoint``), as the JAX package's
    ``nn.remat`` of a layer; without autograd a plain call.  The recompute
    draws its dropout masks again from ``rng`` (the generator the layer
    draws from), which is set back to its state at the forward call for the
    recompute and restored after it, so the masks and hence the gradients
    are the forward pass's.  torch's own ``preserve_rng_state`` covers only
    the global generators, not an explicit one."""
    if not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import checkpoint

    state = rng.get_state() if rng is not None else None
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), _recompute(rng, state)))


def run_layers(layers, recompute: bool, x, *args, rng: Optional[torch.Generator] = None):
    """``x = layer(x, *args, rng)`` through ``layers`` in turn, each one
    recomputed in the backward pass (``remat``) when ``recompute``."""
    for layer in layers:
        x = remat(layer, x, *args, rng, rng=rng) if recompute else layer(x, *args, rng)
    return x


def sinusoid_table(n_position: int, d_hid: int) -> np.ndarray:
    """Interleaved sin/cos positional table (sin on even dims, cos on odd)."""
    pos = np.arange(n_position)[:, None].astype(np.float64)
    dim = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000.0, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def t2t_sinusoid(n_position: int, d_hid: int) -> np.ndarray:
    """tensor2tensor-style [sin | cos] table with a zero row 0 (padding)."""
    half = d_hid // 2
    emb = np.exp(np.arange(half) * -(np.log(10000.0) / (half - 1)))
    ang = np.arange(n_position)[:, None] * emb[None, :]
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    if d_hid % 2 == 1:
        table = np.concatenate([table, np.zeros((n_position, 1))], axis=1)
    table[0] = 0.0
    return table.astype(np.float32)


def fuse_weight_norm(v: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Weight norm baked into a plain kernel: ``g * v / max(||v||, 1e-12)``
    with the norm over every axis but the last (the output channel), as the
    JAX package applies it to (k, in, out) kernels."""
    v = np.asarray(v, np.float32)
    norm = np.linalg.norm(v.reshape(-1, v.shape[-1]), axis=0)
    return (v * (np.asarray(g, np.float32) / np.maximum(norm, 1e-12))).astype(np.float32)


def _normal(shape, std: float, generator: torch.Generator, device) -> torch.Tensor:
    return (torch.randn(shape, generator=generator) * std).to(device)


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor], view=(-1,)) -> torch.Tensor:
    return y if bias is None else y + bias.view(view)


def _bias(module: nn.Module, which) -> Optional[torch.Tensor]:
    """The bias a layer adds, in its compute dtype: its own (``which``
    True), none (False), or a slice of it (a rank's columns under tensor
    parallelism, ``parallel/tensor_parallel``)."""
    if which is False:
        return None
    b = cast_param(module, "bias")
    return b if which is True or b is None else b[which]


class Linear(nn.Linear):
    """Dense layer with lecun-normal weights and zero bias by default."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, *,
                 generator: torch.Generator, device=None, bias_init: float = 0.0, dtype=None):
        super().__init__(d_in, d_out, bias=bias, device=device)
        self.dtype = compute_dtype(dtype)
        with torch.no_grad():
            self.weight.copy_(_normal((d_out, d_in), 1.0 / math.sqrt(d_in), generator, device))
            if bias:
                self.bias.fill_(bias_init)

    def forward(self, x: torch.Tensor, bias=True) -> torch.Tensor:
        """``bias``: the layer's own (True), none (False) or a slice of it."""
        if self.dtype is None:
            return F.linear(x, self.weight, _bias(self, bias))
        y = F.linear(x.to(self.dtype), cast_param(self, "weight"))
        return _add_bias(y, _bias(self, bias))


class Embedding(nn.Embedding):
    """Lookup table with normal(std) rows; ``zero_row0`` zeroes the padding
    row.  The rows come out in ``dtype`` (flax looks them up in float32 and
    its callers cast).  Split over a model group (``tp``, set by
    ``parallel/tensor_parallel.parallelize``), the weight holds this rank's
    features, and the rows are gathered."""

    tp = None

    def __init__(self, n: int, d: int, *, generator: torch.Generator, device=None,
                 std: Optional[float] = None, zero_row0: bool = False, dtype=None):
        super().__init__(n, d, device=device)
        self.dtype = compute_dtype(dtype)
        with torch.no_grad():
            w = _normal((n, d), 1.0 / math.sqrt(d) if std is None else std, generator, device)
            if zero_row0:
                w[0] = 0.0
            self.weight.copy_(w)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        rows = F.embedding(ids, self.weight if self.dtype is None else cast_param(self, "weight"))
        return rows if self.tp is None else gather_from_model(rows, -1, self.tp.group)


class Conv1d(nn.Module):
    """1-D convolution with the JAX package's padding: "SAME" (the default)
    is asymmetric for even effective kernels, (total // 2, total - total // 2)
    with total = (kernel_size - 1) * dilation; "CAUSAL" pads all of total on
    the left, so an output sees no later input.  Weight (out, in, k).

    In float32 on CUDA under autograd (training; serving runs without
    autograd) an ungrouped convolution is an unfold and one float32 product
    (``conv1d_unfold``), whose forward and gradients are cuBLAS products
    in float32: cuDNN's float32 convolutions at k = 9 lie 4.62x the CPU's
    distance from float64, which put one e2e gradient past the float64
    oracle's bar (ROADMAP C1).  ``UNFOLD_TRAINING = False`` gives cuDNN's."""

    UNFOLD_TRAINING = True

    def __init__(self, d_in: int, d_out: int, kernel_size: int, dilation: int = 1,
                 bias: bool = True, *, generator: torch.Generator, device=None,
                 std: Optional[float] = None, dtype=None, padding: str = "SAME"):
        super().__init__()
        self.dilation = dilation
        self.dtype = compute_dtype(dtype)
        total = (kernel_size - 1) * dilation
        pads = {"SAME": (total // 2, total - total // 2), "CAUSAL": (total, 0)}
        if padding not in pads:
            raise ValueError(f"padding must be SAME or CAUSAL, not {padding!r}")
        self.pad = pads[padding]
        std = 1.0 / math.sqrt(d_in * kernel_size) if std is None else std
        self.weight = nn.Parameter(_normal((d_out, d_in, kernel_size), std, generator, device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device)) if bias else None
        self.groups = 1

    def conv_ncw(self, x: torch.Tensor, bias=True) -> torch.Tensor:
        """(B, C_in, T) -> (B, C_out, T).  ``bias``: the layer's own (True),
        none (False) or a slice of it."""
        dt, groups = self.dtype, self.groups
        if dt is None:
            b = _bias(self, bias)
            if (self.UNFOLD_TRAINING and x.is_cuda and x.dtype == torch.float32 and groups == 1
                    and torch.is_grad_enabled()):
                return conv1d_unfold(F.pad(x, self.pad), self.weight, b, self.dilation)
            return F.conv1d(F.pad(x, self.pad), self.weight, b, dilation=self.dilation,
                            groups=groups)
        y = F.conv1d(F.pad(x.to(dt), self.pad), cast_param(self, "weight"),
                     dilation=self.dilation, groups=groups)
        return _add_bias(y, _bias(self, bias), (-1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C_in) -> (B, T, C_out)."""
        return self.conv_ncw(x.transpose(1, 2)).transpose(1, 2)


def conv1d_unfold(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                  dilation: int = 1) -> torch.Tensor:
    """An unpadded ungrouped ``F.conv1d`` of (B, C_in, T) as an unfold and one
    ``torch.matmul`` (autograd differentiates both; full float32 products
    while ``torch.backends.cuda.matmul.allow_tf32`` is off, PyTorch's
    default)."""
    c_out, c_in, k = weight.shape
    cols = F.unfold(x.unsqueeze(2), (1, k), dilation=(1, dilation))  # (B, C_in * k, T_out)
    y = torch.matmul(weight.reshape(c_out, c_in * k), cols)
    return y if bias is None else y + bias[:, None]


class DepthwiseConv1d(Conv1d):
    """A depthwise 1-D convolution, "SAME" padding, no bias: flax's bare
    ``nn.Conv(C, (k,), feature_group_count=C, use_bias=False)`` (no
    ``Conv_0`` wrapper, so ``convert.to_jax`` writes its ``kernel`` at the
    module's own path).  JAX's (k, 1, C) kernel is (C, 1, k) here."""

    def __init__(self, d: int, kernel_size: int, *, generator: torch.Generator, device=None,
                 dtype=None):
        super().__init__(1, d, kernel_size, bias=False, generator=generator, device=device,
                         std=1.0 / math.sqrt(kernel_size), dtype=dtype)
        self.groups = d


class ConvTranspose1d(nn.Module):
    """Transposed conv with padding (k - u) // 2, so T frames become T * u
    samples.  Weight (in, out, k), as torch's ``conv_transpose1d`` takes it."""

    def __init__(self, d_in: int, d_out: int, kernel_size: int, stride: int, *,
                 generator: torch.Generator, device=None, std: float = 0.01, dtype=None):
        super().__init__()
        self.stride = stride
        self.dtype = compute_dtype(dtype)
        self.padding = (kernel_size - stride) // 2
        self.weight = nn.Parameter(_normal((d_in, d_out, kernel_size), std, generator, device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device))

    def conv_ncw(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if dt is None:
            return F.conv_transpose1d(x, self.weight, self.bias, stride=self.stride,
                                      padding=self.padding)
        y = F.conv_transpose1d(x.to(dt), cast_param(self, "weight"), stride=self.stride,
                               padding=self.padding)
        return _add_bias(y, cast_param(self, "bias"), (-1, 1))


def same_padding(length: int, kernel_size: int, stride: int = 1, dilation: int = 1):
    """XLA's SAME padding of a ``length``-long axis: ceil(length / stride)
    outputs, the pad split (total // 2, total - total // 2)."""
    eff = (kernel_size - 1) * dilation + 1
    total = max((-(-length // stride) - 1) * stride + eff - length, 0)
    return total // 2, total - total // 2


class _ConvTranspose1dHalfCPU(torch.autograd.Function):
    """``F.conv_transpose1d`` of 16-bit CPU tensors whose input gradient, the
    adjoint strided convolution, is computed in float32 from the 16-bit
    operands and rounded once, as a 16-bit convolution does: PyTorch's CPU
    (oneDNN) bfloat16 convolution at stride > 1 gives a wrong result (as far
    from float64 as the result's own size at HiFi-GAN's upsampling shapes),
    and the transposed convolution's backward is one."""

    @staticmethod
    def forward(ctx, x, w, stride: int, padding: int):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding)
        return F.conv_transpose1d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding = ctx.conf
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = F.conv1d(gy.float(), w.float(), stride=stride, padding=padding).to(gy.dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.ops.aten.convolution_backward(
                gy, x, w, None, [stride], [padding], [1], True, [0], 1, [False, True, False])[1]
        return gx, gw, None, None


class _WeightNorm(nn.Module):
    """Weight norm as trainable parameters, one for one with the JAX
    package's leaves: ``v`` (normal(0.01) from ``generator``), ``g`` (``||v||``
    at init) and ``bias`` (zeros).  The kernel is
    ``w = g * v / max(||v||, 1e-12)``, the norm taken for each output channel
    over every other axis (``norm_dims``), as JAX takes it over all but the
    last axis of its (..., in, out) kernel.  Autograd and the optimizer see v
    and g, never w.  In a 16-bit compute ``dtype`` the kernel is made in
    float32 and cast, and the input, the product and the bias are in the
    dtype, as the JAX modules' ``astype(self.dtype)``.

    Split over a model group (``tp``, set by
    ``parallel/tensor_parallel.parallelize``), ``v`` holds this rank's output
    channels, which take their slices of the replicated ``g`` and bias (the
    norm is per output channel, so it stays local); the input enters through
    ``copy_to_model`` and the output channels are gathered."""

    tp = None

    def __init__(self, shape, out_dim: int, *, generator: torch.Generator, device=None,
                 std: float = 0.01, dtype=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.out_dim = out_dim
        self.norm_dims = tuple(i for i in range(len(shape)) if i != out_dim)
        v = _normal(shape, std, generator, device)
        self.v = nn.Parameter(v)
        self.g = nn.Parameter(torch.linalg.vector_norm(v, dim=self.norm_dims))
        self.bias = nn.Parameter(torch.zeros(shape[out_dim], device=device))

    def _mine(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (per output channel) cut to this rank's channels."""
        return t if self.tp is None else t[self.tp.part(t.shape[0])]

    def weight(self) -> torch.Tensor:
        norm = torch.linalg.vector_norm(self.v, dim=self.norm_dims, keepdim=True)
        view = [1] * self.v.dim()
        view[self.out_dim] = -1
        return self.v * (self._mine(self.g).view(view) / torch.clamp(norm, min=1e-12))

    def _operands(self, x: torch.Tensor):
        """(input, kernel, bias) in the compute dtype; a split layer's input
        through ``copy_to_model``."""
        if self.tp is not None:
            x = copy_to_model(x, self.tp.group)
        w, b = self.weight(), self._mine(self.bias)
        if self.dtype is None:
            return x, w, b
        return x.to(self.dtype), w.to(self.dtype), b.to(self.dtype)

    def _gathered(self, y: torch.Tensor) -> torch.Tensor:
        """A split layer's (B, C_out / m, ...) output gathered on channels."""
        return y if self.tp is None else gather_from_model(y, 1, self.tp.group)


class WNConv1d(_WeightNorm):
    """Weight-normalised 1-D convolution (the JAX ``WNConv1d``), ``v`` as
    (out, in / groups, k).  ``padding`` is "SAME" (XLA's, asymmetric for even
    effective kernels) or an explicit (left, right)."""

    def __init__(self, d_in: int, d_out: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1, padding="SAME", *,
                 generator: torch.Generator, device=None, dtype=None):
        super().__init__((d_out, d_in // groups, kernel_size), 0, generator=generator,
                         device=device, dtype=dtype)
        self.kernel_size, self.stride, self.dilation, self.groups = (
            kernel_size, stride, dilation, groups)
        self.padding = padding if isinstance(padding, str) else tuple(padding)

    def conv_ncw(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C_in, T) -> (B, C_out, T_out)."""
        left, right = (same_padding(x.shape[-1], self.kernel_size, self.stride, self.dilation)
                       if self.padding == "SAME" else self.padding)
        if left != right:
            x, left = F.pad(x, (left, right)), 0
        x, w, b = self._operands(x)
        conf = (self.stride, left, self.dilation, self.groups)
        if w.dtype in HALF:  # the product rounded, then the bias added and rounded, as JAX
            return self._gathered(_add_bias(F.conv1d(x, w, None, *conf), b, (-1, 1)))
        return self._gathered(F.conv1d(x, w, b, *conf))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C_in) -> (B, T_out, C_out)."""
        return self.conv_ncw(x.transpose(1, 2)).transpose(1, 2)


class WNConvTranspose1d(_WeightNorm):
    """Weight-normalised transposed convolution (the JAX
    ``WNConvTranspose1d``): ``v`` as (in, out, k), the layout
    ``conv_transpose1d`` takes, so the norm runs over dims (0, 2), not
    torch ``weight_norm``'s default dim 0.  Padding (k - u) // 2: T frames
    become T * u samples."""

    def __init__(self, d_in: int, d_out: int, kernel_size: int, stride: int, *,
                 generator: torch.Generator, device=None, dtype=None):
        super().__init__((d_in, d_out, kernel_size), 1, generator=generator, device=device,
                         dtype=dtype)
        self.stride = stride
        self.padding = (kernel_size - stride) // 2

    def conv_ncw(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = self._operands(x)
        if w.dtype not in HALF:
            return self._gathered(F.conv_transpose1d(x, w, b, stride=self.stride,
                                                     padding=self.padding))
        if not x.is_cuda and torch.is_grad_enabled() and w.requires_grad:
            y = _ConvTranspose1dHalfCPU.apply(x, w, self.stride, self.padding)
        else:
            y = F.conv_transpose1d(x, w, stride=self.stride, padding=self.padding)
        return self._gathered(_add_bias(y, b, (-1, 1)))  # bias after the rounded product, as JAX


class WNConv2d(_WeightNorm):
    """Weight-normalised 2-D convolution over NCHW (the JAX discriminators'
    ``WNConv2d``, NHWC there), ``v`` as (out, in, kh, kw); ``padding`` is
    ((top, bottom), (left, right))."""

    def __init__(self, d_in: int, d_out: int, kernel_size, stride=(1, 1),
                 padding=((0, 0), (0, 0)), *, generator: torch.Generator, device=None):
        super().__init__((d_out, d_in, *kernel_size), 0, generator=generator, device=device)
        self.stride = tuple(stride)
        (top, bottom), (left, right) = padding
        if top != bottom or left != right:
            raise ValueError(f"asymmetric 2-D padding {padding} is not supported")
        self.padding = (top, left)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C_in, H, W) -> (B, C_out, H_out, W_out)."""
        return F.conv2d(x, self.weight(), self.bias, stride=self.stride, padding=self.padding)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the feature axis with the eps passed in.  In a 16-bit
    ``dtype`` it is flax's: the statistics in float32 as E[x^2] - E[x]^2
    (clamped at 0), scale and bias applied in float32, one rounding."""

    def __init__(self, d: int, eps: float, device=None, dtype=None):
        super().__init__(d, eps=eps, device=device)
        self.dtype = compute_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return super().forward(x)
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype)


class BatchNorm(nn.Module):
    """flax's BatchNorm over (B, C, T), channels on axis 1.  With ``train``
    it normalises by the batch's mean and biased variance, the latter as
    max(0, E[x^2] - E[x]^2), and moves the running statistics by
    ``ra = 0.99 ra + 0.01 stat`` (torch's BatchNorm1d uses momentum 0.1 and
    the unbiased variance); without, it uses the running statistics.  The
    flag is an argument, as flax's ``use_running_average``, so that serving
    never touches the statistics whatever the module's mode.  ``channels_last``
    takes (B, T, C), as flax's default layout, normalising over every axis
    but the features (padded frames included).  While ``remat`` recomputes
    a layer the running statistics stay as the forward pass left them.

    ``group`` (a process group, ``parallel/data_parallel.set_batchnorm_group``)
    makes the batch statistics those of the rows of every rank in it, as
    JAX's BatchNorm normalises over the global batch of a sharded step: the
    sums, sums of squares and counts are reduced over the group by a
    differentiable ``all_reduce``."""

    MOMENTUM = 0.99

    def __init__(self, d: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.group = None
        self.weight = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))
        self.register_buffer("running_mean", torch.zeros(d, device=device))
        self.register_buffer("running_var", torch.ones(d, device=device))

    def forward(self, x: torch.Tensor, train: bool = False,
                channels_last: bool = False) -> torch.Tensor:
        dims, view = ((0, 1), (1, 1, -1)) if channels_last else ((0, 2), (1, -1, 1))
        if train:
            mean, var = self._batch_stats(x, dims)
            if not recomputing():
                with torch.no_grad():
                    m = self.MOMENTUM
                    self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(view)) * mul.view(view) + self.bias.view(view)

    def _batch_stats(self, x: torch.Tensor, dims):
        """The mean and biased variance over ``dims`` (and over the group's
        rows)."""
        if self.group is None:
            mean = x.mean(dim=dims)
            return mean, torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
        from torch.distributed.nn.functional import all_reduce

        d = x.shape[1] if dims == (0, 2) else x.shape[2]  # the channels
        count = x.new_full((1,), x.numel() // d)
        stats = all_reduce(torch.cat([x.sum(dim=dims), (x * x).sum(dim=dims), count]),
                           group=self.group)
        mean, sq = stats[:d] / stats[-1], stats[d:2 * d] / stats[-1]
        return mean, torch.clamp(sq - mean * mean, min=0.0)
