"""JAX's default random sampler, reimplemented in integer tensor ops: the
bits, ``uniform`` and ``normal`` that ``jax.random`` draws from a threefry
key, for the draws the JAX package makes from a fixed key.  The reformer's
LSH hashes with ``jax.random.normal(PRNGKey(0), (D, n_hashes, n_buckets //
2), dtype)`` in serving and in training (its train steps pass no ``lsh``
rng), so the port computes the same rotations itself
(``lsh_rotations``).

The layout is JAX's with ``jax_threefry_partitionable`` (the default since
JAX 0.5): element i of a draw of shape S hashes the 64-bit counter i,
split into (hi, lo) 32-bit words, with Threefry-2x32 (20 rounds) under the
key; its 32 random bits are the xor of the two output words, and an 8-bit
draw keeps their low byte.  ``uniform`` fills the mantissa of a float in
[1, 2) with the top bits (bfloat16 has 7 mantissa bits, so JAX draws 8
bits for it) and maps [1, 2) onto [minval, maxval); ``normal`` is
sqrt(2) erfinv(u) for u uniform on [nextafter(-1, 0), 1).

The threefry words are uint32 values held in int64 tensors with 32-bit
masks (torch's uint32 lacks shifts and xor on the CPU).  erfinv is XLA's
single-precision Giles polynomial over XLA's own log1p and log, with fused
multiply-adds (``torch.erfinv`` and ``torch.log1p`` differ from XLA's in the
last bits).  float32 and bfloat16 are covered; any other dtype raises.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry_2x32(key: Tuple[int, int], x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32, 20 rounds, of the counter words (x0, x1) under ``key``
    (two uint32 words): int64 tensors holding uint32 values in and out."""
    k0, k1 = key[0] & _M32, key[1] & _M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key_data(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)``'s two words."""
    return (seed >> 32) & _M32, seed & _M32


def random_bits(key: Tuple[int, int], bit_width: int, shape) -> torch.Tensor:
    """JAX's ``random_bits(key, bit_width, shape)`` (8 or 32 bits), as int64
    tensor values on the CPU."""
    if bit_width not in (8, 32):
        raise ValueError(f"bit_width must be 8 or 32, not {bit_width}")
    n = math.prod(shape)
    count = torch.arange(n, dtype=torch.int64)
    b0, b1 = threefry_2x32(key, count >> 32, count & _M32)
    bits = b0 ^ b1
    if bit_width == 8:
        bits = bits & 0xFF
    return bits.reshape(tuple(shape))


def _as_float(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Reinterpret uint32 (float32) or uint16 (bfloat16) values held in int64."""
    if dtype == torch.float32:
        signed = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)
        return signed.view(torch.float32)
    signed = torch.where(bits >= 2 ** 15, bits - 2 ** 16, bits).to(torch.int16)
    return signed.view(torch.bfloat16)


def _check_dtype(dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the JAX sampler covers float32 and bfloat16, not {dtype}")


def uniform(key: Tuple[int, int], shape, dtype=torch.float32, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` on the CPU."""
    _check_dtype(dtype)
    if dtype == torch.float32:
        one, nmant, rng_bits = 0x3F800000, 23, 32
    else:
        one, nmant, rng_bits = 0x3F80, 7, 8
    bits = random_bits(key, rng_bits, shape)
    floats = _as_float((bits >> (rng_bits - nmant)) | one, dtype) - torch.ones((), dtype=dtype)
    lo = torch.tensor(minval, dtype=dtype)
    hi = torch.tensor(maxval, dtype=dtype)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def _f32(c: float) -> torch.Tensor:
    return torch.tensor(c, dtype=torch.float32)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c rounded once."""
    b = b if isinstance(b, torch.Tensor) else _f32(b)
    c = c if isinstance(c, torch.Tensor) else _f32(c)
    return torch.addcmul(c.expand_as(a), a, b)


# the Cephes log polynomial that XLA's CPU backend emits for float32
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    """log of positive normal float32 values: frexp, then a degree-8
    polynomial in the mantissa, as XLA's CPU backend computes it."""
    bits = x.view(torch.int32).to(torch.int64)
    e = (((bits >> 23) & 0xFF) - 0x7E).to(torch.float32)
    m = ((bits & 0x807FFFFF) | 0x3F000000).to(torch.int32).view(torch.float32)  # [0.5, 1)
    low = m < 0.707106781186547524
    e = e - low.to(torch.float32)
    m = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    m2 = m * m
    m3 = m2 * m
    y, y1, y2 = (_fma(torch.full_like(m, _LOG_P[i]), m, _LOG_P[i + 1]) for i in (0, 3, 6))
    y, y1, y2 = _fma(y, m, _LOG_P[2]), _fma(y1, m, _LOG_P[5]), _fma(y2, m, _LOG_P[8])
    y = _fma(_fma(y, m3, y1), m3, y2) * m3
    y = y + e * -2.12194440e-4
    m = m + m2 * -0.5 + y
    return m + e * 0.693359375


# XLA's log1p: a Cephes rational for |x| < sqrt(2) - 1, log(1 + x) beyond
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p_f32(x: torch.Tensor) -> torch.Tensor:
    def poly(coefs):
        p = torch.zeros_like(x)
        for c in coefs:
            p = _fma(p, x, c)
        return p

    x2 = x * x
    small = x * x2 * (poly(_LOG1P_NUM) / poly(_LOG1P_DEN))
    small = x + _fma(x2, -0.5, small)
    large = _log_f32(torch.clamp(x + 1.0, min=torch.finfo(torch.float32).tiny))
    return torch.where(x.abs() < 0.41421356237309504880, small, large)


# XLA's ErfInv32 (Giles, "Approximating the erfinv function"): a degree-8
# polynomial in w = -log1p(-x^2) - 2.5 for w < 5, in sqrt(w) - 3 beyond
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erfinv of a float32 tensor on the CPU: its log1p and
    log, and each step of the polynomials one fused multiply-add."""
    w = -_log1p_f32(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, _f32(_ERFINV_SMALL[0]), _f32(_ERFINV_LARGE[0])).expand_as(x)
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = _fma(p, w, torch.where(small, _f32(a), _f32(b)))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: Tuple[int, int], shape, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` on the CPU.  In bfloat16 the
    uniform is drawn in bfloat16 (from 8 random bits), its erfinv taken in
    float32 and rounded."""
    _check_dtype(dtype)
    lo = float(np.nextafter(np.array(-1.0, np.float32), np.float32(0.0))) \
        if dtype == torch.float32 else -1.0 + 2.0 ** -8
    u = uniform(key, shape, dtype, lo, 1.0)
    e = erfinv_f32(u.float()).to(dtype)
    return torch.tensor(math.sqrt(2.0), dtype=dtype) * e


_TABLES: Dict[tuple, torch.Tensor] = {}


def lsh_rotations(shape, dtype, device) -> torch.Tensor:
    """``jax.random.normal(PRNGKey(0), shape, dtype)`` on ``device``, made
    once for each (shape, dtype, device) on the host and kept there."""
    key = (tuple(shape), dtype, torch.device(device))
    table = _TABLES.get(key)
    if table is None:
        table = _TABLES[key] = normal(key_data(0), shape, dtype).to(device)
    return table
