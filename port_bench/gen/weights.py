"""Seeded weights, made by the benchmark on the device and handed to both
the program and the reference.

One ``torch.randn`` call on a generator on the run's device draws every
random entry; each tensor takes its slice in the order of
``named_parameters``.  The configuration file's ``init`` block sets the
rule, by parameter name:

- a weight of a ``Linear``, ``Conv1d``, ``ConvTranspose1d`` or
  ``Embedding``: normal with std gain / sqrt(fan_in) (fan_in: inputs x
  kernel, over the stride for a transposed convolution; 1 for an
  embedding); ``gains`` maps a name suffix to its gain (default 1);
- a weight of a LayerNorm or BatchNorm, and ``pos_alpha``: 1; every bias:
  0 unless ``biases`` gives a value for its name suffix;
- BatchNorm running statistics: mean 0, variance 1.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _fan_in(module, p: torch.Tensor) -> float:
    kind = type(module).__name__
    if kind.endswith("ConvTranspose1d"):
        return p.shape[0] * p.shape[2] / module.stride
    if kind.endswith("Embedding"):
        return 1.0
    return float(math.prod(p.shape[1:]))


def _suffix_value(table: Dict[str, float], name: str, default):
    for suffix, v in table.items():
        if name.endswith(suffix):
            return v
    return default


def seeded_weights(model: torch.nn.Module, init: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device`` for every parameter and every
    BatchNorm running statistic of ``model`` (names as its ``state_dict``)."""
    gains, biases = init.get("gains", {}), init.get("biases", {})
    owners = {}
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            owners[f"{mname}.{pname}" if mname else pname] = m
    plan, n_random = [], 0
    for name, p in model.named_parameters():
        m = owners[name]
        kind = type(m).__name__
        if name.endswith("pos_alpha") or (kind.endswith(("LayerNorm", "BatchNorm"))
                                          and name.endswith(".weight")):
            plan.append((name, p.shape, "const", 1.0))
        elif name.endswith(".bias"):
            plan.append((name, p.shape, "const", float(_suffix_value(biases, name, 0.0))))
        else:
            std = _suffix_value(gains, name, 1.0) / math.sqrt(_fan_in(m, p))
            plan.append((name, p.shape, "normal", std, n_random))
            n_random += p.numel()
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(n_random, generator=g, device=device)
    out = {}
    for entry in plan:
        name, shape = entry[0], entry[1]
        if entry[2] == "const":
            out[name] = torch.full(shape, entry[3], device=device)
        else:
            std, start = entry[3], entry[4]
            out[name] = flat[start:start + math.prod(shape)].view(shape) * std
    for name, b in model.named_buffers():
        if name.endswith("running_mean"):
            out[name] = torch.zeros_like(b, device=device)
        elif name.endswith("running_var"):
            out[name] = torch.ones_like(b, device=device)
    return out


@torch.no_grad()
def load(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``model``'s parameters and running statistics;
    every parameter must be given."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(weights))
    if missing:
        raise KeyError(f"no benchmark weight for {missing[:5]}")
    for name, p in params.items():
        p.copy_(weights[name])
    for name, b in model.named_buffers():
        if name in weights:
            b.copy_(weights[name])
