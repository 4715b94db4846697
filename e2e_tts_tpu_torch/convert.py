"""Carry a JAX parameter tree (nested dicts of numpy arrays, as a bundle's
``.msgpack`` holds them) into the port's modules.

Layouts:
- a Dense ``kernel`` (in, out) becomes a Linear ``weight`` (out, in);
- a conv ``kernel`` (k, in, out) becomes (out, in, k);
- a weight-norm conv ``{v, g}`` becomes ``g * v / max(||v||, 1e-12)``, the norm
  over (k, in) for each output channel, then (out, in, k);
- a weight-norm transposed conv ``{v, g}`` (k, in, out) becomes (in, out, k)
  with no flip: the JAX package flips the kernel inside its apply, which is
  what ``conv_transpose1d`` does by definition;
- a 2-D conv kernel (kh, kw, in, out) becomes (out, in, kh, kw).

A weight-norm pair is fused into one kernel unless the target module keeps
it: where the target's names (``names``, its ``state_dict`` keys) hold
``<conv>.v``, as the training forms of the vocoder and the discriminators
do, ``v`` takes the kernel's layout and ``g`` lands as it is.

Every array must land on a parameter or buffer of the same shape, and every
parameter and buffer must receive one (the acoustic model's aligner
included); anything else raises.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from .nn.common import fuse_weight_norm

_RENAMES = (
    (r"/layer_(\d+)/", r"/layers.\1/"),
    (r"/ln_(\d+)/LayerNorm_0/", r"/norms.\1/"),
    (r"/LayerNorm_0/", r"/layer_norm/"),
    (r"/Conv_0/", r"/"),
    (r"/bn_(\d+)/", r"/bns.\1/"),
    (r"/up_(\d+)/", r"/ups.\1/"),
    (r"/res_(\d+)_(\d+)/", r"/resblocks.\1.\2/"),
    (r"/conv1_(\d+)/", r"/convs1.\1/"),
    (r"/conv2_(\d+)/", r"/convs2.\1/"),
    (r"/conv_(\d+)/", r"/convs.\1/"),
)
_LEAVES = {"kernel": "weight", "embedding": "weight", "scale": "weight",
           "mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _torch_name(path: str) -> str:
    """'/decoder/layer_0/pos_ffn/w_1/Conv_0/kernel' -> 'decoder.layers.0.pos_ffn.w_1.weight'."""
    head, leaf = path.rsplit("/", 1)
    head += "/"
    for pat, rep in _RENAMES:
        head = re.sub(pat, rep, head)
    return (head + _LEAVES.get(leaf, leaf)).strip("/").replace("/", ".")


def _layout(name: str, leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf not in ("kernel", "v"):
        return arr
    if arr.ndim == 2:
        return arr.T  # Dense (in, out) -> Linear (out, in)
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)  # (kh, kw, in, out) -> (out, in, kh, kw)
    if ".ups." in f".{name}":
        return arr.transpose(1, 2, 0)  # (k, in, out) -> (in, out, k), no flip
    return arr.transpose(2, 1, 0)  # (k, in, out) -> (out, in, k)


def convert(variables: dict, names: Optional[Iterable[str]] = None) -> Dict[str, np.ndarray]:
    """JAX variables {"params": ..., ["batch_stats": ...]} -> {torch name: array}.
    ``names``: the target module's parameter and buffer names; a weight-norm
    pair stays (v, g) where they hold its ``v``, and is fused otherwise."""
    flat = {}
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise ValueError(f"unexpected variable collection {collection!r}")
        flat.update(_flatten(tree))
    keep = set(names or ())
    wn = {p.rsplit("/", 1)[0] for p in flat if p.endswith("/v")}
    out = {}
    for path, arr in flat.items():
        parent, leaf = path.rsplit("/", 1)
        if parent in wn and leaf in ("v", "g") and _torch_name(f"{parent}/v") not in keep:
            if leaf == "g":
                continue
            arr, path = fuse_weight_norm(arr, flat[f"{parent}/g"]), f"{parent}/kernel"
        name = _torch_name(path)
        if name in out:
            raise ValueError(f"two arrays map to {name}")
        out[name] = np.array(_layout(name, path.rsplit("/", 1)[1], arr), order="C")
    return out


def load_into(module: torch.nn.Module, variables: dict) -> int:
    """Copy JAX ``variables`` into ``module`` in place.  Returns the number of
    arrays placed.  Raises on a leftover array, a shape or dtype mismatch, or
    a parameter/buffer that received nothing."""
    state = module.state_dict()
    arrays = convert(variables, state)
    targets = set(state)
    leftover = sorted(set(arrays) - targets)
    missing = sorted(targets - set(arrays))
    if leftover or missing:
        raise ValueError(f"weights do not match the module: leftover {leftover}, "
                         f"missing {missing}")
    with torch.no_grad():
        for name in targets:
            src = torch.from_numpy(arrays[name])
            dst = state[name]
            if src.shape != dst.shape:
                raise ValueError(f"{name}: array {tuple(src.shape)} vs module {tuple(dst.shape)}")
            if src.dtype != dst.dtype:
                raise ValueError(f"{name}: array {src.dtype} vs module {dst.dtype}")
            dst.copy_(src)
    return len(targets)
