"""Carry a JAX parameter tree (nested dicts of numpy arrays, as a bundle's
``.msgpack`` holds them) into the port's modules (``convert``,
``load_into``), and a port module's weights back into that tree
(``to_jax``).

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

The block families keep flax's names as module names where no rename
applies: the auto-names ``Dense_0``, ``Dense_1`` and ``BatchNorm_0`` (the
auto-named ``LayerNorm_0`` becomes ``layer_norm``), the stacks' ``attn_0``,
``ff_norm_0``, ..., and the bare parameters ``u_bias`` and ``v_bias``.  A
module tied across layers (the fastformer's pooling projections, the
reformer's shared layer) is one module, stored once.

Every array must land on a parameter or buffer of the same shape, and every
parameter and buffer must receive one (the acoustic model's aligner
included); anything else raises.

The way back cannot reverse the renames: ``/Conv_0/`` -> ``/`` erases a path
segment.  ``to_jax`` names each array from the type of the module that holds
it instead, as the JAX package's modules name their leaves: in the acoustic
model a ``Conv1d`` is flax's ``Conv`` inside a named wrapper
(``<name>/Conv_0/{kernel,bias}``) but a ``DepthwiseConv1d`` (the
conformer's) is a bare ``Conv`` (``<name>/kernel``), a ``Linear`` a ``Dense``
(``<name>/{kernel,bias}``); in a generator every convolution is weight-normed
(``<name>/{v,g,bias}``, no ``Conv_0``).  A serving generator holds fused
kernels and writes ``v = w`` and ``g = ||w||`` (the norm over every axis but
the output channel), so JAX's ``g * v / ||v||`` gives back ``w`` to rounding;
a training generator writes its (v, g) as they are.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from .nn import common
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


_MODULE_PATHS = (  # the inverse of _RENAMES, on "/"-joined module paths
    (r"/layers/(\d+)/", r"/layer_\1/"),
    (r"/norms/(\d+)/", r"/ln_\1/LayerNorm_0/"),
    (r"/layer_norm/", r"/LayerNorm_0/"),
    (r"/bns/(\d+)/", r"/bn_\1/"),
    (r"/ups/(\d+)/", r"/up_\1/"),
    (r"/resblocks/(\d+)/(\d+)/", r"/res_\1_\2/"),
    (r"/convs1/(\d+)/", r"/conv1_\1/"),
    (r"/convs2/(\d+)/", r"/conv2_\1/"),
    (r"/convs/(\d+)/", r"/conv_\1/"),
)


def _jax_module_path(name: str) -> str:
    """'decoder.layers.0.pos_ffn.w_1' -> '/decoder/layer_0/pos_ffn/w_1/'."""
    path = "/" + name.replace(".", "/") + "/" if name else "/"
    for pat, rep in _MODULE_PATHS:
        path = re.sub(pat, rep, path)
    return path


def _to_jax_layout(module, arr: np.ndarray) -> np.ndarray:
    """A kernel (or weight norm's v) from the port's layout to JAX's."""
    if isinstance(module, (common.ConvTranspose1d, common.WNConvTranspose1d)):
        return arr.transpose(2, 0, 1)  # (in, out, k) -> (k, in, out), no flip
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)  # (out, in, kh, kw) -> (kh, kw, in, out)
    return arr.transpose(2, 1, 0)  # (out, in, k) -> (k, in, out)


def _jax_leaves(module, leaf: str, arr: np.ndarray, weight_norm: bool):
    """[(collection, path below the module, array)] for one tensor."""
    if isinstance(module, common.BatchNorm):
        return [{"weight": ("params", "scale"), "bias": ("params", "bias"),
                 "running_mean": ("batch_stats", "mean"),
                 "running_var": ("batch_stats", "var")}[leaf] + (arr,)]
    if isinstance(module, torch.nn.LayerNorm):
        return [("params", {"weight": "scale", "bias": "bias"}[leaf], arr)]
    if isinstance(module, torch.nn.Embedding):
        return [("params", "embedding", arr)]
    if isinstance(module, torch.nn.Linear):
        return [("params", "kernel" if leaf == "weight" else leaf,
                 arr.T if leaf == "weight" else arr)]
    if isinstance(module, common._WeightNorm):
        return [("params", leaf, _to_jax_layout(module, arr) if leaf == "v" else arr)]
    if isinstance(module, common.DepthwiseConv1d):  # flax's nn.Conv itself, no Conv_0
        return [("params", "kernel", _to_jax_layout(module, arr))]
    if isinstance(module, (common.Conv1d, common.ConvTranspose1d)):
        if leaf == "bias":
            return [("params", "bias" if weight_norm else "Conv_0/bias", arr)]
        w = _to_jax_layout(module, arr)
        if not weight_norm:
            return [("params", "Conv_0/kernel", w)]
        g = np.linalg.norm(w.reshape(-1, w.shape[-1]), axis=0).astype(w.dtype)
        return [("params", "v", w), ("params", "g", g)]
    return [("params", leaf, arr)]  # a bare parameter (a predictor's pos_alpha)


def to_jax(module: torch.nn.Module) -> dict:
    """A port module's weights -> the JAX package's variables
    {"params": ..., ["batch_stats": ...]}: nested dicts of float32 numpy
    arrays under the JAX names, as its ``save_bundle`` writes them.  A
    generator (HiFi-GAN or iSTFTNet, serving or training form) writes
    weight-normed convolutions; any other module (the acoustic model) plain
    ones.  Raises unless ``convert`` of the result gives back every tensor
    of ``module.state_dict()`` under its own name and shape."""
    from .nn.hifigan import HifiGanGenerator, IstftNetGenerator

    weight_norm = isinstance(module, (HifiGanGenerator, IstftNetGenerator))
    state = module.state_dict()
    tree: dict = {}
    for name, tensor in state.items():
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner)
        arr = tensor.detach().cpu().numpy()
        if arr.dtype.kind == "f":
            arr = arr.astype(np.float32)
        for collection, below, a in _jax_leaves(sub, leaf, arr, weight_norm):
            path = (_jax_module_path(owner) + below).strip("/").split("/")
            node = tree.setdefault(collection, {})
            for key in path[:-1]:
                node = node.setdefault(key, {})
            if path[-1] in node:
                raise ValueError(f"two tensors map to {collection}/{'/'.join(path)}")
            node[path[-1]] = np.ascontiguousarray(a)
    back = convert(tree, [n for n in state if n.endswith(".v")])
    wrong = sorted(set(back) ^ set(state)) + sorted(
        n for n in state if n in back and tuple(back[n].shape) != tuple(state[n].shape))
    if wrong:
        raise ValueError(f"the JAX names do not map back to the module: {wrong}")
    return tree
