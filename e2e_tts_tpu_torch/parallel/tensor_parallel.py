"""Tensor parallelism over the mesh's "model" axis: what XLA's SPMD
partitioner inserts into JAX's sharded steps for the megatron rules of
``parallel/sharding.py``, written out as explicit collectives, as
``data_parallel.py`` writes out the data axis.

Each rank of a model group holds plain local shards of the parameters that
``sharding.split_dim`` splits (:func:`parallelize` slices them in place and
switches the layers that own them to their split forward) and computes its
part of each split layer:

- column-parallel (attention's ``w_q``, ``w_k`` and ``w_v``, the FFN's
  ``w_1``): the replicated input enters through :func:`copy_to_model`, and
  the rank computes its output columns, adding its slice of the replicated
  bias;
- row-parallel (attention's ``fc``, the FFN's ``w_2``): the rank's partial
  product over its input columns, the sum over the group
  (:func:`reduce_from_model`), then the replicated bias once;
- gathered (the word embedding's features; the vocoder's ``conv_pre`` and
  upsampling convolutions, split on their output channels, whose outputs
  feed replicated resblocks): the rank's part, then :func:`gather_from_model`;
- a head cut across ranks (the model axis does not divide the heads): q, k
  and v are gathered, every rank attends over the whole heads, and
  :func:`scatter_to_model` hands each rank its columns for ``fc``.

Gradients (:func:`reduce_model_gradients`): a split parameter's gradient is
its shard's, on its rank alone.  A replicated parameter that each rank uses
only a slice of (the column-parallel biases; the split convolutions' ``g``
and bias) has a partial gradient on each rank, summed over the group.  A
replicated parameter that every rank uses whole has the same gradient on
every rank; the group's first rank broadcasts it, so that a backward with
atomic adds (a gather's scatter on CUDA) cannot leave the replicas a bit
apart.  The clipping norm (:func:`global_norm`) adds the split gradients'
squares over the group and counts each replicated one once.  Adam's moments
take each parameter's local shape, as JAX's dry run shards them.

Dropout draws on replicated activations only (after ``fc`` and after
``w_2``), so the ranks of a model group draw one mask: their dropout
generators are seeded by the data coordinate (``data_parallel.rank_seed``
over the data group).  Under gloo a CUDA tensor takes ``all_reduce`` and
``broadcast`` only, so a gather is an ``all_reduce`` of each rank's piece in
zeros (exact).  A group of None is one process, and every function here is
then the identity.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from .data_parallel import bucketed, reduce_gradients
from .mesh import model_group
from .sharding import axis_sizes, split_dim

SPLIT, PARTIAL, WHOLE = "split", "partial", "whole"


class ModelShard(NamedTuple):
    """A layer's place in its model group: the group, this rank in it, and
    its size."""

    group: object
    rank: int
    size: int

    def part(self, n: int) -> slice:
        """This rank's contiguous share of ``n`` (the model axis divides it)."""
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def role(p: torch.Tensor) -> str:
    """SPLIT (a local shard), PARTIAL (replicated, used in slices) or WHOLE
    (replicated, used whole): what :func:`parallelize` made of ``p``."""
    return getattr(p, "tp_role", WHOLE)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    shape = list(x.shape)
    w = shape[dim]
    shape[dim] = n * w
    out = x.new_zeros(shape)
    out.narrow(dim, r * w, w).copy_(x)
    dist.all_reduce(out, group=group)
    return out


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    w = x.shape[dim] // n
    return x.narrow(dim, r * w, w).contiguous()


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.group), None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the backward pass sums the input gradient over ``group``."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``; the backward pass is the identity."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' pieces of ``x`` along ``dim`` side by side, in rank order;
    the backward pass keeps this rank's slice of the gradient."""
    return x if group is None else _GatherFromModel.apply(x, dim % x.dim(), group)


def scatter_to_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim``; the backward pass gathers
    the ranks' gradients (the adjoint of :func:`gather_from_model`)."""
    return x if group is None else _ScatterToModel.apply(x, dim % x.dim(), group)


def local_shard(name: str, full: torch.Tensor, mesh, index: Optional[int] = None) -> torch.Tensor:
    """The shard of parameter ``name`` that the rank at model coordinate
    ``index`` holds (read from the ``DeviceMesh`` when None): its slice along
    ``split_dim``, or ``full`` where the rules replicate it."""
    d = split_dim(name, tuple(full.shape), mesh)
    if d is None:
        return full
    if index is None:
        index = mesh.get_coordinate()[list(axis_sizes(mesh)).index("model")]
    return full.chunk(axis_sizes(mesh)["model"], d)[index].contiguous()


def _mark(p: torch.Tensor, how: str, shard: Optional[ModelShard] = None, dim: int = 0) -> None:
    """``p`` takes its role; a SPLIT one becomes this rank's shard on
    ``dim`` (kept as ``p.tp_dim``)."""
    if how == SPLIT:
        with torch.no_grad():
            p.data = p.data.chunk(shard.size, dim)[shard.rank].clone()
        p.tp_dim = dim
    p.tp_role = how


def parallelize(module: torch.nn.Module, mesh) -> torch.nn.Module:
    """Split ``module`` over the mesh's model axis, in place: every
    parameter that the rules split becomes this rank's slice of it, and the
    layers that own them (``MultiHeadAttention``, ``ConvFFN``, ``Embedding``,
    the weight-normalised convolutions) compute their split forward.  A
    layer whose weights the divisibility guard replicates runs unsplit.
    Returns ``module``; the identity where the model axis has one rank.
    Build the optimizer's state after it (the moments take local shapes)."""
    from ..nn.common import Embedding, _WeightNorm
    from ..nn.transformer import ConvFFN, MultiHeadAttention

    group = model_group(mesh)
    if group is None:
        return module
    shard = ModelShard(group, dist.get_rank(group), dist.get_world_size(group))
    params = dict(module.named_parameters())
    dims = {n: split_dim(n, tuple(p.shape), mesh) for n, p in params.items()}
    done = set()

    def split(owner: str, layer, plan) -> None:
        """``plan``: (parameter path in ``layer``, role, dim) triples, taken
        when the first parameter is split by the rules."""
        names = [f"{owner}.{leaf}" if owner else leaf for leaf, _, _ in plan]
        first = dims[names[0]]
        if first is None:
            return
        for name, (_, how, dim) in zip(names, plan):
            if how == SPLIT and dims[name] != dim:
                raise NotImplementedError(f"{name}: split on {dims[name]}, where {names[0]} "
                                          f"is split on {first}")
            _mark(params[name], how, shard, dim)
            done.add(name)
        layer.tp = shard

    for owner, layer in module.named_modules():
        if isinstance(layer, MultiHeadAttention):
            split(owner, layer, [(f"{w}.weight", SPLIT, 0) for w in ("w_q", "w_k", "w_v")]
                  + [(f"{w}.bias", PARTIAL, 0) for w in ("w_q", "w_k", "w_v")]
                  + [("fc.weight", SPLIT, 1)])
        elif isinstance(layer, ConvFFN):
            split(owner, layer, [("w_1.weight", SPLIT, 0), ("w_1.bias", PARTIAL, 0),
                                 ("w_2.weight", SPLIT, 1)])
        elif isinstance(layer, Embedding):
            split(owner, layer, [("weight", SPLIT, 1)])
        elif isinstance(layer, _WeightNorm):
            split(owner, layer, [("v", SPLIT, layer.out_dim), ("g", PARTIAL, 0),
                                 ("bias", PARTIAL, 0)])
    left = [n for n, d in dims.items() if d is not None and n not in done]
    if left:
        raise NotImplementedError(f"no split forward for {left[:4]}")
    return module


def reduce_model_gradients(params: Sequence[torch.Tensor], grads: List[torch.Tensor],
                           group) -> List[torch.Tensor]:
    """The gradients made whole over the model ``group`` (in place;
    returned): PARTIAL ones summed, WHOLE ones broadcast from the group's
    first rank, SPLIT ones left as they are."""
    if group is None:
        return grads
    reduce_gradients([g for p, g in zip(params, grads) if role(p) == PARTIAL], group)
    src = dist.get_global_rank(group, 0)
    bucketed([g for p, g in zip(params, grads) if role(p) == WHOLE],
             lambda flat: dist.broadcast(flat, src=src, group=group))
    return grads


def global_norm(params: Sequence[torch.Tensor], norms: Sequence[torch.Tensor],
                group) -> torch.Tensor:
    """The norm of the whole model's gradient from each tensor's local norm:
    the split tensors' squares summed over the model ``group``, each
    replicated tensor's counted once."""
    def squares(keep):
        picked = [n for p, n in zip(params, norms) if keep(role(p) == SPLIT)]
        return (torch.stack(picked).square().sum() if picked
                else torch.zeros((), device=norms[0].device)).reshape(1)

    split = squares(lambda s: s)
    dist.all_reduce(split, group=group)
    return torch.sqrt(split + squares(lambda s: not s))[0]
