"""The global step over a data group: what XLA's partitioner inserts into
JAX's sharded step, written out for N PyTorch ranks that each compute on
their own rows.

JAX partitions one global program, so its sharded train step is exactly the
step on the whole batch.  Here each rank runs the step on its rows of the
global batch (every rank builds the same global batch from the same seed
and keeps its rows: ``parallel/sharding.shard_batch``), and these pieces make
the N local steps one global step:

- the loss: each rank's loss is its share of the global loss, local sums
  over global normalisers (``models/acoustic_loss``: the counts of valid
  frames, phonemes, voiced phonemes, words and alignment cells in one
  ``all_reduce``), means over rows divided by the group's size;
- the gradients: summed over the group (:func:`reduce_gradients`, in flat
  buckets to keep the collectives few) before clipping and Adam, so every
  rank applies the same update to the same parameters;
- BatchNorm: a module given the group (:func:`set_batchnorm_group`) reduces
  its sum, sum of squares and count over it through
  ``torch.distributed.nn.functional.all_reduce``, so that the gradient flows
  through the global statistics; the running statistics then move the same
  way on every rank;
- the logged metrics: the sum of the ranks' shares (:func:`reduce_metrics`);
- random draws: dropout masks come from a generator seeded with the seed
  plus the rank (:func:`rank_seed`), so the rows of each rank draw their own
  masks; draws made once for the whole batch (the e2e step's crop starts)
  come from a generator with the same seed on every rank, drawn at the global
  batch's size, each rank keeping its rows.

An explicit reduction after ``backward`` and not ``DistributedDataParallel``:
the GAN steps run two optimizers over several backward passes, which DDP's
hooks do not fit, and an explicit sum is the global step JAX computes.
A group of None is one process, and every function here is then the
identity.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

BUCKET_BYTES = 32 << 20  # one all_reduce per 32 MiB of gradients


def data_group(mesh):
    """The process group of the mesh's "data" axis, or None where the axis
    has one rank (one process: nothing to reduce)."""
    if mesh is None or mesh.get_coordinate() is None:
        return None
    group = mesh.get_group("data")
    return group if dist.get_world_size(group) > 1 else None


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def rank_seed(seed: int, group) -> int:
    """The dropout generator's seed on this rank: ``seed`` plus its rank in
    the group (``seed`` in one process)."""
    return seed + group_rank(group)


def reduce_gradients(grads: List[torch.Tensor], group,
                     bucket_bytes: int = BUCKET_BYTES) -> List[torch.Tensor]:
    """The gradients summed over ``group`` (in place; returned): tensors of
    one dtype and device are flattened into buckets of at most
    ``bucket_bytes`` (a tensor larger than that alone), one ``all_reduce`` a
    bucket."""
    if group is None:
        return grads
    buckets: Dict[tuple, List[List[torch.Tensor]]] = {}
    for t in grads:
        runs = buckets.setdefault((t.dtype, t.device), [[]])
        size = sum(x.numel() for x in runs[-1]) * t.element_size()
        if runs[-1] and size + t.numel() * t.element_size() > bucket_bytes:
            runs.append([])
        runs[-1].append(t)
    for runs in buckets.values():
        for run in runs:
            flat = torch.cat([t.reshape(-1) for t in run])
            dist.all_reduce(flat, group=group)
            offset = 0
            for t in run:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
    return grads


def reduce_counts(counts: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Scalar counts summed over ``group`` in one ``all_reduce``."""
    if group is None:
        return list(counts)
    stacked = torch.stack([c.detach() for c in counts])
    dist.all_reduce(stacked, group=group)
    return list(stacked.unbind())


def reduce_metrics(metrics: Dict[str, torch.Tensor], group,
                   keep: Sequence[str] = ("grad_norm",)) -> Dict[str, torch.Tensor]:
    """The global metrics from each rank's shares: every scalar summed over
    ``group`` in one ``all_reduce``, but those in ``keep`` (already global,
    as the norm of the reduced gradient)."""
    names = [k for k in metrics if k not in keep]
    if group is None or not names:
        return metrics
    summed = reduce_counts([metrics[k].float() for k in names], group)
    return {**metrics, **{k: v.to(metrics[k].dtype) for k, v in zip(names, summed)}}


def share(loss: torch.Tensor, group) -> torch.Tensor:
    """A mean over the batch's rows as this rank's share of the global mean
    (every rank holds as many rows)."""
    n = group_size(group)
    return loss if n == 1 else loss / n


def set_batchnorm_group(module: torch.nn.Module, group) -> None:
    """Every ``BatchNorm`` of ``module`` normalises over ``group``'s rows
    in training (None: its own rows)."""
    from ..nn.common import BatchNorm

    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group


def global_rows(n_local: int, group) -> slice:
    """This rank's rows of a global batch of ``n_local`` x the group's size."""
    r = group_rank(group)
    return slice(r * n_local, (r + 1) * n_local)


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' equal-sized row blocks of ``t`` stacked in rank order, on
    every rank.  Through ``all_reduce`` (each rank's block in zeros), which
    gloo takes where it takes no gather of CUDA tensors; integers travel as
    int64, exactly, and under gloo through the host."""
    n = group_size(group)
    if n == 1:
        return t
    host = dist.get_backend(group) == "gloo"
    wide = t.to("cpu" if host else t.device,
                torch.int64 if not t.is_floating_point() else t.dtype)
    out = wide.new_zeros((n * t.shape[0],) + tuple(t.shape[1:]))
    out[global_rows(t.shape[0], group)] = wide
    dist.all_reduce(out, group=group)
    return out.to(t.device, t.dtype)
