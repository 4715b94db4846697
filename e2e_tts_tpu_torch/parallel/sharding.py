"""Sharding rules: parameter names to DTensor placements (port of
``e2e_tts_tpu/parallel/sharding.py``).

Data parallelism: every batch tensor splits its leading axis over "data",
each rank keeping its contiguous rows.  Tensor parallelism: weight matrices
split over "model" in the megatron column/row pattern, as JAX's rules say,
rewritten on the port's names and layouts:

- attention q/k/v projections (``nn.Linear`` weights, (out, in)): the
  output axis, dim 0 (JAX's ``Dense`` kernel is (in, out): ``P(None,
  "model")``); the attention output ``fc``: the input axis, dim 1;
- the FFN's convolutions ((out, in, k); JAX's are (k, in, out)): ``w_1`` its
  output axis, dim 0, ``w_2`` its input axis, dim 1;
- the word embedding ((n, d), as JAX's): the feature axis, dim 1;
- the vocoder: ``conv_pre``'s ``v`` (out, in, k) its output axis, dim 0;
  the upsampling ``v``s ((in, out, k), a transposed convolution's layout;
  JAX's are (k, in, out)) their output axis, dim 1; the residual blocks'
  ``v``s stay replicated;
- everything else (norms, biases, ``g``s, small predictors) replicated.

The first rule that matches wins, and a tensor whose split axis the model
axis does not divide is replicated, as JAX's guard does.  A mesh here is a
``DeviceMesh``, or for the rules alone a mapping of axis names to sizes
(``{"data": 4, "model": 2}``), so that the rules can be read without the
ranks they name.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch

# (name fragment, leaf name, split dim, the rule's ndim) -- first match wins;
# dim None replicates.  The ndim is JAX's spec length: a rule applies to a
# tensor of at least that many dims.
_RULES: Tuple[Tuple[str, str, Any, int], ...] = (
    ("w_q", "weight", 0, 2),
    ("w_k", "weight", 0, 2),
    ("w_v", "weight", 0, 2),
    ("fc", "weight", 1, 2),
    ("pos_ffn.w_1", "weight", 0, 3),
    ("pos_ffn.w_2", "weight", 1, 3),
    ("src_word_emb", "weight", 1, 2),
    ("conv_pre", "v", 0, 3),
    ("ups.", "v", 1, 3),
    ("resblocks.", "v", None, 3),  # residual convs stay replicated
)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of such a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def split_dim(name: str, shape, mesh):
    """The dim of a parameter ``name`` of ``shape`` that the "model" axis
    splits, or None (replicated)."""
    sizes = axis_sizes(mesh)
    if sizes.get("model", 1) == 1:
        return None
    leaf = name.rsplit(".", 1)[-1]
    for frag, pname, dim, ndim in _RULES:
        if frag in name and leaf == pname and ndim <= len(shape):
            # divisibility guard: replicate if the split dim does not divide
            if dim is not None and shape[dim] % sizes["model"]:
                return None
            return dim
    return None


def _placements(dim, mesh):
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    return tuple(Shard(dim) if (a == "model" and dim is not None) else Replicate()
                 for a in names)


def param_sharding_rules(module: torch.nn.Module, mesh) -> Dict[str, tuple]:
    """{parameter name: DTensor placements, one per mesh axis}."""
    return {n: _placements(split_dim(n, tuple(p.shape), mesh), mesh)
            for n, p in module.named_parameters()}


def batch_sharding(mesh) -> tuple:
    """Placements of a batch tensor: its leading axis over "data"."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if a == "data" else Replicate() for a in axis_sizes(mesh))


def shard_params(module: torch.nn.Module, mesh) -> Dict[str, Any]:
    """{parameter name: DTensor} placed by :func:`param_sharding_rules`; each
    rank holds its shard."""
    from torch.distributed.tensor import distribute_tensor

    rules = param_sharding_rules(module, mesh)
    return {n: distribute_tensor(p.detach(), mesh, list(rules[n]))
            for n, p in module.named_parameters()}


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def replicate(tree: Any, mesh) -> Any:
    """Every tensor of ``tree`` as a replicated DTensor on ``mesh``
    (optimizer moments, batch statistics, step counters)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    repl = [Replicate()] * len(axis_sizes(mesh))
    return _tree_map(lambda t: distribute_tensor(t, mesh, repl), tree)


def local_rows(n_rows: int, mesh, grad_accum: int = 1):
    """This rank's rows of an ``n_rows`` global batch: its contiguous share by
    its coordinate on "data" (all rows when ``mesh`` is None, one process;
    none on a rank outside the mesh).  With ``grad_accum`` N the batch is N
    microbatches of contiguous rows, as JAX's step splits it, and the rank
    takes its share of each in turn (a list of rows)."""
    if mesh is None:
        return slice(0, n_rows)
    coord = mesh.get_coordinate()
    if coord is None:
        return slice(0, 0)
    sizes = axis_sizes(mesh)
    n = sizes["data"]
    if n_rows % (n * grad_accum):
        raise ValueError(f"batch of {n_rows} rows does not split over {n} data ranks "
                         f"x {grad_accum} microbatches")
    c = coord[list(sizes).index("data")]
    micro = n_rows // grad_accum
    per = micro // n
    if grad_accum == 1:
        return slice(c * per, (c + 1) * per)
    return [i * micro + c * per + j for i in range(grad_accum) for j in range(per)]


def shard_batch(batch: Any, mesh, grad_accum: int = 1) -> Any:
    """Each tensor of a global ``batch`` (every rank holds the same) cut to
    this rank's rows (:func:`local_rows`): the local shard of
    :func:`batch_sharding`, as JAX's engine puts a host's rows in
    ``_put_global``."""
    if mesh is None:
        return batch
    first = next(t for t in _leaves(batch))
    rows = local_rows(first.shape[0], mesh, grad_accum)
    return _tree_map(lambda t: t[rows], batch)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
