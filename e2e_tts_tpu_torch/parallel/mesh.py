"""Device meshes (port of ``e2e_tts_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the world's
ranks, one device a rank (the rank's card, or the CPU), laid out (data,
model): the batch splits over "data", wide weight matrices over "model"
(``parallel/sharding.py``).  JAX's devices are the port's ranks, so the
shape arithmetic (:func:`mesh_shape`, :func:`data_mesh_shape`) is JAX's with
the world size in place of ``len(jax.devices())``.

Where :func:`make_data_mesh` shrinks the data axis to a divisor of the
batch, the mesh holds the first ranks only: the ranks outside it take no
rows and wait at the end (``mesh.get_coordinate()`` is None there), as JAX
leaves those devices idle.  In one process the mesh has one rank, and a
one-process group is started for it (on an in-memory store) if none is.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .distributed import device, process_count


def mesh_shape(n_available: int, n_devices: Optional[int] = None,
               model_parallel: int = 1) -> Tuple[int, int]:
    """(data, model) of a mesh over the first ``n_devices`` of
    ``n_available`` devices (all when None or 0); raises as JAX's
    ``make_mesh`` does."""
    n = n_devices or n_available
    if n > n_available:
        raise ValueError(f"asked for {n} devices, have {n_available}")
    if n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} must divide {n}")
    return n // model_parallel, model_parallel


def data_mesh_shape(n_available: int, batch_size: int,
                    model_parallel: int = 1) -> Tuple[int, int]:
    """(data, model) whose data axis is the largest divisor of
    ``batch_size`` that the devices hold."""
    avail = n_available // model_parallel
    n_data = max((d for d in range(1, avail + 1) if batch_size % d == 0), default=1)
    return mesh_shape(n_available, n_data * model_parallel, model_parallel)


def _device_type() -> str:
    try:
        return device().type
    except RuntimeError:  # one process, no card: the CPU
        return "cpu"


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              axis_names: Sequence[str] = ("data", "model")):
    """A (data, model) ``DeviceMesh`` over the first ``n_devices`` ranks
    (every rank when None).  ``model_parallel`` must divide them; every rank
    calls it, those outside the mesh too."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = mesh_shape(process_count(), n_devices, model_parallel)
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
    ranks = torch.arange(shape[0] * shape[1]).reshape(shape)
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=tuple(axis_names))


def make_data_mesh(batch_size: int, model_parallel: int = 1):
    """A mesh whose data axis divides ``batch_size`` (it shrinks to fit)."""
    shape = data_mesh_shape(process_count(), batch_size, model_parallel)
    return make_mesh(shape[0] * shape[1], model_parallel=model_parallel)


def model_group(mesh):
    """The process group of the mesh's "model" axis (this rank's row of
    ranks that split the wide weights between them), or None where the axis
    has one rank or this rank is outside the mesh: the twin of
    ``data_parallel.data_group``."""
    if mesh is None or mesh.get_coordinate() is None:
        return None
    if dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1) == 1:
        return None
    return mesh.get_group("model")
