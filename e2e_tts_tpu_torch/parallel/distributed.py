"""Multi-process setup (port of ``e2e_tts_tpu/parallel/distributed.py``).

Every process calls :func:`initialize` first; it starts
``torch.distributed`` when the world has more than one process, and a single
process is a no-op, as JAX's is.  The world is read from the arguments, or
from JAX's environment names (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``,
``PROCESS_ID``), or from torchrun's (``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``).

Each rank computes on ``cuda:{LOCAL_RANK}`` (modulo the cards it sees), or on
the CPU when the caller passes ``device="cpu"``.  The backend follows the
devices: NCCL where every rank of a host has a card of its own, gloo on the
CPU and where ranks share a card (NCCL refuses two ranks on one device).  A
host's ranks are ``LOCAL_WORLD_SIZE`` (torchrun sets it), else the whole
world; ``initialize(backend=...)`` overrides the choice.
Under gloo a CUDA tensor takes ``broadcast`` and ``all_reduce`` only, so the
port gathers through ``all_reduce`` (``parallel/data_parallel.all_gather_rows``).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 600.0
_DEVICE: Optional[torch.device] = None


def _int_env(*names: str) -> Optional[int]:
    for name in names:
        v = os.environ.get(name)
        if v:
            return int(v)
    return None


def _address(coordinator_address: Optional[str]) -> Optional[str]:
    """host:port from the argument, ``COORDINATOR_ADDRESS``, or torchrun's
    ``MASTER_ADDR`` and ``MASTER_PORT``."""
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if addr:
        return addr
    host, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{host}:{port}" if host and port else None


def choose_backend(device_type: str, local_world: int, n_cards: int) -> str:
    """NCCL where each of a host's ``local_world`` ranks has one of its
    ``n_cards`` cards, gloo on the CPU and where ranks share a card."""
    if device_type != "cuda" or local_world > n_cards:
        return "gloo"
    return "nccl"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Start ``torch.distributed`` from the arguments or the environment
    names; returns True when the world has more than one process.  A second
    call keeps the group the first started.  ``device``: "cpu", or None for
    the rank's card; ``backend`` overrides :func:`choose_backend`.  A
    collective that does not return within ``timeout_s`` raises."""
    global _DEVICE
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    num_processes = num_processes or _int_env("NUM_PROCESSES", "WORLD_SIZE")
    process_id = process_id if process_id is not None else _int_env("PROCESS_ID", "RANK")
    addr = _address(coordinator_address)
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if num_processes is None or num_processes <= 1:
        log.info("one process: torch.distributed not started")
        _DEVICE = torch.device("cpu") if on_cpu else None
        return False
    if addr is None or process_id is None:
        raise ValueError(f"{num_processes} processes need a coordinator address and a "
                         "process id (COORDINATOR_ADDRESS/PROCESS_ID or MASTER_ADDR/"
                         "MASTER_PORT/RANK)")
    local_rank = _int_env("LOCAL_RANK")
    local_world = _int_env("LOCAL_WORLD_SIZE") or num_processes
    if on_cpu:
        _DEVICE = torch.device("cpu")
        n_cards = 0
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        n_cards = torch.cuda.device_count()
        index = (local_rank if local_rank is not None else process_id) % n_cards
        _DEVICE = torch.device("cuda", index)
        torch.cuda.set_device(_DEVICE)
    backend = backend or choose_backend(_DEVICE.type, local_world, n_cards)
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    log.warning("torch.distributed: rank %d of %d on %s, backend %s", process_id,
                num_processes, _DEVICE, backend)
    return True


def device() -> torch.device:
    """This rank's device: what :func:`initialize` chose, else CUDA (which
    raises without a card)."""
    if _DEVICE is not None:
        return _DEVICE
    from ..device import resolve_device

    return resolve_device(None)


def backend() -> Optional[str]:
    """The started group's backend, or None in one process."""
    return dist.get_backend() if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def host_local_batch(global_batch: int) -> int:
    """Per-process batch size for a globally sharded batch."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    return global_batch // n


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs."""
    return process_index() == 0


def barrier(group=None) -> None:
    """All ranks of ``group`` (the world when None) meet; a no-op in one
    process."""
    if process_count() > 1:
        dist.barrier(group=group)
