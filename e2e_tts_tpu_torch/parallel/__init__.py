"""Data and tensor parallelism over processes (port of
``e2e_tts_tpu/parallel/``): the mesh, the sharding rules, the
multi-process setup, and the global step's reductions
(``data_parallel``)."""

from .mesh import make_data_mesh, make_mesh
from .sharding import (
    batch_sharding,
    local_rows,
    param_sharding_rules,
    replicate,
    shard_batch,
    shard_params,
)
from .distributed import host_local_batch, initialize, is_primary
