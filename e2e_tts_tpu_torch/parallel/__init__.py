"""Data and tensor parallelism over processes (port of
``e2e_tts_tpu/parallel/``): the mesh, the sharding rules, the
multi-process setup, the global step's reductions over the data axis
(``data_parallel``), the split layers' collectives over the model axis
(``tensor_parallel``), and the twin of JAX's multichip dry run
(``dryrun``)."""

from .mesh import make_data_mesh, make_mesh, model_group
from .sharding import (
    batch_sharding,
    local_rows,
    param_sharding_rules,
    replicate,
    shard_batch,
    shard_params,
)
from .distributed import host_local_batch, initialize, is_primary
from .tensor_parallel import parallelize
