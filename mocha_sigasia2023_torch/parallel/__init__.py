"""Data parallelism over ranks (one process a device) on
torch.distributed: the (data, model) mesh, placement by rank, the
gradient reduction and process-group set-up.  The role of the JAX
package's ``data_parallel_jit`` (a step whose gradients XLA all-reduces)
is taken by ``train.trainer.GeneratorTrainer(mesh=...)``, which
all-reduces them explicitly."""

from .mesh import (
    all_gather_rows, all_reduce_mean_, make_mesh, replicate, shard_batch,
    shard_streams,
)
from .distributed import initialize_multihost, is_primary_host, spawn
