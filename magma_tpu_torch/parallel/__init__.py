"""Parallelism over ``torch.distributed``: the process mesh, the sharding
rules, ring attention and the sequence-sharded decode (port of
``magma_tpu/parallel``)."""

from magma_tpu_torch.parallel.mesh import Mesh, make_mesh
from magma_tpu_torch.parallel.partition import combine, partition
from magma_tpu_torch.parallel.sharding import shard_batch, shard_lm_params, shard_params

__all__ = [
    "Mesh",
    "make_mesh",
    "partition",
    "combine",
    "shard_params",
    "shard_lm_params",
    "shard_batch",
]
