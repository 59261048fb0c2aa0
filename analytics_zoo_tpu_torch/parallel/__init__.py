"""Parallelism over a device mesh.

Port of ``analytics_zoo_tpu/parallel``: ring attention (sequence
parallelism), tensor-parallel sharding rules, the ZeRO partition specs,
mixture of experts and pipelining, over the ``Mesh`` / ``NamedSharding``
/ ``device_put`` of ``parallel.mesh``.  One process holds every shard
(the JAX package's single-controller model).
"""

from analytics_zoo_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, NamedSharding, PartitionSpec, ShardedTensor, device_put)
from analytics_zoo_tpu_torch.parallel.sharding import (  # noqa: F401
    partition_params, partition_specs, ShardingRule)
from analytics_zoo_tpu_torch.parallel.ring import ring_attention  # noqa: F401
from analytics_zoo_tpu_torch.parallel.moe import (  # noqa: F401
    init_moe_params, moe_ffn, partition_moe_params)
from analytics_zoo_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply, stack_stage_params)
from analytics_zoo_tpu_torch.parallel.zero import (  # noqa: F401
    bytes_per_device, replicated_shardings, tree_bytes,
    zero_partition_spec, zero_shardings)

__all__ = ["Mesh", "NamedSharding", "PartitionSpec", "ShardedTensor",
           "device_put", "ring_attention", "partition_params",
           "partition_specs", "ShardingRule", "init_moe_params", "moe_ffn",
           "partition_moe_params", "pipeline_apply", "stack_stage_params",
           "bytes_per_device", "replicated_shardings", "tree_bytes",
           "zero_partition_spec", "zero_shardings"]
