"""Parallelism over a device mesh: ring attention (sequence parallelism).

Port of ``analytics_zoo_tpu/parallel``.  ``ring_attention`` and the
``Mesh`` it runs over are ported; the JAX package's other exports
(tensor-parallel sharding rules, ZeRO, mixture of experts, pipelining)
raise ``NotImplementedError`` naming ROADMAP until they are.
"""

from analytics_zoo_tpu_torch.parallel.mesh import Mesh
from analytics_zoo_tpu_torch.parallel.ring import ring_attention


def _not_ported(name: str):
    def stub(*args, **kwargs):
        raise NotImplementedError(
            f"parallel.{name} is not ported yet (ROADMAP Queue 1 item 5: "
            "parallel/ sharding, zero, moe and pipeline)")
    stub.__name__ = stub.__qualname__ = name
    return stub


partition_params = _not_ported("partition_params")
partition_specs = _not_ported("partition_specs")
ShardingRule = _not_ported("ShardingRule")
init_moe_params = _not_ported("init_moe_params")
moe_ffn = _not_ported("moe_ffn")
partition_moe_params = _not_ported("partition_moe_params")
pipeline_apply = _not_ported("pipeline_apply")
stack_stage_params = _not_ported("stack_stage_params")
bytes_per_device = _not_ported("bytes_per_device")
replicated_shardings = _not_ported("replicated_shardings")
tree_bytes = _not_ported("tree_bytes")
zero_partition_spec = _not_ported("zero_partition_spec")
zero_shardings = _not_ported("zero_shardings")

__all__ = ["Mesh", "ring_attention"]
