"""Parameter-sharding rules: tensor parallelism over the "model" axis.

Port of ``analytics_zoo_tpu/parallel/sharding.py``.  Rules map parameter
paths to ``PartitionSpec``s (Megatron-style: column-parallel fc1,
row-parallel fc2, vocab-sharded embeddings).  A rule's regex matches the
``/``-joined leaf path, the JAX package's form; a ``state_dict`` key's
dots count as ``/`` (``parallel.mesh.tree_map_with_path``), so
``attn/qkv/W$`` matches the same leaves in both packages.

- ``partition_specs`` returns a tree of ``PartitionSpec``s and works on
  any tree whose leaf paths end in the parameter naming convention,
  optimizer-state trees included.
- ``partition_params`` wraps them in ``NamedSharding``s, which
  ``parallel.mesh.device_put`` places.

The estimator applies them to its dotted parameter tree and to its
optimizer's slot tree (``mu/<name>``, ``trace/<name>``: the rules match
the suffix), so a weight's moments are placed as the weight.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

from analytics_zoo_tpu_torch.parallel.mesh import (
    Mesh, NamedSharding, PartitionSpec as P, tree_map, tree_map_with_path)


@dataclass
class ShardingRule:
    """First regex (on the '/'-joined param path) that matches wins."""
    pattern: str
    spec: Tuple[Optional[str], ...]

    def matches(self, path: str) -> bool:
        return re.search(self.pattern, path) is not None


# Megatron-style defaults for the layer catalog's naming conventions.
DEFAULT_TP_RULES: Sequence[ShardingRule] = (
    # embedding tables: shard the vocab dim
    ShardingRule(r"embed[^/]*/embeddings$", ("model", None)),
    ShardingRule(r"(token|position|segment)_embed$", ("model", None)),
    # transformer FFN: column-parallel fc1, row-parallel fc2
    ShardingRule(r"ffn/fc1/W$", (None, "model")),
    ShardingRule(r"ffn/fc1/b$", ("model",)),
    ShardingRule(r"ffn/fc2/W$", ("model", None)),
    # attention qkv: shard heads (output dim); out-proj row-parallel
    ShardingRule(r"attn/qkv/W$", (None, "model")),
    ShardingRule(r"attn/qkv/b$", ("model",)),
    ShardingRule(r"attn/out/W$", ("model", None)),
)


def _leaf_shape(leaf):
    shape = getattr(leaf, "shape", None)
    return tuple(shape) if shape is not None else ()


def partition_specs(tree: Any, mesh: Mesh,
                    rules: Sequence[ShardingRule] = DEFAULT_TP_RULES,
                    default_spec: Tuple = ()) -> Any:
    """Tree of ``PartitionSpec``s for ``tree``: the first matching rule's
    spec where it also divides the leaf's dims evenly, ``default_spec``
    (replicated) otherwise; every leaf replicates when the mesh has no
    "model" axis above 1."""
    tp = mesh.shape.get("model", 1)
    if tp <= 1:
        return tree_map(lambda _: P(*default_spec), tree)

    def assign(path, leaf):
        shape = _leaf_shape(leaf)
        for rule in rules:
            if rule.matches(path):
                spec = rule.spec
                if len(spec) <= len(shape) and _divides(shape, spec, mesh):
                    return P(*spec)
                break
        return P(*default_spec)

    return tree_map_with_path(assign, tree)


def named_shardings(mesh: Mesh, specs: Any) -> Any:
    """Wrap a tree of ``PartitionSpec``s in ``NamedSharding``s."""
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def partition_params(params: Any, mesh: Mesh,
                     rules: Sequence[ShardingRule] = DEFAULT_TP_RULES,
                     default_spec: Tuple = ()) -> Any:
    """Tree of ``NamedSharding``s for ``params``: rule spec where a rule
    matches AND the axis sizes divide evenly; replicated otherwise."""
    return named_shardings(mesh, partition_specs(params, mesh, rules,
                                                 default_spec))


def _divides(shape, spec, mesh) -> bool:
    for dim, axis in zip(shape, spec):
        if axis is not None and dim % mesh.shape.get(axis, 1) != 0:
            return False
    return True
