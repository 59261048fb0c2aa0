"""Cross-replica sharding of the weight update (ZeRO-style, arXiv
2004.13336): the partition specs.

Port of ``analytics_zoo_tpu/parallel/zero.py``.  In plain data-parallel
training every replica holds the whole optimizer state; partitioned over
the data axis, each holds ``1/dp`` of the moments and runs ``1/dp`` of the
update.  This module is the spec math: which dimension of each leaf
shards over the data axis (the first one free and divisible by ``dp``),
composed with a tensor-parallel base spec over "model" when the weights
are already split.  ``bytes_per_device`` reads what a placed tree holds
per position.  The estimator's sharded step applies the specs to its
optimizer slots and gradients (``estimator/estimator.py`` ``_place``).

Works on the leaves the port's trees hold: tensors, numpy arrays and
``ShardedTensor``s (only ``shape`` and ``dtype`` are read).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.parallel.mesh import (
    Mesh, NamedSharding, PartitionSpec as P, tree_leaves, tree_map)


def zero_partition_spec(shape, dp: int, axis: str = "data",
                        base: Optional[P] = None) -> P:
    """PartitionSpec sharding the first FREE dim divisible by ``dp`` over
    ``axis``; ``base`` (a tensor-parallel spec over e.g. "model") is
    preserved and its occupied dims are skipped.  Fully replicated over
    ``axis`` when no free dim divides (or dp==1): the base spec alone
    survives."""
    shape = tuple(shape)
    base_t = tuple(base) if base is not None else ()
    base_t = base_t + (None,) * (len(shape) - len(base_t))
    if dp <= 1:
        return P(*base_t) if any(a is not None for a in base_t) else P()
    for i, d in enumerate(shape):
        if base_t[i] is None and d >= dp and d % dp == 0:
            spec = list(base_t)
            spec[i] = axis
            return P(*spec)
    return P(*base_t) if any(a is not None for a in base_t) else P()


def _shape(leaf):
    return tuple(np.shape(leaf) if not hasattr(leaf, "shape")
                 else leaf.shape)


def zero_shardings(tree: Any, mesh: Mesh, axis: str = "data",
                   base_specs: Any = None) -> Any:
    """Tree of ``NamedSharding``s partitioning every leaf of ``tree`` (an
    optimizer-state or gradient tree) across the ``axis`` replicas,
    composed with ``base_specs`` (a matching tree of model-axis specs from
    ``partition_specs``) when the weights are tensor-parallel."""
    dp = mesh.shape.get(axis, 1)

    def assign(leaf, base=None):
        return NamedSharding(
            mesh, zero_partition_spec(_shape(leaf), dp, axis, base=base))

    if base_specs is None:
        return tree_map(assign, tree)
    return tree_map(assign, tree, base_specs)


def replicated_shardings(tree: Any, mesh: Mesh) -> Any:
    repl = NamedSharding(mesh, P())
    return tree_map(lambda _: repl, tree)


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def tree_bytes(tree: Any) -> int:
    """Total logical bytes of a tree (per replica when replicated)."""
    return sum(
        int(np.prod(tuple(l.shape))) * _itemsize(l.dtype)
        for l in tree_leaves(tree)
        if hasattr(l, "shape") and hasattr(l, "dtype"))


def bytes_per_device(tree: Any) -> int:
    """Per-position resident bytes of a PLACED tree: each leaf counts its
    shard shape under its sharding (replicated and unplaced leaves count
    whole).  Host math only."""
    total = 0
    for l in tree_leaves(tree):
        if not (hasattr(l, "shape") and hasattr(l, "dtype")):
            continue
        sharding = getattr(l, "sharding", None)
        shape = tuple(l.shape)
        if sharding is not None:
            shape = sharding.shard_shape(shape)
        total += int(np.prod(shape)) * _itemsize(l.dtype)
    return total
