"""The in-memory (DRAM-tier) FeatureSet.

Port of ``FeatureSet`` from ``analytics_zoo_tpu/data/featureset.py``:
features and labels are trees (arrays, lists, tuples, dicts of arrays)
held as host numpy; an epoch is a permutation from the ``"records"``
stream of ``epoch_rng(seed, epoch)``, so the same seed and epoch give the
same batches as the JAX package.  Where the JAX version shards each batch
over a device mesh, this one copies it to one device as torch tensors.
The disk, generator and device tiers are not ported.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.data.cursor import epoch_rng

Tree = Any


def tree_map(fn: Callable, tree: Tree) -> Tree:
    """``fn`` on every leaf of a tree of lists, tuples and dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _tree_len(tree: Tree) -> int:
    leaves = tree_leaves(tree)
    if not leaves:
        raise ValueError("empty tree")
    n = leaves[0].shape[0]
    if any(leaf.shape[0] != n for leaf in leaves):
        raise ValueError("inconsistent leading dimensions in tree")
    return n


def to_device(tree: Tree, device) -> Tree:
    """Host numpy leaves -> torch tensors on ``device``."""
    return tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a))
                    .to(device), tree)


class FeatureSet:
    """An in-memory dataset of (features, labels) trees."""

    def __init__(self, features: Tree, labels: Optional[Tree] = None,
                 shuffle: bool = True, seed: int = 0):
        self.features = tree_map(np.asarray, features)
        self.labels = None if labels is None else tree_map(np.asarray,
                                                            labels)
        self.shuffle = shuffle
        self.seed = seed
        self._n = _tree_len(self.features)
        if self.labels is not None and _tree_len(self.labels) != self._n:
            raise ValueError("features/labels length mismatch")

    @staticmethod
    def from_ndarrays(features: Tree, labels: Optional[Tree] = None,
                      **kw) -> "FeatureSet":
        return FeatureSet(features, labels, **kw)

    def __len__(self) -> int:
        return self._n

    def steps_per_epoch(self, batch_size: int,
                        drop_remainder: bool = True) -> int:
        if drop_remainder:
            return self._n // batch_size
        return math.ceil(self._n / batch_size)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(self._n)
        if self.shuffle:
            epoch_rng(self.seed, epoch, "records").shuffle(idx)
        return idx

    def local_batches(self, batch_size: int, epoch: int = 0,
                      drop_remainder: bool = True, ordered: bool = False
                      ) -> Iterator[Tuple[Tree, Optional[Tree]]]:
        """Host-side numpy batches."""
        idx = np.arange(self._n) if ordered else self._epoch_indices(epoch)
        for s in range(self.steps_per_epoch(batch_size, drop_remainder)):
            sel = idx[s * batch_size:(s + 1) * batch_size]
            x = tree_map(lambda a: a[sel], self.features)
            y = None if self.labels is None else tree_map(lambda a: a[sel],
                                                          self.labels)
            yield x, y

    def batches(self, batch_size: int, epoch: int = 0,
                drop_remainder: bool = True, device=None):
        """``(x, y)`` batches as torch tensors on ``device``, in the
        epoch's shuffled order (training)."""
        for x, y, _ in self.batches_with_counts(
                batch_size, epoch, drop_remainder, device, ordered=False):
            yield x, y

    def batches_with_counts(self, batch_size: int, epoch: int = 0,
                            drop_remainder: bool = True, device=None,
                            ordered: bool = True):
        """``(x, y, rows)`` on ``device``; ordered by default (the
        evaluate / predict feed, whose outputs line up with the rows).  A
        ragged last batch keeps its real size: one device needs no
        padding."""
        for x, y in self.local_batches(batch_size, epoch, drop_remainder,
                                       ordered=ordered):
            n = tree_leaves(x)[0].shape[0]
            yield (to_device(x, device),
                   None if y is None else to_device(y, device), n)
