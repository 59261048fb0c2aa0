"""The in-memory FeatureSet (DRAM tier) and its card-resident tier.

Port of ``FeatureSet`` and ``DeviceFeatureSet`` from
``analytics_zoo_tpu/data/featureset.py``: features and labels are trees
(arrays, lists, tuples, dicts of arrays) held as host numpy; an epoch is a
permutation from the ``"records"`` stream of ``epoch_rng(seed, epoch)``,
so the same seed and epoch give the same batches as the JAX package.
Where the JAX version shards each batch over a device mesh, this one
copies it to one device as torch tensors.

``cache_device()`` (the DEVICE tier, ``memory_type="DEVICE"``) keeps the
epoch's batches resident on the card as one ``(steps, batch, ...)`` tensor
per leaf, composed once from a shuffled pass; every epoch then permutes
the batch order only, with the ``"batches"`` stream of ``epoch_rng``, as
the JAX tier does.  The estimator gathers each step's batch on the device
through a device cursor into that order, so a step reads no host input.
The disk, generator and sharded tiers, and the sources other than
ndarrays, raise naming ROADMAP Queue 1 item 3.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.unported import QUEUE_ITEMS
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


def _unported(name: str):
    def stub(*args, **kwargs):
        raise NotImplementedError(f"FeatureSet.{name} is not ported yet "
                                  f"({QUEUE_ITEMS[3]})")
    stub.__name__ = name
    return stub


def to_device(tree: Tree, device) -> Tree:
    """Host numpy leaves -> torch tensors on ``device``."""
    return tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a))
                    .to(device), tree)


class FeatureSet:
    """An in-memory dataset of (features, labels) trees."""

    def __init__(self, features: Tree, labels: Optional[Tree] = None,
                 shuffle: bool = True, sequential_order: bool = False,
                 seed: int = 0):
        self.features = tree_map(np.asarray, features)
        self.labels = None if labels is None else tree_map(np.asarray,
                                                            labels)
        # sequential_order keeps the records' order in every epoch
        self.shuffle = shuffle and not sequential_order
        self.seed = seed
        self._n = _tree_len(self.features)
        if self.labels is not None and _tree_len(self.labels) != self._n:
            raise ValueError("features/labels length mismatch")

    @staticmethod
    def from_ndarrays(features: Tree, labels: Optional[Tree] = None,
                      **kw) -> "FeatureSet":
        return FeatureSet(features, labels, **kw)

    from_dataframe = staticmethod(_unported("from_dataframe"))
    from_tfrecord_file = staticmethod(_unported("from_tfrecord_file"))
    from_generator = staticmethod(_unported("from_generator"))
    from_sources = staticmethod(_unported("from_sources"))
    disk = staticmethod(_unported("disk"))
    to_disk = _unported("to_disk")

    def cache_device(self, shuffle_batches: Optional[bool] = None,
                     seed: Optional[int] = None) -> "DeviceFeatureSet":
        """The batches resident on the card (the DEVICE tier); epochs
        permute the batch order only."""
        return DeviceFeatureSet(self, shuffle_batches=shuffle_batches,
                                seed=seed)

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


class DeviceFeatureSet:
    """The DEVICE tier: the epoch's training batches materialised once on a
    device as ``(steps, batch, ...)`` tensors and reused by every epoch.
    Batch composition is fixed at cache time (a shuffled pass when the
    base shuffles); each epoch replays the batches in the order
    ``epoch_order`` gives.  Evaluation and prediction (ragged tails,
    ordered rows) stream from the base, so they never hold a second
    copy."""

    def __init__(self, base: FeatureSet,
                 shuffle_batches: Optional[bool] = None,
                 seed: Optional[int] = None):
        self.base = base
        self.shuffle_batches = (getattr(base, "shuffle", False)
                                if shuffle_batches is None
                                else shuffle_batches)
        self.seed = getattr(base, "seed", 0) if seed is None else seed
        self._cache = {}

    def __len__(self) -> int:
        return len(self.base)

    @property
    def labels(self):
        return self.base.labels

    def steps_per_epoch(self, batch_size: int,
                        drop_remainder: bool = True) -> int:
        return self.base.steps_per_epoch(batch_size, drop_remainder)

    def local_batches(self, batch_size: int, epoch: int = 0,
                      drop_remainder: bool = True, ordered: bool = False):
        yield from self.base.local_batches(batch_size, epoch, drop_remainder,
                                           ordered=ordered)

    def _perm(self, steps: int, epoch: int) -> Optional[np.ndarray]:
        """The order the cached batches replay in at ``epoch`` (the JAX
        tier's ``epoch_rng(seed, epoch, "batches")`` permutation), or None
        for the cached order without batch shuffling."""
        if not self.shuffle_batches:
            return None
        return epoch_rng(self.seed, epoch, "batches").permutation(steps)

    def stacked_epoch(self, batch_size: int, epoch: int = 0, device=None):
        """``(xs, ys, steps, perm)``: every training batch of an epoch
        stacked on a leading axis, resident on ``device`` and cached (one
        entry: a new batch size or device replaces it), and ``epoch``'s
        batch order (None: in order).  ``None`` when an epoch has no full
        batch or the set has no labels."""
        steps = self.steps_per_epoch(batch_size, True)
        if steps == 0 or self.base.labels is None:
            return None
        key = (batch_size, str(torch.device(device) if device is not None
                               else "cpu"))
        if key not in self._cache:
            self._cache.clear()
            n = steps * batch_size
            idx = (self.base._epoch_indices(0)[:n] if self.shuffle_batches
                   else np.arange(n))

            def resh(a):
                a = np.asarray(a)[idx]
                return torch.from_numpy(np.ascontiguousarray(
                    a.reshape((steps, batch_size) + a.shape[1:]))).to(device)

            self._cache[key] = (tree_map(resh, self.base.features),
                                tree_map(resh, self.base.labels))
        xs, ys = self._cache[key]
        return xs, ys, steps, self._perm(steps, epoch)

    def batches(self, batch_size: int, epoch: int = 0,
                drop_remainder: bool = True, device=None):
        for x, y, _ in self.batches_with_counts(
                batch_size, epoch, drop_remainder, device, ordered=False):
            yield x, y

    def batches_with_counts(self, batch_size: int, epoch: int = 0,
                            drop_remainder: bool = True, device=None,
                            ordered: bool = True):
        """Training batches (``drop_remainder``, in the epoch's order) come
        from the resident epoch; a ragged or row-ordered feed from a
        shuffled cache streams from the base."""
        stacked = (self.stacked_epoch(batch_size, epoch, device)
                   if drop_remainder and not (ordered
                                              and self.shuffle_batches)
                   else None)
        if stacked is None:
            yield from self.base.batches_with_counts(
                batch_size, epoch, drop_remainder, device, ordered=ordered)
            return
        xs, ys, steps, perm = stacked
        order = np.arange(steps) if ordered or perm is None else perm
        for i in order:
            take = lambda a: a[int(i)]
            yield tree_map(take, xs), tree_map(take, ys), batch_size

    def evict(self) -> None:
        """Release the resident batches."""
        self._cache.clear()
