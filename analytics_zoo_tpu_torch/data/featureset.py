"""The FeatureSet tiers: in memory (DRAM), on the card (DEVICE), streamed
from a generator, and sliced on disk (DISK_AND_DRAM).

Port of ``analytics_zoo_tpu/data/featureset.py``: features and labels are
trees (arrays, lists, tuples, dicts of arrays) held as host numpy; an epoch
is a permutation from the ``"records"`` stream of ``epoch_rng(seed,
epoch)``, so the same seed and epoch give the same batches as the JAX
package.  Where the JAX version shards each batch over a device mesh, this
one copies it to one device as torch tensors: given ``ctx=``, the mesh's
device when its positions share one (one process runs every data
position of its own there), with the JAX package's check that the global
batch divides by the data axis.  When the positions lie on several
devices (``ctx.distinct_devices``, a mesh over several cards) and no
``device`` is named, each batch is cut into the data axis's row blocks,
each staged on its position's device on that position's stream
(``Mesh.stream``) as ``featureset.py:283-300`` of the JAX package shards
it: every leaf is a ``ShardedTensor`` split over "data" (a ragged last
batch zero-padded up to the data-axis multiple first, as in JAX), and the
DEVICE tier keeps each position's rows of its epoch on that position's
device.  Given the ``ctx=`` of a
job of several processes (the estimator's training feed), each process
takes the rows of its data coordinates of every global batch of B rows:
``[g * B/G, (g + 1) * B/G)`` for data group ``g`` of ``G``
(``Mesh.data_group``: processes holding the same coordinates form a
group, each process its own when it holds a coordinate alone), as
``make_array_from_process_local_data`` assembles a global batch from the
rows each process holds of its addressable shards, the processes that
hold the same shards (replicas) supplying the same rows; so every
process of a model group split across processes feeds the same rows,
and every process all of them when the data axis is 1.  A B that the
data axis does not divide raises the JAX package's ``ValueError``; the DEVICE tier then keeps its epoch's batches
on the host and feeds each process its rows of them in the resident
epoch's order, where the JAX tier takes its per-batch path.

``cache_device()`` (the DEVICE tier, ``memory_type="DEVICE"``) keeps the
epoch's batches resident on the card as one ``(steps, batch, ...)`` tensor
per leaf, composed once from a shuffled pass (for a streamed tier, from
its first epoch's batches); every epoch then permutes the batch order
only, with the ``"batches"`` stream of ``epoch_rng``, as the JAX tier
does.  The estimator gathers each step's batch on the device through a
device cursor into that order, so a step reads no host input.

The sources: ndarrays, a DataFrame (duck-typed: ``toPandas`` or
``df[col].to_numpy()``), TFRecord files of ``tf.Example`` records
(``data/tfrecord.py``), a generator (``GeneratorFeatureSet``: a seeded
window shuffle) and slice files (``DiskFeatureSet``: ``.npz`` files with
one ``f{j}`` / ``l{j}`` key per leaf, in ``jax.tree_util``'s leaf order,
so the two packages read each other's slices).  ``from_sources`` picks the
tier from a memory-type keyword.  The sharded sources are in
``data/sharded.py``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.data.cursor import epoch_rng
from analytics_zoo_tpu_torch.parallel.mesh import (
    NamedSharding, PartitionSpec, ShardedTensor, join, on_stream)

Tree = Any


def tree_map(fn: Callable, tree: Tree) -> Tree:
    """``fn`` on every leaf of a tree of lists, tuples and dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Tree) -> list:
    return tree_flatten(tree)[0]


def tree_flatten(tree: Tree) -> Tuple[list, Any]:
    """The leaves in ``jax.tree_util``'s order (a dict's keys sorted) and
    the structure ``tree_unflatten`` rebuilds the tree from."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        return ([leaf for ls, _ in parts for leaf in ls],
                (dict, keys, [d for _, d in parts]))
    if isinstance(tree, (list, tuple)):
        parts = [tree_flatten(v) for v in tree]
        return ([leaf for ls, _ in parts for leaf in ls],
                (type(tree), None, [d for _, d in parts]))
    return [tree], None


def tree_unflatten(treedef, leaves: Sequence) -> Tree:
    """The tree of ``treedef`` (from ``tree_flatten``) over ``leaves``."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, subs = d
        vals = [build(sd) for sd in subs]
        return dict(zip(keys, vals)) if kind is dict else kind(vals)
    return build(treedef)


def _check_divisible(batch_size: int, ctx) -> None:
    div = ctx.global_batch_divisor
    if batch_size % div != 0:
        raise ValueError(
            f"global batch_size {batch_size} must be a multiple of the "
            f"data-parallel axis size {div}")


def _ctx_device(batch_size: int, device, ctx):
    """``device`` (else the mesh's, or its data sharding when the mesh's
    positions lie on several devices) after ``ctx``'s batch check."""
    if ctx is None:
        return device
    _check_divisible(batch_size, ctx)
    if device is not None:
        return device
    return (ctx.data_sharding if ctx.distinct_devices
            else ctx.mesh.local_devices[0])


def _local_data(mesh) -> int:
    return len(mesh.local_range("data")) if "data" in mesh.axis_names \
        else 1


def place_rows(a, sharding: NamedSharding, dim: int = 0,
               pad: bool = False) -> ShardedTensor:
    """A host array (or tensor) holding this process's rows along ``dim``
    as a ``ShardedTensor`` split over the "data" axis of ``sharding``'s
    mesh: local data coordinate ``i`` takes row block ``i``, copied to its
    position's device on that position's stream (through pinned memory on
    a card), after which the device's current stream waits for the copy.
    ``pad`` zero-pads a ragged row count up to the local data axis's
    multiple first."""
    mesh = sharding.mesh
    t = a if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(a))
    local = _local_data(mesh)
    n = t.shape[dim]
    if n % local:
        if not pad:
            raise ValueError(f"{n} rows do not divide over {local} data "
                             "positions")
        shape = list(t.shape)
        shape[dim] = local - n % local
        t = torch.cat([t, t.new_zeros(shape)], dim=dim)
        n = t.shape[dim]
    rows, first = n // local, mesh.local_range("data").start
    made, shards, streams = {}, [None] * mesh.size, []
    for p in mesh.local_positions:
        dev = mesh.devices.flat[p]
        i = mesh.coords(p).get("data", 0) - first
        key = (str(dev), i)
        if key not in made:
            block = t.narrow(dim, i * rows, rows)
            stream = mesh.stream(p)
            with on_stream(stream):
                if stream is not None:
                    block = block.contiguous().pin_memory()
                made[key] = block.to(dev, non_blocking=stream is not None) \
                    .contiguous()
            streams.append(stream)
        shards[p] = made[key]
    join(streams, made.values())
    shape = list(t.shape)
    shape[dim] = rows * mesh.shape.get("data", 1)
    spec = PartitionSpec(*([None] * dim + ["data"]))
    return ShardedTensor(shards, shape, NamedSharding(mesh, spec))


def _process_rows(batch_size: int, ctx) -> Optional[slice]:
    """This process's rows of a global batch of ``batch_size`` under the
    ``ctx`` of several processes (None: every row): the rows of its data
    coordinates, block ``g`` of ``G`` for data group ``g``
    (``Mesh.data_group``), the same rows in every process of the group
    and every row when the data axis is 1."""
    pc = 1 if ctx is None else ctx.process_count
    if pc == 1:
        return None
    g, n = ctx.mesh.data_group()
    if batch_size % n != 0:
        raise ValueError(f"global batch_size {batch_size} must divide by "
                         f"the {n} data groups of the process count {pc}")
    lbs = batch_size // n
    return slice(g * lbs, (g + 1) * lbs)


def _multi_process(ctx) -> bool:
    return ctx is not None and ctx.process_count > 1


def _tree_len(tree: Tree) -> int:
    leaves = tree_leaves(tree)
    if not leaves:
        raise ValueError("empty tree")
    n = leaves[0].shape[0]
    if any(leaf.shape[0] != n for leaf in leaves):
        raise ValueError("inconsistent leading dimensions in tree")
    return n


def to_device(tree: Tree, device) -> Tree:
    """Host numpy leaves -> torch tensors on ``device``, or placed row
    block by row block when ``device`` is a data sharding
    (``place_rows``, a ragged batch padded)."""
    if isinstance(device, NamedSharding):
        return tree_map(lambda a: place_rows(a, device, pad=True), tree)
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

    @staticmethod
    def from_dataframe(df, feature_cols: Sequence[str],
                       label_cols: Optional[Sequence[str]] = None,
                       **kw) -> "FeatureSet":
        """A DataFrame's columns: anything with ``toPandas`` (Spark) or a
        pandas-like frame whose ``df[col].to_numpy()`` gives a column.
        Scalar feature columns become (N, 1), so they feed ``Input((1,))``
        towers; one column gives an array, several a dict."""
        if hasattr(df, "toPandas"):
            df = df.toPandas()
        feats = {c: df[c].to_numpy().reshape(-1, 1) for c in feature_cols}
        if len(feature_cols) == 1:
            feats = feats[feature_cols[0]]
        labels = None
        if label_cols:
            labels = {c: df[c].to_numpy() for c in label_cols}
            if len(label_cols) == 1:
                labels = labels[label_cols[0]]
        return FeatureSet(feats, labels, **kw)

    @staticmethod
    def from_tfrecord_file(path: str, feature_keys=None, label_keys=None,
                           verify: bool = True, **kw) -> "FeatureSet":
        """A TFRecord file, or a directory of them, of ``tf.Example``
        records.  Numeric features stack to (N, ...) arrays (one key gives
        an array, several a dict); ``label_keys`` split those columns out
        as labels.  Default keys: every key, sorted."""
        from analytics_zoo_tpu_torch.data import tfrecord as _tfr
        examples = _tfr.read_example_file(path, verify=verify)
        if not examples:
            raise ValueError(f"no tf.Example records under {path!r}")
        keys = (list(feature_keys) if feature_keys is not None
                else sorted(k for k in examples[0]
                            if not (label_keys and k in label_keys)))
        feats = _tfr.examples_to_arrays(examples, keys)
        if len(keys) == 1:
            feats = feats[keys[0]]
        labels = None
        if label_keys:
            labels = _tfr.examples_to_arrays(examples, list(label_keys))
            if len(label_keys) == 1:
                labels = labels[list(label_keys)[0]]
        return FeatureSet(feats, labels, **kw)

    @staticmethod
    def from_generator(gen: Callable[[], Iterator[Tuple]], size: int,
                       **kw) -> "GeneratorFeatureSet":
        return GeneratorFeatureSet(gen, size, **kw)

    @staticmethod
    def disk(paths: Sequence[str], **kw) -> "DiskFeatureSet":
        return DiskFeatureSet(paths, **kw)

    @staticmethod
    def from_sources(features: Tree, labels: Optional[Tree] = None,
                     memory_type: str = "DRAM", num_slices: int = 4,
                     cache_dir: Optional[str] = None, **kw) -> "FeatureSet":
        """The tier by memory type: ``DISK_AND_DRAM[:<n>]`` sliced epochs
        (``n`` slices, default ``num_slices``, under ``cache_dir``),
        ``DEVICE`` / ``HBM`` resident on the card, and ``DRAM``, ``DIRECT``
        and ``PMEM`` in host memory (the last two kept for the config's
        surface)."""
        mt = memory_type.upper()
        if mt.startswith("DISK_AND_DRAM"):
            if ":" in mt:
                num_slices = int(mt.split(":", 1)[1])
            fs = FeatureSet(features, labels, **kw)
            return fs.to_disk(cache_dir or ".zoo_featureset_cache",
                              num_slices, **kw)
        if mt in ("DEVICE", "HBM"):
            return FeatureSet(features, labels, **kw).cache_device()
        return FeatureSet(features, labels, **kw)

    def to_disk(self, cache_dir: str, num_slices: int,
                **kw) -> "DiskFeatureSet":
        """Write the DISK_AND_DRAM(num_slices) slices as ``.npz`` files
        (records in order, ``ceil(n / num_slices)`` a slice) and return
        the tier over them, with this set's shuffle and seed."""
        from analytics_zoo_tpu_torch.data.sharded import write_npz_shards
        paths = write_npz_shards(cache_dir, self.features, self.labels,
                                 num_slices, prefix="slice")
        feat_def = tree_flatten(self.features)[1]
        label_def = (tree_flatten(self.labels)[1]
                     if self.labels is not None else None)
        kw.setdefault("shuffle", self.shuffle)
        kw.setdefault("seed", self.seed)
        return DiskFeatureSet(paths, feat_def=feat_def, label_def=label_def,
                              **kw)

    def cache_device(self, shuffle_batches: Optional[bool] = None,
                     seed: Optional[int] = None) -> "DeviceFeatureSet":
        """The batches resident on the card (the DEVICE tier); epochs
        permute the batch order only."""
        return DeviceFeatureSet(self, shuffle_batches=shuffle_batches,
                                seed=seed)

    def __len__(self) -> int:
        return self._n

    def size(self) -> int:
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
                drop_remainder: bool = True, device=None, ctx=None):
        """``(x, y)`` batches as torch tensors on ``device`` (else
        ``ctx``'s mesh device), in the epoch's shuffled order
        (training)."""
        for x, y, _ in self.batches_with_counts(
                batch_size, epoch, drop_remainder, device, ordered=False,
                ctx=ctx):
            yield x, y

    def batches_with_counts(self, batch_size: int, epoch: int = 0,
                            drop_remainder: bool = True, device=None,
                            ordered: bool = True, ctx=None):
        """``(x, y, rows)`` on ``device`` (else ``ctx``'s mesh device, or
        its positions' devices); ordered by default (the evaluate /
        predict feed, whose outputs line up with the rows).  A ragged
        last batch keeps its real size on one device (it needs no
        padding) and is zero-padded when placed over positions; ``rows``
        counts the real ones.  Under the ``ctx`` of several processes,
        this process's rows of each batch."""
        device = _ctx_device(batch_size, device, ctx)
        for x, y in self.local_batches(batch_size, epoch, drop_remainder,
                                       ordered=ordered):
            rows = _process_rows(tree_leaves(x)[0].shape[0], ctx)
            if rows is not None:
                x = tree_map(lambda a: a[rows], x)
                y = None if y is None else tree_map(lambda a: a[rows], y)
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

    def size(self) -> int:
        return self.base.size()

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

    def stacked_epoch(self, batch_size: int, epoch: int = 0, device=None,
                      ctx=None):
        """``(xs, ys, steps, perm)``: every training batch of an epoch
        stacked on a leading axis, resident on ``device`` (else ``ctx``'s
        mesh device) and cached (one entry: a new batch size or device
        replaces it), and ``epoch``'s batch order (None: in order).
        ``None`` when an epoch has no full batch or the set has no
        labels, and under the ``ctx`` of several processes (each feeds its
        own rows, as the JAX tier's per-batch path does)."""
        device = _ctx_device(batch_size, device, ctx)
        steps = self.steps_per_epoch(batch_size, True)
        if (steps == 0 or self.base.labels is None
                or _multi_process(ctx)):
            return None
        key = (batch_size, repr(device) if isinstance(device, NamedSharding)
               else str(torch.device(device) if device is not None
                        else "cpu"))
        if key not in self._cache:
            self._cache.clear()
            stacked = self._compose(batch_size, steps, device)
            if stacked is None:
                return None
            self._cache[key] = stacked
        xs, ys, steps = self._cache[key]
        return xs, ys, steps, self._perm(steps, epoch)

    @staticmethod
    def _resident(a, device):
        """One leaf of the resident epoch, ``(steps, batch, ...)``: on
        ``device``, or each position's rows of every batch on its device
        (split over "data" along the batch axis)."""
        if isinstance(device, NamedSharding):
            return place_rows(a, device, dim=1)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def _compose(self, batch_size: int, steps: int, device):
        """The resident epoch: an in-memory base indexed once (a shuffled
        pass when batches shuffle); a streamed base's first epoch, its
        batches stacked in the order it gives them."""
        base = self.base
        put = lambda a: self._resident(a, device)
        if isinstance(base, FeatureSet):
            n = steps * batch_size
            idx = (base._epoch_indices(0)[:n] if self.shuffle_batches
                   else np.arange(n))

            def resh(a):
                a = np.asarray(a)[idx]
                return put(a.reshape((steps, batch_size) + a.shape[1:]))
            return (tree_map(resh, base.features),
                    tree_map(resh, base.labels), steps)
        batches = list(base.local_batches(batch_size, 0, True,
                                          ordered=not self.shuffle_batches))
        if not batches or batches[0][1] is None:
            return None
        return (tree_map(put, _stack([x for x, _ in batches])),
                tree_map(put, _stack([y for _, y in batches])), len(batches))

    def batches(self, batch_size: int, epoch: int = 0,
                drop_remainder: bool = True, device=None, ctx=None):
        for x, y, _ in self.batches_with_counts(
                batch_size, epoch, drop_remainder, device, ordered=False,
                ctx=ctx):
            yield x, y

    def batches_with_counts(self, batch_size: int, epoch: int = 0,
                            drop_remainder: bool = True, device=None,
                            ordered: bool = True, ctx=None):
        """Training batches (``drop_remainder``, in the epoch's order) come
        from the resident epoch; a ragged or row-ordered feed from a
        shuffled cache streams from the base."""
        device = _ctx_device(batch_size, device, ctx)
        cached = drop_remainder and not (ordered and self.shuffle_batches)
        if cached and _multi_process(ctx):
            # the resident epoch's batches and order, this process's rows
            batches = self._host_epoch(batch_size)
            perm = self._perm(len(batches), epoch)
            rows = _process_rows(batch_size, ctx)
            take = lambda a: a[rows]
            for i in (range(len(batches)) if ordered or perm is None
                      else perm):
                x, y = batches[int(i)]
                yield (to_device(tree_map(take, x), device),
                       to_device(tree_map(take, y), device),
                       rows.stop - rows.start)
            return
        stacked = (self.stacked_epoch(batch_size, epoch, device)
                   if cached else None)
        if stacked is None:
            yield from self.base.batches_with_counts(
                batch_size, epoch, drop_remainder, device, ordered=ordered)
            return
        xs, ys, steps, perm = stacked
        order = np.arange(steps) if ordered or perm is None else perm
        for i in order:
            take = lambda a: a[int(i)]      # a placed leaf: its rows' views
            yield tree_map(take, xs), tree_map(take, ys), batch_size

    def _host_epoch(self, batch_size: int) -> list:
        """The resident epoch's batches as host arrays (composed as
        ``_compose`` composes them), kept for the next epochs: what each
        of several processes feeds its rows from."""
        key = ("host", batch_size)
        if key not in self._cache:
            self._cache.clear()
            self._cache[key] = list(self.base.local_batches(
                batch_size, 0, True, ordered=not self.shuffle_batches))
        return self._cache[key]

    def evict(self) -> None:
        """Release the resident batches."""
        self._cache.clear()


def _stack(items: list) -> Tree:
    """Trees of one structure stacked leaf by leaf on a new leading axis."""
    flat = [tree_flatten(it) for it in items]
    return tree_unflatten(flat[0][1], [np.stack(col) for col in
                                       zip(*(leaves for leaves, _ in flat))])


class _Batchable:
    """The feeding surface of the streamed tiers: FeatureSet's, over their
    own ``local_batches``."""

    batches = FeatureSet.batches
    batches_with_counts = FeatureSet.batches_with_counts
    cache_device = FeatureSet.cache_device


class GeneratorFeatureSet(_Batchable):
    """A dataset streamed from a generator factory: ``gen()`` yields
    per-example ``(features, labels)`` tuples (or bare features), batched
    on the host; ``size`` bounds an epoch.

    ``shuffle=True`` is a seeded window shuffle (a shuffle buffer): records
    gather in windows of ``shuffle_window`` (default ``4 * batch_size``)
    and each window is permuted by its own ``epoch_rng(seed, epoch,
    "window", w)`` stream, so a deterministic producer replays the same
    epoch order.  Batches span window edges; no record is dropped there."""

    def __init__(self, gen: Callable[[], Iterator[Tuple]], size: int,
                 shuffle: bool = False, seed: int = 0,
                 shuffle_window: Optional[int] = None, **_):
        self.gen = gen
        self._n = size
        self.shuffle = shuffle
        self.seed = int(seed)
        self.shuffle_window = shuffle_window
        self.labels = True      # presence unknown until the first item

    def __len__(self) -> int:
        return self._n

    def size(self) -> int:
        return self._n

    def steps_per_epoch(self, batch_size: int,
                        drop_remainder: bool = True) -> int:
        return (self._n // batch_size if drop_remainder
                else math.ceil(self._n / batch_size))

    def _items(self):
        produced = 0
        for item in self.gen():
            if produced >= self._n:
                return
            if isinstance(item, tuple) and len(item) == 2:
                yield item
            else:
                yield item, None
            produced += 1

    def local_batches(self, batch_size: int, epoch: int = 0,
                      drop_remainder: bool = True, ordered: bool = False):
        window = (int(self.shuffle_window) if self.shuffle_window
                  else 4 * batch_size)
        shuffling = self.shuffle and not ordered
        buf_x, buf_y = [], []
        win_x, win_y = [], []
        widx = 0

        def drain_window():
            """Permute the full window under its own stream, move it into
            the batch buffer and yield the whole batches there."""
            nonlocal widx
            if shuffling and win_x:
                perm = epoch_rng(self.seed, epoch, "window",
                                 widx).permutation(len(win_x))
                win_x[:] = [win_x[int(i)] for i in perm]
                win_y[:] = [win_y[int(i)] for i in perm]
            widx += 1
            buf_x.extend(win_x)
            buf_y.extend(win_y)
            win_x.clear()
            win_y.clear()
            while len(buf_x) >= batch_size:
                bx, by = buf_x[:batch_size], buf_y[:batch_size]
                del buf_x[:batch_size], buf_y[:batch_size]
                yield _stack(bx), (None if by[0] is None else _stack(by))

        for x, y in self._items():
            win_x.append(x)
            win_y.append(y)
            if len(win_x) == window:
                yield from drain_window()
        yield from drain_window()
        if buf_x and not drop_remainder:
            yield _stack(buf_x), (None if buf_y[0] is None
                                  else _stack(buf_y))


class DiskFeatureSet(_Batchable):
    """DISK_AND_DRAM(numSlice): one slice file in host memory at a time; a
    data pass reads every slice.  Each slice is an ``.npz`` file with one
    ``f{j}`` (feature) / ``l{j}`` (label) array per leaf in
    ``tree_flatten`` order; ``feat_def`` / ``label_def`` rebuild the trees
    (without them one leaf is an array, several a tuple).  The slice order
    and each slice's record order are independent ``epoch_rng`` streams
    (``"slices"``; ``"slice", i``)."""

    def __init__(self, paths: Sequence[str], feat_def=None, label_def=None,
                 shuffle: bool = True, seed: int = 0, **_):
        if not paths:
            raise ValueError("no slice files")
        self.paths = list(paths)
        self.feat_def = feat_def
        self.label_def = label_def
        self.shuffle = shuffle
        self.seed = seed
        self._sizes: List[int] = []
        for p in self.paths:
            with np.load(p) as z:
                self._sizes.append(z[z.files[0]].shape[0])
        self._n = int(sum(self._sizes))

    def __len__(self) -> int:
        return self._n

    def size(self) -> int:
        return self._n

    @property
    def num_slices(self) -> int:
        return len(self.paths)

    def steps_per_epoch(self, batch_size: int,
                        drop_remainder: bool = True) -> int:
        if drop_remainder:
            return sum(s // batch_size for s in self._sizes)
        return sum(math.ceil(s / batch_size) for s in self._sizes)

    def _load_slice(self, i: int) -> FeatureSet:
        # indexed lookup, not sorted(): "f10" sorts before "f2"
        with np.load(self.paths[i]) as z:
            nf = sum(1 for k in z.files if k.startswith("f"))
            nl = sum(1 for k in z.files if k.startswith("l"))
            feats = [z[f"f{j}"] for j in range(nf)]
            labels = [z[f"l{j}"] for j in range(nl)]
        if self.feat_def is not None:
            features = tree_unflatten(self.feat_def, feats)
        else:
            features = feats[0] if len(feats) == 1 else tuple(feats)
        lab = None
        if labels:
            if self.label_def is not None:
                lab = tree_unflatten(self.label_def, labels)
            else:
                lab = labels[0] if len(labels) == 1 else tuple(labels)
        return FeatureSet(features, lab, shuffle=self.shuffle, seed=self.seed)

    @property
    def labels(self):
        with np.load(self.paths[0]) as z:
            return True if any(k.startswith("l") for k in z.files) else None

    def local_batches(self, batch_size: int, epoch: int = 0,
                      drop_remainder: bool = True, ordered: bool = False):
        order = np.arange(self.num_slices)
        if self.shuffle and not ordered:
            epoch_rng(self.seed, epoch, "slices").shuffle(order)
        for si in order:
            fs = self._load_slice(int(si))
            n = len(fs)
            if self.shuffle and not ordered:
                idx = epoch_rng(self.seed, epoch, "slice",
                                int(si)).permutation(n)
            else:
                idx = np.arange(n)
            steps = (n // batch_size if drop_remainder
                     else math.ceil(n / batch_size))
            for s in range(steps):
                sel = idx[s * batch_size:(s + 1) * batch_size]
                x = tree_map(lambda a: a[sel], fs.features)
                y = (None if fs.labels is None
                     else tree_map(lambda a: a[sel], fs.labels))
                yield x, y
