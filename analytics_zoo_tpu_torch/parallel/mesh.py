"""A named grid of devices, partition specs and placed tensors: the
port's counterparts of ``jax.sharding.Mesh``, ``PartitionSpec``,
``NamedSharding`` and ``jax.device_put``.

The JAX package is single-controller: one program runs a ``shard_map``
over a ``Mesh`` of devices.  Within a process the port keeps that model:
the process holds every shard of its positions and places each on the
device at its mesh coordinate.  A mesh may span several processes
(``processes``: the process of each position; ``process_index``: this
one; ``group``: their ``parallel.distributed.Group``), as a JAX mesh spans
the devices of every host: a position of another process is not
addressable here, and a ``ShardedTensor`` holds this process's shards
only.  A device may appear more than once
(``Mesh(["cuda:0"] * 4, ("sequence",))`` runs four shards on one card,
``["cpu"] * 8`` eight on the host), the counterpart of XLA's virtual host
devices; moving a shard to a device it is already on costs nothing.

``device_put(x, NamedSharding(mesh, spec))`` returns a ``ShardedTensor``:
one contiguous tensor per mesh position, on that position's device,
holding the block of ``x`` the spec gives the position (positions that
hold the same block on the same device share one tensor).  Its
collectives work in place, in mesh-position order: ``all_gather_into`` a
global buffer, ``reduce_scatter_`` from a global tensor of partial sums,
and ``scatter_`` from a global value every process holds.  Within one
process they copy between fixed addresses (so a CUDA graph can replay
them; on one card a slice and a copy, or an add); across processes they
add a collective of the group (an all-gather of the blocks a process
lacks, ``exchange``; an all-reduce of the partial sums).  Trees are
nested dicts, lists and tuples; their leaf paths join the keys with
``/``, and a dict key's ``.`` (a ``state_dict`` key) counts as ``/``
too, so a rule written for a JAX path matches the same port leaf.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """``devices``: a nested sequence (or object array) of devices or device
    strings, one dimension per name in ``axis_names``.  ``processes``
    (same shape; default all 0) gives the process of each position,
    ``process_index`` this process and ``group`` the processes'
    ``parallel.distributed.Group`` (None: one process)."""

    def __init__(self, devices, axis_names: Sequence[str], *,
                 processes=None, process_index: int = 0, group=None):
        raw = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if raw.ndim != len(axis_names):
            raise ValueError(f"a mesh of {raw.ndim} dimension(s) "
                             f"{raw.shape} needs as many axis names, got "
                             f"{axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names must differ, got {axis_names}")
        flat = np.empty(raw.size, dtype=object)
        flat[:] = [torch.device(d) for d in raw.flat]
        self.devices = flat.reshape(raw.shape)
        self.axis_names = axis_names
        procs = (np.zeros(raw.shape, dtype=np.int64) if processes is None
                 else np.asarray(processes, dtype=np.int64))
        if procs.shape != raw.shape:
            raise ValueError(f"processes {procs.shape} must have the "
                             f"devices' shape {raw.shape}")
        self.processes = procs
        self.process_index = int(process_index)
        self.group = group
        if group is not None and (group.rank, group.size) != (
                self.process_index, int(procs.max()) + 1):
            raise ValueError(f"{group} does not match a mesh of "
                             f"{int(procs.max()) + 1} processes seen from "
                             f"process {self.process_index}")
        self._local = [p for p, q in enumerate(procs.flat)
                       if q == self.process_index]
        if not self._local:
            raise ValueError(f"process {self.process_index} holds no "
                             "position of this mesh")

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: size}`` in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def device(self, coords: Mapping[str, int]) -> torch.device:
        """The device at ``coords`` (``{axis name: index}``); an axis left
        out is taken at index 0."""
        unknown = set(coords) - set(self.axis_names)
        if unknown:
            raise ValueError(f"no mesh axis {sorted(unknown)}; axes are "
                             f"{self.axis_names}")
        return self.devices[tuple(coords.get(a, 0) for a in self.axis_names)]

    def coords(self, position: int) -> Dict[str, int]:
        """``{axis name: index}`` of flat position ``position`` (the order
        of ``devices.flat``)."""
        idx = np.unravel_index(position, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    @property
    def process_count(self) -> int:
        return int(self.processes.max()) + 1

    def is_local(self, position: int) -> bool:
        """Whether flat position ``position`` belongs to this process."""
        return int(self.processes.flat[position]) == self.process_index

    @property
    def local_positions(self) -> List[int]:
        """This process's flat positions, in order."""
        return list(self._local)

    @property
    def local_devices(self) -> List[torch.device]:
        """The devices of this process's positions, in position order."""
        return [self.devices.flat[p] for p in self._local]

    def local_range(self, axis: str) -> range:
        """The coordinates along ``axis`` of this process's positions (a
        process holds a contiguous range of every axis)."""
        idx = sorted({self.coords(p)[axis] for p in self._local})
        return range(idx[0], idx[-1] + 1)

    def reshaped(self, shape, axis_names: Sequence[str]) -> "Mesh":
        """The same positions, processes and group in another layout."""
        return Mesh(self.devices.reshape(shape), axis_names,
                    processes=self.processes.reshape(shape),
                    process_index=self.process_index, group=self.group)

    def __repr__(self):
        devices = sorted({str(d) for d in self.local_devices})
        if self.process_count == 1:
            return f"Mesh({self.shape}, devices={devices})"
        return (f"Mesh({self.shape}, process {self.process_index} of "
                f"{self.process_count}, devices={devices})")


class PartitionSpec(tuple):
    """One entry per leading dimension: None (not split), an axis name, or
    a tuple of axis names (split over their product, the first major).
    Dimensions past the spec's length are not split.  Equal to the tuple
    of its entries, as JAX's is."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class NamedSharding:
    """A ``PartitionSpec`` over ``mesh``: which block of a tensor each mesh
    position holds."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        spec = PartitionSpec(*spec)
        for entry in spec:
            for axis in _axes(entry):
                if axis not in mesh.axis_names:
                    raise ValueError(f"no mesh axis {axis!r}; axes are "
                                     f"{mesh.axis_names}")
        self.mesh = mesh
        self.spec = spec

    def _parts(self, dim: int) -> int:
        entry = self.spec[dim] if dim < len(self.spec) else None
        return math.prod(self.mesh.shape[a] for a in _axes(entry))

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        """The shape of the block one position holds."""
        global_shape = tuple(global_shape)
        if len(self.spec) > len(global_shape):
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"shape {global_shape} has dimensions")
        out = []
        for dim, n in enumerate(global_shape):
            parts = self._parts(dim)
            if n % parts:
                raise ValueError(f"dimension {dim} of {global_shape} does "
                                 f"not divide into {parts} shards "
                                 f"({self.spec})")
            out.append(n // parts)
        return tuple(out)

    def index(self, position: int, global_shape) -> Tuple[slice, ...]:
        """The slices of the global tensor that flat mesh position
        ``position`` holds."""
        block = self.shard_shape(global_shape)
        coords = self.mesh.coords(position)
        out = []
        for dim, size in enumerate(block):
            entry = self.spec[dim] if dim < len(self.spec) else None
            i = 0
            for axis in _axes(entry):
                i = i * self.mesh.shape[axis] + coords[axis]
            out.append(slice(i * size, (i + 1) * size))
        return tuple(out)

    @property
    def is_fully_replicated(self) -> bool:
        """Whether every position holds the whole tensor (no entry of the
        spec names an axis above size 1)."""
        return all(self._parts(d) == 1 for d in range(len(self.spec)))

    def unique_blocks(self, global_shape
                      ) -> List[Tuple[int, Tuple[slice, ...]]]:
        """``(position, slices)`` of each distinct block of this process's
        positions, in position order: positions that hold the same block
        on the same device count once, at the first of them."""
        seen, out = set(), []
        for p in self.mesh.local_positions:
            dev = self.mesh.devices.flat[p]
            slices = self.index(p, global_shape)
            key = (str(dev), _key(slices))
            if key not in seen:
                seen.add(key)
                out.append((p, slices))
        return out

    def __repr__(self):
        return f"NamedSharding(mesh={self.mesh.shape}, spec={self.spec!r})"


def _key(slices) -> tuple:
    return tuple((s.start, s.stop) for s in slices)


def block_table(sharding: "NamedSharding", global_shape
                ) -> List[Tuple[Tuple[slice, ...], List[int], int]]:
    """Every distinct block of the global tensor under ``sharding``, in the
    position order of its first holder: ``(slices, processes that hold
    it, this process's first position holding it or -1)``.  The same on
    every process (but for the last field)."""
    mesh = sharding.mesh
    rows: Dict[tuple, list] = {}
    for p in range(mesh.size):
        slices = sharding.index(p, global_shape)
        row = rows.setdefault(_key(slices), [slices, [], -1])
        q = int(mesh.processes.flat[p])
        if q not in row[1]:
            row[1].append(q)
        if row[2] < 0 and q == mesh.process_index:
            row[2] = p
    return [tuple(r) for r in rows.values()]


def exchange(entries, group, like: torch.Tensor) -> None:
    """The cross-process part of an all-gather, in one collective.
    ``entries``: ``(owner, numel, src, dst)`` for every block that some
    process lacks, in an order every process shares; ``src`` is the
    owner's tensor of the block (None elsewhere), ``dst`` where a process
    that lacks the block takes it (None where it holds it).  Each process
    sends the blocks it owns, packed in order and padded to the longest
    process's pack, in ``like``'s dtype on its device."""
    if not entries:
        return
    sizes = [0] * group.size
    for owner, numel, _, _ in entries:
        sizes[owner] += numel
    mine = [e[2].reshape(-1) for e in entries if e[0] == group.rank]
    buf = torch.zeros(max(sizes), dtype=like.dtype, device=like.device)
    if mine:
        torch.cat(mine, out=buf[:sizes[group.rank]])
    packs = group.all_gather(buf)
    at = [0] * group.size
    for owner, numel, _, dst in entries:
        if dst is not None:
            src = packs[owner][at[owner]:at[owner] + numel]
            dst.copy_(src.view(dst.shape))
        at[owner] += numel


class ShardedTensor:
    """A tensor placed over a mesh: ``shards[p]`` is the contiguous block
    of mesh position ``p`` (``mesh.devices.flat`` order) on that
    position's device, None for a position of another process; ``shape``
    is the global shape.  The shards are updated in place, never
    replaced, so the lookups below are worked out once (a decode step
    makes them for every layer)."""

    def __init__(self, shards: Sequence[torch.Tensor], shape,
                 sharding: NamedSharding):
        self.shards = list(shards)
        self.shape = torch.Size(shape)
        self.sharding = sharding
        if len(self.shards) != sharding.mesh.size:
            raise ValueError(f"{len(self.shards)} shards for a mesh of "
                             f"{sharding.mesh.size} positions")
        self._unique: List[Tuple[Tuple[slice, ...], torch.Tensor]] = []
        self._by_coords: Dict[tuple, torch.Tensor] = {}
        self._items: Dict[int, "ShardedTensor"] = {}

    @property
    def dtype(self) -> torch.dtype:
        return self.local_shard.dtype

    @property
    def local_shard(self) -> torch.Tensor:
        """This process's first shard."""
        return self.shards[self.sharding.mesh.local_positions[0]]

    def unique_shards(self) -> List[Tuple[Tuple[slice, ...], torch.Tensor]]:
        """``(global slices, tensor)`` of each distinct shard tensor of
        this process: what an in-place update writes to."""
        if not self._unique:
            seen = set()
            for p, t in enumerate(self.shards):
                if t is not None and id(t) not in seen:
                    seen.add(id(t))
                    self._unique.append(
                        (self.sharding.index(p, self.shape), t))
        return self._unique

    def shard(self, coords: Mapping[str, int]) -> torch.Tensor:
        """The shard at mesh ``coords`` (absent axes at index 0)."""
        mesh = self.sharding.mesh
        key = tuple(coords.get(a, 0) for a in mesh.axis_names)
        t = self._by_coords.get(key)
        if t is None:
            flat = np.ravel_multi_index(key, mesh.devices.shape)
            t = self._by_coords[key] = self.shards[int(flat)]
        return t

    def __getitem__(self, i: int) -> "ShardedTensor":
        """Index ``i`` of the leading dimension, which must not be split:
        each shard's ``[i]`` (a contiguous view of a contiguous shard)."""
        if not isinstance(i, int):
            raise TypeError("a ShardedTensor takes one integer index")
        item = self._items.get(i)
        if item is not None:
            return item
        spec = self.sharding.spec
        if spec and _axes(spec[0]):
            raise ValueError(f"dimension 0 is split ({spec})")
        views: Dict[int, torch.Tensor] = {}
        shards = [None if t is None else views.setdefault(id(t), t[i])
                  for t in self.shards]
        item = self._items[i] = ShardedTensor(
            shards, self.shape[1:], NamedSharding(
                self.sharding.mesh, PartitionSpec(*spec[1:])))
        return item

    def all_gather_into(self, out: torch.Tensor) -> torch.Tensor:
        """The all-gather into a fixed buffer: every distinct shard copied
        into its block of ``out`` (the global shape), in position order;
        a shard that already is that block of ``out`` (the same memory)
        is skipped.  In place and capturable within one process: a CUDA
        graph replays the same copies between the same addresses.  The
        blocks this process lacks come from their owners (``exchange``)."""
        for slices, t in self.unique_shards():
            block = out[slices]
            if not _same_memory(block, t):
                block.copy_(t)
        mesh = self.sharding.mesh
        if mesh.process_count > 1:
            entries = []
            for slices, holders, p in block_table(self.sharding, self.shape):
                if len(holders) == mesh.process_count:
                    continue
                owner = min(holders)
                numel = math.prod(sl.stop - sl.start for sl in slices)
                entries.append((owner, numel,
                                self.shards[p] if owner == mesh.process_index
                                else None, None if p >= 0 else out[slices]))
            exchange(entries, mesh.group, out)
        return out

    def reduce_scatter_(self, src: torch.Tensor,
                        accumulate: bool = False) -> "ShardedTensor":
        """The reduce-scatter into these shards, in place: ``src`` (the
        global shape) holds this process's sums over its positions (one
        process computes its whole batch); across processes they are
        summed first (an all-reduce of a copy of ``src``).  Each distinct
        shard then takes its block, in position order, written
        (``copy_``) or added (``accumulate``) in the shard's dtype.  On one
        card it is a slice and a copy."""
        mesh = self.sharding.mesh
        if mesh.process_count > 1:
            src = mesh.group.all_reduce(src.clone())
        return self.scatter_(src, accumulate)

    def scatter_(self, src: torch.Tensor,
                 accumulate: bool = False) -> "ShardedTensor":
        """Each distinct shard of this process takes its block of ``src``
        (a global value every process holds, such as a checkpoint's full
        array), written or added in the shard's dtype; no collective."""
        for slices, t in self.unique_shards():
            block = src[slices]
            if accumulate:
                t.add_(block.to(t.dtype))
            elif not _same_memory(block, t):
                t.copy_(block)
        return self

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: the first local
        shard's), from every process's shards."""
        device = torch.device(device) if device is not None \
            else self.local_shard.device
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        return self.all_gather_into(out)

    def __repr__(self):
        return (f"ShardedTensor(shape={tuple(self.shape)}, "
                f"dtype={self.dtype}, sharding={self.sharding!r})")


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` are views of the same elements."""
    return (a.device == b.device and a.data_ptr() == b.data_ptr()
            and a.shape == b.shape and a.stride() == b.stride())


def _place(x, sharding: NamedSharding) -> ShardedTensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    mesh = sharding.mesh
    made: Dict[tuple, torch.Tensor] = {}
    shards = []
    for p, dev in enumerate(mesh.devices.flat):
        if not mesh.is_local(p):
            shards.append(None)
            continue
        slices = sharding.index(p, x.shape)
        key = (str(dev), _key(slices))
        if key not in made:
            made[key] = x[slices].to(dev).contiguous()
        shards.append(made[key])
    return ShardedTensor(shards, x.shape, sharding)


def device_put(tree: Any, sharding: Any) -> Any:
    """Place every leaf of ``tree`` (tensors or numpy arrays) by
    ``sharding``: one ``NamedSharding`` for all, or a tree of them
    matching ``tree``.  A shard that is a contiguous block of a
    tensor already on its device shares that tensor's memory.  Over
    several processes each places its own positions' shards from the
    full value it holds (JAX's ``make_array_from_callback`` contract)."""
    if isinstance(sharding, NamedSharding):
        return tree_map(lambda x: _place(x, sharding), tree)
    return tree_map(_place, tree, sharding)


# --- trees ------------------------------------------------------------------

def _is_node(x) -> bool:
    return isinstance(x, (dict, list)) or (
        isinstance(x, tuple) and not isinstance(x, PartitionSpec))


def _children(x) -> List[Tuple[str, Any]]:
    if isinstance(x, dict):
        return [(str(k).replace(".", "/"), v) for k, v in x.items()]
    return [(str(i), v) for i, v in enumerate(x)]


def _rebuild(x, values: List[Any]):
    if isinstance(x, dict):
        return type(x)(zip(x.keys(), values))
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*values)
    return type(x)(values)


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any,
                       _path: str = "") -> Any:
    """``fn(path, leaf, *matching leaves of rest)`` over the leaves of
    ``tree`` (None is an empty subtree and stays None); ``rest`` match
    ``tree``'s structure down to its leaves."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(_path, tree, *rest)
    kids = _children(tree)
    if isinstance(tree, dict):
        others = [[r[k] for k in tree] for r in rest]
    else:
        others = [list(r) for r in rest]
        for r in others:
            if len(r) != len(kids):
                raise ValueError(f"tree structures differ at {_path!r}")
    values = [tree_map_with_path(
        fn, v, *(o[i] for o in others),
        _path=f"{_path}/{k}" if _path else k)
        for i, (k, v) in enumerate(kids)]
    return _rebuild(tree, values)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    return tree_map_with_path(lambda _, *xs: fn(*xs), tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out
