"""Checkpoints: ``(params, opt_state, state, meta)`` bundles by step.

Port of the single-writer layout of ``analytics_zoo_tpu/estimator/
checkpoint.py``: one directory per step, ``ckpt-<step>/``, holding
``leaves.npz`` (leaf ``i`` as ``a<i>``), ``treedef.pkl`` (the tree's
structure, the leaf count, the step and every leaf's dtype by name) and
the ``COMPLETE`` marker.  A checkpoint is written into ``ckpt-<step>.tmp``
and renamed when complete, so a partial write is never restored;
``latest_checkpoint`` skips a directory without the marker, and ``keep``
retains the newest.  Dtypes are recorded by name because ``np.savez``
stores bf16 as raw 2-byte voids: bf16 leaves (a bf16 first moment) are
written as their bits and read back as bf16.

The bundle the port writes and restores is laid out by the port's names:
``params`` and ``state`` are ``{dotted name: tensor}`` (a module's
parameters and buffers), ``opt_state`` the port optimizer's state
(``{"count", <slot>: {name: tensor}}``), ``meta`` a dict of ints.

Restoring reads checkpoints of both packages.  One written by the JAX
package pickles a jax ``PyTreeDef`` in ``treedef.pkl``, which cannot be
unpickled without jax: it is read with an unpickler that turns jax's and
optax's classes into stubs and keeps the tree's node list (the post-order
``(kind, arity, keys or class, ...)`` records a ``PyTreeDef`` pickles), from
which the JAX flatten order of ``(params, opt_state, state, meta)`` is
rebuilt: dicts by sorted key, tuples and lists in order, optax's
namedtuple states by field (``ScaleByAdamState(count, mu, nu)`` inside
its chain).  The JAX parameter and state trees map onto dotted names
(``interop``'s layout) and the optax state onto the port optimizer's
slots.  Checkpoints written by the port are restorable by the port only:
its ``treedef.pkl`` holds the port's own structure, not a ``PyTreeDef``.
The ``checkpoint_write`` chaos point fires before every write, as in the
JAX package: a failed write takes the estimator's retry path, and the
tmp-then-rename layout keeps a partial write from being restorable.

Placed leaves (``parallel.ShardedTensor``: the estimator's weights and
optimizer state on a mesh) are written as their full arrays, each distinct
shard copied to the host into its block (``to_host_array``: no gather on
the device), so a checkpoint is independent of the mesh it came from and
restores onto any other.  The per-host layout (``save_checkpoint(
per_host=True)``, the JAX package's ``checkpoint.py:47-302``) writes each
sharded leaf as its shards instead: every process writes
``shards.h<p>.npz`` (its distinct shards) and ``shardidx.h<p>.pkl``
(``(leaf, array name, slice bounds)`` each), and ``treedef.pkl``'s
``partial`` names those leaves with their shape and dtype.  It is chosen
by itself (``needs_per_host``) when a sharded leaf spans processes (a
ZeRO-sharded optimizer slot over a "data" axis that several processes
split, or a Megatron-placed weight or slot of a model group split
across processes): process 0 makes the directory, every process writes its host
files between two barriers of the leaves' process group, process 0
writes the rest, marks it complete and renames it, and a third barrier
holds every process until the checkpoint exists.  Every process of such
a job must call ``save_checkpoint``; with replicated state only process 0
writes (the estimator's gate).  Restore merges the host files of either
package's per-host checkpoints into full arrays (so a checkpoint of two
processes restores in one) and fails loudly when they do not cover a
leaf (a missing host file).
"""

from __future__ import annotations

import io
import os
import pickle
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.parallel import distributed
from analytics_zoo_tpu_torch.parallel.mesh import ShardedTensor, block_table
from analytics_zoo_tpu_torch.testing import chaos

#: who wrote a checkpoint, in its treedef.pkl
WRITER = "analytics_zoo_tpu_torch"

class _Leaf:
    """Where leaf ``index`` sits in a port checkpoint's structure."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def __getstate__(self):
        return self.index

    def __setstate__(self, index):
        self.index = index


def _flatten(tree, leaves: list):
    """The tree's skeleton with ``_Leaf`` markers, its leaves appended to
    ``leaves`` in the JAX order (dicts by sorted key)."""
    if isinstance(tree, dict):
        return {k: _flatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, leaves) for v in tree)
    if tree is None:
        return None
    leaves.append(tree)
    return _Leaf(len(leaves) - 1)


def _unflatten(skeleton, leaves: list):
    if isinstance(skeleton, _Leaf):
        return leaves[skeleton.index]
    if isinstance(skeleton, JaxNode):
        return JaxNode(skeleton.name, [_unflatten(c, leaves)
                                       for c in skeleton.children])
    if isinstance(skeleton, dict):
        return {k: _unflatten(v, leaves) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_unflatten(v, leaves) for v in skeleton)
    return skeleton


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy (bf16 as its uint16 bits)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(leaf) -> str:
    dtype = leaf.dtype
    if isinstance(dtype, torch.dtype):
        return "bfloat16" if dtype == torch.bfloat16 else \
            torch.empty((), dtype=dtype).numpy().dtype.name
    return np.dtype(dtype).name


def _shard_items(leaf: ShardedTensor):
    """(slice-bounds key, host array) of each distinct shard, in position
    order: the one loop both layouts share.  A block several positions
    hold on different devices (per-position replicas) is copied from its
    first holder."""
    seen = set()
    for slices, t in leaf.unique_shards():
        key = tuple((sl.start, sl.stop, sl.step) for sl in slices)
        if key not in seen:
            seen.add(key)
            yield key, _host(t)


def to_host_array(a: Any) -> np.ndarray:
    """One leaf as a full host array, without a gather on the device: a
    placed leaf copies each distinct shard to the host into its block of
    the array (bf16 comes back as its uint16 bits: numpy has no bf16)."""
    if isinstance(a, ShardedTensor):
        out = np.empty(tuple(a.shape),
                       _host(a.local_shard.reshape(-1)[:0]).dtype)
        for key, arr in _shard_items(a):
            out[tuple(slice(*b) for b in key)] = arr
        return out
    if isinstance(a, torch.Tensor):
        return _host(a)
    return np.asarray(a)


def _is_partial(leaf) -> bool:
    """A sharded leaf some of whose blocks only other processes hold:
    what ``to_host_array`` cannot assemble here."""
    if not isinstance(leaf, ShardedTensor) \
            or leaf.sharding.is_fully_replicated \
            or leaf.sharding.mesh.process_count == 1:
        return False
    return any(p < 0 for _, _, p in block_table(leaf.sharding, leaf.shape))


def needs_per_host(bundle: Any) -> bool:
    """Whether checkpointing ``bundle`` needs every process to write (a
    sharded leaf spans processes): the automatic ``per_host`` choice."""
    leaves: list = []
    _flatten(bundle, leaves)
    return any(_is_partial(leaf) for leaf in leaves)


def _group_of(leaves):
    """The process group of the bundle's placed leaves, else the live
    context's (None: one process)."""
    for leaf in leaves:
        if isinstance(leaf, ShardedTensor):
            return leaf.sharding.mesh.group
    return distributed._group()


def _barrier(group, tag: str) -> None:
    if group is not None and group.size > 1:
        group.barrier(tag)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array ``np.savez`` writes and its dtype's name."""
    if isinstance(leaf, (torch.Tensor, ShardedTensor)):
        return to_host_array(leaf), _dtype_name(leaf)
    a = np.asarray(leaf)
    return a, np.dtype(a.dtype).name


def _write_host_shards(tmp: str, partial: dict, leaves, pidx: int) -> None:
    """This process's part of a per-host checkpoint: one npz of its
    distinct shards of every partial leaf, and the index of their slice
    bounds."""
    arrays, index = {}, []
    for i in partial:
        for j, (key, arr) in enumerate(_shard_items(leaves[i])):
            name = f"a{i}_s{j}"
            arrays[name] = arr
            index.append((i, name, key))
    np.savez(os.path.join(tmp, f"shards.h{pidx}.npz"), **arrays)
    with open(os.path.join(tmp, f"shardidx.h{pidx}.pkl"), "wb") as fh:
        pickle.dump(index, fh)


def _to_tensor(a: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    """A stored array as a CPU tensor of its recorded dtype (bf16 from its
    bits: npz keeps it as raw 2-byte voids or, from the port, uint16)."""
    if dtype_name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    if dtype_name is not None and a.dtype.kind == "V":
        a = a.view(np.dtype(dtype_name))
    return torch.from_numpy(np.array(a, order="C"))


def save_checkpoint(directory: str, step: int, bundle: Any,
                    keep: int = 3, per_host: bool = None) -> str:
    """Write ``ckpt-<step>/`` under ``directory`` (tmp then rename, the
    COMPLETE marker last) and keep the newest ``keep``; returns its path.
    ``bundle`` is a tree of dicts, lists and tuples whose leaves are
    tensors, placed tensors, arrays or numbers.  ``per_host=True`` writes
    every sharded leaf as this process's shards; None chooses it when a
    leaf spans processes (``needs_per_host``).  Over several processes
    each one calls this for a per-host checkpoint (its barriers pair
    with the others'); see the module docstring."""
    # fault-injection point: a failed write here must hit the Estimator's
    # checkpoint-restore retry path
    chaos.fire("checkpoint_write")
    leaves: list = []
    skeleton = _flatten(bundle, leaves)
    if per_host is None:
        per_host = any(_is_partial(leaf) for leaf in leaves)
    group = _group_of(leaves)
    pidx = 0 if group is None else group.rank
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt-{step}")
    tmp = path + ".tmp"
    if pidx == 0:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    partial = {}
    if per_host:
        _barrier(group, f"zoo_ckpt_start_{step}")   # tmp exists for all
        # dtypes by name: npz keeps bf16 as raw 2-byte words
        partial = {i: {"shape": tuple(leaf.shape),
                       "dtype": _dtype_name(leaf)}
                   for i, leaf in enumerate(leaves)
                   if isinstance(leaf, ShardedTensor)
                   and not leaf.sharding.is_fully_replicated}
        _write_host_shards(tmp, partial, leaves, pidx)
    if pidx == 0:
        arrays, dtypes = {}, {}
        for i, leaf in enumerate(leaves):
            if i not in partial:
                arrays[f"a{i}"], dtypes[i] = _to_numpy(leaf)
        np.savez(os.path.join(tmp, "leaves.npz"), **arrays)
        with open(os.path.join(tmp, "treedef.pkl"), "wb") as fh:
            pickle.dump({"treedef": skeleton, "n": len(leaves),
                         "step": step, "partial": partial,
                         "dtypes": dtypes, "writer": WRITER}, fh)
    if per_host:
        _barrier(group, f"zoo_ckpt_written_{step}")  # every host's shards
    if pidx == 0:
        with open(os.path.join(tmp, "COMPLETE"), "w") as fh:
            fh.write(str(step))
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        _retain(directory, keep)
    if per_host:
        # the returned path exists on every process once this returns
        _barrier(group, f"zoo_ckpt_done_{step}")
    return path


def _retain(directory: str, keep: int) -> None:
    ckpts = sorted(
        (int(d.split("-")[1]), d) for d in os.listdir(directory)
        if d.startswith("ckpt-") and not d.endswith(".tmp")
        and d.split("-")[1].isdigit())
    for _, d in ckpts[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_checkpoint(directory: str) -> Optional[str]:
    """The complete ``ckpt-<step>`` of the highest step, or None."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for d in os.listdir(directory):
        if not d.startswith("ckpt-") or d.endswith(".tmp"):
            continue
        full = os.path.join(directory, d)
        if not os.path.exists(os.path.join(full, "COMPLETE")):
            continue
        try:
            step = int(d.split("-")[1])
        except ValueError:
            continue
        if step > best_step:
            best, best_step = full, step
    return best


# --- reading a checkpoint the JAX package wrote ----------------------------

class _Stub:
    """Any class of jax, jaxlib or optax met while unpickling: keeps the
    state it is given and nothing else."""

    def __init__(self, *args, **kwargs):
        self.args = args

    def __setstate__(self, state):
        self.state = state


class _StubUnpickler(pickle.Unpickler):
    _FOREIGN = ("jax", "jaxlib", "optax", "ml_dtypes", "analytics_zoo_tpu")

    def find_class(self, module, name):
        if module.split(".")[0] in self._FOREIGN:
            return type(name, (_Stub,), {"stub_module": module})
        return super().find_class(module, name)


class JaxNode:
    """A namedtuple node of a JAX tree (an optax state), by class name."""

    def __init__(self, name: str, children: list):
        self.name = name
        self.children = children

    def __repr__(self):
        return f"{self.name}({self.children})"


def _jax_structure(treedef) -> Any:
    """The skeleton of a pickled ``PyTreeDef``: its post-order node list
    ``(kind, arity, data, ...)`` rebuilt into dicts (kind 5, ``data`` the
    sorted keys), tuples (2), lists (4), ``JaxNode``s (3, ``data`` the
    namedtuple class), None (1) and ``_Leaf`` markers (0) numbered in
    flatten order."""
    state = getattr(treedef, "state", None)
    if not (isinstance(state, tuple) and len(state) == 2
            and isinstance(state[1], list)):
        raise ValueError("treedef.pkl holds no PyTreeDef node list this "
                         "reader knows")
    stack, n_leaves = [], 0
    for node in state[1]:
        kind, arity, data = node[0], node[1], node[2]
        kids = stack[len(stack) - arity:] if arity else []
        if arity:
            del stack[len(stack) - arity:]
        if kind == 0:
            stack.append(_Leaf(n_leaves))
            n_leaves += 1
        elif kind == 1:
            stack.append(None)
        elif kind == 2:
            stack.append(tuple(kids))
        elif kind == 3:
            stack.append(JaxNode(getattr(data, "__name__", str(data)), kids))
        elif kind == 4:
            stack.append(list(kids))
        elif kind == 5:
            stack.append(dict(zip(data, kids)))
        else:
            raise ValueError(f"treedef.pkl has a node of kind {kind} (a "
                             "custom pytree node) this reader cannot map")
    if len(stack) != 1:
        raise ValueError("treedef.pkl's node list does not form one tree")
    return stack[0]


#: optax state classes -> their fields, in flatten order
_OPTAX_FIELDS = {
    "ScaleByAdamState": ("count", "mu", "nu"),
    "ScaleByScheduleState": ("count",),
    "TraceState": ("trace",),
    "ScaleByRssState": ("sum_of_squares",),
    "ScaleByAdaDeltaState": ("e_g", "e_x"),
    "ScaleByRmsState": ("nu",),
    "ScaleByRmsWithCountState": ("count", "nu"),
}


def _dotted(tree, prefix: str = "") -> Dict[str, Any]:
    """A nested JAX parameter tree -> ``{dotted name: leaf}``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_dotted(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_dotted(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def _optax_state(tree, out: dict) -> dict:
    """The port optimizer's state from an optax state tree: the first
    ``count`` (Adam's before the schedule's), a second one as
    ``schedule_count``, and every moment slot, each ``{dotted name:
    leaf}``."""
    if isinstance(tree, JaxNode):
        fields = _OPTAX_FIELDS.get(tree.name)
        if fields is None:            # MaskedState, EmptyState, ...
            for child in tree.children:
                _optax_state(child, out)
            return out
        for field, child in zip(fields, tree.children):
            if field == "count":
                out.setdefault("schedule_count" if "count" in out
                               else "count", child)
            else:
                out.setdefault(field, _dotted(child))
    elif isinstance(tree, (list, tuple)):
        for child in tree:
            _optax_state(child, out)
    return out


def _from_jax(bundle) -> tuple:
    params, opt_state, state, meta = bundle
    meta = {k: (int(v) if isinstance(v, torch.Tensor) else v)
            for k, v in _dotted(meta).items()}
    return (_dotted(params), _optax_state(opt_state, {}),
            _dotted(state or {}), _undot(meta))


def _undot(flat: Dict[str, Any]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _merge_host_shards(path: str, partial: dict) -> dict:
    """The per-host shard files (of either package) merged into full
    arrays, one a partial leaf; a leaf the files do not cover (a host's
    file missing or torn) raises.  bf16 leaves come back as their uint16
    bits."""
    def storage(dtype_name):
        return np.dtype(np.uint16 if dtype_name == "bfloat16"
                        else dtype_name)

    out = {i: np.empty(tuple(m["shape"]), storage(m["dtype"]))
           for i, m in partial.items()}
    covered = {i: 0 for i in partial}
    seen = {i: set() for i in partial}
    for fname in sorted(os.listdir(path)):
        if not (fname.startswith("shardidx.h") and fname.endswith(".pkl")):
            continue
        host = fname[len("shardidx."):-len(".pkl")]
        with open(os.path.join(path, fname), "rb") as fh:
            index = _StubUnpickler(fh).load()
        with np.load(os.path.join(path, f"shards.{host}.npz")) as z:
            for i, name, key in index:
                if key in seen[i]:       # another host's copy of a block
                    continue
                seen[i].add(key)
                arr = z[name]
                if arr.dtype != out[i].dtype:
                    # npz keeps bf16 (and the JAX writer's ml_dtypes) as
                    # raw 2-byte words: the recorded dtype reads them
                    arr = arr.view(out[i].dtype)
                out[i][tuple(slice(*b) for b in key)] = arr
                covered[i] += arr.size
    for i, m in partial.items():
        want = int(np.prod(m["shape"])) if m["shape"] else 1
        if covered[i] != want:
            raise ValueError(
                f"per-host checkpoint at {path} does not cover leaf {i}: "
                f"{covered[i]} of {want} elements present (a host's "
                "shard file is missing or torn)")
    return out


def restore_checkpoint(path: str) -> Tuple[Any, int]:
    """``(bundle, step)`` of the checkpoint at ``path``, written by the
    port or by the JAX package, with CPU tensors as leaves.  The bundle is
    the port's ``(params, opt_state, state, meta)``: a JAX-written one is
    mapped onto dotted names and the port optimizer's slots; meta's
    numbers are ints."""
    with open(os.path.join(path, "treedef.pkl"), "rb") as fh:
        raw = fh.read()
    meta = _StubUnpickler(io.BytesIO(raw)).load()
    partial = meta.get("partial") or {}
    dtypes = dict(meta.get("dtypes") or {})
    merged = _merge_host_shards(path, partial) if partial else {}
    dtypes.update({i: m["dtype"] for i, m in partial.items()})
    with np.load(os.path.join(path, "leaves.npz")) as z:
        leaves = [_to_tensor(merged[i] if i in merged else z[f"a{i}"],
                             dtypes.get(i)) for i in range(meta["n"])]
    if meta.get("writer") == WRITER:
        bundle = _unflatten(meta["treedef"], leaves)
        params, opt_state, state, info = bundle
        info = {k: (int(v) if isinstance(v, torch.Tensor) else v)
                for k, v in _dotted(info).items()}
        return (params, opt_state, state, _undot(info)), int(meta["step"])
    bundle = _unflatten(_jax_structure(meta["treedef"]), leaves)
    return _from_jax(bundle), int(meta["step"])
