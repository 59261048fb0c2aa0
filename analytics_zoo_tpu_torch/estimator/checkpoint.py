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
The per-host sharded layout is not ported (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import io
import os
import pickle
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.unported import reject

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


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array ``np.savez`` writes and its dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, np.dtype(a.dtype).name


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
    tensors, arrays or numbers."""
    reject("save_checkpoint", 5, per_host=per_host)
    leaves: list = []
    skeleton = _flatten(bundle, leaves)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt-{step}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays, dtypes = {}, {}
    for i, leaf in enumerate(leaves):
        arrays[f"a{i}"], dtypes[i] = _to_numpy(leaf)
    np.savez(os.path.join(tmp, "leaves.npz"), **arrays)
    with open(os.path.join(tmp, "treedef.pkl"), "wb") as fh:
        pickle.dump({"treedef": skeleton, "n": len(leaves), "step": step,
                     "partial": {}, "dtypes": dtypes, "writer": WRITER}, fh)
    with open(os.path.join(tmp, "COMPLETE"), "w") as fh:
        fh.write(str(step))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    _retain(directory, keep)
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
    ``count`` (Adam's before the schedule's) and every moment slot, each
    ``{dotted name: leaf}``."""
    if isinstance(tree, JaxNode):
        fields = _OPTAX_FIELDS.get(tree.name)
        if fields is None:            # MaskedState, EmptyState, ...
            for child in tree.children:
                _optax_state(child, out)
            return out
        for field, child in zip(fields, tree.children):
            if field == "count":
                out.setdefault("count", child)
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


def restore_checkpoint(path: str) -> Tuple[Any, int]:
    """``(bundle, step)`` of the checkpoint at ``path``, written by the
    port or by the JAX package, with CPU tensors as leaves.  The bundle is
    the port's ``(params, opt_state, state, meta)``: a JAX-written one is
    mapped onto dotted names and the port optimizer's slots; meta's
    numbers are ints."""
    with open(os.path.join(path, "treedef.pkl"), "rb") as fh:
        raw = fh.read()
    meta = _StubUnpickler(io.BytesIO(raw)).load()
    if meta.get("partial"):
        raise NotImplementedError(
            f"{path} is a per-host sharded checkpoint; its layout is not "
            "ported yet (ROADMAP Queue 1 item 5)")
    dtypes = meta.get("dtypes") or {}
    with np.load(os.path.join(path, "leaves.npz")) as z:
        leaves = [_to_tensor(z[f"a{i}"], dtypes.get(i))
                  for i in range(meta["n"])]
    if meta.get("writer") == WRITER:
        bundle = _unflatten(meta["treedef"], leaves)
        params, opt_state, state, info = bundle
        info = {k: (int(v) if isinstance(v, torch.Tensor) else v)
                for k, v in _dotted(info).items()}
        return (params, opt_state, state, _undot(info)), int(meta["step"])
    bundle = _unflatten(_jax_structure(meta["treedef"]), leaves)
    return _from_jax(bundle), int(meta["step"])
