"""Weights across the two packages.

A JAX parameter pytree, exported as nested dicts of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``), maps one to one onto a
port module: the module's ``state_dict`` keys are the tree's paths joined
with dots (see ``keras/engine.py``).  For the BERT classifier::

    {"bert": {"token_embed", "position_embed", "segment_embed",
              "pooler": {W, b}, "embed_ln": {gamma, beta},
              "<name>_block{i}": {"attn": {"qkv": {W, b}, "out": {W, b}},
                                  "ffn": {"fc1": {W, b}, "fc2": {W, b}},
                                  "ln1": {gamma, beta},
                                  "ln2": {gamma, beta}}},
     "head": {W, b}}

Lists and tuples in a tree are walked by index, so the decoder LM's
``{"blocks": [{"qkv": {W, b}, ...}, ...]}`` maps onto ``blocks.0.qkv.W``
(an ``nn.ModuleList``), and ``params_tree`` rebuilds a list wherever every
key of a level is a digit.

Nothing is transposed or renamed.  Loading is strict: a key missing from
either side, or a shape that differs, raises and names the path.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    items = (enumerate(tree) if isinstance(tree, (list, tuple))
             else tree.items())
    flat: Dict[str, np.ndarray] = {}
    for key, val in items:
        path = f"{prefix}{key}"
        if isinstance(val, (Mapping, list, tuple)):
            flat.update(_flatten(val, path + "."))
        else:
            flat[path] = val
    return flat


def _lists(node):
    """Nested dicts -> the same with every all-digit-keyed level a list."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[k] for k in sorted(out, key=int)]
    return out


def params_tree(module: nn.Module) -> dict:
    """The module's weights as the JAX layout's nested dicts (and lists)
    of numpy arrays (copies on the host)."""
    tree: dict = {}
    for path, t in module.state_dict().items():
        node = tree
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().cpu().numpy().copy()
    return _lists(tree)


@torch.no_grad()
def load_jax_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy every leaf of ``tree`` into ``module``'s parameter of the same
    path, on the parameter's own device and dtype.  Raises ``KeyError``
    for a missing or extra key and ``ValueError`` for a shape mismatch,
    naming the path, before it writes anything."""
    flat = _flatten(tree)
    target = module.state_dict()
    missing = sorted(set(target) - set(flat))
    extra = sorted(set(flat) - set(target))
    if missing or extra:
        raise KeyError(f"parameter tree does not match {type(module).__name__}:"
                       f" missing {missing}, extra {extra}")
    for path, dst in target.items():
        src = np.asarray(flat[path])
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape mismatch at {path!r}: tree has "
                             f"{tuple(src.shape)}, module has "
                             f"{tuple(dst.shape)}")
    for path, dst in target.items():
        # np.array copies: exported JAX leaves are read-only views
        dst.copy_(torch.from_numpy(np.array(flat[path], order="C")))
    return module
