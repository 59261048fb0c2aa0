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

Nothing is transposed or renamed.  Loading is strict: a key missing from
either side, or a shape that differs, raises and names the path.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path + "."))
        else:
            flat[path] = val
    return flat


def params_tree(module: nn.Module) -> dict:
    """The module's weights as the JAX layout's nested dicts of numpy
    arrays (copies on the host)."""
    tree: dict = {}
    for path, t in module.state_dict().items():
        node = tree
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().cpu().numpy().copy()
    return tree


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
