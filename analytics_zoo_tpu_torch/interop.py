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

What the JAX package keeps in ``state`` (a frozen embedding table,
BatchNormalization's ``moving_mean`` / ``moving_var``) is a buffer of the
module: ``state_tree`` reads the buffers and
``load_jax_params(module, params, state)`` writes them.  The layer
catalogue's trees cross the same way: convolution kernels ``(k..., in,
out)``, recurrent ``W`` / ``U`` / ``b``, ``Bidirectional``'s ``forward`` /
``backward`` subtrees, and ``TimeDistributed`` / ``KerasLayerWrapper``,
whose tree is their inner layer's, unnested.

Nothing is transposed or renamed.  Loading is strict: a key missing from
either side, or a shape that differs, raises and names the path.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

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


def _split(module: nn.Module):
    """``module``'s state_dict as (parameters, buffers) by path."""
    names = {n for n, _ in module.named_parameters()}
    items = module.state_dict().items()
    return ({p: t for p, t in items if p in names},
            {p: t for p, t in items if p not in names})


def _tree(flat: Mapping[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().cpu().numpy().copy()
    return _lists(tree)


def params_tree(module: nn.Module) -> dict:
    """The module's parameters as the JAX layout's nested dicts (and
    lists) of numpy arrays (copies on the host)."""
    return _tree(_split(module)[0])


def state_tree(module: nn.Module) -> dict:
    """The module's buffers (the JAX package's ``state``: frozen tables)
    in the same layout; ``{}`` when it has none."""
    return _tree(_split(module)[1])


@torch.no_grad()
def load_jax_params(module: nn.Module, tree: Mapping,
                    state: Optional[Mapping] = None) -> nn.Module:
    """Copy every leaf of ``tree`` into ``module``'s parameter of the same
    path, and every leaf of ``state`` into its buffer of the same path, on
    the tensor's own device and dtype.  Raises ``KeyError`` for a missing
    or extra key in either tree and ``ValueError`` for a shape mismatch,
    naming the path, before it writes anything."""
    params, buffers = _split(module)
    pairs = [("parameter", _flatten(tree), params),
             ("state", _flatten(state or {}), buffers)]
    for what, flat, target in pairs:
        missing = sorted(set(target) - set(flat))
        extra = sorted(set(flat) - set(target))
        if missing or extra:
            raise KeyError(f"{what} tree does not match "
                           f"{type(module).__name__}: missing {missing}, "
                           f"extra {extra}")
        for path, dst in target.items():
            shape = tuple(np.shape(flat[path]))
            if shape != tuple(dst.shape):
                raise ValueError(f"shape mismatch at {path!r}: tree has "
                                 f"{shape}, module has {tuple(dst.shape)}")
    for _, flat, target in pairs:
        for path, dst in target.items():
            # np.array copies: exported JAX leaves are read-only views
            dst.copy_(torch.from_numpy(np.array(flat[path], order="C")))
    return module
