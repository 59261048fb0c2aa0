"""The embedding layers.

Port of ``analytics_zoo_tpu/keras/layers/embedding.py``: ``Embedding``, a
``(input_dim, output_dim)`` table, ``embeddings``, gathered by the
input's ids.  A trainable table is a parameter; a frozen one
(``trainable=False``) is a buffer, the JAX layer's ``state``, which no
optimizer sees.  ``WordEmbedding`` is a frozen table of pretrained word
vectors, read from a GloVe text file (one ``word v1 v2 ...`` line each)
through a word index; ``SparseEmbedding`` is ``Embedding`` (a dense
gather), as in the JAX package.

``partition`` is the JAX layer's sharding hint, stored and read by
nothing, as there: the estimator's Megatron rules shard a trainable
table's vocab over "model" by its path (``embed[^/]*/embeddings$``,
``parallel/sharding.py``).

Ids outside the table give what ``jnp.take`` gives in the JAX package:
an id in ``[-input_dim, 0)`` counts from the end, and any other
out-of-range id gives a row of NaN (with no gradient to the table).  The
gather never sees such an id, so no device-side assert can fire.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras import initializers
from analytics_zoo_tpu_torch.keras.engine import Layer


class Embedding(Layer):
    def __init__(self, input_dim: int, output_dim: int, init="uniform",
                 trainable: bool = True, weights: Optional[np.ndarray] = None,
                 partition: Optional[str] = None, **kw):
        super().__init__(**kw)
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.kernel_init = initializers.get(init)
        self.trainable = trainable
        self.pretrained = weights
        # sharding hint: "model" shards the vocab dim over the tp axis
        self.partition = partition
        if weights is not None and np.shape(weights) != (input_dim,
                                                         output_dim):
            raise ValueError("pretrained embedding shape mismatch")
        table = torch.empty(input_dim, output_dim)
        if trainable:
            self.embeddings = nn.Parameter(table)
        else:
            self.register_buffer("embeddings", table)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        if self.pretrained is None:
            self.kernel_init(self.embeddings, generator)
        else:
            self.embeddings.copy_(torch.from_numpy(
                np.asarray(self.pretrained, np.float32)))

    def forward(self, x):
        return take_rows(self.embeddings, x)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.output_dim,)


def take_rows(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, x.astype(int32), axis=0)``: an id in ``[-n, 0)``
    counts from the end, any other out-of-range id gives a NaN row, and
    the gather never sees such an id (no device-side assert)."""
    ids = x.to(torch.int32) if x.is_floating_point() else x  # as astype
    n = table.shape[0]
    ids = torch.where(ids < 0, ids + n, ids)
    valid = (ids >= 0) & (ids < n)
    rows = gather_rows(table, torch.where(valid, ids, 0))
    return torch.where(valid.unsqueeze(-1), rows, float("nan"))


class _OrderedGather(torch.autograd.Function):
    """``F.embedding(ids, table)`` with a backward whose sums do not
    depend on the run.  The gather's own backward on the card adds the
    gradients of an id's positions into its row in no fixed order, which
    on a row that many positions share (a padding id, BERT's two
    segments) made two runs of a training step differ.  Adding them in
    turn (``index_put_`` with ``accumulate``) is fixed but serial, about
    a microsecond a position on the longest row; a scan of all the
    positions' gradients lets each row's sum take rounding from every
    other row's.  Here the positions are sorted by id (stably) and each
    id's gradients are summed among themselves as a tree: at step ``s``
    every position adds the one ``s`` after it if that one holds the same
    id, so after ``log2(n)`` steps the first position of each id holds
    its sum."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.shape, ctx.dtype = table.shape, table.dtype
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        rows, width = ctx.shape
        sid, order = torch.sort(ids.reshape(-1), stable=True)
        x = grad.reshape(-1, width)[order].to(ctx.dtype)
        n, s = x.shape[0], 1
        if not n:
            return grad.new_zeros(ctx.shape, dtype=ctx.dtype), None
        while s < n:
            x[:-s] += torch.where((sid[s:] == sid[:-s])[:, None], x[s:], 0.0)
            s *= 2
        every = torch.arange(rows, device=sid.device, dtype=sid.dtype)
        first = torch.searchsorted(sid, every).clamp(max=n - 1)
        return torch.where((sid[first] == every)[:, None], x[first], 0.0), None


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, table)``; on the card, when the table takes a
    gradient, through ``_OrderedGather``.  On the CPU the gather's
    backward already adds in position order, as the JAX package's
    scatter-add does."""
    ids = ids.long()
    if table.is_cuda and table.requires_grad and torch.is_grad_enabled():
        return _OrderedGather.apply(table, ids)
    return F.embedding(ids, table)


class WordEmbedding(Embedding):
    """Pretrained word vectors, frozen by default.  ``embedding_file`` (a
    GloVe text file) with ``word_index`` (word -> row; default the file's
    order from row 1) gives the table; row 0 and words missing from the
    file stay zero."""

    def __init__(self, embedding_file: Optional[str] = None,
                 word_index: Optional[dict] = None, trainable: bool = False,
                 input_dim: Optional[int] = None,
                 output_dim: Optional[int] = None,
                 weights: Optional[np.ndarray] = None, **kw):
        if embedding_file is not None:
            weights, input_dim, output_dim = _load_glove(
                embedding_file, word_index)
        super().__init__(input_dim, output_dim, trainable=trainable,
                         weights=weights, **kw)


def _load_glove(path: str, word_index: Optional[dict]):
    vecs = {}
    dim = None
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            parts = line.rstrip().split(" ")
            vecs[parts[0]] = np.asarray(parts[1:], dtype=np.float32)
            dim = len(parts) - 1
    if word_index is None:
        word_index = {w: i + 1 for i, w in enumerate(vecs)}
    n = max(word_index.values()) + 1
    table = np.zeros((n, dim), dtype=np.float32)
    for w, i in word_index.items():
        if w in vecs and i < n:
            table[i] = vecs[w]
    return table, n, dim


class SparseEmbedding(Embedding):
    """Embedding for one-hot-style sparse ids: a dense gather, as in the
    JAX package."""
