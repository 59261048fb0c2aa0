"""KNRM: kernel-pooling neural ranking for text matching.

Port of ``analytics_zoo_tpu/models/textmatching.py``: query and document
embeddings (one shared table), the cosine translation matrix, RBF kernel
pooling and a linear ranker (``target_mode="ranking"``) or a sigmoid
classifier (``"classification"``), the same graph, layer names and
parameter tree.  ``embedding_weights`` gives the table (GloVe vectors, say)
and ``train_embed=False`` freezes it as a buffer, the JAX ``state``.
Takes ``device=`` (default: the card; raises without one).

The kernel pooling is a module-level function (so a saved model pickles).
Its centres ``mus`` are numpy's ``linspace`` values rounded to f32, as in
the JAX package; they and the widths are made on the device at each call,
so a training step captured as a CUDA graph copies nothing from the host.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras.engine import Input, Lambda
from analytics_zoo_tpu_torch.models.common import Ranker, ZooModel


def _pool_consts(device, kernel_num: int, sigma: float, exact_sigma: float):
    """The kernels' centres ``mus`` and ``2 * sigma^2``, f32, made on
    ``device`` with no copy from the host (so a captured step can make
    them).  The centres are numpy's ``linspace`` values, ``i * step +
    start`` in f64 with the last set to ``stop``, then rounded to f32."""
    # fill_ with a Python number, never an indexed assignment of one: that
    # copies a host tensor, which a CUDA graph capture refuses
    n = kernel_num - 1
    start, stop = -1.0 + 1.0 / kernel_num, 1.0 - 1.0 / kernel_num
    mus = torch.ones(kernel_num, dtype=torch.float32, device=device)
    if n:
        grid = torch.arange(n, dtype=torch.float64, device=device)
        if n > 1:
            grid = grid * ((stop - start) / (n - 1)) + start
            grid[-1:].fill_(stop)
        else:
            grid = grid + start
        mus[:n] = grid
    sigmas = torch.full((kernel_num,), sigma, dtype=torch.float32,
                        device=device)
    sigmas[-1:].fill_(exact_sigma)
    return mus, 2.0 * torch.square(sigmas)


def _kernel_pool(inputs, kernel_num: int, sigma: float, exact_sigma: float):
    """RBF kernel pooling over the cosine translation matrix: (B, K)."""
    qe, de = inputs
    mus, denom = _pool_consts(qe.device, kernel_num, sigma, exact_sigma)
    norm = lambda t: torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-8
    qn, dn = qe / norm(qe), de / norm(de)
    m = torch.einsum("bqe,bde->bqd", qn, dn)   # translation matrix (B,Lq,Ld)
    k = torch.exp(-torch.square(m[..., None] - mus) / denom)
    kde = torch.sum(k, dim=2)                   # (B, Lq, K)
    return torch.sum(torch.log1p(torch.clamp(kde, min=1e-10)), dim=1)


def _kernel_pool_shape(s, kernel_num: int):
    return (None, kernel_num)


class KNRM(Ranker, ZooModel):
    def __init__(self, text1_length: int, text2_length: int,
                 vocab_size: int = 20000, embed_size: int = 300,
                 embedding_weights: Optional[np.ndarray] = None,
                 train_embed: bool = True, kernel_num: int = 21,
                 sigma: float = 0.1, exact_sigma: float = 0.001,
                 target_mode: str = "ranking", **kw):
        if target_mode not in ("ranking", "classification"):
            raise ValueError(f"target_mode must be 'ranking' or "
                             f"'classification', got {target_mode!r}")
        if embedding_weights is not None:
            vocab_size, embed_size = embedding_weights.shape
        self.kernel_num = kernel_num
        self.text1_length = text1_length
        self.text2_length = text2_length
        q = Input((text1_length,), name="text1")
        d = Input((text2_length,), name="text2")
        embed = L.Embedding(vocab_size, embed_size,
                            weights=embedding_weights,
                            trainable=train_embed, name="embed")
        qe, de = embed(q), embed(d)
        pooled = Lambda(
            functools.partial(_kernel_pool, kernel_num=kernel_num,
                              sigma=sigma, exact_sigma=exact_sigma),
            output_shape_fn=functools.partial(_kernel_pool_shape,
                                              kernel_num=kernel_num),
            name="kernel_pooling")([qe, de])
        if target_mode == "ranking":
            out = L.Dense(1, name="rank_head")(pooled)
        else:
            out = L.Dense(1, activation="sigmoid", name="clf_head")(pooled)
        super().__init__(input=[q, d], output=out, **kw)
