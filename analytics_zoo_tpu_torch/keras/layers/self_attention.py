"""Transformer / BERT layers.

Port of ``analytics_zoo_tpu/keras/layers/self_attention.py``: multi-head
attention over ``ops.flash_attention`` (the hand-written CUDA kernel on the
card), the position-wise FFN, the post-LN ``TransformerBlock``, the
GPT-style ``TransformerLayer`` and the ``BERT`` encoder.  The 2D-mesh
(tensor-parallel) branch of the JAX attention is not ported.

Dense weights keep the JAX layout ``W: (d_in, d_out)`` applied as
``x @ W + b`` so parameter trees cross without transposes.  Layers start in
eval mode, as the JAX layers' ``training`` flag defaults to False.  In
training mode a forward given an int ``seed`` (the JAX ``rng``) drops
exactly what the JAX layers drop for that seed: per-site seeds derive as
there (``ops/dropout.derive_seed``), hidden dropout is
``ops/dropout.hash_dropout`` and attention dropout runs inside the kernel.
Without a seed, or in eval mode, nothing is dropped.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras import activations, initializers
from analytics_zoo_tpu_torch.keras.engine import Layer
from analytics_zoo_tpu_torch.keras.layers.normalization import LayerNorm
from analytics_zoo_tpu_torch.ops.attention import BACKENDS, flash_attention
from analytics_zoo_tpu_torch.ops.dropout import (as_seed, derive_seed,
                                                 hash_dropout)


class Dense(Layer):
    """``{"W": (d_in, d_out), "b": (d_out,)}``, applied as ``x @ W + b``."""

    def __init__(self, d_in: int, d_out: int, init="glorot_uniform"):
        super().__init__(name="dense")
        self.kernel_init = initializers.get(init)
        self.W = nn.Parameter(torch.empty(d_in, d_out))
        self.b = nn.Parameter(torch.zeros(d_out))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        self.kernel_init(self.W, generator)
        self.b.zero_()

    def forward(self, x):
        # one fused GEMM + bias; W.t() is a view, not a copy
        return F.linear(x, self.W.t(), self.b)


def _split_mask(x):
    if isinstance(x, (list, tuple)):
        return x[0], x[1]
    return x, None


class MultiHeadAttention(Layer):
    """``backend`` is handed to ``flash_attention`` (None: the kernel on
    the card, the plain version on the CPU; "plain" forces the plain
    version, which is how a run checks the kernel)."""

    def __init__(self, hidden_size: int, n_head: int,
                 attn_dropout: float = 0.1, causal: bool = False,
                 init="glorot_uniform", name: Optional[str] = None,
                 backend: Optional[str] = None):
        super().__init__(name=name)
        if hidden_size % n_head:
            raise ValueError("hidden_size must divide n_head")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")
        self.hidden_size = hidden_size
        self.n_head = n_head
        self.head_dim = hidden_size // n_head
        self.attn_dropout = attn_dropout
        self.causal = causal
        self.backend = backend
        self.qkv = Dense(hidden_size, 3 * hidden_size, init)
        self.out = Dense(hidden_size, hidden_size, init)

    def forward(self, x, mask=None, seed: Optional[int] = None):
        if mask is None:
            x, mask = _split_mask(x)
        drop = self.attn_dropout if self.training and seed is not None \
            else 0.0
        B, T, D = x.shape
        qkv = self.qkv(x)                                  # (B, T, 3D)

        def heads(t):  # a strided view: the kernel reads it in place
            return t.view(B, T, self.n_head, self.head_dim).transpose(1, 2)
        q, k, v = (heads(t) for t in qkv.split(D, dim=-1))
        y = flash_attention(q, k, v, padding_mask=mask, causal=self.causal,
                            dropout_rate=drop,
                            dropout_seed=derive_seed(seed, 0x417)
                            if drop else None, backend=self.backend)
        return self.out(y.transpose(1, 2).reshape(B, T, D))


class PositionwiseFFN(Layer):
    def __init__(self, hidden_size: int, intermediate: int,
                 activation="gelu", init="glorot_uniform",
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.activation = activations.get(activation)
        self.fc1 = Dense(hidden_size, intermediate, init)
        self.fc2 = Dense(intermediate, hidden_size, init)

    def forward(self, x):
        return self.fc2(self.activation(self.fc1(x)))


class TransformerBlock(Layer):
    """Post-LN residual block (the BERT convention)."""

    def __init__(self, hidden_size: int, n_head: int, intermediate: int,
                 hidden_drop: float = 0.1, attn_drop: float = 0.1,
                 causal: bool = False, activation="gelu",
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.attn = MultiHeadAttention(hidden_size, n_head, attn_drop,
                                       causal, name=self.name + "_attn")
        self.ffn = PositionwiseFFN(hidden_size, intermediate, activation,
                                   name=self.name + "_ffn")
        self.ln1 = LayerNorm(hidden_size, name=self.name + "_ln1")
        self.ln2 = LayerNorm(hidden_size, name=self.name + "_ln2")
        self.hidden_drop = hidden_drop

    def _drop(self, x, seed, salt):
        if not self.training or seed is None or self.hidden_drop <= 0:
            return x
        return hash_dropout(x, self.hidden_drop, seed=derive_seed(seed, salt))

    def forward(self, x, mask=None, seed: Optional[int] = None):
        if mask is None:
            x, mask = _split_mask(x)
        x = self.ln1(x + self._drop(self.attn(x, mask, seed=seed), seed, 1))
        return self.ln2(x + self._drop(self.ffn(x), seed, 2))


class TransformerLayer(Layer):
    """GPT-style stack: one table for token + position embeddings (positions
    take its tail rows) and N causal blocks."""

    def __init__(self, vocab: int, seq_len: int, n_block: int = 12,
                 hidden_size: int = 768, n_head: int = 12,
                 intermediate: Optional[int] = None, embedding_drop=0.1,
                 hidden_drop=0.1, attn_drop=0.1, causal: bool = True,
                 output_all_block: bool = False, name: Optional[str] = None):
        super().__init__(name=name)
        self.vocab = vocab
        self.seq_len = seq_len
        self.hidden_size = hidden_size
        self.embedding_drop = embedding_drop
        self.output_all_block = output_all_block
        self.embed = nn.Parameter(torch.empty(vocab + seq_len, hidden_size))
        self.blocks = []
        for i in range(n_block):
            blk = TransformerBlock(hidden_size, n_head,
                                   intermediate or 4 * hidden_size,
                                   hidden_drop, attn_drop, causal=causal,
                                   activation="gelu",
                                   name=f"{self.name}_block{i}")
            self.add_module(blk.name, blk)
            self.blocks.append(blk)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        initializers.normal(self.embed, generator, scale=0.02)

    def forward(self, x, seed: Optional[int] = None):
        h = F.embedding(x.long(), self.embed)
        pos = self.embed[self.vocab:self.vocab + x.shape[1]]
        h = h + pos[None]
        base = as_seed(seed)
        if self.training and base is not None and self.embedding_drop > 0:
            h = hash_dropout(h, self.embedding_drop,
                             seed=derive_seed(base, 0x5eed))
        outs = []
        for i, blk in enumerate(self.blocks):
            h = blk(h, seed=derive_seed(base, i + 1))
            outs.append(h)
        return outs if self.output_all_block else h


class BERT(Layer):
    """BERT encoder.  Input ``[token_ids, segment_ids, padding_mask]``
    (mask 1 = valid); output ``(sequence_output, pooled_output)``."""

    def __init__(self, vocab: int = 40990, hidden_size: int = 768,
                 n_block: int = 12, n_head: int = 12, seq_len: int = 512,
                 intermediate_size: int = 3072, hidden_drop: float = 0.1,
                 attn_drop: float = 0.1, initializer_range: float = 0.02,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.vocab = vocab
        self.hidden_size = hidden_size
        self.seq_len = seq_len
        self.initializer_range = initializer_range
        self.hidden_drop = hidden_drop
        self.token_embed = nn.Parameter(torch.empty(vocab, hidden_size))
        self.position_embed = nn.Parameter(torch.empty(seq_len, hidden_size))
        self.segment_embed = nn.Parameter(torch.empty(2, hidden_size))
        self.pooler = Dense(hidden_size, hidden_size)
        self.embed_ln = LayerNorm(hidden_size, name=self.name + "_embed_ln")
        self.blocks = []
        for i in range(n_block):
            blk = TransformerBlock(hidden_size, n_head, intermediate_size,
                                   hidden_drop, attn_drop, causal=False,
                                   activation="gelu",
                                   name=f"{self.name}_block{i}")
            self.add_module(blk.name, blk)
            self.blocks.append(blk)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        for p in (self.token_embed, self.position_embed, self.segment_embed):
            initializers.normal(p, generator, scale=self.initializer_range)

    def forward(self, x, seed: Optional[int] = None):
        tokens, segments, mask = x
        T = tokens.shape[1]
        h = (F.embedding(tokens.long(), self.token_embed)
             + self.position_embed[None, :T, :]
             + F.embedding(segments.long(), self.segment_embed))
        h = self.embed_ln(h)
        # one seed for the stack, per-block seeds by int32 mixing, as in
        # the JAX layer; dropout after the embedding LayerNorm
        base = as_seed(seed)
        if self.training and base is not None and self.hidden_drop > 0:
            h = hash_dropout(h, self.hidden_drop,
                             seed=derive_seed(base, 0x5eed))
        # one (B, T) int32 mask for all blocks: the kernel reads it as is
        mask = (mask != 0).to(torch.int32)
        for i, blk in enumerate(self.blocks):
            h = blk(h, mask, seed=derive_seed(base, i + 1))
        pooled = torch.tanh(self.pooler(h[:, 0, :]))
        return h, pooled


def set_attention_backend(module: nn.Module, backend: Optional[str]) -> None:
    """Point every ``MultiHeadAttention`` under ``module`` at ``backend``
    (None, "plain" or "cuda"; see ``ops.flash_attention``)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}")
    for m in module.modules():
        if isinstance(m, MultiHeadAttention):
            m.backend = backend
