"""Transformer / BERT layers.

Port of ``analytics_zoo_tpu/keras/layers/self_attention.py``: multi-head
attention over ``ops.flash_attention`` (the hand-written CUDA kernel on the
card), the position-wise FFN, the post-LN ``TransformerBlock``, the
GPT-style ``TransformerLayer`` and the ``BERT`` encoder.  When the live
context (``common.context.current_context``, a peek that builds none:
the calling thread's ``context_scope`` first, which the estimator pins to
its own context while it trains, evaluates and predicts, else the
process's) has a mesh with a "model" axis above 1 that divides the
heads, and its "data" axis divides the batch, attention runs as
``ops.attention.sharded_flash_attention`` over that mesh, as the JAX
layer does: one kernel launch per (data, model) block, each
differentiable through its own ``flash_attention`` (one backward launch
a block).

Dense weights keep the JAX layout ``W: (d_in, d_out)`` applied as
``x @ W + b`` so parameter trees cross without transposes.  Layers start in
eval mode, as the JAX layers' ``training`` flag defaults to False.  In
training mode a forward given a ``seed`` (the JAX ``rng``: an int, or a
0-d int32 tensor on the card, which the training step derives from its
device step counter) drops exactly what the JAX layers drop for that
seed: per-site seeds derive as there (``ops/dropout.derive_seed``; a
tensor seed's sites in one derivation each), hidden dropout is
``ops/dropout.hash_dropout`` and attention dropout runs inside the kernel,
which reads a tensor seed from device memory.  Without a seed, or in eval
mode, nothing is dropped.  The masks are drawn over global rows, as the
JAX package draws them over the whole batch: in a job of several
processes (the live context's), each draw adds the global index of this
process's first row (``ops/dropout.process_offset``; the attention
kernels' ``bh_offset``), so a process drops its rows of the global
masks.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from analytics_zoo_tpu_torch.keras import activations, initializers
from analytics_zoo_tpu_torch.keras.engine import Layer
from analytics_zoo_tpu_torch.keras.layers.core import Dense
from analytics_zoo_tpu_torch.keras.layers.embedding import gather_rows
from analytics_zoo_tpu_torch.keras.layers.normalization import LayerNorm
from analytics_zoo_tpu_torch.ops.attention import (
    flash_attention, resolve_backend, sharded_flash_attention)
from analytics_zoo_tpu_torch.ops.dropout import (as_seed, derive_seed,
                                                 hash_dropout,
                                                 process_offset)
from analytics_zoo_tpu_torch.parallel import distributed


def projection(d_in: int, d_out: int, init="glorot_uniform") -> Dense:
    """``{"W": (d_in, d_out), "b": (d_out,)}`` applied as ``x @ W + b``: a
    sublayer's projection, named "dense" so that it takes no auto-name
    (the JAX layers keep these weights inline)."""
    return Dense(d_out, init=init, input_shape=(d_in,), name="dense")


def _site_seeds(seed, salts: range) -> list:
    """``derive_seed(seed, s)`` for each salt of ``salts``: for a tensor
    seed one derivation over all of them on its device (a step on the card
    launches a few kernels per seed it derives), views of it returned."""
    if seed is None:
        return [None] * len(salts)
    if isinstance(seed, torch.Tensor):
        return list(derive_seed(seed, torch.arange(
            salts.start, salts.stop, device=seed.device)).unbind())
    return [derive_seed(seed, s) for s in salts]


def _mesh_2d():
    """The live context's mesh when it carries a model axis > 1, else
    None.  Peeks without initializing (a bare layer call must not force
    a default mesh into existence)."""
    from analytics_zoo_tpu_torch.common.context import current_context
    ctx = current_context()
    if ctx is None:
        return None
    mesh = ctx.mesh
    return mesh if mesh.shape.get("model", 1) > 1 else None


def _local_data(mesh) -> int:
    """This process's positions along the mesh's "data" axis (1 inside a
    ``position_scope``: the batch is one data position's rows)."""
    if distributed.current_position() is not None:
        return 1
    return (len(mesh.local_range("data")) if "data" in mesh.axis_names
            else 1)


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
        backend = resolve_backend(backend)
        self.hidden_size = hidden_size
        self.n_head = n_head
        self.head_dim = hidden_size // n_head
        self.attn_dropout = attn_dropout
        self.causal = causal
        self.backend = backend
        self.qkv = projection(hidden_size, 3 * hidden_size, init)
        self.out = projection(hidden_size, hidden_size, init)

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
        kw = dict(padding_mask=mask, causal=self.causal, dropout_rate=drop,
                  dropout_seed=derive_seed(seed, 0x417) if drop else None,
                  backend=self.backend)
        mesh = _mesh_2d()
        if (mesh is not None and self.n_head % mesh.shape["model"] == 0
                and B % _local_data(mesh) == 0):
            y = sharded_flash_attention(mesh, q, k, v, **kw)
        else:
            y = flash_attention(q, k, v, **kw, bh_offset=distributed
                                .batch_offset(B) * self.n_head)
        return self.out(y.transpose(1, 2).reshape(B, T, D))


class PositionwiseFFN(Layer):
    def __init__(self, hidden_size: int, intermediate: int,
                 activation="gelu", init="glorot_uniform",
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.activation = activations.get(activation)
        self.fc1 = projection(hidden_size, intermediate, init)
        self.fc2 = projection(intermediate, hidden_size, init)

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

    def _drop(self, x, seed):
        if seed is None:
            return x
        return hash_dropout(x, self.hidden_drop, seed=seed,
                            offset=process_offset(x.shape))

    def forward(self, x, mask=None, seed: Optional[int] = None):
        if mask is None:
            x, mask = _split_mask(x)
        drops = (_site_seeds(seed, range(1, 3))
                 if self.training and self.hidden_drop > 0 else [None] * 2)
        x = self.ln1(x + self._drop(self.attn(x, mask, seed=seed), drops[0]))
        return self.ln2(x + self._drop(self.ffn(x), drops[1]))


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
        h = gather_rows(self.embed, x)
        pos = self.embed[self.vocab:self.vocab + x.shape[1]]
        h = h + pos[None]
        base = as_seed(seed)
        if self.training and base is not None and self.embedding_drop > 0:
            h = hash_dropout(h, self.embedding_drop,
                             seed=derive_seed(base, 0x5eed),
                             offset=process_offset(h.shape))
        outs = []
        seeds = _site_seeds(base, range(1, len(self.blocks) + 1))
        for blk, blk_seed in zip(self.blocks, seeds):
            h = blk(h, seed=blk_seed)
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
        self.pooler = projection(hidden_size, hidden_size)
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
        h = (gather_rows(self.token_embed, tokens)
             + self.position_embed[None, :T, :]
             + gather_rows(self.segment_embed, segments))
        h = self.embed_ln(h)
        # one seed for the stack, per-block seeds by int32 mixing, as in
        # the JAX layer; dropout after the embedding LayerNorm
        base = as_seed(seed)
        if self.training and base is not None and self.hidden_drop > 0:
            h = hash_dropout(h, self.hidden_drop,
                             seed=derive_seed(base, 0x5eed),
                             offset=process_offset(h.shape))
        # one (B, T) int32 mask for all blocks: the kernel reads it as is
        mask = (mask != 0).to(torch.int32)
        seeds = _site_seeds(base, range(1, len(self.blocks) + 1))
        for blk, blk_seed in zip(self.blocks, seeds):
            h = blk(h, mask, seed=blk_seed)
        pooled = torch.tanh(self.pooler(h[:, 0, :]))
        return h, pooled


def set_attention_backend(module: nn.Module, backend: Optional[str]) -> None:
    """Point every ``MultiHeadAttention`` under ``module`` at ``backend``
    (None, "plain" or "cuda", or the JAX names "jnp" / "pallas"; see
    ``ops.flash_attention``)."""
    backend = resolve_backend(backend)
    for m in module.modules():
        if isinstance(m, MultiHeadAttention):
            m.backend = backend
