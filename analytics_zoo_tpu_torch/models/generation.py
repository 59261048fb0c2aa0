"""Decoder-only transformer LM: the model LLM serving runs.

Port of ``analytics_zoo_tpu/models/generation.py``: the GPT-2 architecture
(pre-LN blocks, fused QKV projection with biases, tanh-GELU, LayerNorm eps
1e-5 and a final ``ln_f``, learned position embeddings, input and output
embeddings tied).  ``DecoderLM`` is an ``nn.Module`` whose ``state_dict``
keys are the JAX parameter tree's paths (``tok_emb``, ``pos_emb``,
``ln_f.gamma``, ``blocks.0.qkv.W``, ...); dense layers are ``x @ W + b``
with ``W`` ``(d_in, d_out)``, so ``interop.load_jax_params`` moves a JAX
tree across with nothing transposed.

The entry points are functions over the module, as the JAX package's are
over its parameter tree:

- ``dense_logits``: full-sequence causal forward with plain attention (the
  oracle the paged path is held to).
- ``prefill``: causal forward over one padded prompt that also writes every
  position's K/V into the paged cache.
- ``prefill_chunk``: one chunk of a prompt, attending through the page
  table (``ops.paged_attention.paged_chunk_attention``).
- ``decode_step``: one token per batch slot, attending through the block
  tables (``ops.paged_attention.paged_decode_attention``).

The cache's pages are updated IN PLACE (the JAX package replaces them
functionally): K/V land through ``index_copy_`` on a view of the page
tensor, and the functions return the same page tensors they were given, so
``logits, cache.k_pages, cache.v_pages = model.decode(...)`` still holds.
Dead batch slots carry ``lengths == 0`` and scratch-page slots (page 0):
their writes may collide there, in any order, and no live row reads them.

Model parallelism (``DecoderLM.shard(mesh)`` or ``mesh=``): the paged
attention of ``prefill_chunk`` and ``decode_step`` splits along KV heads
over the mesh's "model" axis (``ops.paged_attention.sharded_*``), one
kernel launch per shard, on the pages of a ``PagedKVCache`` built with
``page_sharding``.  Only attention is sharded: its output is gathered on
the model's device before the out projection, so everything else runs
there in the one-card order, and sharded decode is token-exact against
the unsharded path.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.common.context import resolve_device
from analytics_zoo_tpu_torch.llm.kv_cache import write_slots
from analytics_zoo_tpu_torch.ops.paged_attention import (
    _NEG_INF, paged_chunk_attention, paged_decode_attention,
    sharded_paged_chunk_attention, sharded_paged_decode_attention)
from analytics_zoo_tpu_torch.parallel.mesh import (
    NamedSharding, PartitionSpec)


class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.W = nn.Parameter(torch.empty(d_in, d_out), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(d_out), requires_grad=False)


class _LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(d), requires_grad=False)
        self.beta = nn.Parameter(torch.zeros(d), requires_grad=False)


class _Block(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.qkv = _Dense(hidden, 3 * hidden)
        self.out = _Dense(hidden, hidden)
        self.fc1 = _Dense(hidden, intermediate)
        self.fc2 = _Dense(intermediate, hidden)
        self.ln1 = _LayerNorm(hidden)
        self.ln2 = _LayerNorm(hidden)


def _dense(p: _Dense, x):
    return torch.addmm(p.b, x.reshape(-1, x.shape[-1]), p.W).reshape(
        *x.shape[:-1], p.W.shape[1])


def _ln(p: _LayerNorm, x, eps: float = 1e-5):
    # the biased (population) variance, the statistic of jnp.var
    return F.layer_norm(x, (x.shape[-1],), p.gamma, p.beta, eps)


def _qkv_heads(blk: _Block, x, n_head: int):
    """x (..., D) -> q, k, v each (..., n_head, head_dim), views of the
    fused projection."""
    qkv = _dense(blk.qkv, _ln(blk.ln1, x))
    q, k, v = qkv.chunk(3, dim=-1)
    hd = q.shape[-1] // n_head
    split = lambda t: t.reshape(*t.shape[:-1], n_head, hd)
    return split(q), split(k), split(v)


def _ffn(blk: _Block, x):
    # jax.nn.gelu defaults to the tanh approximation
    return _dense(blk.fc2, F.gelu(_dense(blk.fc1, _ln(blk.ln2, x)),
                                  approximate="tanh"))


def _write(pages, li: int, slots, kv) -> None:
    """Scatter ``kv`` (N, Hkv, D) into page-space ``slots`` of layer
    ``li``, in place (on every shard of sharded pages)."""
    write_slots(pages, li, slots, kv)


def dense_logits(params: "DecoderLM", tokens, n_head: int):
    """Full causal forward with plain attention; tokens (B, T) int ->
    logits (B, T, V).  The reference the paged path must reproduce."""
    B, T = tokens.shape
    x = params.tok_emb[tokens] + params.pos_emb[:T][None]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                 device=x.device))
    for blk in params.blocks:
        q, k, v = _qkv_heads(blk, x, n_head)          # (B, T, H, hd)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                         k.float()) / math.sqrt(q.shape[-1])
        s = torch.where(mask[None, None], s, _NEG_INF)
        p = torch.softmax(s, dim=-1)
        att = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
        att = att.reshape(B, T, -1).to(x.dtype)
        x = x + _dense(blk.out, att)
        x = x + _ffn(blk, x)
    return _ln(params.ln_f, x) @ params.tok_emb.T


@torch.inference_mode()
def greedy_reference(params: "DecoderLM", prompt, max_new_tokens: int,
                     n_head: int, eos_id: int = -1) -> List[int]:
    """Host-side greedy decode through ``dense_logits``: O(T^2) per
    token, an oracle for tests only."""
    toks = [int(t) for t in prompt]
    dev = params.tok_emb.device
    out = []
    for _ in range(max_new_tokens):
        logits = dense_logits(params, torch.tensor([toks], device=dev),
                              n_head)[0, -1]
        nxt = int(logits.argmax())
        out.append(nxt)
        if nxt == eos_id:
            break
        toks.append(nxt)
    return out


def prefill(params: "DecoderLM", tokens, length: int, k_pages, v_pages,
            slots, n_head: int):
    """Causal forward over ONE padded prompt, writing K/V to the cache.

    tokens (Tb,) int (padded), ``length`` the true prompt length, slots
    (Tb,) int64 page-space slot per position (padding positions point at
    the scratch page).  Returns (next-token logits (V,), k_pages,
    v_pages)."""
    Tb = tokens.shape[0]
    x = params.tok_emb[tokens] + params.pos_emb[:Tb]
    pos = torch.arange(Tb, dtype=torch.int32, device=x.device)
    valid = pos < int(length)
    mask = (pos[:, None] >= pos[None, :]) & valid[None, :]
    for li, blk in enumerate(params.blocks):
        q, k, v = _qkv_heads(blk, x, n_head)          # (Tb, H, hd)
        _write(k_pages, li, slots, k)
        _write(v_pages, li, slots, v)
        s = torch.einsum("qhd,khd->hqk", q.float(),
                         k.float()) / math.sqrt(q.shape[-1])
        s = torch.where(mask[None], s, _NEG_INF)
        p = torch.softmax(s, dim=-1)
        att = torch.einsum("hqk,khd->qhd", p, v.float())
        att = att.reshape(Tb, -1).to(x.dtype)
        x = x + _dense(blk.out, att)
        x = x + _ffn(blk, x)
    last = _ln(params.ln_f, x)[int(length) - 1]
    return last @ params.tok_emb.T, k_pages, v_pages


def prefill_chunk(params: "DecoderLM", tokens, start: int, length: int,
                  page_table, k_pages, v_pages, slots, n_head: int,
                  mesh=None):
    """Causal forward over ONE CHUNK of a prompt, attending through the
    paged cache: earlier chunks and adopted prefix blocks are read back
    through the page table.

    tokens (Tc,) int padded chunk, ``start`` context tokens already
    cached (a host int), ``length`` true tokens in this chunk,
    page_table (nb,) int32 (scratch-padded), slots (Tc,) int64 page-space
    slot per chunk position (padding -> scratch).  Returns (next-token
    logits (V,) at position ``start + length - 1``, k_pages, v_pages); the
    logits only mean anything on the final chunk.  ``mesh`` shards the
    attention along KV heads over the mesh's "model" axis."""
    Tc = tokens.shape[0]
    start = int(start)
    max_pos = params.pos_emb.shape[0]
    # JAX gathers clamp an out-of-range index, torch's raise: clip the
    # positions of a tail padded past the table explicitly, as JAX does
    pos = torch.arange(start, start + Tc, device=tokens.device).clamp_(
        0, max_pos - 1)
    x = params.tok_emb[tokens] + params.pos_emb[pos]
    for li, blk in enumerate(params.blocks):
        q, k, v = _qkv_heads(blk, x, n_head)          # (Tc, H, hd)
        _write(k_pages, li, slots, k)
        _write(v_pages, li, slots, v)
        if mesh is None:
            att = paged_chunk_attention(q, k_pages[li], v_pages[li],
                                        page_table, start)
        else:     # gathered on the model's device: see the module's notes
            att = sharded_paged_chunk_attention(
                mesh, q, k_pages[li], v_pages[li], page_table, start)
        att = att.reshape(Tc, -1).to(x.dtype)
        x = x + _dense(blk.out, att)
        x = x + _ffn(blk, x)
    last = _ln(params.ln_f, x)[int(length) - 1]
    return last @ params.tok_emb.T, k_pages, v_pages


def decode_step(params: "DecoderLM", tokens, positions, lengths,
                page_tables, k_pages, v_pages, slots, n_head: int,
                mesh=None):
    """One token per batch slot through the paged cache.

    tokens / positions (B,) int, lengths (B,) int32, slots (B,) int64,
    page_tables (B, nb) int32.  ``lengths`` INCLUDES the token being
    written this step; dead slots carry length 0 and scratch slots.
    ``positions`` must lie below the position table's size (``LLMServing``
    checks ``max_model_len`` against it).  Returns (logits (B, V),
    k_pages, v_pages).  ``mesh`` shards the paged attention along KV heads
    over the mesh's "model" axis; everything outside attention runs on the
    model's device, so the result is token-exact against the unsharded
    path."""
    B = tokens.shape[0]
    x = params.tok_emb[tokens] + params.pos_emb[positions]
    for li, blk in enumerate(params.blocks):
        q, k, v = _qkv_heads(blk, x, n_head)          # (B, H, hd)
        _write(k_pages, li, slots, k)
        _write(v_pages, li, slots, v)
        if mesh is None:
            att = paged_decode_attention(q, k_pages[li], v_pages[li],
                                         lengths, page_tables)
        else:
            att = sharded_paged_decode_attention(
                mesh, q, k_pages[li], v_pages[li], lengths, page_tables)
        att = att.reshape(B, -1).to(x.dtype)
        x = x + _dense(blk.out, att)
        x = x + _ffn(blk, x)
    return _ln(params.ln_f, x) @ params.tok_emb.T, k_pages, v_pages


class DecoderLM(nn.Module):
    """The decoder LM's weights plus the entry points the LLM engine
    calls (``prefill``, ``prefill_chunk``, ``decode``).

    Weights start as the JAX package's ``init_decoder_params`` draws them
    (normal std 0.02 for the embeddings and dense kernels, zero biases,
    LayerNorm gains 1), from ``generator`` (a ``torch.Generator``; seed 0
    when None), and are usually replaced by ``interop.load_jax_params``.
    ``device=None`` means the card (``resolve_device``).  The methods take
    host arrays (numpy, lists, ints), copy them to the device in one
    transfer and run under ``torch.inference_mode()``.  ``mesh`` shards
    the model's paged attention at once (``shard``).
    """

    def __init__(self, vocab: int, hidden: int, n_head: int, n_layers: int,
                 intermediate: int, max_pos: int, eos_id: int = -1,
                 generator: Optional[torch.Generator] = None,
                 device=None, mesh=None):
        if hidden % n_head:
            raise ValueError("hidden must divide n_head")
        device = resolve_device(device)
        super().__init__()
        self.tok_emb = nn.Parameter(torch.empty(vocab, hidden),
                                    requires_grad=False)
        self.pos_emb = nn.Parameter(torch.empty(max_pos, hidden),
                                    requires_grad=False)
        self.ln_f = _LayerNorm(hidden)
        self.blocks = nn.ModuleList(_Block(hidden, intermediate)
                                    for _ in range(n_layers))
        gen = generator or torch.Generator().manual_seed(0)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith(("emb", ".W")):
                    p.copy_(0.02 * torch.randn(p.shape, generator=gen))
        self.to(device)
        self.eval()
        self.vocab = vocab
        self.max_pos = max_pos
        self.eos_id = eos_id
        self.n_head = n_head
        self.head_dim = hidden // n_head
        self.n_kv_heads = n_head
        self.n_layers = n_layers
        self.mesh = None
        self.page_sharding = None
        if mesh is not None:
            self.shard(mesh)

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device

    @property
    def dtype(self) -> torch.dtype:
        return self.tok_emb.dtype

    def shard(self, mesh) -> "DecoderLM":
        """Shard this model's paged attention along KV heads over
        ``mesh``'s "model" axis (model parallelism for serving): the
        entry points route attention through the sharded paged ops, and
        ``page_sharding`` places a ``PagedKVCache``'s pages so each
        device holds ``n_kv_heads / mp`` heads; each shard's launches
        run on its position's device (over several cards on its stream,
        ``Mesh.block_streams``).  The weights stay where they are."""
        mp = mesh.shape["model"]
        if self.n_kv_heads % mp:
            raise ValueError(
                f"n_kv_heads {self.n_kv_heads} must divide the model "
                f"axis ({mp} devices)")
        self.mesh = mesh
        self.page_sharding = NamedSharding(
            mesh, PartitionSpec(None, None, None, "model", None))
        return self

    @classmethod
    def tiny(cls, generator: Optional[torch.Generator] = None,
             vocab: int = 96, hidden: int = 32, n_head: int = 2,
             n_layers: int = 2, intermediate: int = 64, max_pos: int = 512,
             device=None) -> "DecoderLM":
        return cls(vocab, hidden, n_head, n_layers, intermediate, max_pos,
                   generator=generator, device=device)

    def _ints(self, *arrays: Sequence) -> List[torch.Tensor]:
        """Host int arrays -> int32 tensors on the model's device, in ONE
        copy (each call of the entry points needs several small ones)."""
        parts = [np.asarray(a, np.int32) for a in arrays]
        flat = torch.from_numpy(np.concatenate([a.ravel() for a in parts]))
        flat = flat.to(self.device)
        out, off = [], 0
        for a in parts:
            out.append(flat[off:off + a.size].view(a.shape))
            off += a.size
        return out

    @torch.inference_mode()
    def prefill(self, tokens, length, k_pages, v_pages, slots):
        toks, sl = self._ints(tokens, slots)
        return prefill(self, toks, int(length), k_pages, v_pages,
                       sl.long(), self.n_head)

    @torch.inference_mode()
    def prefill_chunk(self, tokens, start, length, page_table, k_pages,
                      v_pages, slots):
        toks, table, sl = self._ints(tokens, page_table, slots)
        return prefill_chunk(self, toks, int(start), int(length), table,
                             k_pages, v_pages, sl.long(), self.n_head,
                             self.mesh)

    @torch.inference_mode()
    def decode(self, tokens, positions, lengths, page_tables, k_pages,
               v_pages, slots):
        toks, pos, lens, tables, sl = self._ints(
            tokens, positions, lengths, page_tables, slots)
        return decode_step(self, toks, pos, lens, tables, k_pages, v_pages,
                           sl.long(), self.n_head, self.mesh)
