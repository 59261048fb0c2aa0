"""Paged attention: decode and chunked prefill through block tables.

Port of ``analytics_zoo_tpu/ops/paged_attention.py``.  The LLM serving
cache keeps each sequence's K/V in fixed-size blocks of a shared page pool
(``llm/kv_cache.py``), and attention reads them through the sequence's
block table:

    q            (B, H, D)          one new token per sequence (decode)
                 (Tc, H, D)         one chunk of one prompt (prefill)
    k/v_pages    (P, bs, Hkv, D)    the shared page pool
    lengths      (B,)               tokens visible per sequence
    block_tables (B, nb)            page id per logical block

On CUDA tensors ``paged_decode_attention`` launches the kernel of
``ops/csrc/paged_decode.cu`` and ``paged_chunk_attention`` the kernel of
``ops/csrc/paged_chunk.cu`` (see ``ops/_kernels.py``), or they raise; on
CPU tensors, or when ``backend="plain"`` is asked for, they run
``_gather_reference`` and ``_reference_chunk``, the plain PyTorch versions
the kernels are held to, written line for line after the JAX package's
(f32 scores, the ``-1e30`` mask, ``max(l, 1e-37)``).  Query head ``h``
reads KV head ``h // (H // Hkv)`` (GQA); a sequence with ``lengths == 0``
(a dead decode lane pointing at the scratch page) gets zeros.

``sharded_paged_decode_attention`` and ``sharded_paged_chunk_attention``
spread one model's attention over a mesh's "model" axis along KV heads:
shard s holds query heads ``[s·H/mp, (s+1)·H/mp)`` and exactly their KV
heads (contiguous blocks, so the GQA map inside a shard is the global one
shifted), runs the ordinary kernel on its device, and the outputs are
concatenated along heads on the caller's device.  Each shard's keys split
as the unsharded call's do, so a head's sums run in the same order and the
sharded result equals the unsharded one bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops.attention import resolve_backend
from analytics_zoo_tpu_torch.parallel.mesh import ShardedTensor

_NEG_INF = -1e30


def _gqa(k: torch.Tensor, v: torch.Tensor, H: int, axis: int):
    """K/V with each KV head repeated for its ``H // Hkv`` query heads."""
    Hkv = k.shape[axis]
    if Hkv != H:
        if H % Hkv:
            raise ValueError(f"GQA needs H % Hkv == 0, got {H} % {Hkv}")
        rep = H // Hkv
        k = torch.repeat_interleave(k, rep, dim=axis)
        v = torch.repeat_interleave(v, rep, dim=axis)
    return k, v


def _gather_reference(q, k_pages, v_pages, lengths, block_tables,
                      sm_scale):
    """Gather-based paged decode attention: the plain version of the
    decode kernel."""
    B, H, D = q.shape
    P, bs, Hkv, _ = k_pages.shape
    nb = block_tables.shape[1]
    T = nb * bs
    tables = block_tables.long()
    k = k_pages[tables].reshape(B, T, Hkv, D)
    v = v_pages[tables].reshape(B, T, Hkv, D)
    k, v = _gqa(k, v, H, axis=2)
    s = torch.einsum("bhd,bthd->bht", q.float(), k.float()) * sm_scale
    pos = torch.arange(T, dtype=torch.int32, device=q.device)
    valid = pos[None, :] < lengths[:, None].to(torch.int32)
    s = torch.where(valid[:, None, :], s, _NEG_INF)
    m = s.amax(dim=-1)
    # masked entries contribute 0 even on fully-masked rows
    p = torch.where(s <= _NEG_INF / 2, 0.0, torch.exp(s - m[..., None]))
    l = p.sum(dim=-1)
    o = torch.einsum("bht,bthd->bhd", p, v.float())
    return (o / l.clamp_min(1e-37)[..., None]).to(q.dtype)


def _reference_chunk(q, k_pages, v_pages, page_table, start, sm_scale):
    """Causal chunk attention through one page table: the plain version
    of the chunk kernel."""
    Tc, H, D = q.shape
    P, bs, Hkv, _ = k_pages.shape
    nb = page_table.shape[0]
    T = nb * bs
    table = page_table.long()
    k = k_pages[table].reshape(T, Hkv, D)
    v = v_pages[table].reshape(T, Hkv, D)
    k, v = _gqa(k, v, H, axis=1)
    s = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * sm_scale
    kpos = torch.arange(T, dtype=torch.int32, device=q.device)
    qpos = int(start) + torch.arange(Tc, dtype=torch.int32, device=q.device)
    valid = kpos[None, :] <= qpos[:, None]
    s = torch.where(valid[None], s, _NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(s <= _NEG_INF / 2, 0.0, torch.exp(s - m[..., None]))
    l = p.sum(dim=-1)                          # (H, Tc)
    o = torch.einsum("hqk,khd->qhd", p, v.float())
    return (o / l.clamp_min(1e-37).T[:, :, None]).to(q.dtype)


def _use_kernel(q, backend, what: str) -> bool:
    backend = resolve_backend(backend)
    dev = q.device.type
    kernel = not (backend == "plain" or (backend is None and dev == "cpu"))
    if kernel and dev != "cuda":
        raise ValueError(f"the {what} kernel needs CUDA tensors; got "
                         f"{q.device} (backend={backend!r})")
    return kernel


def paged_decode_attention(q, k_pages, v_pages, lengths, block_tables,
                           sm_scale: Optional[float] = None,
                           backend: Optional[str] = None,
                           pages_per_compute_block: int = 4):
    """One decode step of attention through a paged KV cache.

    Args:
      q: ``(B, H, D)`` query of the newest token of each sequence.
      k_pages, v_pages: ``(P, bs, Hkv, D)`` shared page pools (``P``
        pages of ``bs`` slots; GQA when ``Hkv < H``).
      lengths: ``(B,)`` int32, tokens visible per sequence (INCLUDING the
        one just written); 0 marks a dead slot and yields zeros.
      block_tables: ``(B, nb)`` int32 page ids; entries past
        ``ceil(length / bs)`` are never read but must be valid page
        indices (point them at the scratch page).
      sm_scale: softmax scale, applied to the scores; default
        ``1/sqrt(D)``.
      backend: None runs the kernel for CUDA tensors and the plain version
        for CPU tensors; ``"cuda"`` demands the kernel; ``"plain"`` runs
        the plain version on any device.
      pages_per_compute_block: the TPU kernel's tile size, accepted and
        ignored (the CUDA kernel walks the pages its own way).

    A CUDA tensor never falls back to the plain version: an unsupported
    shape or dtype, a failed build or a failed launch raises.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _decode(q, k_pages, v_pages, lengths, block_tables, sm_scale,
                   backend)


def _decode(q, k_pages, v_pages, lengths, block_tables, sm_scale, backend,
            rule_heads=None):
    if _use_kernel(q, backend, "paged-decode"):
        return _kernels.paged_decode(q, k_pages, v_pages, lengths,
                                     block_tables, sm_scale=sm_scale,
                                     rule_heads=rule_heads)
    return _gather_reference(q, k_pages, v_pages, lengths, block_tables,
                             sm_scale)


def paged_chunk_attention(q, k_pages, v_pages, page_table, start,
                          sm_scale: Optional[float] = None,
                          backend: Optional[str] = None):
    """Causal CHUNK attention through ONE sequence's page table: the
    chunked-prefill primitive.

    Args:
      q: ``(Tc, H, D)`` queries for chunk positions ``start ..
        start+Tc-1`` (trailing pad positions allowed; their outputs are
        discarded by the caller).
      k_pages, v_pages: ``(P, bs, Hkv, D)`` page pools; the chunk's OWN
        K/V must already be written, so query ``i`` attends to every
        cached token ``<= start + i``.
      page_table: ``(nb,)`` int32 page ids, scratch-padded past the
        sequence's blocks.
      start: context tokens cached BEFORE this chunk, a host int.
      backend: as for ``paged_decode_attention``.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _chunk(q, k_pages, v_pages, page_table, int(start), sm_scale,
                  backend)


def _chunk(q, k_pages, v_pages, page_table, start, sm_scale, backend,
           rule_heads=None):
    if _use_kernel(q, backend, "paged-chunk"):
        return _kernels.paged_chunk(q, k_pages, v_pages, page_table, start,
                                    sm_scale=sm_scale,
                                    rule_heads=rule_heads)
    return _reference_chunk(q, k_pages, v_pages, page_table, start,
                            sm_scale)


def _pool_shards(pages, mesh, axis: str, mp: int) -> list:
    """The ``(P, bs, Hkv/mp, D)`` pool of each model shard, on its device:
    a ``ShardedTensor`` split along KV heads over ``axis`` gives its own
    shards (read in place); a whole pool is cut into contiguous copies."""
    if isinstance(pages, ShardedTensor):
        spec = tuple(pages.sharding.spec) + (None,) * 4
        if pages.sharding.mesh is not mesh or spec[:4] != (
                None, None, axis, None):
            raise ValueError(f"a placed page pool must be split along KV "
                             f"heads over '{axis}' of this mesh, got "
                             f"{pages.sharding}")
        return [pages.shard({axis: s}) for s in range(mp)]
    hk = pages.shape[2] // mp
    return [pages[:, :, s * hk:(s + 1) * hk].to(
        mesh.device({axis: s})).contiguous() for s in range(mp)]


def _sharded(mesh, q, k_pages, v_pages, axis, run, *replicated):
    """Run ``run(q_s, k_s, v_s, *replicated_s, rule_heads)`` on each model
    shard's device (over several devices, ``Mesh.block_streams``, on its
    stream, so the shards' launches overlap; on a shared device one after
    another) and concatenate the outputs along heads once q's stream has
    waited for theirs."""
    mp = mesh.shape[axis]
    H, Hkv = q.shape[1], k_pages.shape[2]
    if H % mp or Hkv % mp:
        raise ValueError(
            f"heads must divide the model axis: H={H}, Hkv={Hkv}, "
            f"mp={mp}")
    # (imported here: the parallel package imports this module)
    from analytics_zoo_tpu_torch.parallel.mesh import (join, on_stream,
                                                       used_on)
    ks = _pool_shards(k_pages, mesh, axis, mp)
    vs = _pool_shards(v_pages, mesh, axis, mp)
    hq = H // mp
    streams = mesh.streams_at([{axis: s} for s in range(mp)])
    outs = []
    for s in range(mp):
        dev = mesh.device({axis: s})
        with on_stream(streams[s]):
            ins = [q, ks[s], vs[s], *replicated]
            used_on(ins, streams[s])
            o = run(q[:, s * hq:(s + 1) * hq].to(dev), ks[s], vs[s],
                    *(t.to(dev) for t in replicated), (H, Hkv))
            outs.append(o.to(q.device))
    join(streams, outs)
    return torch.cat(outs, dim=1)


def sharded_paged_decode_attention(mesh, q, k_pages, v_pages, lengths,
                                   block_tables,
                                   sm_scale: Optional[float] = None,
                                   axis: str = "model"):
    """``paged_decode_attention`` sharded along KV heads over ``mesh``'s
    ``axis`` (requires ``H % mp == 0`` and ``Hkv % mp == 0``).  The pools
    are ``ShardedTensor``s split along KV heads over ``axis`` (what a
    sharded ``PagedKVCache`` holds) or whole tensors.  On CUDA tensors
    every shard launches the kernel; on CPU tensors each runs the plain
    version."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])

    def run(q_, k_, v_, lens_, bt_, heads):
        return _decode(q_, k_, v_, lens_, bt_, sm_scale, None,
                       rule_heads=heads[1])

    return _sharded(mesh, q, k_pages, v_pages, axis, run,
                    lengths.to(torch.int32), block_tables.to(torch.int32))


def sharded_paged_chunk_attention(mesh, q, k_pages, v_pages, page_table,
                                  start,
                                  sm_scale: Optional[float] = None,
                                  axis: str = "model"):
    """``paged_chunk_attention`` sharded along KV heads over ``mesh``'s
    ``axis``: chunked prefill for a model-parallel decode cache."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    start = int(start)

    def run(q_, k_, v_, table_, heads):
        return _chunk(q_, k_, v_, table_, start, sm_scale, None,
                      rule_heads=heads[0])

    return _sharded(mesh, q, k_pages, v_pages, axis, run,
                    page_table.to(torch.int32))
