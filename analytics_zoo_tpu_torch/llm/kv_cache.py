"""Paged KV cache: fixed-size block pool + per-sequence block tables.

Port of ``analytics_zoo_tpu/llm/kv_cache.py``.  The decode cache is the
scarce serving resource (device memory), so it is managed like an OS page
table rather than per-request buffers:

- ``BlockPool`` — a free-list allocator over ``num_blocks`` fixed-size
  blocks with REF COUNTS, so a prefix shared between sequences (fork,
  system prompts) is stored once and freed when its last reader releases
  it.
- ``BlockTable`` — one sequence's logical-block -> physical-block map.
  Appends allocate lazily (one block per ``block_size`` tokens) and are
  ATOMIC: the whole append either commits or raises
  ``BlockPoolExhausted`` with no state change.  Appending into a block
  another table also references triggers copy-on-write via the cache's
  page-copy hook.
- ``PagedKVCache`` — owns the page tensors ``(L, P, bs, Hkv, D)`` on the
  model's device, where page 0 is a reserved SCRATCH page: dead batch
  slots write their garbage K/V there, so a padded decode step can never
  corrupt a live sequence's blocks.  Pool block ``b`` maps to page
  ``b + 1``.

With ``page_sharding`` (a ``NamedSharding`` splitting the KV-head axis over
a mesh's "model" axis, ``DecoderLM.page_sharding``) the pages are a
``parallel.mesh.ShardedTensor``: one contiguous ``(L, P, bs, Hkv/mp, D)``
tensor per shard on the shard's device, so each device holds ``1/mp`` of
the pool and the kernels read each shard in place.

The pages are updated IN PLACE (``copy_page``, ``write`` and the model's
entry points), on every shard, where the JAX package replaces them
functionally.  All of it runs on PyTorch's current stream, in the engine
thread's order, so a copy-on-write finishes before the step that writes
into its destination.

Thread-safety: the pool takes a lock — the decode loop owns all
allocation, but cancels arrive from other threads and the leak accounting
must stay exact under that race.

Every cache registers a ``kv_blocks`` pool on the device-memory ledger, as
the JAX cache does: its snapshot walks the host-side tables and radix
cache (never a page tensor), and ``refcount_balance`` is the ground truth
the leak sentinel sweeps against.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.context import resolve_device
from analytics_zoo_tpu_torch.observability import memory as zoomem
from analytics_zoo_tpu_torch.parallel.mesh import ShardedTensor


class BlockPoolExhausted(RuntimeError):
    """No free KV blocks — the scheduler preempts or sheds on this."""


class BlockPool:
    """Free-list allocator with ref counts over ``num_blocks`` blocks."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1 or block_size < 1:
            raise ValueError("num_blocks and block_size must be >= 1")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._lock = threading.Lock()
        # LIFO free list: recently-freed blocks are re-handed first
        # (their pages are the ones still warm in cache)
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref = [0] * num_blocks
        self.exhaustion_events = 0

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - self.free_blocks

    def refcount(self, block: int) -> int:
        with self._lock:
            return self._ref[block]

    def alloc_n(self, n: int) -> List[int]:
        """Allocate ``n`` blocks atomically (all-or-nothing)."""
        with self._lock:
            if n > len(self._free):
                self.exhaustion_events += 1
                raise BlockPoolExhausted(
                    f"need {n} KV blocks, {len(self._free)} free "
                    f"of {self.num_blocks}")
            out = [self._free.pop() for _ in range(n)]
            for b in out:
                self._ref[b] = 1
            return out

    def alloc(self) -> int:
        return self.alloc_n(1)[0]

    def incref(self, block: int) -> None:
        with self._lock:
            if self._ref[block] <= 0:
                raise ValueError(f"incref on free block {block}")
            self._ref[block] += 1

    def decref(self, block: int) -> bool:
        """Drop one reference; returns True when the block was freed."""
        with self._lock:
            r = self._ref[block]
            if r <= 0:
                raise ValueError(f"decref on free block {block}")
            self._ref[block] = r - 1
            if r == 1:
                self._free.append(block)
                return True
            return False


class BlockTable:
    """One sequence's ordered physical blocks + token count."""

    __slots__ = ("pool", "blocks", "num_tokens")

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self.blocks: List[int] = []
        self.num_tokens = 0

    def _blocks_needed(self, n: int) -> int:
        bs = self.pool.block_size
        return -((self.num_tokens + n) // -bs) - len(self.blocks)

    def append_tokens(self, n: int,
                      cow_copy: Optional[Callable[[int, int], None]] = None
                      ) -> np.ndarray:
        """Reserve slots for ``n`` new tokens; returns their BLOCK-space
        flat slot indices ``block * block_size + offset`` (int32).

        Atomic: every needed allocation (growth blocks AND a
        copy-on-write replacement for a shared tail block) happens
        before any state mutates, so ``BlockPoolExhausted`` leaves the
        table exactly as it was.  ``cow_copy(src, dst)`` is invoked for
        a shared tail block (refcount > 1) so the owner (``PagedKVCache``)
        can copy the page contents before this sequence writes into it.
        """
        if n <= 0:
            return np.empty((0,), np.int32)
        bs = self.pool.block_size
        pool = self.pool
        off0 = self.num_tokens % bs
        cow_src = None
        if (off0 and self.blocks
                and pool.refcount(self.blocks[-1]) > 1):
            cow_src = self.blocks[-1]
        need = self._blocks_needed(n) + (1 if cow_src is not None else 0)
        fresh = pool.alloc_n(need) if need else []
        # --- commit point: nothing below can fail -----------------------
        if cow_src is not None:
            dst = fresh.pop(0)
            if cow_copy is not None:
                cow_copy(cow_src, dst)
            pool.decref(cow_src)
            self.blocks[-1] = dst
        self.blocks.extend(fresh)
        slots = np.empty((n,), np.int32)
        for i in range(n):
            t = self.num_tokens + i
            slots[i] = self.blocks[t // bs] * bs + t % bs
        self.num_tokens += n
        return slots

    def fork(self) -> "BlockTable":
        """A new table SHARING this one's blocks (prefix sharing): every
        block's refcount bumps; divergent appends copy-on-write."""
        child = BlockTable(self.pool)
        for b in self.blocks:
            self.pool.incref(b)
        child.blocks = list(self.blocks)
        child.num_tokens = self.num_tokens
        return child

    def truncate(self) -> None:
        """Release every block (sequence retired/preempted/cancelled)."""
        for b in self.blocks:
            self.pool.decref(b)
        self.blocks = []
        self.num_tokens = 0


class PagedKVCache:
    """The device page tensors + the pool/table machinery.

    Pages are ``(L, P, bs, Hkv, D)`` tensors on ``device`` (None: the
    card) with page 0 reserved as scratch; pool block ``b`` lives at page
    ``b + 1``.  ``page_sharding`` (a ``NamedSharding`` over the KV-head
    axis, see ``DecoderLM.shard``) places them over a model-parallel mesh
    instead: each shard holds ``Hkv / mp`` heads of every page, on its
    device.  ``prefix_cache=True`` attaches a ``RadixPrefixCache`` over
    the same pool (cross-request prefix reuse).
    """

    def __init__(self, n_layers: int, num_blocks: int, block_size: int,
                 n_kv_heads: int, head_dim: int, dtype=torch.float32,
                 page_sharding=None, prefix_cache: bool = False,
                 device=None):
        self.pool = BlockPool(num_blocks, block_size)
        self.n_layers = n_layers
        self.block_size = block_size
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.device = resolve_device(device)
        shape = (n_layers, num_blocks + 1, block_size, n_kv_heads,
                 head_dim)
        if page_sharding is None:
            self.k_pages = torch.zeros(shape, dtype=dtype,
                                       device=self.device)
            self.v_pages = torch.zeros(shape, dtype=dtype,
                                       device=self.device)
        else:
            self.k_pages = _zero_pages(shape, dtype, page_sharding)
            self.v_pages = _zero_pages(shape, dtype, page_sharding)
        self.page_sharding = page_sharding
        if prefix_cache:
            from analytics_zoo_tpu_torch.llm.prefix_cache import \
                RadixPrefixCache
            self.prefix_cache: Optional[RadixPrefixCache] = \
                RadixPrefixCache(self.pool)
        else:
            self.prefix_cache = None
        itemsize = torch.empty((), dtype=dtype).element_size()
        #: bytes of KV one cached token holds (both k and v, all layers)
        self.kv_bytes_per_token = int(
            2 * n_layers * n_kv_heads * head_dim * itemsize)
        #: ... of which one device holds (1/mp of it over a model axis)
        self.kv_bytes_per_token_per_device = (
            self.kv_bytes_per_token if page_sharding is None else int(
                2 * n_layers * head_dim * itemsize
                * page_sharding.shard_shape(shape)[3]))
        self._tables: Dict[str, BlockTable] = {}
        # device-memory ledger pool: attribution walks the tables + radix
        # cache; refcount_balance is the ground truth the leak sentinel
        # sweeps against
        self._mem_pool = zoomem.get_ledger().register(
            "kv_blocks", self._mem_snapshot,
            reconcile_fn=self._mem_reconcile, owner=self)

    # ---- table lifecycle --------------------------------------------------
    def table(self, seq_id: str) -> BlockTable:
        t = self._tables.get(seq_id)
        if t is None:
            t = self._tables[seq_id] = BlockTable(self.pool)
        return t

    def fork(self, src_id: str, dst_id: str) -> BlockTable:
        if dst_id in self._tables:
            raise ValueError(f"sequence {dst_id!r} already has a table")
        child = self._tables[src_id].fork()
        self._tables[dst_id] = child
        return child

    def free(self, seq_id: str) -> None:
        t = self._tables.pop(seq_id, None)
        if t is not None:
            t.truncate()

    def append_tokens(self, seq_id: str, n: int) -> np.ndarray:
        """Slot indices in PAGE space (scratch-shifted, ready for the
        model's scatter): ``(block + 1) * bs + offset``."""
        slots = self.table(seq_id).append_tokens(n, cow_copy=self.copy_page)
        return slots + self.block_size   # block b -> page b + 1

    # ---- cross-request prefix reuse ---------------------------------------
    def adoptable_tokens(self, tokens) -> int:
        """How many leading tokens of a prompt the radix cache would
        supply (read-only sizing peek for the scheduler — no hit/miss
        stats, but the matched nodes ARE touched most-recently-used so
        admission-pressure reclaim takes other leaves first instead of
        evicting the very prefix the admission is sized against)."""
        if self.prefix_cache is None or len(tokens) <= self.block_size:
            return 0
        return self.block_size * len(
            self.prefix_cache.match(tokens, max_tokens=len(tokens) - 1))

    def adopt_prefix(self, seq_id: str, tokens) -> int:
        """Seed a NEW sequence's table with the longest cached prefix of
        ``tokens``: every matched radix block is adopted by refcount
        bump — zero recompute for those tokens.  At least one token is
        always left for prefill to compute (it must produce logits).
        Returns the number of adopted tokens (0 on miss/disabled)."""
        if self.prefix_cache is None:
            return 0
        t = self.table(seq_id)
        if t.blocks or t.num_tokens:
            raise ValueError(
                f"adopt_prefix on non-empty table {seq_id!r}")
        blocks = self.prefix_cache.match(tokens,
                                         max_tokens=len(tokens) - 1)
        for b in blocks:
            self.pool.incref(b)
        t.blocks = list(blocks)
        t.num_tokens = len(blocks) * self.block_size
        if len(tokens) > self.block_size:
            # sub-block prompts can never match or insert — counting
            # them would drown the published hit rate
            self.prefix_cache.count_lookup(t.num_tokens)
        return t.num_tokens

    def insert_prefix(self, seq_id: str, tokens) -> int:
        """Register a completed prefill's full blocks in the radix
        cache (misses insert; the next request with this prefix
        adopts).  Returns new cache nodes created."""
        if self.prefix_cache is None:
            return 0
        t = self._tables[seq_id]
        return self.prefix_cache.insert(tokens, t.blocks)

    def reclaim(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` by evicting cache-only (refcount-1)
        radix leaves, LRU first — the lever the scheduler pulls BEFORE
        preempting live work.  Returns blocks actually freed."""
        if self.prefix_cache is None:
            return 0
        return self.prefix_cache.evict(n_blocks)

    def page_table(self, seq_id: str, max_blocks: int) -> np.ndarray:
        """(max_blocks,) int32 page ids, scratch-padded."""
        t = self._tables[seq_id]
        if len(t.blocks) > max_blocks:
            raise ValueError(
                f"sequence {seq_id!r} holds {len(t.blocks)} blocks > "
                f"table width {max_blocks}")
        out = np.zeros((max_blocks,), np.int32)   # scratch page 0 pads
        out[:len(t.blocks)] = np.asarray(t.blocks, np.int32) + 1
        return out

    # ---- device-side ops --------------------------------------------------
    def copy_page(self, src_block: int, dst_block: int) -> None:
        """Copy-on-write hook: duplicate one pool block's page contents
        (all layers), in place and on the current stream, before a forked
        sequence diverges into it."""
        src, dst = src_block + 1, dst_block + 1
        for pages in _tensors(self.k_pages) + _tensors(self.v_pages):
            pages[:, dst].copy_(pages[:, src])

    def write(self, layer: int, slots, k, v) -> None:
        """Scatter ``k``/``v`` (N, Hkv, D) into page-space ``slots`` of
        one layer, in place.  (The model's entry points do this inside
        their own forward; this host-level entry point serves tests and
        the pure-python scheduler paths.)"""
        idx = torch.as_tensor(np.asarray(slots), dtype=torch.long,
                              device=self.device)
        for pages, x in ((self.k_pages, k), (self.v_pages, v)):
            write_slots(pages, layer, idx,
                        torch.as_tensor(x, device=self.device))

    def leak_check(self) -> Dict[str, int]:
        """Accounting snapshot for the leak invariants: with no live
        tables every block must be either back on the free list or held
        exactly once by the radix prefix cache (``cached_blocks``)."""
        held = sum(len(t.blocks) for t in self._tables.values())
        cached = (self.prefix_cache.cached_blocks
                  if self.prefix_cache is not None else 0)
        return {"tables": len(self._tables), "held_blocks": held,
                "cached_blocks": cached,
                "free_blocks": self.pool.free_blocks,
                "in_use": self.pool.blocks_in_use}

    # ---- memory ledger pool ----------------------------------------------
    @property
    def block_bytes(self) -> int:
        """Device bytes one pool block holds (k + v, all layers)."""
        return self.block_size * self.kv_bytes_per_token

    def _mem_snapshot(self) -> Dict[str, object]:
        """The ``kv_blocks`` pool contract, derived from ONE walk of the
        tables + radix cache so attribution sums to used by construction:
        a block held by exactly one sequence books under ``seq:<id>``, a
        cache-only block under ``prefix_cache``, and a block with several
        holders (forked or adopted prefix) under ``shared``.  Pinned =
        blocks any live sequence references; cache-only blocks are what
        ``reclaim()`` can demote."""
        bb = self.block_bytes
        holders: Dict[int, List[str]] = {}
        for seq_id, t in list(self._tables.items()):
            for b in list(t.blocks):
                holders.setdefault(b, []).append(f"seq:{seq_id}")
        if self.prefix_cache is not None:
            for b in self.prefix_cache.held_blocks():
                holders.setdefault(b, []).append("prefix_cache")
        owners: Dict[str, int] = {}
        pinned = 0
        for b, hs in holders.items():
            key = hs[0] if len(hs) == 1 else "shared"
            owners[key] = owners.get(key, 0) + bb
            if any(h.startswith("seq:") for h in hs):
                pinned += bb
        return {"capacity_bytes": self.pool.num_blocks * bb,
                "used_bytes": len(holders) * bb,
                "pinned_bytes": pinned,
                "blocks": len(holders),
                "owners": owners}

    def _mem_reconcile(self) -> List[str]:
        """The leak sentinel's ground truth: exact per-block refcount
        books plus the radix cache's node-book recount.  A block acquired
        behind the tables' back (``pool.alloc_n`` with no table or cache
        holding it) shows up here as an expected-0 ref mismatch within
        one sweep."""
        lines = [f"block {b}: {msg}"
                 for b, msg in sorted(self.refcount_balance().items())]
        if self.prefix_cache is not None:
            lines.extend(self.prefix_cache.reconcile())
        return lines

    def refcount_balance(self) -> Dict[int, str]:
        """EXACT per-block books: every pool refcount must equal the
        number of table references plus the number of radix-cache
        references on that block.  Returns the mismatches (empty ==
        balanced)."""
        expected = [0] * self.pool.num_blocks
        # list() copies: another thread may append/free meanwhile (a
        # torn read is fine — a RuntimeError is not)
        for t in list(self._tables.values()):
            for b in list(t.blocks):
                expected[b] += 1
        if self.prefix_cache is not None:
            for b in self.prefix_cache.held_blocks():
                expected[b] += 1
        out: Dict[int, str] = {}
        with self.pool._lock:
            actual = list(self.pool._ref)
        for b, (exp, act) in enumerate(zip(expected, actual)):
            if exp != act:
                out[b] = f"expected {exp} refs, pool says {act}"
        return out


def _zero_pages(shape, dtype, sharding) -> ShardedTensor:
    """Zero pages placed by ``sharding``: one zero tensor per distinct
    (device, block), made on its device (never a whole pool first)."""
    block = sharding.shard_shape(shape)
    mesh = sharding.mesh
    made: Dict[tuple, torch.Tensor] = {}
    shards = []
    for p, dev in enumerate(mesh.devices.flat):
        key = (str(dev), tuple((s.start, s.stop)
                               for s in sharding.index(p, shape)))
        if key not in made:
            made[key] = torch.zeros(block, dtype=dtype, device=dev)
        shards.append(made[key])
    return ShardedTensor(shards, shape, sharding)


def _tensors(pages) -> List[torch.Tensor]:
    if isinstance(pages, ShardedTensor):
        return [t for _, t in pages.unique_shards()]
    return [pages]


def write_slots(pages, layer: int, slots: torch.Tensor,
                kv: torch.Tensor) -> None:
    """Scatter ``kv`` (N, Hkv, D) into page-space ``slots`` (int64, on
    ``kv``'s device) of layer ``layer`` of ``pages`` (L, P, bs, Hkv, D),
    in place: a tensor, or a ``ShardedTensor``, each of whose shards
    takes its block of heads (and moves it to its device)."""
    if not isinstance(pages, ShardedTensor):
        L, P, bs, Hkv, D = pages.shape
        pages[layer].view(P * bs, Hkv, D).index_copy_(0, slots,
                                                      kv.to(pages.dtype))
        return
    for index, shard in pages.unique_shards():
        if any((s.start, s.stop) != (0, n)
               for s, n in zip(index[:3], pages.shape[:3])):
            raise ValueError(f"pages split along L, P or bs cannot take "
                             f"slot writes: {pages.sharding}")
        L, P, bs, Hkv, D = shard.shape
        part = kv[:, index[3], index[4]].to(shard.device, shard.dtype)
        shard[layer].view(P * bs, Hkv, D).index_copy_(
            0, slots.to(shard.device), part)
