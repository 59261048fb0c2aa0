"""Cross-request radix prefix cache over the paged KV block pool.

Copy of ``analytics_zoo_tpu/llm/prefix_cache.py`` (host-only; the port
cannot import the JAX package).

Fleet traffic shares prompt prefixes — system prompts, few-shot
preambles, multi-turn history — yet the continuous batcher used to
prefill every request from token zero.  This module generalizes the
refcounted ``BlockTable.fork()``/copy-on-write machinery of
``llm/kv_cache.py`` into an AUTOMATIC cache: a radix tree at BLOCK
granularity, keyed on token content, whose nodes each own one pool
block (docs/llm-serving.md "Radix prefix cache").

- **Match** (admission-time): walk the tree over the prompt's full
  ``block_size``-token chunks; every matched node's block is adopted by
  the new sequence via a refcount bump — ZERO recompute for the shared
  prefix, the same physical KV attended by every sharer.
- **Insert** (prefill completion): the sequence's full blocks are
  registered along its token path; each NEW node takes its own
  reference on the block (``incref``), so the KV outlives the sequence
  and the next request with that prefix hits.
- **Evict** (pool pressure): LRU by LEAF, over nodes whose block sits
  at refcount 1 — i.e. held ONLY by the cache.  A block shared with a
  live sequence is unevictable by construction (evicting its node would
  free nothing and orphan a resident prefix), so eviction always frees
  exactly one pool block per removed node and the books stay exact.

Content addressing makes reuse trivially exact: a block's KV depends
only on the tokens at and before it, so equal token paths denote equal
KV pages.  Two concurrent misses on the same prefix may both compute
it; the second insert finds the path occupied and keeps its private
copy (slightly wasteful, never wrong).

Thread-safety: one lock over the tree.  The engine thread owns
match/insert/evict; the lock keeps the stats and books coherent for
metrics readers and the leak-check invariants.
"""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from analytics_zoo_tpu_torch.llm.kv_cache import BlockPool


class _Node:
    """One cached block: the ``block_size`` tokens it holds, the pool
    block id, and the tree links."""

    __slots__ = ("key", "block", "parent", "children", "last_used")

    def __init__(self, key: Tuple[int, ...], block: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0


class RadixPrefixCache:
    """Block-granular radix tree over one ``BlockPool``.

    The cache holds its OWN reference on every node's block: a block
    shared between the cache and N live sequences carries refcount
    N + 1, and the exactness invariant the chaos/eviction tests hold is
    ``pool refcount == table references + cache references`` for every
    block at every point (``PagedKVCache.refcount_balance``).
    """

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self.block_size = pool.block_size
        self._lock = threading.Lock()
        self._root_children: Dict[Tuple[int, ...], _Node] = {}
        self._clock = itertools.count(1)
        self._n_nodes = 0
        # stats (exact, monotonic; the engine exposes them as metrics)
        self.hits = 0
        self.misses = 0
        self.tokens_saved = 0
        self.insertions = 0
        self.evictions = 0

    # ---- queries ----------------------------------------------------------
    @property
    def cached_blocks(self) -> int:
        """Blocks the cache holds a reference on (== node count)."""
        with self._lock:
            return self._n_nodes

    def held_blocks(self) -> List[int]:
        """Every pool block the cache currently references (the
        leak-check/refcount-balance surface)."""
        with self._lock:
            out: List[int] = []
            stack = list(self._root_children.values())
            while stack:
                n = stack.pop()
                out.append(n.block)
                stack.extend(n.children.values())
            return out

    def reconcile(self) -> List[str]:
        """Consistency check: recount the tree and cross-check the
        incrementally-maintained node book — a drifted
        ``_n_nodes`` means an insert/evict path moved a node without
        its book entry, exactly the class of bug the leak sentinel
        exists to catch.  Returns divergence lines (empty == exact)."""
        with self._lock:
            count = 0
            stack = list(self._root_children.values())
            while stack:
                n = stack.pop()
                count += 1
                stack.extend(n.children.values())
            if count != self._n_nodes:
                return [f"radix node book says {self._n_nodes}, tree "
                        f"walk counts {count}"]
            return []

    # ---- match ------------------------------------------------------------
    def match(self, tokens: Sequence[int],
              max_tokens: Optional[int] = None) -> List[int]:
        """Longest cached prefix of ``tokens`` in FULL blocks; returns
        the matched blocks (refcounts NOT bumped — the adopter increfs
        under its own table discipline, see ``PagedKVCache.adopt_prefix``).

        Pure lookup plus an LRU touch: matched nodes become
        most-recently-used, which also protects a prefix the scheduler
        just sized an admission against from being reclaimed before
        the sequence adopts it.  Hit/miss/saved stats are counted at
        ADOPTION (``PagedKVCache.adopt_prefix``) — a sizing peek or a
        sub-block prompt must not skew the published rate.

        ``max_tokens`` caps the match (the engine passes
        ``len(ctx) - 1`` so at least one token is always recomputed —
        prefill must produce the next-token logits).
        """
        bs = self.block_size
        limit = len(tokens) if max_tokens is None else min(
            len(tokens), max_tokens)
        with self._lock:
            blocks: List[int] = []
            children = self._root_children
            for i in range(0, limit - bs + 1, bs):
                key = tuple(int(t) for t in tokens[i:i + bs])
                node = children.get(key)
                if node is None:
                    break
                node.last_used = next(self._clock)
                blocks.append(node.block)
                children = node.children
            return blocks

    def count_lookup(self, matched_tokens: int) -> None:
        """Record one ADOPTION-path lookup outcome (the single source
        the Prometheus counters, ``metrics()`` and the bench all read).
        The caller applies its own eligibility rule (e.g. sub-block
        prompts are not counted — they can never match or insert)."""
        with self._lock:
            if matched_tokens:
                self.hits += 1
                self.tokens_saved += matched_tokens
            else:
                self.misses += 1

    # ---- insert -----------------------------------------------------------
    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> int:
        """Register a finished prefill's FULL blocks along its token
        path; returns how many new nodes were created.  Existing nodes
        are kept (first writer wins — the later duplicate block stays
        private to its sequence and frees with it)."""
        bs = self.block_size
        n_full = min(len(tokens) // bs, len(blocks))
        created = 0
        with self._lock:
            children = self._root_children
            parent: Optional[_Node] = None
            for j in range(n_full):
                key = tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])
                node = children.get(key)
                if node is None:
                    node = _Node(key, int(blocks[j]), parent)
                    # the cache's OWN reference: the block now outlives
                    # the inserting sequence
                    self.pool.incref(node.block)
                    children[key] = node
                    self._n_nodes += 1
                    self.insertions += 1
                    created += 1
                node.last_used = next(self._clock)
                parent = node
                children = node.children
            return created

    # ---- evict ------------------------------------------------------------
    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` pool blocks: LRU over LEAVES whose
        block is at refcount 1 (cache-only).  One tree walk seeds an
        LRU heap of evictable leaves; removing a leaf may expose its
        parent as the next candidate, which is pushed as it appears —
        O(nodes + freed·log nodes), not a re-walk per freed block
        (reclaim runs on the engine thread's admission path).  Returns
        blocks actually freed."""
        freed = 0
        with self._lock:
            heap: List[Tuple[int, int, _Node]] = []
            tie = itertools.count()
            stack = list(self._root_children.values())
            while stack:
                node = stack.pop()
                if node.children:
                    stack.extend(node.children.values())
                else:
                    heapq.heappush(heap,
                                   (node.last_used, next(tie), node))
            while freed < n_blocks and heap:
                _, _, victim = heapq.heappop(heap)
                if victim.children:
                    continue               # stale entry: grew children
                if self.pool.refcount(victim.block) != 1:
                    continue               # shared with a live table
                siblings = (victim.parent.children
                            if victim.parent is not None
                            else self._root_children)
                if siblings.get(victim.key) is not victim:
                    continue               # already removed
                del siblings[victim.key]
                self._n_nodes -= 1
                self.evictions += 1
                self.pool.decref(victim.block)   # refcount 1 -> freed
                freed += 1
                parent = victim.parent
                if parent is not None and not parent.children:
                    heapq.heappush(
                        heap, (parent.last_used, next(tie), parent))
        return freed

    def flush(self) -> int:
        """Evict everything evictable (tests/bench teardown); with no
        live sequences this empties the cache entirely."""
        return self.evict(self.pool.num_blocks)
