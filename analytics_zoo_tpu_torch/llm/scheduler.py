"""Continuous-batching scheduler (docs/llm-serving.md "Scheduler").

Copy of ``analytics_zoo_tpu/llm/scheduler.py`` (host-only; the port
cannot import the JAX package).

The decode batch is a FIXED-WIDTH slot array (one step shape); sequences
are admitted into free slots and retired out of them *mid-batch*, so a finished sequence's slot is refilled on the very next
step instead of idling until the batch's slowest member drains (the
static-padded-batching tax).

Sequence state machine::

    WAITING --admit/slot--> PREFILL --prefill done--> DECODING
       ^                                                |
       |        preempt (blocks freed,                  |
       +---- generated tokens kept: recompute ----------+
                      on resume)
    DECODING/PREFILL --eos / max tokens / deadline / cancel / error-->
    FINISHED

Preemption: when the block pool exhausts mid-decode, the lowest-
priority (then youngest) running sequence is evicted — its blocks free
immediately, its prompt + generated-so-far requeue at its original
priority, and resume re-prefills the whole context (recompute-on-
resume; no swapped-out KV to page back in).  The scheduler owns ONLY
placement/accounting; device work, token publication and credits live
in ``llm.engine``.
"""

from __future__ import annotations

import itertools
import time
from typing import List, Optional

from analytics_zoo_tpu_torch.llm.kv_cache import PagedKVCache

#: sequence states
WAITING = "waiting"
PREFILL = "prefill"     # slotted, context not yet in the KV cache
DECODING = "decoding"
FINISHED = "finished"

_arrivals = itertools.count()


class GenSequence:
    """One generation request travelling the scheduler."""

    __slots__ = ("uri", "prompt", "max_new_tokens", "priority",
                 "deadline", "tref", "generated", "state", "slot",
                 "arrival", "t_enqueue", "t_first_token", "t_last_token",
                 "preemptions", "credits", "prefill_pos",
                 "prefix_checked")

    def __init__(self, uri: str, prompt, max_new_tokens: int,
                 priority: int = 0, deadline=None, tref=None):
        self.uri = uri
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.priority = int(priority)
        self.deadline = deadline
        self.tref = tref
        self.generated: List[int] = []
        self.state = WAITING
        self.slot: Optional[int] = None
        self.arrival = next(_arrivals)
        self.t_enqueue = time.monotonic()
        self.t_first_token: Optional[float] = None
        self.t_last_token: Optional[float] = None
        self.preemptions = 0
        self.credits = 0      # admission credits held (released once)
        self.prefill_pos = 0  # context tokens already in the KV cache
        self.prefix_checked = False  # radix lookup done for this slotting

    @property
    def context_len(self) -> int:
        return len(self.prompt) + len(self.generated)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    def __repr__(self) -> str:
        return (f"GenSequence({self.uri!r}, {self.state}, "
                f"ctx={self.context_len}, gen={len(self.generated)}/"
                f"{self.max_new_tokens})")


class ContinuousBatchingScheduler:
    """Slot placement + preemption policy over one ``PagedKVCache``.

    ``mode="continuous"`` refills slots every step; ``mode="static"``
    only admits when EVERY slot is empty (whole-batch turnover — the
    padded-batching baseline the regression bar compares against, run
    through the identical engine/step machinery so the measured gap is
    pure scheduling).
    """

    def __init__(self, cache: PagedKVCache, max_slots: int,
                 mode: str = "continuous"):
        if mode not in ("continuous", "static"):
            raise ValueError(f"unknown scheduling mode {mode!r}")
        self.cache = cache
        self.mode = mode
        self.slots: List[Optional[GenSequence]] = [None] * max_slots
        self.waiting: List[GenSequence] = []
        self.preemptions = 0

    # ---- queries ----------------------------------------------------------
    @property
    def max_slots(self) -> int:
        return len(self.slots)

    def active(self) -> List[GenSequence]:
        return [s for s in self.slots if s is not None]

    def decoding(self) -> List[GenSequence]:
        return [s for s in self.slots if s is not None
                and s.state == DECODING]

    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None
                                         for s in self.slots)

    def find(self, uri: str) -> Optional[GenSequence]:
        for s in self.waiting:
            if s.uri == uri:
                return s
        for s in self.slots:
            if s is not None and s.uri == uri:
                return s
        return None

    # ---- admission --------------------------------------------------------
    def add(self, seq: GenSequence) -> None:
        self.waiting.append(seq)
        # stable order: highest priority first, then arrival (a
        # preempted sequence re-queues with its ORIGINAL arrival, so it
        # outranks later work at equal priority)
        self.waiting.sort(key=lambda s: (-s.priority, s.arrival))

    def _blocks_for(self, n_tokens: int) -> int:
        bs = self.cache.block_size
        return -(n_tokens // -bs)

    def schedule_admissions(self) -> List[GenSequence]:
        """Move waiting sequences into free slots (blocks permitting);
        returns those now needing prefill.  Admission preempts only
        STRICTLY lower-priority running work — equal-priority sequences
        wait for capacity instead of thrashing each other."""
        if self.mode == "static" and any(s is not None
                                         for s in self.slots):
            return []
        admitted: List[GenSequence] = []
        free_slots = [i for i, s in enumerate(self.slots) if s is None]
        while free_slots and self.waiting:
            seq = self.waiting[0]
            # room for the whole context plus the first generated
            # token, LESS whatever the radix cache already holds — the
            # adoptable blocks need no new pool space, and sizing
            # against them stops reclaim from evicting the very prefix
            # this admission is about to adopt (the peek also touches
            # the matched nodes most-recently-used)
            adoptable = self.cache.adoptable_tokens(
                seq.prompt + seq.generated)
            need = self._blocks_for(seq.context_len + 1) \
                - adoptable // self.cache.block_size
            while self.cache.pool.free_blocks < need:
                # cold radix-cache blocks go first — evicting a cached
                # prefix costs recompute-on-next-hit, never live work
                if self.cache.reclaim(need - self.cache.pool.free_blocks):
                    continue
                if not self._preempt_one(below_priority=seq.priority,
                                         exclude=seq):
                    break
            if self.cache.pool.free_blocks < need:
                break
            self.waiting.pop(0)
            slot = free_slots.pop(0)
            seq.slot = slot
            seq.state = PREFILL
            self.slots[slot] = seq
            admitted.append(seq)
        return admitted

    # ---- preemption -------------------------------------------------------
    def _freeable_blocks(self, seq: GenSequence) -> int:
        """How many pool blocks evicting ``seq`` actually returns: only
        blocks whose refcount drops to ZERO free — a block shared with
        the radix cache or a forked sibling frees nothing when this
        sequence's reference drops."""
        t = self.cache._tables.get(seq.uri)
        if t is None:
            return 0
        return sum(1 for b in t.blocks if self.cache.pool.refcount(b) == 1)

    def _victim(self, below_priority: Optional[int] = None,
                exclude: Optional[GenSequence] = None,
                require_freeable: bool = True
                ) -> Optional[GenSequence]:
        cands = [s for s in self.slots
                 if s is not None and s is not exclude
                 and (below_priority is None
                      or s.priority < below_priority)]
        if require_freeable:
            # evicting a sequence whose blocks are all SHARED frees no
            # pool capacity — the pre-prefix-sharing policy would evict
            # such a victim and still fail to admit
            cands = [s for s in cands if self._freeable_blocks(s) > 0]
        if not cands:
            return None
        # lowest priority loses; ties evict the youngest (its lost
        # recompute work is the smallest)
        return min(cands, key=lambda s: (s.priority, -s.arrival))

    def _preempt_one(self, below_priority: Optional[int] = None,
                     exclude: Optional[GenSequence] = None,
                     require_freeable: bool = True) -> bool:
        victim = self._victim(below_priority, exclude, require_freeable)
        if victim is None:
            return False
        self.preempt(victim)
        return True

    def preempt(self, seq: GenSequence) -> None:
        """Evict one slotted sequence: free its blocks NOW, requeue it
        (prompt + generated kept — recompute-on-resume)."""
        self.release_slot(seq)
        seq.state = WAITING
        seq.preemptions += 1
        self.preemptions += 1
        self.add(seq)

    def free_blocks_for_decode(self, seq: GenSequence,
                               exclude=None) -> bool:
        """Make room for one more token of ``seq``: reclaim cold cache
        blocks, then preempt (any priority — running work must advance)
        until a block frees or no victim remains.  Returns False when
        no lever can produce a free block (the caller must fail or
        self-preempt ``seq``)."""
        ex = exclude or seq
        if self.cache.reclaim(1):
            return True
        if self._preempt_one(below_priority=None, exclude=ex):
            return True
        # last resort: a victim whose blocks are ALL shared frees
        # nothing directly, but evicting it drops those blocks toward
        # refcount 1 — where the radix cache can reclaim them, or (for
        # plain forked sharers with no cache reference) where evicting
        # the LAST sharer returns them to the pool outright.  With N
        # sharers the first N-1 evictions free nothing, so keep going
        # until a block actually frees or no victim remains.
        while self._preempt_one(below_priority=None, exclude=ex,
                                require_freeable=False):
            if self.cache.pool.free_blocks or self.cache.reclaim(1):
                return True
        return False

    # ---- retirement -------------------------------------------------------
    def release_slot(self, seq: GenSequence) -> None:
        """Drop the sequence from its slot and free its KV blocks (the
        one accounting path retire/preempt/cancel/expire all share)."""
        if seq.slot is not None and self.slots[seq.slot] is seq:
            self.slots[seq.slot] = None
        seq.slot = None
        seq.prefill_pos = 0      # resume re-prefills (adopting anew)
        seq.prefix_checked = False
        self.cache.free(seq.uri)

    def remove(self, seq: GenSequence) -> None:
        """Take the sequence out of the scheduler entirely (finished,
        cancelled, expired) — slot, blocks and waiting entry."""
        if seq in self.waiting:
            self.waiting.remove(seq)
        self.release_slot(seq)
        seq.state = FINISHED
