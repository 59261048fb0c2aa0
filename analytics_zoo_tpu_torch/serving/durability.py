"""Durable request/result plane: journaled broker + warm standby.

Port of ``analytics_zoo_tpu/serving/durability.py``: the same WAL
records, ledger, dedup barrier and chaos points.

The fleet and streaming tiers assumed the one broker-owning process
never dies: ``FleetSupervisor`` owned the only copy of every queued
request.  This module extends the ``PaneJournal`` write-ahead
discipline to the request plane, the role Redis
played for the reference's Cluster Serving (SURVEY §1 L7):

- ``DurableBroker`` — the broker surface (``InMemoryBroker`` parity)
  with every mutating op journaled to a segment-based WAL
  (``common/wal.py``) with group-commit batching.  ``xadd``/``xack``/
  result publishes return only after their record's group flush, so an
  acknowledged-at-client request survives ``kill -9`` of the owner.
- **Pending-entry ledger**: every delivered-but-unacked entry is held
  per ``(stream, group)``; entries idle past ``redeliver_idle_s`` (a
  consumer died mid-work, or the broker owner was replaced) are
  REDELIVERED on the next read — claim-on-death without a reaper
  thread.
- **Dedup barrier**: clients stamp a ``dedup_id`` on each logical
  enqueue; an at-least-once retry of the same enqueue (client retried
  a dead connection whose xadd had in fact committed) is dropped with
  its original sid returned — at-least-once transport + the barrier =
  exactly-once enqueue, the same discipline the streaming consumer's
  ``DedupBarrier`` applies to panes.
- ``BrokerReplica`` — a warm standby: tails the primary's WAL over the
  broker-bridge wire (``wal_tail``), applies each record to its own
  ``DurableBroker`` (journaling a replicated copy locally), and on
  ``promote()`` catches up the unreplicated tail straight from the
  primary's on-disk WAL, arms immediate redelivery of every pending
  entry, and starts serving — zero acknowledged-request loss without
  synchronous replication.

Chaos points: ``wal_append`` fires before each
journal append, ``wal_replay`` before each replayed record's
application (replay retries transient faults, bounded), and
``broker_promote`` at the top of a promotion.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import CancelledError
from typing import Dict, List, Optional, Tuple

from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common.wal import (WriteAheadLog,
                                                _read_segment)
from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
from analytics_zoo_tpu_torch.testing import chaos

logger = logging.getLogger("analytics_zoo_tpu_torch.serving")

__all__ = ["BrokerReplica", "DurableBroker", "replay_dir"]

_m_redelivered = obs.lazy_counter(
    "zoo_broker_redelivered_total",
    "pending-entry-ledger redeliveries (consumer died or idle past the "
    "claim window)")
_m_dedup = obs.lazy_counter(
    "zoo_broker_dedup_dropped_total",
    "duplicate enqueues dropped by the broker dedup barrier (client "
    "retry of an already-committed xadd)")
_m_replay_faults = obs.lazy_counter(
    "zoo_broker_wal_replay_faults_total",
    "transient faults retried while applying replayed WAL records")
_m_promotions = obs.lazy_counter(
    "zoo_broker_promotions_total",
    "standby replicas promoted to primary")
_m_recovered = obs.lazy_counter(
    "zoo_broker_recovered_entries_total",
    "stream entries rebuilt from the WAL at recovery", ["state"])

#: bound on remembered dedup ids (at-least-once retries arrive within
#: seconds of the original; an LRU this deep cannot forget a live one)
_DEDUP_MAX = 65536


def replay_dir(wal_dir: str, from_seq: int = 0):
    """``(seq, record)`` over a WAL directory WITHOUT constructing a
    ``WriteAheadLog`` (the promote-time disk catch-up reads the dead
    primary's directory read-only).  A torn tail here IS a crash
    artifact: counted."""
    from analytics_zoo_tpu_torch.common.wal import _segments_from
    for _first, path in _segments_from(wal_dir, from_seq):
        yield from _read_segment(path, from_seq)


class _Pending:
    """One delivered-but-unacked entry in the ledger."""

    __slots__ = ("fields", "delivered_mono", "deliveries", "consumer")

    def __init__(self, fields, consumer, delivered_mono):
        self.fields = fields
        self.consumer = consumer
        self.delivered_mono = delivered_mono
        self.deliveries = 1


class DurableBroker:
    """The broker surface over a write-ahead log.

    Stream semantics live HERE (append-only list + per-group cursor +
    the pending-entry ledger — replayable exactly); the result/hash
    side delegates to an inner ``InMemoryBroker`` (its event-driven
    ``wait_result`` is what the bridge's combined wait+read uses) with
    every mutation journaled first.
    """

    def __init__(self, wal_dir: str, inner=None,
                 segment_bytes: int = 4 << 20,
                 commit_interval_ms: float = 0.0, sync: bool = False,
                 redeliver_idle_s: float = 3.0, recover: bool = True,
                 checkpoint_every_records: int = 200_000):
        self.inner = inner or InMemoryBroker()
        self.redeliver_idle_s = float(redeliver_idle_s)
        self.checkpoint_every_records = int(checkpoint_every_records)
        self.role = "primary"
        # mint lock: the JOURNAL-ORDER lock — every mutating op appends
        # its record AND applies its state change under it, so journal
        # order == state order (replay rebuilds exactly what consumers
        # saw) and ``checkpoint`` can snapshot atomically.  Group-commit
        # WAITs happen outside it.
        self._mint = threading.Lock()
        self._since_ckpt = 0
        # serializes apply_replicated's check-then-act on applied_seq:
        # a promote-time disk catch-up racing a tail thread that
        # outlived its join timeout (hung primary) must never apply
        # one record twice
        self._apply_lock = threading.Lock()
        self._cond = threading.Condition()
        self._streams: Dict[str, List[Tuple[str, dict]]] = {}
        self._cursors: Dict[Tuple[str, str], int] = {}
        self._unacked: Dict[Tuple[str, str],
                            "OrderedDict[str, _Pending]"] = {}
        self._dedup: "OrderedDict[str, str]" = OrderedDict()
        self._sid = 1
        self._applied_seq = 0      # highest PRIMARY seq applied (standby)
        self.wal = WriteAheadLog(wal_dir, segment_bytes=segment_bytes,
                                 commit_interval_ms=commit_interval_ms,
                                 sync=sync)
        if recover:
            self._recover()

    # ---- journal ----------------------------------------------------------
    def _journal(self, rec, wait: bool = True) -> int:
        chaos.fire("wal_append")
        self._since_ckpt += 1
        return self.wal.append(rec, wait=wait)

    def _recover(self) -> None:
        n = 0
        for seq, rec in self.wal.replay(0):
            self._apply_with_retry(rec)
            n += 1
        if n:
            with self._cond:
                fresh = sum(
                    len(v) - max([c for (s, _g), c in
                                  self._cursors.items() if s == name]
                                 or [0])
                    for name, v in self._streams.items())
                pending = sum(len(v) for v in self._unacked.values())
            _m_recovered.labels(state="fresh").inc(max(fresh, 0))
            _m_recovered.labels(state="pending").inc(pending)
            logger.info("durable broker recovered %d WAL records "
                        "(%d entries pending redelivery)", n, pending)
        # everything pending at recovery is due immediately: its
        # consumer is from the previous life
        self.arm_redelivery()

    def _apply_with_retry(self, rec) -> None:
        """Apply one replayed/replicated record; transient faults (the
        ``wal_replay`` chaos class) retry bounded — a record is never
        silently skipped (that would lose an acknowledged request)."""
        last = None
        for _attempt in range(3):
            try:
                chaos.fire("wal_replay")
                self._apply(rec)
                return
            except (Exception, CancelledError) as exc:
                last = exc
                _m_replay_faults.inc()
                logger.warning("WAL replay fault on %r (retrying): %s",
                               rec[0] if rec else rec, exc)
        raise RuntimeError(f"WAL replay failed after retries: {last!r}")

    def _apply(self, rec) -> None:
        """Re-apply one journaled op to live state (recovery and the
        standby's replication stream share this)."""
        kind = rec[0]
        if kind == "repl":
            # a standby's locally journaled copy of a primary record:
            # unwrap, remember how far the replication stream got
            _, pseq, inner_rec = rec
            self._applied_seq = max(self._applied_seq, int(pseq))
            self._apply(inner_rec)
            return
        if kind == "xadd":
            _, stream, sid, fields = rec
            with self._cond:
                self._streams.setdefault(stream, []).append(
                    (sid, dict(fields)))
                try:
                    self._sid = max(self._sid, int(sid) + 1)
                except ValueError:
                    pass
                did = fields.get("dedup_id")
                if did:
                    self._dedup_add(did, sid)
                self._cond.notify_all()
        elif kind == "group":
            _, stream, group = rec
            with self._cond:
                self._streams.setdefault(stream, [])
                self._cursors.setdefault((stream, group), 0)
        elif kind == "deliver":
            _, stream, group, sids = rec
            now = time.monotonic()
            with self._cond:
                key = (stream, group)
                pend = self._unacked.setdefault(key, OrderedDict())
                entries = self._streams.get(stream, [])
                cur = self._cursors.setdefault(key, 0)
                for sid in sids:
                    if sid in pend:
                        pend[sid].delivered_mono = now
                        pend[sid].deliveries += 1
                        continue
                    # fresh delivery: advance the cursor past it
                    for i in range(cur, len(entries)):
                        if entries[i][0] == sid:
                            pend[sid] = _Pending(entries[i][1], "?", now)
                            cur = i + 1
                            break
                self._cursors[key] = cur
        elif kind == "ack":
            _, stream, group, sids = rec
            with self._cond:
                pend = self._unacked.get((stream, group))
                if pend:
                    for sid in sids:
                        pend.pop(sid, None)
        elif kind == "results":
            self.inner.set_results(rec[1])
        elif kind == "hset":
            self.inner.hset(rec[1], rec[2])
        elif kind == "delete":
            self.inner.delete(rec[1])
        elif kind == "delete_stream":
            stream = rec[1]
            with self._cond:
                self._streams.pop(stream, None)
                for key in [k for k in self._cursors if k[0] == stream]:
                    del self._cursors[key]
                for key in [k for k in self._unacked if k[0] == stream]:
                    del self._unacked[key]
        elif kind == "snapshot":
            # a checkpoint record RESETS state to its snapshot: replay
            # before it is superseded, replay after it layers on top
            state = rec[1]
            now = time.monotonic()
            with self._cond:
                self._streams = {s: list(v)
                                 for s, v in state["streams"].items()}
                self._cursors = {tuple(k): v
                                 for k, v in state["cursors"]}
                self._unacked = {
                    tuple(k): OrderedDict(
                        (sid, _Pending(fields, "?", now))
                        for sid, fields, _dlv in pend)
                    for k, pend in state["unacked"]}
                for (k, pend) in state["unacked"]:
                    for sid, _fields, dlv in pend:
                        self._unacked[tuple(k)][sid].deliveries = dlv
                self._dedup = OrderedDict(state["dedup"])
                self._sid = max(self._sid, int(state["sid"]))
                self._applied_seq = max(self._applied_seq,
                                        int(state.get("applied_seq",
                                                      0)))
                self._cond.notify_all()
            for key in self.inner.keys("*"):
                self.inner.delete(key)
            if state["hashes"]:
                self.inner.set_results(state["hashes"])
        else:
            raise ValueError(f"unknown WAL record kind {kind!r}")

    def _dedup_add(self, dedup_id: str, sid: str) -> None:
        # lock held by caller
        self._dedup[dedup_id] = sid
        self._dedup.move_to_end(dedup_id)
        while len(self._dedup) > _DEDUP_MAX:
            self._dedup.popitem(last=False)

    # ---- replication surface ----------------------------------------------
    def wal_tail(self, from_seq: int, limit: int = 1024
                 ) -> List[Tuple[int, object]]:
        """Flushed records with ``seq >= from_seq`` — the standby's
        pull feed, proxied over the broker bridge."""
        return self.wal.tail(int(from_seq), int(limit))

    def apply_replicated(self, seq: int, rec) -> None:
        """Standby side: apply one primary record and journal a local
        copy (so a restarted/promoted standby recovers to the same
        state from its OWN directory)."""
        seq = int(seq)
        with self._apply_lock:
            if seq <= self._applied_seq:
                return                  # already applied (tail overlap)
            self._apply_with_retry(rec)
            self._applied_seq = seq
            self.wal.append(("repl", seq, rec), wait=False)
        if rec and rec[0] == "snapshot":
            # the primary compacted: compact the mirror too, so the
            # standby's directory (and a restarted standby's replay)
            # stays bounded the same way
            try:
                self.checkpoint()
            except (Exception, CancelledError):
                logger.exception("standby checkpoint failed; continuing")

    @property
    def applied_seq(self) -> int:
        return self._applied_seq

    def arm_redelivery(self) -> None:
        """Make every pending entry due NOW (recovery/promotion: the
        consumers that held them are gone)."""
        due = time.monotonic() - self.redeliver_idle_s
        with self._cond:
            for pend in self._unacked.values():
                for p in pend.values():
                    p.delivered_mono = due
            self._cond.notify_all()

    # ---- stream side ------------------------------------------------------
    def xadd(self, stream: str, fields: dict) -> str:
        fields = dict(fields)
        did = fields.get("dedup_id")
        if did:
            with self._cond:
                prior = self._dedup.get(did)
                if prior is not None:
                    # the dedup barrier: an at-least-once client retry
                    # of a committed xadd is dropped, original sid back
                    _m_dedup.inc()
                    return prior
        with self._mint:
            sid = str(self._sid)
            self._sid += 1
            seq = self._journal(("xadd", stream, sid, fields),
                                wait=False)
            with self._cond:
                self._streams.setdefault(stream, []).append(
                    (sid, fields))
                if did:
                    self._dedup_add(did, sid)
                self._cond.notify_all()
        # journal-before-acknowledge: the xadd returns only after its
        # record's group flush — an acknowledged-at-client request is
        # on disk, so kill -9 of the owner cannot lose it
        try:
            self.wal.commit(seq)
        except BaseException:
            # the flush failed (ENOSPC/EIO): ROLL BACK the live insert
            # and the dedup entry — otherwise a client retry of this
            # ERRORED enqueue would dedup against an entry that never
            # reached disk (a silent ack of an unflushed record)
            with self._cond:
                entries = self._streams.get(stream, [])
                for i in range(len(entries) - 1, -1, -1):
                    if entries[i][0] == sid:
                        del entries[i]
                        break
                if did and self._dedup.get(did) == sid:
                    del self._dedup[did]
            raise
        return sid

    def xgroup_create(self, stream: str, group: str) -> None:
        self._journal(("group", stream, group), wait=False)
        with self._cond:
            self._streams.setdefault(stream, [])
            self._cursors.setdefault((stream, group), 0)

    def xreadgroup(self, stream: str, group: str, consumer: str,
                   count: int = 16, block_ms: int = 100
                   ) -> List[Tuple[str, dict]]:
        deadline = time.monotonic() + block_ms / 1000.0
        key = (stream, group)
        while True:
            batch: List[Tuple[str, dict]] = []
            now = time.monotonic()
            with self._cond:
                pend = self._unacked.setdefault(key, OrderedDict())
                # 1) claim-on-death: pending entries idle past the
                # window are re-served first (their consumer is gone
                # or wedged; at-least-once, dedup'd downstream by the
                # replace-semantics result plane)
                for sid, p in pend.items():
                    if len(batch) >= count:
                        break
                    if now - p.delivered_mono >= self.redeliver_idle_s:
                        p.delivered_mono = now
                        p.deliveries += 1
                        p.consumer = consumer
                        batch.append((sid, dict(p.fields)))
                redelivered = len(batch)
                # 2) fresh entries past the group cursor
                entries = self._streams.get(stream, [])
                cur = self._cursors.setdefault(key, 0)
                take = entries[cur:cur + (count - len(batch))]
                if take:
                    self._cursors[key] = cur + len(take)
                    for sid, fields in take:
                        pend[sid] = _Pending(fields, consumer, now)
                        batch.append((sid, dict(fields)))
            if batch:
                if redelivered:
                    _m_redelivered.inc(redelivered)
                # delivery bookkeeping is journaled WITHOUT waiting for
                # the flush: losing a deliver record merely re-delivers
                # the entry, which the ledger + result replace
                # semantics already make invisible
                with self._mint:
                    self._journal(("deliver", stream, group,
                                   [sid for sid, _ in batch]),
                                  wait=False)
                return batch
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return []
            with self._cond:
                self._cond.wait(remaining)

    def xack(self, stream: str, group: str, *ids: str) -> int:
        if ids:
            # acks commit synchronously: an acked entry must never be
            # redelivered by a recovered broker (the no-duplicate-side-
            # effects half of the contract)
            with self._mint:
                seq = self._journal(("ack", stream, group, list(ids)),
                                    wait=False)
                with self._cond:
                    pend = self._unacked.get((stream, group))
                    if pend:
                        for sid in ids:
                            pend.pop(sid, None)
            self.wal.commit(seq)
            self._maybe_checkpoint()
        return len(ids)

    def _maybe_checkpoint(self) -> None:
        if (self.checkpoint_every_records
                and self._since_ckpt >= self.checkpoint_every_records):
            try:
                self.checkpoint()
            except (Exception, CancelledError):
                # compaction is an optimization; a failed one must not
                # fail the ack that triggered it
                logger.exception("WAL checkpoint failed; continuing")

    def delete_stream(self, stream: str) -> None:
        with self._mint:
            self._journal(("delete_stream", stream), wait=False)
            with self._cond:
                self._streams.pop(stream, None)
                for key in [k for k in self._cursors
                            if k[0] == stream]:
                    del self._cursors[key]
                for key in [k for k in self._unacked
                            if k[0] == stream]:
                    del self._unacked[key]

    def pending(self, stream: str, group: str) -> Dict[str, int]:
        """sid -> delivery count of the (stream, group) ledger (ops
        and the chaos tests read this)."""
        with self._cond:
            pend = self._unacked.get((stream, group), {})
            return {sid: p.deliveries for sid, p in pend.items()}

    # ---- result side (journaled, delegated) -------------------------------
    def hset(self, key: str, mapping: dict) -> None:
        with self._mint:
            seq = self._journal(("hset", key, dict(mapping)),
                                wait=False)
            self.inner.hset(key, mapping)
        self.wal.commit(seq)

    def set_results(self, results: Dict[str, dict]) -> None:
        with self._mint:
            seq = self._journal(
                ("results", {k: dict(v) for k, v in results.items()}),
                wait=False)
            self.inner.set_results(results)
        self.wal.commit(seq)

    def wait_result(self, key: str, timeout: float) -> bool:
        return self.inner.wait_result(key, timeout)

    def hgetall(self, key: str) -> dict:
        return self.inner.hgetall(key)

    def delete(self, key: str) -> None:
        with self._mint:
            self._journal(("delete", key), wait=False)
            self.inner.delete(key)

    def keys(self, pattern: str = "*") -> List[str]:
        return self.inner.keys(pattern)

    # ---- compaction -------------------------------------------------------
    def checkpoint(self) -> int:
        """Compact the log: journal ONE snapshot record carrying the
        whole live state, then GC every segment wholly before it —
        recovery and replication replay stay bounded by the live
        state's size plus the post-snapshot tail, not by total
        requests ever served.  Atomic versus every mutator (all
        journal+mutate under the journal-order lock), so the snapshot
        is exactly the state at its log position."""
        with self._mint:
            with self._cond:
                state = {
                    "streams": {s: list(v)
                                for s, v in self._streams.items()},
                    "cursors": [(k, v)
                                for k, v in self._cursors.items()],
                    "unacked": [(k, [(sid, p.fields, p.deliveries)
                                     for sid, p in pend.items()])
                                for k, pend in self._unacked.items()],
                    "dedup": list(self._dedup.items()),
                    "sid": self._sid,
                    "applied_seq": self._applied_seq,
                }
            state["hashes"] = {k: self.inner.hgetall(k)
                               for k in self.inner.keys("*")}
            seq = self.wal.append(("snapshot", state), wait=False)
            self._since_ckpt = 0
        self.wal.commit(seq)
        removed = self.wal.gc(seq)
        logger.info("WAL checkpoint at seq %d (%d segments GC'd)",
                    seq, removed)
        return seq

    def close(self) -> None:
        self.wal.close()


class BrokerReplica:
    """Warm standby: tails a primary ``DurableBroker`` over the broker
    bridge and keeps a fully materialized copy; ``promote()`` turns the
    copy into the serving primary.

    The tail loop is pull-based (``wal_tail`` from the last applied
    seq), so replication survives primary restarts and transient bridge
    failures without handshakes; the promote-time disk catch-up closes
    the tail gap a dead primary never got to serve over the wire."""

    def __init__(self, primary_address: Tuple[str, int], wal_dir: str,
                 poll_s: float = 0.05, primary_wal_dir: Optional[str] = None,
                 **broker_kw):
        from analytics_zoo_tpu_torch.serving.fleet import RemoteBroker
        self.broker = DurableBroker(wal_dir, recover=True, **broker_kw)
        self.broker.role = "standby"
        self.primary_wal_dir = primary_wal_dir
        self.poll_s = float(poll_s)
        self._primary = RemoteBroker(primary_address)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # promote() arrives over the bridge, one thread per supervisor
        # connection: a retried promote racing a slow first attempt
        # must serialize, or both would run the disk catch-up and
        # double-apply records
        self._promote_lock = threading.Lock()
        self.promoted = False

    def start(self) -> "BrokerReplica":
        self._thread = threading.Thread(target=self._tail_loop,
                                        name="broker-standby-tail",
                                        daemon=True)
        self._thread.start()
        return self

    def _tail_loop(self) -> None:
        while not self._stop.is_set():
            try:
                batch = self._primary.wal_tail(
                    self.broker.applied_seq + 1, 1024)
            except (Exception, CancelledError):
                # primary briefly unreachable (or already dead — the
                # supervisor will promote us): keep polling
                self._stop.wait(self.poll_s)
                continue
            if not batch:
                self._stop.wait(self.poll_s)
                continue
            for seq, rec in batch:
                if self._stop.is_set():
                    # a promote started while this batch was in
                    # flight: stop applying — the catch-up owns the
                    # stream now (apply_replicated's lock backstops
                    # any record already past this check)
                    return
                try:
                    self.broker.apply_replicated(seq, rec)
                except (Exception, CancelledError):
                    # a poisoned record must not kill the tail thread;
                    # the next poll re-pulls from the same seq
                    logger.exception("standby failed applying WAL "
                                     "record %s; will re-pull", seq)
                    break

    def status(self) -> Dict[str, object]:
        return {"applied_seq": self.broker.applied_seq,
                "promoted": self.promoted,
                "role": self.broker.role}

    def applied_seq(self) -> int:
        return self.broker.applied_seq

    def ping(self) -> str:
        return "pong"

    def promote(self, primary_wal_dir: Optional[str] = None) -> int:
        """Take over as primary: stop tailing, catch up the
        unreplicated tail from the dead primary's on-disk WAL, arm
        immediate redelivery of every pending entry.  Returns the
        highest applied primary seq.  Idempotent."""
        chaos.fire("broker_promote")
        with self._promote_lock:
            return self._promote_locked(primary_wal_dir)

    def _promote_locked(self, primary_wal_dir: Optional[str]) -> int:
        if self.promoted:
            return self.broker.applied_seq
        with obs.span("broker.promote",
                      applied_seq=self.broker.applied_seq):
            self._stop.set()
            if self._thread is not None:
                self._thread.join(timeout=10)
            src = primary_wal_dir or self.primary_wal_dir
            caught_up = 0
            if src and os.path.isdir(src):
                for seq, rec in replay_dir(src,
                                           self.broker.applied_seq + 1):
                    self.broker.apply_replicated(seq, rec)
                    caught_up += 1
            # the catch-up records were journaled wait=False: flush
            # them NOW — the records being caught up are acknowledged
            # entries, and this broker is about to be the only copy
            # (kill -9 of the freshly promoted owner must not lose
            # them)
            self.broker.wal.commit()
            self.broker.role = "primary"
            self.broker.arm_redelivery()
            self.promoted = True
        _m_promotions.inc()
        logger.info("standby promoted to primary (caught up %d records "
                    "from disk, applied_seq=%d)", caught_up,
                    self.broker.applied_seq)
        return self.broker.applied_seq

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.broker.close()
