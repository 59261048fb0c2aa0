"""Segment-based write-ahead log: the shared WAL core.

Port of ``analytics_zoo_tpu/common/wal.py`` with the same on-disk format:
a log that either package wrote replays in the other.

The write-ahead *discipline* started life inside the streaming plane's
``PaneJournal`` (journal-before-publish, ); this module
extracts the durable half into one reusable core so the request plane's
``DurableBroker`` (serving/durability.py) and the pane journal's
durable mode speak the same on-disk format:

- **Record framing**: ``u32 magic | u32 payload_len | u32 crc32 |
  u64 seq | payload`` (little-endian, payload = pickle protocol 4).
  The CRC covers the payload only; seq is the appender's monotone
  sequence number, so a tail replica can ask for "everything after N".
- **Segments**: records append to ``wal-<first_seq:020d>.log``; a
  segment past ``segment_bytes`` rolls to a new file, so recovery
  never re-reads an unbounded single file and retired prefixes can be
  GC'd by seq.
- **Group commit**: appenders write under one lock and then join a
  leader/follower flush — the first waiter becomes the leader, lingers
  ``commit_interval_ms`` so concurrent appends pile into ONE flush
  (and ONE fsync when ``sync=True``), and wakes everyone whose record
  the flush covered.  An ``append(wait=True)`` return therefore means
  the record is on its way to disk — the acknowledged-at-client
  durability point.
- **Torn-record recovery**: a crash mid-append leaves a truncated (or
  CRC-broken) final record.  ``replay`` NEVER unpickles garbage and
  never aborts: the torn tail is skipped with a loud counter
  (``zoo_broker_wal_torn_records_total``) and everything before it is
  recovered intact — proven by truncating a real log at every byte
  offset of its last record (tests/test_durability.py).

``sync=False`` (the default) flushes to the OS page cache per group
commit: state survives ``kill -9`` of the process (the chaos bar), not
host power loss; ``sync=True`` adds the fsync for the latter.
"""

from __future__ import annotations

import os
import pickle
import struct
import threading
import time
import zlib
from typing import Iterator, List, Optional, Tuple

from analytics_zoo_tpu_torch import observability as obs

_m_torn = obs.lazy_counter(
    "zoo_broker_wal_torn_records_total",
    "truncated/CRC-broken trailing WAL records skipped at replay")
_m_records = obs.lazy_counter(
    "zoo_broker_wal_records_total", "records appended to the WAL")

#: record header: magic, payload length, payload crc32, sequence number
_MAGIC = 0x57414C5A          # "WALZ"
_HDR = struct.Struct("<IIIQ")

_SEG_PREFIX = "wal-"
_SEG_SUFFIX = ".log"


def _segment_name(first_seq: int) -> str:
    return f"{_SEG_PREFIX}{first_seq:020d}{_SEG_SUFFIX}"


def _segment_first_seq(name: str) -> Optional[int]:
    if not (name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX)):
        return None
    try:
        return int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])
    except ValueError:
        return None


def list_segments(wal_dir: str) -> List[Tuple[int, str]]:
    """``(first_seq, path)`` of every segment, in seq order."""
    out = []
    try:
        names = os.listdir(wal_dir)
    except FileNotFoundError:
        return out
    for name in names:
        first = _segment_first_seq(name)
        if first is not None:
            out.append((first, os.path.join(wal_dir, name)))
    out.sort()
    return out


def _intact_prefix_len(path: str) -> int:
    """Byte length of the segment's intact-record prefix (everything
    before a torn/corrupt tail)."""
    with open(path, "rb") as fh:
        blob = fh.read()
    off, n = 0, len(blob)
    while off < n:
        if off + _HDR.size > n:
            return off
        magic, length, crc, _seq = _HDR.unpack_from(blob, off)
        body_at = off + _HDR.size
        if magic != _MAGIC or body_at + length > n:
            return off
        if zlib.crc32(blob[body_at:body_at + length]) != crc:
            return off
        off = body_at + length
    return off


def _read_segment(path: str, from_seq: int, count_torn: bool = True
                  ) -> Iterator[Tuple[int, object]]:
    """Yield ``(seq, record)`` from one segment; a torn/corrupt TAIL
    stops the segment with the loud counter instead of unpickling
    garbage or raising (the kill-9-mid-append contract).
    ``count_torn=False`` is for LIVE tail reads, where a partial
    record is just the writer's buffer mid-flush — counting those
    would bury the real crash signal in phantoms."""
    with open(path, "rb") as fh:
        blob = fh.read()
    off, n = 0, len(blob)
    while off < n:
        if off + _HDR.size > n:
            if count_torn:
                _m_torn.inc()
            return
        magic, length, crc, seq = _HDR.unpack_from(blob, off)
        body_at = off + _HDR.size
        if magic != _MAGIC or body_at + length > n:
            if count_torn:
                _m_torn.inc()
            return
        payload = blob[body_at:body_at + length]
        if zlib.crc32(payload) != crc:
            if count_torn:
                _m_torn.inc()
            return
        off = body_at + length
        if seq < from_seq:
            continue
        yield seq, pickle.loads(payload)


def _segments_from(wal_dir: str, from_seq: int) -> List[Tuple[int, str]]:
    """Segments that can contain records >= ``from_seq``: every
    segment whose SUCCESSOR starts at or below ``from_seq`` holds only
    earlier records and is skipped — a tail poll costs the live
    segment(s), not the whole log."""
    segs = list_segments(wal_dir)
    keep = []
    for i, (first, path) in enumerate(segs):
        if i + 1 < len(segs) and segs[i + 1][0] <= from_seq:
            continue
        keep.append((first, path))
    return keep


class WriteAheadLog:
    """One append-only, segment-rolled, group-committed log directory.

    Thread-safe.  ``append`` returns the record's seq; with
    ``wait=True`` (the default) it returns only after the record's
    group flush — the durability point.  ``wait=False`` is for records
    whose loss is recoverable by design (delivery bookkeeping: a lost
    deliver record merely re-delivers, and the dedup barrier makes
    that invisible)."""

    def __init__(self, wal_dir: str, segment_bytes: int = 4 << 20,
                 commit_interval_ms: float = 0.0, sync: bool = False):
        self.dir = wal_dir
        self.segment_bytes = int(segment_bytes)
        self.commit_interval_s = max(float(commit_interval_ms), 0.0) / 1e3
        self.sync = bool(sync)
        os.makedirs(wal_dir, exist_ok=True)
        last_seq = 0
        for seq, _rec in self.replay(0):
            last_seq = max(last_seq, seq)
        self._next_seq = last_seq + 1
        # appends start a FRESH segment after recovery: the old tail
        # may end in a torn record, and appending after it would hide
        # every later record behind the tear at the next replay
        self._wlock = threading.Lock()
        self._fh = None
        self._fh_bytes = 0
        self._written_seq = last_seq
        # group-commit state
        self._fcond = threading.Condition()
        self._flushed_seq = last_seq
        self._flushing = False
        self._closed = False

    # ---- append side ------------------------------------------------------
    def _roll_locked(self, first_seq: int) -> None:
        if self._fh is not None:
            self._fh.flush()
            if self.sync:
                # sync mode fsyncs the RETIRING segment too: the group
                # commit only fsyncs the current fh, so records at the
                # tail of a rolled segment would otherwise be
                # acknowledged without ever being fsynced
                os.fsync(self._fh.fileno())
            self._fh.close()
        path = os.path.join(self.dir, _segment_name(first_seq))
        if os.path.exists(path):
            # re-opening a segment that ends in a torn record (a crash
            # whose torn tail was that segment's FIRST record gives the
            # restart the same first_seq): drop the torn bytes so new
            # records are not hidden behind the tear
            keep = _intact_prefix_len(path)
            with open(path, "rb+") as fh:
                fh.truncate(keep)
        self._fh = open(path, "ab")
        self._fh_bytes = self._fh.tell()

    def append(self, record, wait: bool = True) -> int:
        payload = pickle.dumps(record, protocol=4)
        with self._wlock:
            if self._closed:
                raise RuntimeError("WAL is closed")
            seq = self._next_seq
            self._next_seq += 1
            if self._fh is None or self._fh_bytes >= self.segment_bytes:
                self._roll_locked(seq)
            self._fh.write(_HDR.pack(_MAGIC, len(payload),
                                     zlib.crc32(payload), seq) + payload)
            self._fh_bytes += _HDR.size + len(payload)
            self._written_seq = seq
        _m_records.inc()
        if wait:
            self.commit(seq)
        return seq

    def commit(self, seq: Optional[int] = None) -> None:
        """Block until every record up to ``seq`` (default: all written
        so far) is flushed.  Leader/follower group commit: one flush
        covers every record written before it ran."""
        if seq is None:
            with self._wlock:
                seq = self._written_seq
        while True:
            with self._fcond:
                if self._flushed_seq >= seq or self._closed:
                    return
                if self._flushing:
                    # follower: wait for the in-flight flush, re-check
                    self._fcond.wait(0.5)
                    continue
                self._flushing = True
            target = seq
            flushed = False
            try:
                # leader: linger so concurrent appenders pile into this
                # one flush (amortizing the fsync when sync=True)
                if self.commit_interval_s:
                    time.sleep(self.commit_interval_s)
                with self._wlock:
                    target = self._written_seq
                    if self._fh is not None:
                        self._fh.flush()
                        if self.sync:
                            os.fsync(self._fh.fileno())
                flushed = True
            finally:
                with self._fcond:
                    if flushed:
                        # ONLY a successful flush advances the mark: a
                        # failed flush (ENOSPC/EIO) must not let a
                        # follower acknowledge a record that never
                        # reached disk — the follower re-checks, takes
                        # leadership, and retries (or raises to ITS
                        # caller)
                        self._flushed_seq = max(self._flushed_seq,
                                                target)
                    self._flushing = False
                    self._fcond.notify_all()

    @property
    def next_seq(self) -> int:
        with self._wlock:
            return self._next_seq

    # ---- replay side ------------------------------------------------------
    def replay(self, from_seq: int = 0, count_torn: bool = True
               ) -> Iterator[Tuple[int, object]]:
        """``(seq, record)`` for every intact record with
        ``seq >= from_seq``, across segments in order — segments
        wholly below ``from_seq`` are skipped by name, so a tail read
        near the head costs the live segment, not the whole log.  Only
        FLUSHED records are visible (tail readers see the durable
        prefix)."""
        for _first, path in _segments_from(self.dir, from_seq):
            yield from _read_segment(path, from_seq, count_torn)

    def tail(self, from_seq: int, limit: int = 1024
             ) -> List[Tuple[int, object]]:
        """Bounded replay slice for the replication wire
        (``DurableBroker.wal_tail`` proxies this over the broker
        bridge).  A partial record at the on-disk tail here is the
        writer's buffer mid-flush, not a crash — it is skipped
        silently, never counted as torn."""
        out = []
        for seq, rec in self.replay(from_seq, count_torn=False):
            out.append((seq, rec))
            if len(out) >= limit:
                break
        return out

    def gc(self, keep_from_seq: int) -> int:
        """Delete segments holding ONLY records below ``keep_from_seq``
        (the caller has checkpointed that prefix — see
        ``DurableBroker.checkpoint``).  The active segment is never
        deleted.  Returns the number of segments removed."""
        with self._wlock:
            current = self._fh.name if self._fh is not None else None
            keep = {path for _f, path
                    in _segments_from(self.dir, keep_from_seq)}
            removed = 0
            for _first, path in list_segments(self.dir):
                if path in keep or path == current:
                    continue
                try:
                    os.remove(path)
                    removed += 1
                except OSError:
                    pass    # a missing file is already gone
            return removed

    def close(self) -> None:
        self.commit()
        with self._wlock:
            self._closed = True
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None
