"""Stream broker: the Redis command surface Cluster Serving uses.

Port of ``InMemoryBroker`` and ``get_broker`` from
``analytics_zoo_tpu/serving/broker.py``: an in-process, thread-safe
implementation of the five stream / hash commands (XADD, XGROUP CREATE,
XREADGROUP, XACK, HSET/HGETALL) plus the bulk result write and the
event-driven result wait.  Field and result values may be raw ``bytes``
(wire frames) and are carried verbatim.  The Redis, native-queue and fleet
brokers are not ported yet.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

_BROKER_SLICE = ("not ported yet (ROADMAP Queue 1: pipelined serving and "
                 "the HTTP frontend, with the Redis / native / fleet "
                 "brokers)")


class InMemoryBroker:
    """Redis-stream semantics subset: one consumer group, pending tracking."""

    def __init__(self):
        # streams are append-only LISTS of (sid, fields): xreadgroup
        # slices [cursor:cursor+count] in O(count) — materializing the
        # whole stream per read (the obvious OrderedDict approach) is
        # O(total) per call and turns a busy stream quadratic
        self._streams: Dict[str, List[Tuple[str, dict]]] = {}
        self._cursors: Dict[Tuple[str, str], int] = {}
        self._hashes: Dict[str, Dict[str, str]] = {}
        # TWO conditions, one per data plane: stream waiters (the engine
        # readers) park on _lock, result waiters (wait_result — every
        # HTTP handler thread under load) park on _rcond.  With one
        # shared condition every client xadd would notify_all the whole
        # result-waiter herd (hundreds of threads re-checking per write
        # at saturation) — more scheduler work than the poll loop the
        # event-driven wait replaced.
        self._lock = threading.Condition()
        self._rcond = threading.Condition()
        self._seq = itertools.count()

    # ---- stream side ------------------------------------------------------
    def xadd(self, stream: str, fields: dict) -> str:
        with self._lock:
            sid = f"{int(time.time() * 1000)}-{next(self._seq)}"
            self._streams.setdefault(stream, []).append((sid, dict(fields)))
            self._lock.notify_all()
            return sid

    def xgroup_create(self, stream: str, group: str) -> None:
        with self._lock:
            self._streams.setdefault(stream, [])
            self._cursors.setdefault((stream, group), 0)

    def xreadgroup(self, stream: str, group: str, consumer: str,
                   count: int = 16, block_ms: int = 100
                   ) -> List[Tuple[str, dict]]:
        deadline = time.monotonic() + block_ms / 1000.0
        with self._lock:
            self._cursors.setdefault((stream, group), 0)
            while True:
                entries = self._streams.get(stream, [])
                cur = self._cursors[(stream, group)]
                batch = entries[cur:cur + count]
                if batch:
                    self._cursors[(stream, group)] = cur + len(batch)
                    return batch
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._lock.wait(timeout=remaining)

    def xack(self, stream: str, group: str, *ids: str) -> int:
        return len(ids)  # at-least-once; cursor already advanced

    # ---- hash side (result plane: guarded by _rcond) ----------------------
    def hset(self, key: str, mapping: dict) -> None:
        with self._rcond:
            self._hashes.setdefault(key, {}).update(mapping)
            self._rcond.notify_all()

    def set_results(self, results: Dict[str, dict]) -> None:
        """Bulk REPLACE of result hashes in one lock section — the sink's
        hot path (per-key delete+hset would take 2 lock round-trips per
        request).  One notify_all per BULK write wakes the
        ``wait_result`` waiters (event-driven result delivery for the
        HTTP frontend and ``query_blocking`` — no 10 ms poll loops)."""
        with self._rcond:
            for key, mapping in results.items():
                self._hashes[key] = dict(mapping)
            self._rcond.notify_all()

    def wait_result(self, key: str, timeout: float) -> bool:
        """Block on the result condition variable until ``key`` exists
        (a result or error hash was written) or ``timeout`` elapses.
        The event-driven replacement for the client/frontend poll loop:
        a waiter wakes on the very write that publishes its result."""
        deadline = time.monotonic() + max(0.0, timeout)
        with self._rcond:
            while key not in self._hashes:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._rcond.wait(remaining)
            return True

    def hgetall(self, key: str) -> dict:
        with self._rcond:
            return dict(self._hashes.get(key, {}))

    def delete(self, key: str) -> None:
        with self._rcond:
            self._hashes.pop(key, None)

    def keys(self, pattern: str = "*") -> List[str]:
        with self._rcond:
            prefix = pattern.rstrip("*")
            return [k for k in self._hashes if k.startswith(prefix)]


_default_lock = threading.Lock()
_default_broker: Optional[InMemoryBroker] = None


def get_broker(url: Optional[str] = None) -> InMemoryBroker:
    """Broker factory: ``None`` or ``memory://...`` gives the
    process-local ``InMemoryBroker`` singleton; ``redis://``,
    ``native://`` and ``fleet://`` raise ``NotImplementedError``."""
    if url and not url.startswith("memory"):
        raise NotImplementedError(f"broker {url!r} is {_BROKER_SLICE}; "
                                  "use memory:// or pass broker=")
    global _default_broker
    with _default_lock:
        if _default_broker is None:
            _default_broker = InMemoryBroker()
        return _default_broker
