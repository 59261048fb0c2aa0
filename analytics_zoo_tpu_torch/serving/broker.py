"""Stream broker: the Redis command surface Cluster Serving uses.

Port of ``analytics_zoo_tpu/serving/broker.py``: the five stream / hash
commands (XADD, XGROUP CREATE, XREADGROUP, XACK, HSET/HGETALL) plus the
bulk result write, the event-driven result wait and stream deletion, in
three implementations of one surface:

- ``InMemoryBroker``: thread-safe and in-process (tests and single-node
  serving);
- ``NativeQueueBroker``: the same surface over the C++ micro-batching
  queue of ``native/serving_queue.cpp`` (pushes, batch pops and result
  waits outside the GIL);
- ``RedisBroker``: real Redis through redis-py (imported lazily).

Entry fields are an opaque flat dict to every broker (``uri``, ``data``,
``deadline_ts``, ``trace_ctx``, ``dedup_id``, ...), carried verbatim.
Field and result values may be raw ``bytes`` (wire frames): the in-memory
and native brokers carry them as they are; ``RedisBroker`` is the one
place base64 exists, wrapping bytes in ``redis_wire_value`` on write and
unwrapping them in ``redis_unwire_value`` on read, so the string-typed
Redis wire keeps the reference's shape.  ``get_broker`` routes
``redis://``, ``native://``, ``fleet://`` (a ``RemoteBroker`` of a fleet
bridge) and ``memory://``.
"""

from __future__ import annotations

import base64
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

#: Redis parity boundary (the ONLY place base64 touches the binary data
#: plane): bytes values become ``=b64=<base64>`` strings on the Redis
#: wire and convert back on read.  Client-controlled STRING values that
#: happen to start with a sentinel (a hostile uri, say) are escaped with
#: ``=str=`` on write so the round trip is exact for every value —
#: unwire never corrupts or crashes on data it didn't wrap.
_B64_SENTINEL = "=b64="
_STR_SENTINEL = "=str="


def redis_wire_value(v):
    """bytes -> sentinel+base64 str for the string-typed Redis wire;
    sentinel-prefixed strings get the escape prefix; everything else
    passes through."""
    if isinstance(v, (bytes, bytearray, memoryview)):
        return _B64_SENTINEL + base64.b64encode(bytes(v)).decode("ascii")
    if isinstance(v, str) and v.startswith((_B64_SENTINEL, _STR_SENTINEL)):
        return _STR_SENTINEL + v
    return v


def redis_unwire_value(v):
    """Inverse of ``redis_wire_value``: sentinel-wrapped strings inflate
    back to the raw bytes (or the exact string) the client/engine handed
    the broker.  Values this boundary did not wrap pass through — a
    pre-existing Redis value that merely looks like a sentinel can not
    crash the reader."""
    if isinstance(v, str):
        if v.startswith(_STR_SENTINEL):
            return v[len(_STR_SENTINEL):]
        if v.startswith(_B64_SENTINEL):
            try:
                return base64.b64decode(v[len(_B64_SENTINEL):],
                                        validate=True)
            except (ValueError, TypeError):
                return v    # not ours (legacy/foreign data): untouched
    return v


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

    def delete_stream(self, stream: str) -> None:
        """Drop one stream and its group cursors (the LLM engine GCs
        completed token streams through this)."""
        with self._lock:
            self._streams.pop(stream, None)
            for key in [k for k in self._cursors if k[0] == stream]:
                del self._cursors[key]

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


class NativeQueueBroker:
    """The same broker surface over the C++ micro-batching queue
    (``native/serving_queue.cpp``, the role of the reference's
    ``InferenceModel`` BlockingQueue).

    Hot path is native: XADD is a C++ push, XREADGROUP is the queue's
    adaptive batch-pop (wait for the FIRST entry, take everything queued),
    result publish/wait are C++ cv signal/wait — all with the GIL
    released, so client threads and the engine never contend on Python
    locks or 10 ms poll loops.  Result reads are cached host-side after
    the first take (the C++ table hands a completion out once);
    ``wait_result`` gives clients a blocking wait instead of polling."""

    # Read-side cache bound: the C++ table hands each completion out once,
    # so READ results are cached host-side (as raw pickle bytes) for repeat
    # hgetall calls.  Bounded LRU over *read* keys only — a long-running
    # serving process must not grow per-request forever, but UNREAD results
    # are never dropped (their blob still lives in the C++ table until
    # taken).  An evicted key behaves take-once: it was delivered to at
    # least one reader, and later reads see {} like a deleted Redis key.
    READ_CACHE_MAX = 4096

    def __init__(self):
        import ctypes
        import pickle
        from collections import OrderedDict

        from analytics_zoo_tpu_torch import native
        self._ct = ctypes
        self._pickle = pickle
        self._lib = native.load_library()
        self._q = self._lib.zoo_queue_create()
        self._seq = itertools.count(1)
        self._read_cache: "OrderedDict[str, bytes]" = OrderedDict()
        self._result_keys: Dict[str, None] = {}
        self._lock = threading.Lock()

    def close(self) -> None:
        if self._q:
            self._lib.zoo_queue_close(self._q)
            self._lib.zoo_queue_destroy(self._q)
            self._q = None
        # drop the factory singleton so a later get_broker("native://")
        # builds a fresh queue instead of handing out this dead one
        global _native_broker
        with _default_lock:
            if _native_broker is self:
                _native_broker = None

    def _handle(self):
        if not self._q:
            raise RuntimeError("NativeQueueBroker is closed")
        return self._q

    @staticmethod
    def _key_id(key: str) -> int:
        import hashlib
        return int.from_bytes(
            hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")

    #: stable stream -> C++ partition id (same blake2b hash as result
    #: keys): each stream name gets its own partition deque (the fleet
    #: tier's per-replica partitions — ``serving_stream.p0``/``.p1``/...
    #: consume disjoint deques through one native queue), and unrelated
    #: streams (LLM token streams) no longer interleave into one global
    #: deque
    _part_id = _key_id

    # ---- stream side ------------------------------------------------------
    def xadd(self, stream: str, fields: dict) -> str:
        blob = self._pickle.dumps(fields, protocol=4)
        sid = next(self._seq)
        rc = self._lib.zoo_queue_push_part(
            self._handle(), self._part_id(stream), sid,
            (self._ct.c_uint8 * len(blob)).from_buffer_copy(blob),
            len(blob))
        if rc != 0:
            raise RuntimeError("native queue closed")
        return str(sid)

    def xgroup_create(self, stream: str, group: str) -> None:
        pass  # single implicit group: the partition IS the pending list

    def xreadgroup(self, stream, group, consumer, count=16, block_ms=100):
        ct = self._ct
        ids = (ct.c_uint64 * count)()
        sizes = (ct.c_int64 * count)()
        n = self._lib.zoo_queue_pop_batch_part(
            self._handle(), self._part_id(stream), count, block_ms, ids,
            sizes)
        if n <= 0:
            return []
        out = []
        for k in range(n):
            buf = (ct.c_uint8 * sizes[k])()
            got = self._lib.zoo_queue_fetch(self._handle(), ids[k], buf, sizes[k])
            if got != sizes[k]:
                continue
            out.append((str(ids[k]), self._pickle.loads(bytes(buf))))
        return out

    def xack(self, stream, group, *ids) -> int:
        return len(ids)  # pop_batch already removed them

    def delete_stream(self, stream: str) -> None:
        """Drop one stream's pending entries (token-stream GC parity
        with ``InMemoryBroker.delete_stream``)."""
        self._lib.zoo_queue_drop_part(self._handle(),
                                      self._part_id(stream))

    # ---- result side ------------------------------------------------------
    def _publish(self, key: str, mapping: dict) -> None:
        blob = self._pickle.dumps(dict(mapping), protocol=4)
        self._lib.zoo_queue_complete(
            self._handle(), self._key_id(key),
            (self._ct.c_uint8 * len(blob)).from_buffer_copy(blob),
            len(blob))
        with self._lock:
            self._read_cache.pop(key, None)
            # _result_keys must retain every UNREAD result (dropping one
            # would lose delivered data and orphan its C++ blob); read
            # keys leave it when their cache entry is evicted or deleted,
            # so it is bounded in the steady state where results get read
            self._result_keys[key] = None

    def hset(self, key: str, mapping: dict) -> None:
        merged = self.hgetall(key)
        merged.update(mapping)
        self._publish(key, merged)

    def set_results(self, results: Dict[str, dict]) -> None:
        for key, mapping in results.items():
            self._publish(key, mapping)

    def _take_raw(self, key: str):
        """Destructive take of the raw pickle blob (no deserialization)."""
        ct = self._ct
        kid = self._key_id(key)
        size = self._lib.zoo_queue_wait(self._handle(), kid, 0)
        if size <= 0:
            return None
        buf = (ct.c_uint8 * size)()
        got = self._lib.zoo_queue_take(self._handle(), kid, buf, size)
        if got != size:
            return None
        return bytes(buf)

    def hgetall(self, key: str) -> dict:
        # The C++ take is DESTRUCTIVE (the table hands a completion out
        # once), so check-cache + take + cache-fill must be one atomic
        # section: two concurrent readers that both miss would otherwise
        # race the take and the loser would observe a delivered result as
        # missing.  The critical section is memcpy-only — the (potentially
        # multi-MB) pickle.loads happens OUTSIDE the lock so concurrent
        # readers of different keys don't serialize on deserialization.
        with self._lock:
            blob = self._read_cache.get(key)
            if blob is not None:
                self._read_cache.move_to_end(key)
            else:
                blob = self._take_raw(key)
                if blob is None:
                    return {}
                self._read_cache[key] = blob
                while len(self._read_cache) > self.READ_CACHE_MAX:
                    old, _ = self._read_cache.popitem(last=False)
                    self._result_keys.pop(old, None)
        return self._pickle.loads(blob)

    def wait_result(self, key: str, timeout: float) -> bool:
        """Block (GIL released, C++ cv) until a result exists."""
        with self._lock:
            if key in self._read_cache:
                return True
        return self._lib.zoo_queue_wait(
            self._handle(), self._key_id(key), int(timeout * 1000)) > 0

    def delete(self, key: str) -> None:
        with self._lock:
            self._take_raw(key)
            self._read_cache.pop(key, None)
            self._result_keys.pop(key, None)

    def keys(self, pattern: str = "*") -> List[str]:
        prefix = pattern.rstrip("*")
        with self._lock:
            known = list(self._result_keys)
        return [k for k in known if k.startswith(prefix)]


class RedisBroker:
    """Thin adapter exposing the same surface over redis-py.  The
    Redis-parity boundary of the binary data plane: bytes values are
    base64-wrapped HERE (``redis_wire_value``) and nowhere else, so
    clients and the engine exchange raw frames while the Redis wire
    stays reference-shaped strings."""

    def __init__(self, url: str = "redis://localhost:6379"):
        import redis  # lazy: optional dependency
        self._r = redis.Redis.from_url(url)

    def xadd(self, stream, fields):
        return self._r.xadd(
            stream, {k: redis_wire_value(v)
                     for k, v in fields.items()}).decode()

    def xgroup_create(self, stream, group):
        try:
            self._r.xgroup_create(stream, group, id="0", mkstream=True)
        except Exception:
            pass  # BUSYGROUP: already exists

    def xreadgroup(self, stream, group, consumer, count=16, block_ms=100):
        resp = self._r.xreadgroup(group, consumer, {stream: ">"},
                                  count=count, block=block_ms)
        out = []
        for _, entries in resp or []:
            for sid, fields in entries:
                out.append((sid.decode(),
                            {k.decode():
                             redis_unwire_value(v.decode())
                             if isinstance(v, bytes) else v
                             for k, v in fields.items()}))
        return out

    def xack(self, stream, group, *ids):
        return self._r.xack(stream, group, *ids)

    def hset(self, key, mapping):
        self._r.hset(key, mapping={k: redis_wire_value(v)
                                   for k, v in mapping.items()})

    def set_results(self, results):
        """Bulk replace via one pipeline round-trip (DEL+HSET per key)."""
        pipe = self._r.pipeline(transaction=False)
        for key, mapping in results.items():
            pipe.delete(key)
            pipe.hset(key, mapping={k: redis_wire_value(v)
                                    for k, v in mapping.items()})
        pipe.execute()

    def hgetall(self, key):
        return {k.decode(): redis_unwire_value(v.decode())
                for k, v in self._r.hgetall(key).items()}

    def delete(self, key):
        self._r.delete(key)

    def keys(self, pattern="*"):
        return [k.decode() for k in self._r.keys(pattern)]


_default_lock = threading.Lock()
_default_broker: Optional[InMemoryBroker] = None
_native_broker: Optional[NativeQueueBroker] = None


def get_broker(url: Optional[str] = None):
    """Broker factory: ``redis://...`` gives a ``RedisBroker``,
    ``native://...`` the process-local ``NativeQueueBroker`` singleton,
    ``fleet://host:port`` a ``RemoteBroker`` of that fleet bridge, and
    ``memory://...`` or ``None`` the process-local ``InMemoryBroker``
    singleton."""
    global _default_broker, _native_broker
    if url and url.startswith("redis://"):
        return RedisBroker(url)
    if url and url.startswith("fleet://"):
        from analytics_zoo_tpu_torch.serving.fleet import RemoteBroker
        host, _, port = url[len("fleet://"):].partition(":")
        return RemoteBroker((host or "127.0.0.1", int(port)))
    with _default_lock:
        if url and url.startswith("native://"):
            if _native_broker is None:
                _native_broker = NativeQueueBroker()
            return _native_broker
        if _default_broker is None:
            _default_broker = InMemoryBroker()
        return _default_broker
