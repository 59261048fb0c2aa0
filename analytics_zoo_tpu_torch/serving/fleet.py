"""Multi-process serving fleet.

Port of ``analytics_zoo_tpu/serving/fleet.py``: the same bridge wire
(length-prefixed pickle frames, so a port process and a JAX process talk
to each other), routing, merge rules and autoscale decisions.  The
supervisor forks, so ``model_factory`` may be a closure; it must start
before anything initialises CUDA in its process (a forked child cannot
use a card its parent initialised), and each replica builds its model on
the card after the fork.

The single-process serving path is fast per connection (binary wire,
coalescing, TCP_NODELAY), but ONE Python process still parses every
frame and runs every handler thread — the GIL is the ceiling,
and a saturation sweep collapses past the knee.  This module
shards the front door across processes, the way the reference's Cluster
Serving was cluster-scale by design (Redis hub + distributed Flink
engines, SURVEY §1 L7):

- ``BrokerBridge`` / ``RemoteBroker`` — the broker surface served over
  a localhost socket from the ONE process that owns the real broker
  (in-memory or the C++ native queue), so every worker and replica
  process shares one request/result plane.  Entry fields (``uri``,
  ``data``, ``deadline_ts``, ``trace_ctx``, ``batch``) pass through as
  opaque pickled values — deadlines, trace ids and admission credits
  ride the wire UNCHANGED across the process boundary.
- partition helpers — consistent ``uri -> partition`` routing onto
  per-replica streams (``<stream>.p<k>``); a request's result always
  lands on ``result:<uri>``, which only the frontend worker that owns
  the connection waits on, so responses come back to the right process
  by construction.
- ``FleetRouter`` — per-partition circuit breakers (a replica that
  stops answering is ejected and probed back; routing diverts to
  healthy partitions instead of failing the request) plus the engine's
  overload latch lifted into the routing path: a partition that shed
  is routed around for a short window, and when EVERY healthy partition
  is latched the frontend sheds immediately without a broker round
  trip — post-knee goodput comes from rejecting cheaply at the front
  door.
- ``FleetPublisher`` + ``merge_snapshots`` — cross-process metrics
  aggregation: every process pushes its registry snapshot (and recent
  span ring) to the bridge; ``GET /metrics`` on ANY worker renders the
  merged fleet-wide series and ``/spans?trace_id=`` returns one
  request's span chain across the client -> frontend worker -> broker
  partition -> engine replica hop.
- ``ReplicaAutoscaler`` — deterministic (injectable clock) scale
  decision logic with hysteresis, sustain windows, cooldown and a
  max-replica cap, fed by the Prometheus queue-depth/high-water series
  from the replica snapshots.
- ``FleetSupervisor`` — owns the broker + bridge, forks N frontend
  worker processes (SO_REUSEPORT on one port) and M engine replica
  processes, and runs the autoscale loop.
"""

from __future__ import annotations

import hashlib
import logging
import math
import os
import pickle
import signal
import socket
import struct
import threading
import time
from concurrent.futures import CancelledError
from typing import Callable, Dict, List, Optional, Tuple

from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common.config import FleetConfig, ServingConfig
from analytics_zoo_tpu_torch.common.resilience import CircuitBreaker

logger = logging.getLogger("analytics_zoo_tpu_torch.serving")

__all__ = [
    "BrokerBridge", "FleetPublisher", "FleetRouter", "FleetSupervisor",
    "RemoteBroker", "ReplicaAutoscaler", "merge_snapshots",
    "partition_for", "partition_stream",
]

# fleet-wide series (metric catalog)
_m_routed = obs.lazy_counter(
    "zoo_fleet_routed_total",
    "requests routed to an engine partition", ["partition"])
_m_diverted = obs.lazy_counter(
    "zoo_fleet_diverted_total",
    "requests routed AWAY from their home partition (breaker open or "
    "overload latch)", ["partition"])
_m_fastshed = obs.lazy_counter(
    "zoo_fleet_frontdoor_shed_total",
    "requests shed at the frontend because every healthy partition's "
    "overload latch was set (no broker round trip paid)")
_m_snapshots = obs.lazy_counter(
    "zoo_fleet_snapshot_publish_total",
    "per-process registry/span snapshots published to the bridge")
_m_active = obs.lazy_gauge(
    "zoo_fleet_active_replicas",
    "engine replica partitions currently routed to")
_m_autoscale = obs.lazy_counter(
    "zoo_fleet_autoscale_total",
    "autoscaler replica-count changes", ["direction"])
_m_workers = obs.lazy_gauge(
    "zoo_fleet_workers", "frontend worker processes in the fleet")
_m_failovers = obs.lazy_counter(
    "zoo_fleet_broker_failovers_total",
    "broker-owner deaths that triggered a standby promotion "
    "()")


# ---- consistent partition routing -----------------------------------------

def partition_for(uri: str, n: int) -> int:
    """Stable ``uri -> partition`` in ``[0, n)`` — identical in every
    process (hashlib, not ``hash()``: PYTHONHASHSEED must not split the
    routing between workers)."""
    if n <= 1:
        return 0
    digest = hashlib.blake2b(uri.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big") % n


def partition_stream(stream: str, k: int) -> str:
    """The broker stream replica ``k`` consumes (``serving_stream.p0``,
    ``serving_stream.p1``, ...)."""
    return f"{stream}.p{k}"


# ---- broker bridge (the cross-process request/result plane) ---------------

#: broker methods the bridge will proxy (a closed surface: the socket
#: carries method NAMES, never arbitrary callables).  The durability
#: names dispatch to None on brokers without
#: them: ``wal_tail`` feeds the warm standby's replication pull,
#: ``pending`` exposes the pending-entry ledger, and ``promote`` /
#: ``status`` / ``applied_seq`` are the supervisor's control calls on
#: a standby's ``BrokerReplica``.
_BRIDGE_METHODS = frozenset((
    "xadd", "xgroup_create", "xreadgroup", "xack", "hset", "set_results",
    "wait_result", "hgetall", "delete", "keys", "delete_stream",
    "wal_tail", "pending", "promote", "status", "applied_seq",
))


def _send_msg(sock: socket.socket, obj) -> None:
    blob = pickle.dumps(obj, protocol=4)
    sock.sendall(struct.pack("<I", len(blob)) + blob)


def _recv_msg(sock: socket.socket):
    hdr = _recv_exact(sock, 4)
    (n,) = struct.unpack("<I", hdr)
    return pickle.loads(_recv_exact(sock, n))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    parts = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            raise ConnectionError("bridge connection closed")
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


class BrokerBridge:
    """Serves one in-process broker's surface over a localhost socket.

    Runs in the process that OWNS the broker (the fleet supervisor):
    one accept thread, one thread per client connection, length-prefixed
    pickle request/response frames.  Per-op work is dict lookups and
    condition waits — the frame parsing, numpy work and HTTP handling
    that bound the single-process path stay in the worker processes, so
    the hub's GIL carries an order of magnitude less per request than a
    frontend's (the same division of labor as the reference's Redis
    hub).  Beyond the broker surface the bridge carries two fleet
    channels:

    - snapshots: ``snap_put(name, blob)`` / ``snap_all()`` — opaque
      per-process registry/span blobs for fleet-wide ``/metrics`` and
      ``/spans`` (blobs are NOT unpickled server-side);
    - control kv: ``ctl_set(key, value)`` / ``ctl_get(key)`` /
      ``ctl_all()`` — the active-partition count and readiness flags.

    ``wait_hgetall(key, timeout)`` is the combined result wait + read
    (one round trip on the hot result path instead of two).
    """

    def __init__(self, broker, host: str = "127.0.0.1", port: int = 0):
        self.broker = broker
        self._host = host
        self._port = port
        self._listener: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        self._snaps: Dict[str, Tuple[bytes, float]] = {}
        self._ctl: Dict[str, object] = {}

    @property
    def address(self) -> Tuple[str, int]:
        if self._listener is None:
            raise RuntimeError("bridge not started")
        return self._listener.getsockname()[:2]

    def start(self) -> "BrokerBridge":
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self._host, self._port))
        self._listener.listen(256)
        t = threading.Thread(target=self._accept_loop,
                             name="fleet-bridge-accept", daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except (Exception, CancelledError):
                if self._stop.is_set():
                    return
                time.sleep(0.05)
                continue
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="fleet-bridge-conn", daemon=True)
            t.start()
            # prune finished connection threads as new ones arrive: a
            # long-lived fleet churns client connections, and the list
            # must stay bounded by LIVE connections
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    method, args = _recv_msg(conn)
                except (ConnectionError, EOFError, OSError):
                    return
                # per-op guard: one bad request answers an error frame;
                # the connection (and the bridge) lives on.  Cancellation
                # included — a CancelledError escaping a broker op must
                # not kill the serving thread (the cancellation contract).
                try:
                    _send_msg(conn, (0, self._dispatch(method, args)))
                except (Exception, CancelledError) as exc:
                    try:
                        _send_msg(conn, (1, f"{type(exc).__name__}: {exc}"))
                    except (Exception, CancelledError):
                        return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, method: str, args: tuple):
        if method == "ping":
            return "pong"
        if method == "snap_put":
            name, blob = args
            with self._lock:
                self._snaps[name] = (blob, time.time())
            return True
        if method == "snap_all":
            with self._lock:
                return dict(self._snaps)
        if method == "ctl_set":
            key, value = args
            with self._lock:
                self._ctl[key] = value
            return True
        if method == "ctl_get":
            with self._lock:
                return self._ctl.get(args[0])
        if method == "ctl_all":
            with self._lock:
                return dict(self._ctl)
        if method == "wait_hgetall":
            key, timeout = args
            wait = getattr(self.broker, "wait_result", None)
            if wait is not None:
                if not wait(key, timeout):
                    return {}
            else:
                # broker without an event-driven wait (RedisBroker):
                # bounded poll HERE — returning the instant hgetall
                # would turn every fleet request into an immediate 504
                deadline = time.monotonic() + max(0.0, float(timeout))
                while not self.broker.hgetall(key):
                    if time.monotonic() >= deadline:
                        return {}
                    time.sleep(0.01)
            return self.broker.hgetall(key)
        if method not in _BRIDGE_METHODS:
            raise ValueError(f"bridge does not proxy {method!r}")
        fn = getattr(self.broker, method, None)
        if fn is None:       # e.g. delete_stream on a broker without it
            return None
        return fn(*args)

    # local-process conveniences (the supervisor calls these in-process;
    # snap_put also lets the supervisor's own FleetPublisher publish
    # through the bridge object directly — autoscale/worker-count
    # series must reach the fleet-wide /metrics merge like any other
    # process's)
    def snap_put(self, name: str, blob: bytes) -> None:
        with self._lock:
            self._snaps[name] = (blob, time.time())

    def snap_all(self) -> Dict[str, Tuple[bytes, float]]:
        with self._lock:
            return dict(self._snaps)

    def ctl_set(self, key: str, value) -> None:
        with self._lock:
            self._ctl[key] = value

    def ctl_get(self, key: str):
        with self._lock:
            return self._ctl.get(key)

    def stop(self) -> None:
        self._stop.set()
        if self._listener is not None:
            # shutdown wakes the accept thread blocked in accept(), which
            # close alone leaves waiting out its join timeout
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        # connection threads exit on their next recv (client gone or
        # stop flag); daemon threads, bounded join
        for t in self._threads:
            t.join(timeout=2)


class RemoteBroker:
    """The broker surface over a ``BrokerBridge`` socket — what every
    worker/replica process uses as its broker.  One socket per calling
    THREAD (requests are synchronous request/response; handler threads
    must not serialize on one connection), lazily connected.  Carries
    values verbatim (bytes wire frames included), so the binary data
    plane crosses the process boundary with zero re-encoding."""

    def __init__(self, address: Tuple[str, int],
                 connect_timeout: float = 10.0):
        self.address = (address[0], int(address[1]))
        self._connect_timeout = float(connect_timeout)
        self._local = threading.local()

    def _sock(self) -> socket.socket:
        sock = getattr(self._local, "sock", None)
        if sock is None:
            sock = socket.create_connection(
                self.address, timeout=self._connect_timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.sock = sock
        return sock

    def close(self) -> None:
        sock = getattr(self._local, "sock", None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
            self._local.sock = None

    def _call(self, method: str, *args, timeout: float = 30.0):
        sock = self._sock()
        # generous margin over the op's own wait so a server-side block
        # (xreadgroup block_ms, wait_result timeout) never trips the
        # socket timeout first
        sock.settimeout(max(30.0, float(timeout) + 15.0))
        try:
            _send_msg(sock, (method, args))
            status, value = _recv_msg(sock)
        except (OSError, EOFError) as exc:
            # drop the broken connection: the NEXT call reconnects.
            # Callers treat this as a transient broker error (the engine
            # reader retries; InputQueue's RetryPolicy backs off).
            self.close()
            raise ConnectionError(f"fleet bridge call {method} failed: "
                                  f"{exc}") from exc
        if status != 0:
            raise RuntimeError(f"fleet bridge {method}: {value}")
        return value

    # ---- broker surface ---------------------------------------------------
    def xadd(self, stream, fields):
        return self._call("xadd", stream, dict(fields))

    def xgroup_create(self, stream, group):
        return self._call("xgroup_create", stream, group)

    def xreadgroup(self, stream, group, consumer, count=16, block_ms=100):
        return self._call("xreadgroup", stream, group, consumer, count,
                          block_ms, timeout=block_ms / 1e3)

    def xack(self, stream, group, *ids):
        return self._call("xack", stream, group, *ids)

    def hset(self, key, mapping):
        return self._call("hset", key, dict(mapping))

    def set_results(self, results):
        return self._call("set_results", dict(results))

    def wait_result(self, key, timeout):
        return self._call("wait_result", key, timeout, timeout=timeout)

    def wait_hgetall(self, key, timeout):
        """Combined wait + read: ONE bridge round trip on the hot
        result path (``OutputQueue.query_blocking`` uses it when the
        broker offers it)."""
        return self._call("wait_hgetall", key, timeout, timeout=timeout)

    def hgetall(self, key):
        return self._call("hgetall", key)

    def delete(self, key):
        return self._call("delete", key)

    def keys(self, pattern="*"):
        return self._call("keys", pattern)

    def delete_stream(self, stream):
        return self._call("delete_stream", stream)

    # ---- durability surface -----------------------
    def wal_tail(self, from_seq, limit: int = 1024):
        """Flushed WAL records past ``from_seq`` — the standby's pull
        feed against a ``DurableBroker`` primary."""
        return self._call("wal_tail", from_seq, limit)

    def pending(self, stream, group):
        return self._call("pending", stream, group)

    def promote(self, primary_wal_dir=None):
        """Promote the standby behind this bridge (the supervisor's
        failover call; generous timeout — promotion replays the dead
        primary's on-disk tail)."""
        return self._call("promote", primary_wal_dir, timeout=60.0)

    def status(self):
        return self._call("status")

    # ---- fleet channels ---------------------------------------------------
    def ping(self):
        return self._call("ping")

    def snap_put(self, name: str, blob: bytes):
        return self._call("snap_put", name, blob)

    def snap_all(self) -> Dict[str, Tuple[bytes, float]]:
        return self._call("snap_all")

    def ctl_set(self, key: str, value):
        return self._call("ctl_set", key, value)

    def ctl_get(self, key: str):
        return self._call("ctl_get", key)

    def ctl_all(self) -> Dict[str, object]:
        return self._call("ctl_all")


# ---- cross-process metrics/span aggregation -------------------------------

#: gauges that state a FLEET-ABSOLUTE fact every process reports
#: independently (the active partition count, a breaker's state): a
#: cross-process SUM would multiply them by the reporter count, so
#: these merge by MAX (for breaker state, max = the worst state any
#: worker observed).  Everything else sums — fleet totals are what
#: depth/throughput/in-flight series mean at fleet scope.
_GAUGE_MERGE_MAX = frozenset((
    "zoo_fleet_active_replicas", "zoo_fleet_workers",
    "zoo_resilience_breaker_state",
))


def merge_snapshots(snaps: List[dict]) -> dict:
    """Merge ``MetricsRegistry.snapshot()`` dicts into one fleet-wide
    snapshot: counters and histograms SUM (bucket-wise; the registry's
    fixed log-spaced buckets make cross-process sums exact), gauges SUM
    — fleet totals are what the series mean at fleet scope (queue depth
    across replicas adds, throughput adds, in-flight credits add) —
    except the fleet-absolute names in ``_GAUGE_MERGE_MAX``, which
    merge by MAX.  Per-process detail stays on each process's own
    registry (``GET /metrics?local=1``)."""
    out: dict = {}
    for snap in snaps:
        for name, fam in snap.items():
            tgt = out.get(name)
            if tgt is None:
                out[name] = {"kind": fam["kind"],
                             "help": fam.get("help", ""),
                             "series": {k: _copy_val(fam["kind"], v)
                                        for k, v in fam["series"].items()}}
                continue
            if tgt["kind"] != fam["kind"]:
                continue     # conflicting registration; keep the first
            for key, val in fam["series"].items():
                cur = tgt["series"].get(key)
                if cur is None:
                    tgt["series"][key] = _copy_val(fam["kind"], val)
                elif fam["kind"] == "histogram":
                    _merge_hist(cur, val)
                elif name in _GAUGE_MERGE_MAX:
                    tgt["series"][key] = max(cur, val)
                else:
                    tgt["series"][key] = cur + val
    return out


def _copy_val(kind: str, val):
    if kind == "histogram":
        return {"buckets": [list(b) for b in val["buckets"]],
                "sum": val["sum"], "count": val["count"]}
    return val


def _merge_hist(cur: dict, add: dict) -> None:
    if len(cur["buckets"]) != len(add["buckets"]):
        return               # bucket ladders differ; keep the first
    for i, (_, cum) in enumerate(add["buckets"]):
        cur["buckets"][i][1] += cum
    cur["sum"] += add["sum"]
    cur["count"] += add["count"]


class FleetPublisher:
    """Pushes this process's registry snapshot + recent span ring to the
    bridge every ``interval_s`` — the per-process half of fleet-wide
    ``/metrics`` / ``/spans``.  The blob is pickled ONCE here and stored
    opaque server-side; readers unpickle at merge time."""

    def __init__(self, broker, name: str, interval_s: float = 0.5,
                 span_limit: int = 512, metric_filter=None):
        self.broker = broker
        self.name = name
        self.interval_s = max(float(interval_s), 0.05)
        self.span_limit = int(span_limit)
        # optional family-name predicate: the SUPERVISOR (which shares
        # its process — and registry — with whatever launched the
        # fleet) publishes only its zoo_fleet_* series, so unrelated
        # parent-process metrics never leak into the fleet merge
        self.metric_filter = metric_filter
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def publish_once(self) -> None:
        metrics = obs.get_registry().snapshot()
        if self.metric_filter is not None:
            metrics = {k: v for k, v in metrics.items()
                       if self.metric_filter(k)}
        # span_limit <= 0 means publish NO spans (Tracer.export treats
        # a non-positive limit as "no cap" — the opposite)
        spans = (obs.get_tracer().export(limit=self.span_limit)
                 if self.span_limit > 0 else [])
        blob = pickle.dumps(
            {"name": self.name, "pid": os.getpid(), "ts": time.time(),
             "metrics": metrics, "spans": spans,
             "memory": obs.get_memory_ledger().snapshot(top_k=16)},
            protocol=4)
        self.broker.snap_put(self.name, blob)
        _m_snapshots.inc()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.publish_once()
            except (Exception, CancelledError):
                # a bridge hiccup must not kill the publisher thread;
                # the next tick retries
                logger.debug("fleet snapshot publish failed; will retry",
                             exc_info=True)
            self._stop.wait(self.interval_s)

    def start(self) -> "FleetPublisher":
        self._thread = threading.Thread(target=self._run,
                                        name="fleet-publisher",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, final_publish: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if final_publish:
            try:
                self.publish_once()
            except (Exception, CancelledError):
                pass


class FleetContext:
    """A worker process's read-side handle on the fleet channels: merged
    metrics text and merged spans for the HTTP observability routes.
    ``self_name`` is this process's publisher name — its PUSHED snapshot
    is excluded from merges (the live local registry stands in for it;
    merging both would double-count this process)."""

    def __init__(self, broker, self_name: str):
        self.broker = broker
        self.self_name = self_name

    def _remote_snaps(self) -> List[Tuple[str, dict]]:
        out = []
        try:
            snaps = self.broker.snap_all()
        except (Exception, CancelledError):
            return out
        for name, (blob, _ts) in snaps.items():
            if name == self.self_name:
                continue
            try:
                out.append((name, pickle.loads(blob)))
            except (Exception, CancelledError):
                continue     # one corrupt snapshot must not kill /metrics
        return out

    def merged_metrics_text(self) -> str:
        snaps = [obs.get_registry().snapshot()]
        snaps += [s["metrics"] for _, s in self._remote_snaps()
                  if "metrics" in s]
        return obs.render_snapshot(merge_snapshots(snaps))

    def merged_memory(self, top_k: int = 10) -> dict:
        """Fleet-wide device-memory view: this process's LIVE ledger
        snapshot merged with every peer's published one under the
        ledger's merge rules — capacity/pinned MAX per (host, pool)
        because co-hosted processes see the SAME device, usage SUMS
       ."""
        snaps = [obs.get_memory_ledger().snapshot()]
        snaps += [s["memory"] for _, s in self._remote_snaps()
                  if s.get("memory")]
        return obs.merge_memory_snapshots(snaps, top_k=top_k)

    def merged_spans(self, name=None, limit=None, trace_id=None
                     ) -> List[dict]:
        spans = obs.get_tracer().export(name=name, limit=None,
                                        trace_id=trace_id)
        # dedupe within one SOURCE process only (a process republishes
        # its ring every interval; span ids from different processes
        # are disjoint by reseed but must never suppress each other)
        seen = set()
        for src, snap in self._remote_snaps():
            for s in snap.get("spans", ()):
                if name is not None and s.get("name") != name:
                    continue
                if trace_id is not None and s.get("trace_id") != trace_id:
                    continue
                key = (src, s.get("span_id"))
                if key in seen:
                    continue
                seen.add(key)
                spans.append(s)
        spans.sort(key=lambda s: s.get("start") or 0.0)
        return spans[-limit:] if limit and limit > 0 else spans


# ---- routing --------------------------------------------------------------

class FleetRouter:
    """uri -> partition routing with per-partition circuit breakers and
    the fleet overload latch.

    Routing walks the ring from the uri's home partition:

    1. first partition whose breaker is CLOSED and whose overload latch
       is clear wins (the home partition, in the healthy steady state —
       consistent routing keeps a uri's retries on one replica's queue);
    2. else the first non-closed breaker granting a half-open PROBE
       (the recovered replica gets exactly its probe budget);
    3. else, if any partition is healthy-but-latched, the request is
       shed HERE — every healthy replica said 429 within the latch
       window, so the frontend answers 429 without paying the broker
       round trip (post-knee goodput: rejection must stay cheaper than
       acceptance);
    4. else (every breaker open, probe budgets spent) the fleet has no
       live replica: RuntimeError -> HTTP 503.

    The caller reports the outcome: ``note_result`` feeds the breaker
    (a result TIMEOUT is the failure signal — a replica that answered
    anything, even an error, is alive) and arms the latch on shed.
    Thread-safe; shared by every handler thread of a worker."""

    def __init__(self, broker, stream: str, partitions: int = 1,
                 refresh_s: float = 0.25, latch_s: float = 0.25,
                 breaker_failure_threshold: int = 3,
                 breaker_recovery_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        from analytics_zoo_tpu_torch.serving.client import InputQueue
        self.broker = broker
        self.stream = stream
        self._iq_cls = InputQueue
        self._clock = clock
        self._refresh_s = float(refresh_s)
        self._latch_s = float(latch_s)
        self._brk_threshold = int(breaker_failure_threshold)
        self._brk_recovery = float(breaker_recovery_s)
        self._lock = threading.Lock()
        self._active = max(int(partitions), 1)
        self._last_refresh = 0.0
        self._breakers: Dict[int, CircuitBreaker] = {}
        self._queues: Dict[int, object] = {}
        self._latched_until: Dict[int, float] = {}
        for k in range(self._active):
            self._partition(k)
        _m_active.set(float(self._active))

    def _partition(self, k: int):
        with self._lock:
            if k not in self._breakers:
                self._breakers[k] = CircuitBreaker(
                    f"fleet-p{k}",
                    failure_threshold=self._brk_threshold,
                    recovery_s=self._brk_recovery, clock=self._clock)
                self._queues[k] = self._iq_cls(
                    broker=self.broker,
                    stream=partition_stream(self.stream, k))
            return self._queues[k]

    @property
    def active_partitions(self) -> int:
        return self._active

    def set_active(self, n: int) -> None:
        n = max(int(n), 1)
        if n != self._active:
            for k in range(n):
                self._partition(k)
            # ring membership changed: breaker/latch state is keyed by
            # partition INDEX, and index k now maps to a different
            # slice of the ring — an open verdict earned against a
            # dead replica must not punish the healthy replica that
            # inherits the index (and a latched index must not shed
            # its inheritor's traffic)
            with self._lock:
                for b in self._breakers.values():
                    b.reset()
                self._latched_until.clear()
            self._active = n
            _m_active.set(float(n))

    def _maybe_refresh(self) -> None:
        now = self._clock()
        if now - self._last_refresh < self._refresh_s:
            return
        self._last_refresh = now
        try:
            n = self.broker.ctl_get("active_partitions")
        except (Exception, CancelledError):
            return           # keep routing on the last-known count
        if n:
            self.set_active(int(n))

    def queue_for(self, partition: int):
        """The partition's ``InputQueue`` (its ``<stream>.p<k>``)."""
        return self._partition(partition)

    def route(self, uri: str, key: Optional[str] = None
              ) -> Tuple[int, object, bool]:
        """``(partition, input_queue, is_probe)`` for one request.
        ``key`` overrides the routing key (default: the uri) — the
        multi-model tier routes by MODEL name so one model's requests
        consistently land on the partition whose replica already holds
        its weights resident.
        Raises ``ServingShedError`` (-> 429) when every healthy
        partition is latched, ``RuntimeError`` (-> 503) when no replica
        is live."""
        from analytics_zoo_tpu_torch.serving.client import ServingShedError
        self._maybe_refresh()
        n = self._active
        home = partition_for(key if key is not None else uri, n)
        order = [(home + i) % n for i in range(n)]
        now = self._clock()
        latched_healthy = False
        # one walk in ring order, so a RECOVERING home partition gets
        # its half-open probe before traffic diverts past it — an
        # ejected replica must rejoin even while healthy alternatives
        # exist (no probe traffic = no verdict = open forever)
        for p in order:
            b = self._breakers[p]
            if b.admissible:
                if self._latched_until.get(p, 0.0) <= now:
                    _m_routed.labels(partition=str(p)).inc()
                    if p != home:
                        _m_diverted.labels(partition=str(home)).inc()
                    return p, self._partition(p), False
                latched_healthy = True
            elif b.allow():
                # half-open probe: the caller MUST note_result so the
                # probe verdict lands
                _m_routed.labels(partition=str(p)).inc()
                if p != home:
                    _m_diverted.labels(partition=str(home)).inc()
                return p, self._partition(p), True
        if latched_healthy:
            _m_fastshed.inc()
            raise ServingShedError(
                "fleet overloaded: every healthy partition shed within "
                "the latch window — retry with backoff")
        raise RuntimeError("no live engine replica (all partition "
                           "breakers open)")

    def note_result(self, partition: int, timed_out: bool,
                    shed: bool = False) -> None:
        """Feed one request's outcome back: a TIMEOUT (no result at all)
        is the breaker's failure signal; ANY answer — value, error,
        expired, even a shed — proves the replica alive.  A shed
        additionally arms the partition's overload latch."""
        b = self._breakers.get(partition)
        if b is None:
            return
        if timed_out:
            b.record_failure()
        else:
            b.record_success()
            if shed:
                self._latched_until[partition] = (self._clock()
                                                  + self._latch_s)

    def note_shed(self, partition: int) -> None:
        self.note_result(partition, timed_out=False, shed=True)


# ---- autoscaler -----------------------------------------------------------

class ReplicaAutoscaler:
    """Deterministic scale-decision logic (the supervisor drives it; a
    test drives it with an injected clock).

    ``tick(signal, replicas)`` returns the TARGET replica count.  The
    signal is the per-replica queue pressure (the supervisor computes
    summed ``zoo_serving_queue_depth`` across replica snapshots, floored
    by ``zoo_serving_queue_high_water`` growth since the last tick,
    divided by the live replica count).  Hysteresis: scale up only after
    the signal holds >= ``high`` for ``up_sustain_s``; scale down only
    after it holds <= ``low`` for ``down_sustain_s``; a signal inside
    ``(low, high)`` resets both timers and NEVER moves the count; every
    action starts a ``cooldown_s`` window during which no further action
    fires.  The count never leaves ``[min_replicas, max_replicas]``."""

    def __init__(self, min_replicas: int = 1, max_replicas: int = 4,
                 high: float = 32.0, low: float = 2.0,
                 up_sustain_s: float = 1.0, down_sustain_s: float = 3.0,
                 cooldown_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        if max_replicas < min_replicas:
            raise ValueError("max_replicas < min_replicas")
        if low >= high:
            raise ValueError("hysteresis band requires low < high")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.high = float(high)
        self.low = float(low)
        self.up_sustain_s = float(up_sustain_s)
        self.down_sustain_s = float(down_sustain_s)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        self._last_action = -float("inf")

    def tick(self, signal: float, replicas: int) -> int:
        now = self._clock()
        if signal >= self.high:
            self._below_since = None
            if self._above_since is None:
                self._above_since = now
            if (now - self._above_since >= self.up_sustain_s
                    and now - self._last_action >= self.cooldown_s
                    and replicas < self.max_replicas):
                self._last_action = now
                self._above_since = None
                _m_autoscale.labels(direction="up").inc()
                obs.add_event("fleet.scale_up", span=None,
                              signal=signal, replicas=replicas + 1)
                return replicas + 1
        elif signal <= self.low:
            self._above_since = None
            if self._below_since is None:
                self._below_since = now
            if (now - self._below_since >= self.down_sustain_s
                    and now - self._last_action >= self.cooldown_s
                    and replicas > self.min_replicas):
                self._last_action = now
                self._below_since = None
                _m_autoscale.labels(direction="down").inc()
                obs.add_event("fleet.scale_down", span=None,
                              signal=signal, replicas=replicas - 1)
                return replicas - 1
        else:
            # inside the hysteresis band: both timers reset — the
            # autoscaler can NEVER oscillate on a signal that sits
            # between the thresholds
            self._above_since = None
            self._below_since = None
        return replicas


def _series_sum(snapshot: dict, name: str) -> float:
    fam = snapshot.get(name)
    if not fam or fam["kind"] == "histogram":
        return 0.0
    total = 0.0
    for v in fam["series"].values():
        try:
            if v == v:       # skip NaN (a detached pull gauge)
                total += float(v)
        except TypeError:
            pass
    return total


def fleet_queue_signal(replica_snaps: List[dict],
                       prev_hwm: float) -> Tuple[float, float]:
    """``(signal, hwm)`` from replica metric snapshots.  The signal is
    the max of three registry series, so it reads "how backed up are
    the replicas" at whatever granularity is currently binding:

    - summed stage queue depths (``zoo_serving_queue_depth`` — entries
      waiting inside the engines at the snapshot instant),
    - admitted-but-unfinished records
      (``zoo_resilience_admission_in_flight`` — the steadiest pressure
      reading under sustained load; depth gauges sample instants and
      bounce between snapshots),
    - high-water GROWTH since the previous tick (the
      ``zoo_serving_queue_high_water`` gauges — a spike that drained
      between ticks still registers as pressure)."""
    depth = sum(_series_sum(s, "zoo_serving_queue_depth")
                for s in replica_snaps)
    in_flight = sum(_series_sum(s, "zoo_resilience_admission_in_flight")
                    for s in replica_snaps)
    hwm = sum(_series_sum(s, "zoo_serving_queue_high_water")
              for s in replica_snaps)
    growth = max(0.0, hwm - prev_hwm)
    return max(depth, in_flight, growth), hwm


# ---- process entry points -------------------------------------------------

def _install_sigterm_event() -> threading.Event:
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    return stop


def _fresh_process_observability() -> None:
    """A forked child inherits the parent's registry/tracer STATE
    (counters already incremented, spans already recorded).  Start this
    process's telemetry from zero so fleet merges never double-count
    the parent's history."""
    from analytics_zoo_tpu_torch.observability.metrics import MetricsRegistry
    obs.set_registry(MetricsRegistry())
    tracer = obs.get_tracer()
    tracer.clear()
    # disjoint per-process span-id ranges: a forked child inherits the
    # parent's counter position, and two processes both minting span id
    # 1 for one trace would alias parent links (and dedupe keys) in the
    # merged fleet span view.  pid << 40 keeps ids below the 2^62
    # wire-minted trace-id tag.
    tracer.reseed_ids(((os.getpid() & 0x3FFFFF) << 40) | 1)


def _replica_main(address, partition: int, model_factory,
                  serving_cfg: ServingConfig, fleet_cfg: FleetConfig,
                  init_hook=None) -> None:
    """Engine replica process: one ``ClusterServing`` consuming its
    partition stream over the bridge broker.  ``model_factory`` runs
    HERE (after the fork) so each replica owns its model; ``init_hook``
    (tests) runs first — e.g. arming a chaos plan in just this
    process."""
    from analytics_zoo_tpu_torch.serving.engine import ClusterServing
    stop = _install_sigterm_event()
    _fresh_process_observability()
    if init_hook is not None:
        init_hook(partition)
    broker = RemoteBroker(address)
    import dataclasses
    cfg = dataclasses.replace(
        serving_cfg,
        input_stream=partition_stream(serving_cfg.input_stream,
                                      partition))
    engine = ClusterServing(model_factory(), cfg, broker=broker)
    publisher = FleetPublisher(
        broker, name=f"replica-{partition}",
        interval_s=fleet_cfg.snapshot_interval_s,
        span_limit=fleet_cfg.snapshot_span_limit)
    engine.start()
    publisher.start()
    try:
        broker.ctl_set(f"replica_ready:{partition}", os.getpid())
    except (Exception, CancelledError):
        pass
    stop.wait()
    try:
        engine.stop()        # drains: admitted entries reach a result
    finally:
        publisher.stop()


def _frontend_main(address, http_port: int, serving_cfg: ServingConfig,
                   fleet_cfg: FleetConfig, index: int,
                   init_hook=None) -> None:
    """Frontend worker process: the existing ``ServingFrontend`` handler
    stack on a SO_REUSEPORT socket, routing through a ``FleetRouter``
    against the bridge broker."""
    from analytics_zoo_tpu_torch.serving.http_frontend import ServingFrontend
    stop = _install_sigterm_event()
    _fresh_process_observability()
    if init_hook is not None:
        init_hook(index)
    broker = RemoteBroker(address)
    router = FleetRouter(
        broker, stream=serving_cfg.input_stream,
        partitions=int(broker.ctl_get("active_partitions") or 1),
        refresh_s=fleet_cfg.router_refresh_s,
        latch_s=fleet_cfg.overload_latch_s,
        breaker_failure_threshold=fleet_cfg.breaker_failure_threshold,
        breaker_recovery_s=fleet_cfg.breaker_recovery_s)
    name = f"frontend-{index}"
    fe = ServingFrontend(
        broker=broker, config=serving_cfg,
        stream=serving_cfg.input_stream, router=router,
        fleet=FleetContext(broker, self_name=name),
        worker_id=name, port=http_port, reuse_port=True)
    publisher = FleetPublisher(
        broker, name=name, interval_s=fleet_cfg.snapshot_interval_s,
        span_limit=fleet_cfg.snapshot_span_limit)
    fe.start()
    publisher.start()
    try:
        broker.ctl_set(f"frontend_ready:{index}", os.getpid())
    except (Exception, CancelledError):
        pass
    stop.wait()
    try:
        fe.stop()
    finally:
        publisher.stop()


# ---- durable control plane ------------------------

def _durable_broker_kw(fc: FleetConfig) -> dict:
    return {"segment_bytes": fc.wal_segment_bytes,
            "commit_interval_ms": fc.wal_commit_interval_ms,
            "sync": fc.wal_sync,
            "redeliver_idle_s": fc.redeliver_idle_s}


def _broker_owner_main(host: str, port: int, wal_dir: str,
                       fleet_cfg: FleetConfig) -> None:
    """Broker-owner process: the journaled broker + its bridge on the
    fleet's stable broker port.  Recovery is implicit: a restart over
    an existing WAL directory replays it (fresh entries requeue,
    delivered-but-unacked entries arm for redelivery)."""
    from analytics_zoo_tpu_torch.serving.durability import DurableBroker
    stop = _install_sigterm_event()
    _fresh_process_observability()
    broker = DurableBroker(wal_dir, recover=True,
                           **_durable_broker_kw(fleet_cfg))
    bridge = BrokerBridge(broker, host=host, port=port).start()
    # the owner's own series (WAL appends/torn records, dedup drops,
    # ledger redeliveries) join the fleet-wide /metrics merge
    publisher = FleetPublisher(bridge, name="broker-owner",
                               interval_s=fleet_cfg.snapshot_interval_s,
                               span_limit=0).start()
    stop.wait()
    publisher.stop(final_publish=False)
    bridge.stop()
    broker.close()


class _StandbyController:
    """What a standby process serves on its CONTROL bridge: the
    supervisor's promote/status calls.  ``promote`` flips the replica
    to primary and binds the fleet's stable broker port — frontends
    and engine replicas reconnect to the SAME address with bounded
    retry instead of re-discovering a new one."""

    def __init__(self, replica, host: str, primary_port: int,
                 fleet_cfg: FleetConfig):
        self.replica = replica
        self._host = host
        self._primary_port = int(primary_port)
        self._fleet_cfg = fleet_cfg
        self._serving_bridge: Optional[BrokerBridge] = None
        self._publisher: Optional[FleetPublisher] = None
        self._lock = threading.Lock()

    def promote(self, primary_wal_dir=None):
        seq = self.replica.promote(primary_wal_dir)
        with self._lock:
            if self._serving_bridge is None:
                self._serving_bridge = BrokerBridge(
                    self.replica.broker, host=self._host,
                    port=self._primary_port).start()
                self._publisher = FleetPublisher(
                    self._serving_bridge, name="broker-owner",
                    interval_s=self._fleet_cfg.snapshot_interval_s,
                    span_limit=0).start()
        return seq

    def status(self):
        return self.replica.status()

    def applied_seq(self):
        return self.replica.applied_seq()

    def stop(self) -> None:
        with self._lock:
            if self._publisher is not None:
                self._publisher.stop(final_publish=False)
            if self._serving_bridge is not None:
                self._serving_bridge.stop()
        self.replica.stop()


def _standby_main(host: str, primary_port: int, wal_dir: str,
                  primary_wal_dir: str, ctl_conn,
                  fleet_cfg: FleetConfig) -> None:
    """Warm-standby process: tails the primary's WAL over the bridge
    wire and reports its control-bridge port back to the supervisor
    (which calls ``promote`` on owner death)."""
    from analytics_zoo_tpu_torch.serving.durability import BrokerReplica
    stop = _install_sigterm_event()
    _fresh_process_observability()
    replica = BrokerReplica((host, primary_port), wal_dir,
                            primary_wal_dir=primary_wal_dir,
                            **_durable_broker_kw(fleet_cfg)).start()
    ctl = _StandbyController(replica, host, primary_port, fleet_cfg)
    ctl_bridge = BrokerBridge(ctl, host=host, port=0).start()
    try:
        ctl_conn.send(ctl_bridge.address[1])
        ctl_conn.close()
    except (Exception, CancelledError):
        pass
    stop.wait()
    ctl_bridge.stop()
    ctl.stop()


class _BridgeClient(RemoteBroker):
    """The supervisor's handle on a REMOTE broker bridge (durable
    mode): the same object shape the in-process ``BrokerBridge`` has
    where the supervisor uses it (``address``, ctl/snap channels,
    ``stop``)."""

    def stop(self) -> None:
        self.close()


def _free_port(host: str = "127.0.0.1") -> int:
    s = socket.socket()
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---- supervisor -----------------------------------------------------------

class FleetSupervisor:
    """Owns the real broker + bridge, forks the frontend workers and
    engine replicas, publishes the active-partition count, and runs the
    autoscale loop.  ``model_factory`` is called INSIDE each replica
    process (fork start method: closures are fine), so each replica builds
    its own model on the card after the fork; ``start`` raises
    ``RuntimeError`` when CUDA is already initialised in this process.
    ``http_port=0`` has the supervisor pick one free port, which every
    frontend worker then binds (``http_port`` holds it after ``start``)."""

    def __init__(self, model_factory,
                 serving_config: Optional[ServingConfig] = None,
                 fleet_config: Optional[FleetConfig] = None,
                 broker=None, http_port: int = 10020,
                 replica_init_hook=None, autoscale: bool = True):
        self.model_factory = model_factory
        self.serving_config = serving_config or ServingConfig(
            redis_url="memory://")
        self.fleet_config = fleet_config or FleetConfig()
        self.http_port = int(http_port)
        self.replica_init_hook = replica_init_hook
        self.autoscale_enabled = autoscale
        self._broker = broker
        self.bridge: Optional[BrokerBridge] = None
        self._frontends: Dict[int, object] = {}
        self._replicas: Dict[int, object] = {}
        self._stop = threading.Event()
        self._autoscale_thread: Optional[threading.Thread] = None
        self._prev_hwm = 0.0
        # durable control plane state, shared
        # between the main thread, the autoscale loop and the failover
        # loop — every write holds _broker_lock (reentrant: _failover
        # respawns the standby under it)
        self._broker_lock = threading.RLock()
        self._failover_thread: Optional[threading.Thread] = None
        self._owner = None
        self._standby = None
        self._standby_ctl = None
        self._partitions_target = 1
        self.last_failover_ms: Optional[float] = None
        fc = self.fleet_config
        self.autoscaler = ReplicaAutoscaler(
            min_replicas=fc.min_replicas, max_replicas=fc.max_replicas,
            high=fc.scale_up_queue_depth, low=fc.scale_down_queue_depth,
            up_sustain_s=fc.scale_up_sustain_s,
            down_sustain_s=fc.scale_down_sustain_s,
            cooldown_s=fc.autoscale_cooldown_s)

    # ---- lifecycle --------------------------------------------------------
    def start(self, wait_ready_s: float = 30.0) -> "FleetSupervisor":
        import multiprocessing as mp

        import torch

        from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
        if torch.cuda.is_initialized():
            # a forked child cannot use a card its parent initialised:
            # every replica would fail its first CUDA call
            raise RuntimeError(
                "FleetSupervisor.start() must run before anything "
                "initialises CUDA in this process (the replicas fork and "
                "build their models on the card themselves); start the "
                "fleet from a fresh interpreter")
        self._ctx = mp.get_context("fork")
        fc = self.fleet_config
        if self.http_port == 0:
            self.http_port = _free_port(
                getattr(self.serving_config, "http_host", "127.0.0.1"))
        if fc.durable:
            # durable control plane: the
            # broker lives in its OWN supervised process behind a WAL,
            # with a warm standby promoted on kill -9 — the supervisor
            # itself talks to it over the bridge wire like everyone
            self._start_durable_broker(wait_ready_s)
        else:
            if self._broker is None:
                self._broker = InMemoryBroker()
            self.bridge = BrokerBridge(
                self._broker, host=fc.bridge_host,
                port=fc.bridge_port).start()
        n0 = max(fc.replicas, fc.min_replicas, 1)
        with self._broker_lock:
            self._partitions_target = n0
        self.bridge.ctl_set("active_partitions", n0)
        _m_active.set(float(n0))
        for k in range(n0):
            self._spawn_replica(k)
        for i in range(max(fc.frontend_workers, 1)):
            self._spawn_frontend(i)
        _m_workers.set(float(len(self._frontends)))
        # the supervisor's own registry (autoscale events, worker/replica
        # gauges) joins the fleet-wide merge like every other process's
        self._publisher = FleetPublisher(
            self.bridge, name="supervisor",
            interval_s=fc.snapshot_interval_s, span_limit=0,
            metric_filter=lambda name:
                name.startswith("zoo_fleet_")).start()
        self._wait_ready(wait_ready_s)
        if self.autoscale_enabled:
            self._autoscale_thread = threading.Thread(
                target=self._autoscale_loop, name="fleet-autoscale",
                daemon=True)
            self._autoscale_thread.start()
        if fc.durable:
            self._failover_thread = threading.Thread(
                target=self._failover_loop, name="fleet-failover",
                daemon=True)
            self._failover_thread.start()
        return self

    # ---- durable broker lifecycle -----------------
    def _start_durable_broker(self, wait_ready_s: float) -> None:
        import tempfile
        fc = self.fleet_config
        host = fc.bridge_host
        with self._broker_lock:
            self._broker_port = fc.broker_port or _free_port(host)
            self._wal_root = (fc.wal_dir
                              or tempfile.mkdtemp(prefix="zoo-wal-"))
            self._broker_gen = 0
            self._primary_wal_dir = os.path.join(self._wal_root,
                                                 "broker-0")
            self._owner = self._ctx.Process(
                target=_broker_owner_main,
                args=(host, self._broker_port, self._primary_wal_dir,
                      fc),
                name="fleet-broker-owner", daemon=True)
            self._owner.start()
            self.bridge = _BridgeClient((host, self._broker_port))
        self._wait_broker(wait_ready_s)
        self._spawn_standby()

    def _wait_broker(self, timeout_s: float) -> None:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                if self.bridge.ping() == "pong":
                    return
            except (Exception, CancelledError):
                pass
            time.sleep(0.05)
        raise RuntimeError("durable broker owner did not come up on "
                           f"port {self._broker_port}")

    def _spawn_standby(self) -> None:
        fc = self.fleet_config
        host = fc.bridge_host
        with self._broker_lock:
            self._broker_gen += 1
            gen = self._broker_gen
            sdir = os.path.join(self._wal_root, f"broker-{gen}")
            parent_conn, child_conn = self._ctx.Pipe()
            p = self._ctx.Process(
                target=_standby_main,
                args=(host, self._broker_port, sdir,
                      self._primary_wal_dir, child_conn, fc),
                name=f"fleet-broker-standby-{gen}", daemon=True)
            p.start()
        child_conn.close()
        ctl_port = None
        try:
            if parent_conn.poll(30):
                ctl_port = parent_conn.recv()
        except (Exception, CancelledError):
            pass
        parent_conn.close()
        if ctl_port is None:
            # the handshake failed: reap the child NOW — an untracked
            # standby would keep tailing (and journaling) forever,
            # invisible to stop(), while the failover loop spawns a
            # replacement
            p.terminate()
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
            raise RuntimeError("standby process reported no control "
                               "port")
        with self._broker_lock:
            self._standby = p
            self._standby_ctl = _BridgeClient((host, ctl_port))
            self._standby_wal_dir = sdir
        logger.info("broker standby gen %d tailing primary (wal=%s)",
                    gen, sdir)

    def _failover_loop(self) -> None:
        fc = self.fleet_config
        while not self._stop.wait(fc.failover_poll_s):
            try:
                owner = getattr(self, "_owner", None)
                if owner is not None and not owner.is_alive():
                    self._failover()
                elif (self._standby is None
                      or not self._standby.is_alive()):
                    # a dead (or never-successfully-spawned) STANDBY
                    # costs nothing but redundancy: replace it — the
                    # fresh one re-tails the primary from scratch.
                    # `is None` matters: a _spawn_standby that failed
                    # mid-failover must be retried here, or the next
                    # owner death would find nothing to promote.
                    if self._standby is not None:
                        logger.warning("broker standby died; respawning")
                    with self._broker_lock:
                        if self._standby_ctl is not None:
                            self._standby_ctl.close()
                            self._standby_ctl = None
                    self._spawn_standby()
            except (Exception, CancelledError):
                # one bad tick (a kill racing the poll, a slow spawn)
                # must not end supervision; the next tick retries
                logger.exception("failover tick failed; retrying")

    def _failover(self) -> None:
        """The broker owner died: promote the warm standby onto the
        stable broker port, restore control state, and re-arm with a
        fresh standby.  Bounded end to end: promotion retries a few
        times (the ``broker_promote`` chaos class), then the fleet is
        serving again — clients reconnect to the SAME address.  With
        NO live standby (both processes died, or a standby spawn
        failed), recovery falls back to a fresh owner replaying the
        primary's on-disk WAL."""
        t0 = time.monotonic()
        _m_failovers.inc()
        with self._broker_lock:
            standby_ctl = self._standby_ctl
        if standby_ctl is None or self._standby is None \
                or not self._standby.is_alive():
            logger.warning("broker owner died with no live standby; "
                           "recovering a fresh owner from the WAL")
            with self._broker_lock:
                if self._standby_ctl is not None:
                    self._standby_ctl.close()
                    self._standby_ctl = None
                self._standby = None
            self._respawn_owner_from_disk()
        else:
            logger.warning("broker owner died; promoting standby")
            last: Optional[BaseException] = None
            for attempt in range(5):
                try:
                    standby_ctl.promote(self._primary_wal_dir)
                    last = None
                    break
                except (Exception, CancelledError) as exc:
                    last = exc
                    time.sleep(0.1 * (attempt + 1))
            if last is not None:
                raise RuntimeError(
                    f"standby promotion failed after retries: {last!r}")
            with self._broker_lock:
                # the promoted standby process IS the new owner; its
                # control-bridge client has served its purpose
                self._owner = self._standby
                self._primary_wal_dir = self._standby_wal_dir
                self._standby_ctl.close()
                self._standby = None
                self._standby_ctl = None
        self._wait_broker(30.0)
        # the dead bridge's control state died with it: re-publish the
        # partition count so router refreshes keep routing everywhere
        try:
            self.bridge.ctl_set("active_partitions",
                                self._partitions_target)
        except (Exception, CancelledError):
            logger.exception("could not republish partition count")
        with self._broker_lock:
            self.last_failover_ms = (time.monotonic() - t0) * 1e3
        logger.warning("broker failover completed in %.0f ms",
                       self.last_failover_ms)
        # re-arm LAST: a failed spawn here leaves a serving (if
        # standby-less) fleet, and the failover loop's respawn branch
        # retries on its next tick
        self._spawn_standby()

    def _respawn_owner_from_disk(self) -> None:
        """Last-resort recovery (owner dead, no live standby): start a
        fresh owner process over the primary's on-disk WAL — recovery
        replays it, so acknowledged requests still survive.  The
        caller's fall-through waits for the port and re-publishes the
        control state."""
        fc = self.fleet_config
        with self._broker_lock:
            self._owner = self._ctx.Process(
                target=_broker_owner_main,
                args=(fc.bridge_host, self._broker_port,
                      self._primary_wal_dir, fc),
                name="fleet-broker-owner", daemon=True)
            self._owner.start()

    # ---- durable chaos surface --------------------------------------------
    def kill_broker_owner(self, sig=signal.SIGKILL) -> None:
        """Hard-kill the broker-owner process (chaos surface): the
        failover loop promotes the warm standby; acknowledged requests
        replay from the WAL."""
        p = getattr(self, "_owner", None)
        if p is not None and p.is_alive():
            os.kill(p.pid, sig)
            p.join(timeout=10)

    def kill_standby(self, sig=signal.SIGKILL) -> None:
        """Hard-kill the warm standby (chaos surface): no client
        impact; the failover loop re-arms a fresh one."""
        p = getattr(self, "_standby", None)
        if p is not None and p.is_alive():
            os.kill(p.pid, sig)
            p.join(timeout=10)

    @property
    def address(self) -> Tuple[str, int]:
        return self.bridge.address

    @property
    def active_replicas(self) -> int:
        return int(self.bridge.ctl_get("active_partitions") or 0)

    def _spawn_replica(self, k: int) -> None:
        p = self._ctx.Process(
            target=_replica_main,
            args=(self.bridge.address, k, self.model_factory,
                  self.serving_config, self.fleet_config,
                  self.replica_init_hook),
            name=f"fleet-replica-{k}", daemon=True)
        p.start()
        self._replicas[k] = p

    def _spawn_frontend(self, i: int) -> None:
        p = self._ctx.Process(
            target=_frontend_main,
            args=(self.bridge.address, self.http_port,
                  self.serving_config, self.fleet_config, i),
            name=f"fleet-frontend-{i}", daemon=True)
        p.start()
        self._frontends[i] = p

    def _wait_ready(self, timeout_s: float) -> None:
        deadline = time.monotonic() + timeout_s
        want = ([f"replica_ready:{k}" for k in self._replicas]
                + [f"frontend_ready:{i}" for i in self._frontends])
        while time.monotonic() < deadline:
            if all(self.bridge.ctl_get(k) for k in want):
                return
            time.sleep(0.05)
        missing = [k for k in want if not self.bridge.ctl_get(k)]
        raise RuntimeError(f"fleet processes not ready: {missing}")

    # ---- autoscaling ------------------------------------------------------
    def _replica_snaps(self) -> List[dict]:
        out = []
        for name, (blob, _ts) in self.bridge.snap_all().items():
            if not name.startswith("replica-"):
                continue
            try:
                out.append(pickle.loads(blob)["metrics"])
            except (Exception, CancelledError):
                continue     # one corrupt snapshot must not stop a tick
        return out

    def _autoscale_loop(self) -> None:
        fc = self.fleet_config
        while not self._stop.is_set():
            try:
                self.autoscale_tick()
            except (Exception, CancelledError):
                # one bad tick (bridge racing shutdown, a corrupt
                # snapshot) must not kill the autoscaler thread
                logger.exception("autoscale tick failed; retrying")
            self._stop.wait(fc.autoscale_interval_s)

    def idle_capacity(self) -> int:
        """Replica slots idle enough to LEND to background work — the
        continuous training loop schedules its AutoML refit trials onto
        this (``automl.search.IdleCapacityExecutor``,
        ).  A replica counts busy when the fleet
        queue signal says its share of pressure reaches the
        autoscaler's high-water mark; the signal is read WITHOUT
        advancing the autoscaler's own high-water bookkeeping."""
        active = self.active_replicas
        snaps = self._replica_snaps()
        raw, _ = fleet_queue_signal(snaps, self._prev_hwm)
        busy = min(active, int(math.ceil(
            raw / max(self.autoscaler.high, 1.0))))
        return max(0, active - busy)

    def autoscale_tick(self) -> int:
        """One autoscaler evaluation (the loop calls this; tests may
        call it directly).  Returns the active replica count after the
        tick."""
        active = self.active_replicas
        snaps = self._replica_snaps()
        raw, self._prev_hwm = fleet_queue_signal(snaps, self._prev_hwm)
        signal_per_replica = raw / max(active, 1)
        target = self.autoscaler.tick(signal_per_replica, active)
        if target > active:
            self._scale_up(target)
        elif target < active:
            self._scale_down(target)
        return self.active_replicas

    def _scale_up(self, target: int) -> None:
        # spawn whatever partition slots below target lack a LIVE
        # process — a partition whose old replica is mid-retire (or
        # died) gets a fresh one, never a no-op that would publish an
        # active count nobody consumes
        for k in range(target):
            p = self._replicas.get(k)
            if p is None or not p.is_alive():
                self._spawn_replica(k)
        # publish AFTER the processes exist: a frontend routing to the
        # new partition immediately only queues work the replica will
        # drain as it comes up
        with self._broker_lock:
            self._partitions_target = target
        self.bridge.ctl_set("active_partitions", target)
        _m_active.set(float(target))
        logger.info("fleet scaled up to %d replicas", target)

    def _scale_down(self, target: int) -> None:
        # stop routing FIRST; replicas retire only after the frontends'
        # router refresh + a drain grace, so no request is stranded on a
        # partition nobody consumes.  The retiring PROCESS OBJECTS are
        # captured NOW: if a scale-up respawns one of these partitions
        # before the grace elapses, the retire thread must kill the OLD
        # process, never the replacement.
        with self._broker_lock:
            self._partitions_target = target
        self.bridge.ctl_set("active_partitions", target)
        _m_active.set(float(target))
        retiring = [(k, self._replicas[k])
                    for k in sorted(self._replicas) if k >= target]
        fc = self.fleet_config

        def _retire():
            time.sleep(fc.router_refresh_s + fc.drain_grace_s)
            for k, p in retiring:
                if self._replicas.get(k) is p:
                    self._replicas.pop(k, None)
                p.terminate()      # SIGTERM -> engine.stop() drains
                p.join(timeout=15)
        threading.Thread(target=_retire, name="fleet-retire",
                         daemon=True).start()
        logger.info("fleet scaling down to %d replicas", target)

    # ---- chaos/ops surface ------------------------------------------------
    def kill_frontend(self, index: int, sig=signal.SIGKILL) -> None:
        """Hard-kill one frontend worker (chaos surface): the kernel
        stops routing new SO_REUSEPORT connections to it; in-flight
        requests on its connections reset."""
        p = self._frontends.get(index)
        if p is not None and p.is_alive():
            os.kill(p.pid, sig)
            p.join(timeout=10)

    def kill_replica(self, k: int, sig=signal.SIGKILL) -> None:
        """Hard-kill one engine replica (chaos surface): its partition
        stops answering; frontends' breakers open and divert."""
        p = self._replicas.get(k)
        if p is not None and p.is_alive():
            os.kill(p.pid, sig)
            p.join(timeout=10)

    def alive_frontends(self) -> List[int]:
        return sorted(i for i, p in self._frontends.items()
                      if p.is_alive())

    def snapshots(self) -> Dict[str, dict]:
        """All published per-process snapshots, unpickled (ops/tests)."""
        out = {}
        for name, (blob, _ts) in self.bridge.snap_all().items():
            try:
                out[name] = pickle.loads(blob)
            except (Exception, CancelledError):
                continue
        return out

    def stop(self) -> None:
        self._stop.set()
        if self._autoscale_thread is not None:
            self._autoscale_thread.join(timeout=10)
        if self._failover_thread is not None:
            self._failover_thread.join(timeout=10)
        if getattr(self, "_publisher", None) is not None:
            self._publisher.stop(final_publish=False)
            self._publisher = None
        # frontends first (stop accepting), then replicas (drain)
        for p in list(self._frontends.values()):
            if p.is_alive():
                p.terminate()
        for p in list(self._frontends.values()):
            p.join(timeout=10)
        for p in list(self._replicas.values()):
            if p.is_alive():
                p.terminate()
        for p in list(self._replicas.values()):
            p.join(timeout=15)
        for p in list(self._frontends.values()) + list(
                self._replicas.values()):
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        # durable mode: the broker owner retires LAST (the drain above
        # still needed the request/result plane); the WAL keeps its
        # state for the next life
        for p in (self._standby, self._owner):
            if p is not None and p.is_alive():
                p.terminate()
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
        if self._standby_ctl is not None:
            self._standby_ctl.close()
        if self.bridge is not None:
            self.bridge.stop()
