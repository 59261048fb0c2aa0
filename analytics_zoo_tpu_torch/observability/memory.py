"""Unified device-memory ledger: one answer to "what is resident in
device memory right now, who owns it, and do the books match reality?"

A copy of ``analytics_zoo_tpu/observability/memory.py`` (the port cannot
import it: every ``analytics_zoo_tpu`` import loads jax), with the same
pool contract, metric families, watermarks and merge rules.  Only
``device_memory_stats`` differs: it reads ``torch.cuda``'s allocator
where the JAX function reads ``Device.memory_stats()``, and only once
CUDA is initialized, so a scrape never creates a CUDA context.

Every device-memory pool in the system — the model weight cache
(``serving/model_zoo.py``), the paged KV block pool + radix prefix
cache (``llm/kv_cache.py``), the native sample cache
(``native/sample_cache.cpp``), training weight/optimizer state
(``estimator/``), and the hot-swap double-buffer staging overlap —
registers here under ONE contract:

    snapshot_fn() -> {"capacity_bytes": int,   # 0 = unbounded
                      "used_bytes":     int,
                      "pinned_bytes":   int,   # unevictable subset
                      "blocks":         int,
                      "owners":         {owner: bytes}}   # sums to used

The snapshot callback runs under the SUBSYSTEM'S OWN lock, so each
pool's figures are torn-free by construction (used <= capacity,
attribution sums to used); cross-pool consistency is per-call, not
global.  On top of the registered pools the ledger runs:

- a **sampler** (``zoo-mem-sampler`` thread): a fixed-capacity
  time-series ring per pool, rendered as Perfetto COUNTER tracks by
  ``chrome_trace(..., counters=ledger.counter_events())`` and shipped
  in every flight-recorder dump's ``memory`` section;
- a **reconciliation sweep** (``zoo-mem-reconciler`` thread — the leak
  sentinel): each pool's ``reconcile_fn`` cross-checks the ledger
  books against ground truth (``PagedKVCache.refcount_balance``, the
  registry's owner books, a native entry-map recount), plus the
  uniform invariants (owner sum == used, non-negative books).  A
  divergence must CONFIRM on a second read (transient races with live
  allocation are not leaks) before it counts into
  ``zoo_mem_reconcile_failures_total`` and — once per divergence
  episode — fires a rate-limited ``mem_leak`` flight-recorder dump
  naming the pool.  The sweep is a chaos injection point
  (``mem_reconcile``): a fault aborts that sweep cleanly, never the
  thread and never a false dump;
- **pressure watermarks**: configurable fractions per pool; crossing
  one flips ``zoo_mem_pressure_state{pool}`` and fires ``on_pressure``
  callbacks — the hook KV tiering drives demotion from (ROADMAP item
  2) and the retrain loop uses to defer double-buffer swaps.

Fleet merge rules (``GET /debug/memory``, docs/observability.md
"Memory ledger"): processes on one host SHARE the physical device, so
``capacity_bytes``/``pinned_bytes`` merge by MAX per (host, pool) and
then sum across hosts; ``used_bytes``/``blocks``/owner attribution sum
everywhere.
"""

from __future__ import annotations

import logging
import os
import socket
import sys
import threading
import time
import weakref
from collections import deque
from concurrent.futures import CancelledError
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from analytics_zoo_tpu_torch.observability.metrics import get_registry
from analytics_zoo_tpu_torch.observability.tracing import get_tracer

__all__ = ["DEFAULT_WATERMARKS", "MemoryLedger", "MemoryPool",
           "configure", "device_memory_stats", "get_ledger",
           "merge_memory_snapshots"]

logger = logging.getLogger("analytics_zoo_tpu_torch.memory")

#: the uniform pool-contract keys every ``snapshot_fn`` must return
POOL_KEYS = ("capacity_bytes", "used_bytes", "pinned_bytes", "blocks")

#: default pressure thresholds as (level name, fraction of capacity);
#: level 0 is always the implicit "ok" below the first threshold
DEFAULT_WATERMARKS: Tuple[Tuple[str, float], ...] = (
    ("high", 0.85), ("critical", 0.95))

_HOST = socket.gethostname()


def _metrics():
    """The ``zoo_mem_*`` families on the CURRENT default registry
    (declared per call — families are cached — so the ledger follows
    ``set_registry()`` swaps like every lazy instrumentation point)."""
    reg = get_registry()
    return {
        "capacity": reg.gauge(
            "zoo_mem_pool_capacity_bytes",
            "ledger pool capacity (0 = unbounded)", ["pool"]),
        "used": reg.gauge(
            "zoo_mem_pool_used_bytes",
            "ledger pool bytes currently booked", ["pool"]),
        "pinned": reg.gauge(
            "zoo_mem_pool_pinned_bytes",
            "ledger pool bytes pinned (unevictable)", ["pool"]),
        "blocks": reg.gauge(
            "zoo_mem_pool_blocks",
            "ledger pool allocation units in use", ["pool"]),
        "pressure": reg.gauge(
            "zoo_mem_pressure_state",
            "pool pressure watermark level (0 ok, then one per "
            "configured threshold crossed)", ["pool"]),
        "fail": reg.counter(
            "zoo_mem_reconcile_failures_total",
            "reconciliation sweeps that found a confirmed divergence, "
            "by pool", ["pool"]),
        "sweeps": reg.counter(
            "zoo_mem_reconcile_sweeps_total",
            "leak-sentinel reconciliation sweeps completed"),
        "sweep_s": reg.histogram(
            "zoo_mem_reconcile_seconds",
            "duration of one full reconciliation sweep"),
        "ticks": reg.counter(
            "zoo_mem_sampler_ticks_total",
            "utilization samples taken across all pools"),
    }


def device_memory_stats() -> List[Dict[str, int]]:
    """Per-card allocator figures under the JAX ``memory_stats()`` keys —
    the sweep's device-level ground truth and the ``/debug/memory``
    device section: ``bytes_in_use`` (``torch.cuda.memory_allocated``),
    ``peak_bytes_in_use`` (``max_memory_allocated``) and ``bytes_limit``
    (the card's total memory).  ``largest_alloc_size`` has no torch
    counterpart and is left out, as the JAX function leaves out keys its
    backend lacks.  Consults CUDA ONLY if this process already
    initialized it: a metrics scrape must never be the thing that
    creates a CUDA context.  ``[]`` on a host without one."""
    torch = sys.modules.get("torch")
    if torch is None:
        return []
    out: List[Dict[str, int]] = []
    try:
        if not torch.cuda.is_initialized():
            return []
        count = torch.cuda.device_count()
    except Exception:
        return []
    for d in range(count):
        try:
            entry: Dict[str, int] = {
                "device": d,
                "bytes_in_use": int(torch.cuda.memory_allocated(d)),
                "bytes_limit": int(
                    torch.cuda.get_device_properties(d).total_memory),
                "peak_bytes_in_use": int(
                    torch.cuda.max_memory_allocated(d)),
            }
        except Exception:
            continue
        out.append(entry)
    return out


class MemoryPool:
    """One registered pool: the subsystem's snapshot/reconcile hooks
    plus the ledger-side state (utilization ring, pressure level).
    Obtained from ``MemoryLedger.register``; ``close()`` drops exactly
    this registration (a replacement by a newer instance survives)."""

    __slots__ = ("name", "snapshot_fn", "reconcile_fn", "gauges",
                 "watermarks", "ring", "pressure", "_owner_ref",
                 "_ledger_ref", "__weakref__")

    def __init__(self, ledger: "MemoryLedger", name: str,
                 snapshot_fn: Callable[[], Dict],
                 reconcile_fn: Optional[Callable[[], List[str]]],
                 owner, gauges, watermarks, ring_capacity: int):
        self.name = name
        self.snapshot_fn = snapshot_fn
        self.reconcile_fn = reconcile_fn
        self.gauges = tuple(gauges or ())
        # sorted ascending so the level index == thresholds crossed
        self.watermarks = tuple(sorted(
            ((str(n), float(f)) for n, f in (watermarks or ())),
            key=lambda nf: nf[1]))
        self.ring: deque = deque(maxlen=int(ring_capacity))
        self.pressure = 0
        self._owner_ref = None if owner is None else weakref.ref(owner)
        self._ledger_ref = weakref.ref(ledger)

    @property
    def dead(self) -> bool:
        return self._owner_ref is not None and self._owner_ref() is None

    def level_name(self, level: Optional[int] = None) -> str:
        level = self.pressure if level is None else level
        return "ok" if level <= 0 else self.watermarks[level - 1][0]

    def close(self) -> None:
        led = self._ledger_ref()
        if led is not None:
            led.unregister(self)


class MemoryLedger:
    """The process-wide pool registry + sampler + leak sentinel."""

    def __init__(self, sample_interval_s: float = 0.25,
                 reconcile_interval_s: float = 1.0,
                 ring_capacity: int = 256,
                 confirm_delay_s: float = 0.02,
                 leak_dump_interval_s: float = 30.0):
        self.sample_interval_s = max(float(sample_interval_s), 0.005)
        self.reconcile_interval_s = max(float(reconcile_interval_s), 0.005)
        self.ring_capacity = int(ring_capacity)
        self.confirm_delay_s = float(confirm_delay_s)
        self.leak_dump_interval_s = float(leak_dump_interval_s)
        self._lock = threading.RLock()
        self._pools: Dict[str, MemoryPool] = {}
        self._pressure_cbs: List[Callable[[str, str, Dict], None]] = []
        #: pools currently in a confirmed-divergence episode: the
        #: mem_leak dump fires on the clean->diverged EDGE only, so a
        #: persistent leak produces exactly one dump (plus the counter
        #: every sweep) until it heals and re-leaks
        self._diverged: set = set()
        self.last_reconcile_ms: Optional[float] = None
        self._stop = threading.Event()
        self._sampler: Optional[threading.Thread] = None
        self._reconciler: Optional[threading.Thread] = None
        self._collector_registries: "weakref.WeakSet" = weakref.WeakSet()

    # ---- registration -----------------------------------------------------
    def register(self, name: str, snapshot_fn: Callable[[], Dict],
                 reconcile_fn: Optional[Callable[[], List[str]]] = None,
                 owner=None,
                 gauges: Sequence[Tuple[object, Callable[[Dict], float]]]
                 = (),
                 watermarks: Iterable[Tuple[str, float]]
                 = DEFAULT_WATERMARKS) -> MemoryPool:
        """Add (or replace) a pool.  ``owner`` is held by WEAK reference:
        when the owning subsystem is collected its pool drops out, so a
        test's discarded registry can never haunt the fleet snapshot.
        Re-registering a live name replaces it — one subsystem instance
        of each kind per process is the deployment shape; the latest
        instance wins a contended name (the health-gauge rule).

        ``gauges`` routes legacy byte gauges through the ledger: each
        ``(metric_handle, fn)`` pair is set to ``fn(pool_snapshot)`` at
        scrape time, making the ledger the series' ONLY producer."""
        pool = MemoryPool(self, name, snapshot_fn, reconcile_fn, owner,
                          gauges, watermarks, self.ring_capacity)
        with self._lock:
            if name in self._pools:
                logger.debug("memory pool %r re-registered (latest wins)",
                             name)
            self._pools[name] = pool
        self._ensure_collector()
        return pool

    def unregister(self, pool) -> None:
        """Drop a registration — by ``MemoryPool`` handle (no-op when a
        newer instance already replaced it) or by name."""
        name = pool.name if isinstance(pool, MemoryPool) else str(pool)
        with self._lock:
            cur = self._pools.get(name)
            if cur is None:
                return
            if isinstance(pool, MemoryPool) and cur is not pool:
                return
            del self._pools[name]
            self._diverged.discard(name)

    def pools(self) -> List[MemoryPool]:
        """Live pools (dead-owner registrations are reaped here)."""
        with self._lock:
            dead = [n for n, p in self._pools.items() if p.dead]
            for n in dead:
                del self._pools[n]
                self._diverged.discard(n)
            return list(self._pools.values())

    # ---- reading the books ------------------------------------------------
    def _pool_snapshot(self, pool: MemoryPool) -> Optional[Dict]:
        """One pool's contract dict, sanitized; None when the callback
        failed (a broken pool must not break the ledger)."""
        try:
            raw = pool.snapshot_fn() or {}
            snap = {k: int(raw.get(k, 0)) for k in POOL_KEYS}
            snap["owners"] = {str(k): int(v)
                              for k, v in (raw.get("owners") or {}).items()}
            return snap
        except (Exception, CancelledError):
            logger.exception("memory pool %r snapshot failed", pool.name)
            return None

    def snapshot(self, top_k: Optional[int] = None) -> Dict:
        """The fleet-mergeable process snapshot.  ``top_k`` keeps the K
        largest owners per pool and folds the tail into ``(other)`` —
        attribution still sums to used."""
        pools: Dict[str, Dict] = {}
        for pool in self.pools():
            snap = self._pool_snapshot(pool)
            if snap is None:
                continue
            snap["owners"] = _top_k_owners(snap["owners"], top_k)
            snap["pressure"] = pool.level_name(
                self._level_for(pool, snap))
            pools[pool.name] = snap
        return {"host": _HOST, "pid": os.getpid(), "ts": time.time(),
                "pools": pools, "devices": device_memory_stats()}

    def pressure_level(self, name: str) -> int:
        """A pool's CURRENT watermark level from a fresh snapshot (0 =
        ok / unknown pool) — the on-demand form backpressure callers
        poll (the retrain loop's defer-under-pressure check)."""
        with self._lock:
            pool = self._pools.get(name)
        if pool is None or pool.dead:
            return 0
        snap = self._pool_snapshot(pool)
        if snap is None:
            return 0
        return self._level_for(pool, snap)

    def _level_for(self, pool: MemoryPool, snap: Dict) -> int:
        cap = snap["capacity_bytes"]
        if cap <= 0:        # unbounded pools have no pressure notion
            return 0
        frac = snap["used_bytes"] / cap
        level = 0
        for _, threshold in pool.watermarks:
            if frac >= threshold:
                level += 1
        return level

    # ---- pressure watermarks ---------------------------------------------
    def on_pressure(self, cb: Callable[[str, str, Dict], None]) -> None:
        """``cb(pool_name, level_name, pool_snapshot)`` on every level
        TRANSITION, including recovery to ``"ok"``.  Called from the
        sampler (or a scrape); exceptions are swallowed and logged —
        a demotion hook must never hurt the sampling cadence."""
        with self._lock:
            self._pressure_cbs.append(cb)

    def _observe_pressure(self, pool: MemoryPool, snap: Dict) -> None:
        level = self._level_for(pool, snap)
        if level == pool.pressure:
            return
        pool.pressure = level
        name = pool.level_name(level)
        with self._lock:
            cbs = list(self._pressure_cbs)
        for cb in cbs:
            try:
                cb(pool.name, name, snap)
            except (Exception, CancelledError):
                logger.exception("on_pressure callback failed for pool "
                                 "%r", pool.name)

    # ---- sampler ----------------------------------------------------------
    def sample_once(self) -> int:
        """One utilization sample of every pool into its ring (+
        watermark evaluation); returns pools sampled."""
        m = _metrics()
        n = 0
        now = time.time()
        for pool in self.pools():
            snap = self._pool_snapshot(pool)
            if snap is None:
                continue
            pool.ring.append(
                (now, snap["used_bytes"], snap["pinned_bytes"]))
            self._observe_pressure(pool, snap)
            n += 1
        if n:
            m["ticks"].inc(n)
        return n

    def counter_events(self) -> List[Dict]:
        """The sampler rings as Perfetto counter-track samples for
        ``chrome_trace(..., counters=...)``: one ``mem:<pool>`` track
        with ``used_bytes``/``pinned_bytes`` series each."""
        out: List[Dict] = []
        for pool in self.pools():
            for ts, used, pinned in list(pool.ring):
                out.append({"name": f"mem:{pool.name}", "ts": ts,
                            "values": {"used_bytes": used,
                                       "pinned_bytes": pinned}})
        out.sort(key=lambda c: c["ts"])
        return out

    # ---- the leak sentinel ------------------------------------------------
    def _probe_pool(self, pool: MemoryPool) -> List[str]:
        """One read of a pool's divergence lines: the subsystem's own
        ground-truth check plus the uniform contract invariants."""
        lines: List[str] = []
        if pool.reconcile_fn is not None:
            lines.extend(str(x) for x in pool.reconcile_fn())
        snap = self._pool_snapshot(pool)
        if snap is not None:
            osum = sum(snap["owners"].values())
            if osum != snap["used_bytes"]:
                lines.append(f"owner attribution sums to {osum}B, books "
                             f"say {snap['used_bytes']}B used")
            for key in POOL_KEYS:
                if snap[key] < 0:
                    lines.append(f"{key} is negative: {snap[key]}")
            if (snap["capacity_bytes"] > 0
                    and snap["used_bytes"] > snap["capacity_bytes"]):
                lines.append(
                    f"used {snap['used_bytes']}B exceeds capacity "
                    f"{snap['capacity_bytes']}B")
        return lines

    def _reconcile_pool(self, pool: MemoryPool) -> List[str]:
        """Confirmed divergences only: a first-read divergence must
        REPRODUCE identically on a second read after a short settle —
        a snapshot racing live allocation (a block mid-adoption between
        the table walk and the refcount read) is not a leak, and a
        false ``mem_leak`` dump would teach operators to ignore the
        real ones."""
        first = self._probe_pool(pool)
        if not first:
            return []
        time.sleep(self.confirm_delay_s)
        second = self._probe_pool(pool)
        return sorted(set(first) & set(second))

    def reconcile_once(self) -> Dict[str, List[str]]:
        """One full sweep; returns ``{pool: divergence lines}`` for the
        pools whose books failed to reconcile."""
        from analytics_zoo_tpu_torch.testing import chaos
        m = _metrics()
        t0 = time.monotonic()
        # the injection point covers the whole sweep: a fault here must
        # abort THIS sweep with the books untouched — no divergence
        # verdict, no dump — and the next sweep reconciles exactly
        chaos.fire("mem_reconcile")
        failures: Dict[str, List[str]] = {}
        clean: List[str] = []
        for pool in self.pools():
            lines = self._reconcile_pool(pool)
            if lines:
                failures[pool.name] = lines
            else:
                clean.append(pool.name)
        for name, lines in failures.items():
            m["fail"].labels(pool=name).inc()
            with self._lock:
                fresh = name not in self._diverged
                self._diverged.add(name)
            if fresh:
                logger.error("memory ledger divergence in pool %r: %s",
                             name, "; ".join(lines))
                get_tracer().add_event("mem_leak", span=None, pool=name,
                                       lines=len(lines))
                self._trigger_leak_dump(name)
        sweep_ms = (time.monotonic() - t0) * 1e3
        with self._lock:
            for name in clean:
                self._diverged.discard(name)
            self.last_reconcile_ms = sweep_ms
        m["sweeps"].inc()
        m["sweep_s"].observe(sweep_ms / 1e3)
        return failures

    def _trigger_leak_dump(self, pool_name: str) -> None:
        from analytics_zoo_tpu_torch.observability import flight_recorder
        try:
            flight_recorder.get().trigger(
                "mem_leak", detail=pool_name,
                min_interval_s=self.leak_dump_interval_s)
        except (Exception, CancelledError):
            # the recorder swallows its own failures; this guards a
            # broken recorder OBJECT — the sweep must keep sweeping
            logger.exception("mem_leak flight dump failed for pool %r",
                             pool_name)

    def dump_section(self, top_k: int = 8) -> Dict:
        """The flight-recorder ``memory`` section: full snapshot with
        attribution, the sampler rings, and the sentinel state."""
        return {
            "snapshot": self.snapshot(top_k=top_k),
            "rings": {pool.name: [list(s) for s in pool.ring]
                      for pool in self.pools()},
            "diverged": sorted(self._diverged),
            "last_reconcile_ms": self.last_reconcile_ms,
        }

    # ---- background threads ----------------------------------------------
    def start(self) -> "MemoryLedger":
        """Arm the sampler + reconciler (idempotent while running)."""
        with self._lock:
            self._stop.clear()
            if self._sampler is None or not self._sampler.is_alive():
                self._sampler = threading.Thread(
                    target=self._sampler_run, name="zoo-mem-sampler",
                    daemon=True)
                self._sampler.start()
            if self._reconciler is None or not self._reconciler.is_alive():
                self._reconciler = threading.Thread(
                    target=self._reconciler_run,
                    name="zoo-mem-reconciler", daemon=True)
                self._reconciler.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        for t in (self._sampler, self._reconciler):
            if t is not None:
                t.join(timeout=timeout)

    @property
    def running(self) -> bool:
        return any(t is not None and t.is_alive()
                   for t in (self._sampler, self._reconciler))

    def _sampler_run(self) -> None:
        try:
            while not self._stop.wait(self.sample_interval_s):
                try:
                    self.sample_once()
                except (Exception, CancelledError):
                    # a broken pool callback (or a chaos cancel riding
                    # one) costs one tick, never the thread
                    logger.exception("memory sampler tick failed")
        except BaseException as exc:
            logger.exception("memory sampler thread died")
            get_tracer().add_event(
                "thread_death", span=None, thread="zoo-mem-sampler",
                error=f"{type(exc).__name__}: {exc}")
            raise

    def _reconciler_run(self) -> None:
        try:
            while not self._stop.wait(self.reconcile_interval_s):
                try:
                    self.reconcile_once()
                except (Exception, CancelledError):
                    # a chaos raise/cancel at the mem_reconcile point
                    # lands here: the sweep aborted before any verdict,
                    # the next interval sweeps again
                    logger.exception("memory reconcile sweep failed")
        except BaseException as exc:
            logger.exception("memory reconciler thread died")
            get_tracer().add_event(
                "thread_death", span=None, thread="zoo-mem-reconciler",
                error=f"{type(exc).__name__}: {exc}")
            raise

    # ---- pull-time gauge export -------------------------------------------
    def _ensure_collector(self) -> None:
        """ONE registry collector serves every pool (the health-gauge
        WeakSet discipline), declared against the CURRENT registry so
        ``set_registry()`` swaps pick the ledger up at first use."""
        reg = get_registry()
        if reg in self._collector_registries:
            return
        with self._lock:
            if reg in self._collector_registries:
                return
            self._collector_registries.add(reg)
        ledger_ref = weakref.ref(self)

        def _collect():
            led = ledger_ref()
            if led is None or _ledger is not led:
                return      # a reconfigured ledger retires this hook
            m = _metrics()
            for pool in led.pools():
                snap = led._pool_snapshot(pool)
                if snap is None:
                    continue
                m["capacity"].labels(pool=pool.name).set(
                    float(snap["capacity_bytes"]))
                m["used"].labels(pool=pool.name).set(
                    float(snap["used_bytes"]))
                m["pinned"].labels(pool=pool.name).set(
                    float(snap["pinned_bytes"]))
                m["blocks"].labels(pool=pool.name).set(
                    float(snap["blocks"]))
                led._observe_pressure(pool, snap)
                m["pressure"].labels(pool=pool.name).set(
                    float(pool.pressure))
                for handle, fn in pool.gauges:
                    try:
                        handle.set(float(fn(snap)))
                    except (Exception, CancelledError):
                        logger.exception(
                            "ledger gauge view failed for pool %r",
                            pool.name)

        reg.register_collector(_collect)


def _top_k_owners(owners: Dict[str, int],
                  top_k: Optional[int]) -> Dict[str, int]:
    if top_k is None or len(owners) <= top_k:
        return dict(owners)
    ranked = sorted(owners.items(), key=lambda kv: (-kv[1], kv[0]))
    out = dict(ranked[:top_k])
    out["(other)"] = sum(v for _, v in ranked[top_k:])
    return out


def merge_memory_snapshots(snaps: List[Dict],
                           top_k: Optional[int] = None) -> Dict:
    """Merge per-process ``MemoryLedger.snapshot()`` dicts into the
    fleet view.  The documented rules: ``capacity_bytes`` and
    ``pinned_bytes`` state per-host facts every co-hosted process
    reports independently (they share the physical device), so they
    merge by MAX per (host, pool) and SUM across hosts;
    ``used_bytes``/``blocks``/owner attribution sum everywhere.  A
    single-process fleet therefore merges to exactly its own view."""
    per_host: Dict[Tuple[str, str], Dict] = {}
    hosts = set()
    for snap in snaps:
        host = str(snap.get("host") or "?")
        hosts.add(host)
        for name, p in (snap.get("pools") or {}).items():
            agg = per_host.setdefault((host, name), {
                "capacity_bytes": 0, "used_bytes": 0, "pinned_bytes": 0,
                "blocks": 0, "owners": {}})
            agg["capacity_bytes"] = max(agg["capacity_bytes"],
                                        int(p.get("capacity_bytes", 0)))
            agg["pinned_bytes"] = max(agg["pinned_bytes"],
                                      int(p.get("pinned_bytes", 0)))
            agg["used_bytes"] += int(p.get("used_bytes", 0))
            agg["blocks"] += int(p.get("blocks", 0))
            for owner, nbytes in (p.get("owners") or {}).items():
                agg["owners"][owner] = (agg["owners"].get(owner, 0)
                                        + int(nbytes))
    pools: Dict[str, Dict] = {}
    for (_, name), agg in sorted(per_host.items()):
        tgt = pools.setdefault(name, {
            "capacity_bytes": 0, "used_bytes": 0, "pinned_bytes": 0,
            "blocks": 0, "owners": {}})
        for key in ("capacity_bytes", "used_bytes", "pinned_bytes",
                    "blocks"):
            tgt[key] += agg[key]
        for owner, nbytes in agg["owners"].items():
            tgt["owners"][owner] = tgt["owners"].get(owner, 0) + nbytes
    for p in pools.values():
        p["owners"] = _top_k_owners(p["owners"], top_k)
    return {"hosts": sorted(hosts), "processes": len(snaps),
            "pools": pools}


_ledger: Optional[MemoryLedger] = None
_ledger_lock = threading.Lock()


def get_ledger() -> MemoryLedger:
    """The process-default ledger (created lazily, threads NOT armed —
    ``start()`` is the explicit opt-in the bench/serving entry points
    make)."""
    global _ledger
    if _ledger is None:
        with _ledger_lock:
            if _ledger is None:
                _ledger = MemoryLedger()
    return _ledger


def configure(**kwargs) -> MemoryLedger:
    """Replace the process-default ledger (tests shrink the intervals;
    no args resets to defaults).  The previous ledger's threads are
    stopped and its pull collector retires itself."""
    global _ledger
    with _ledger_lock:
        prev = _ledger
        _ledger = MemoryLedger(**kwargs)
        if prev is not None:
            prev.stop(timeout=2.0)
        return _ledger
