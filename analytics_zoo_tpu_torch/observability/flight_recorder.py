"""Failure flight recorder — the serving stack's black box.

A copy of ``analytics_zoo_tpu/observability/flight_recorder.py``,
unchanged but for its imports: the same dump keys, file names, cap and
rate limit.  Its default directory is the JAX copy's
(``zoo-flightrecorder-<pid>`` under the temp dir), so a process that
loads both packages should give each recorder a directory of its own.

A breaker opening, a sustained-overload shed, a chaos fault or a dying
worker thread used to leave only aggregate counters behind; by the time
someone looks, the span ring has rolled and the moment is gone.  The
flight recorder captures that moment AT the trigger: an atomic on-disk
JSON dump of

- the ACTIVE span of the triggering thread (the faulted span, unfinished,
  with its injection/failure events attached),
- the recent span ring (``Tracer.export``) and event journal
  (``Tracer.export_events``),
- a full metrics snapshot of the default registry,

capped at ``max_dumps`` most recent files (oldest evicted), each written
tmp-then-rename so a reader never sees a torn dump.  Triggers are wired
into the resilience layer (breaker→open), the serving engine (overload
latch, worker-thread death) and the chaos harness (every injected
fault); ``GET /debug/flightrecorder`` on the serving frontend lists and
serves dumps.  Every dump counts into
``zoo_flightrecorder_dumps_total{trigger}``.

A trigger must never hurt the path that fired it: dump failures (full
disk, unwritable dir) are swallowed and logged, and per-reason
``min_interval_s`` rate-limits flapping triggers (the engine passes 5 s
for the overload latch).
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import re
import tempfile
import threading
import time
from typing import Dict, List, Optional

from analytics_zoo_tpu_torch.observability import tracing
from analytics_zoo_tpu_torch.observability.metrics import get_registry

__all__ = ["FlightRecorder", "configure", "get"]

logger = logging.getLogger("analytics_zoo_tpu_torch.flightrecorder")

_PREFIX = "flight_"
_SAFE_RE = re.compile(r"[^a-zA-Z0-9_.-]+")


def _m_dumps():
    return get_registry().counter(
        "zoo_flightrecorder_dumps_total",
        "flight-recorder dumps written, by trigger", ["trigger"])


def _finite(v):
    """Non-finite floats as their Prometheus text strings: strict JSON
    has no Infinity/NaN literals, and the dump (and its HTTP serving)
    must parse in any tooling, not just Python's lenient json."""
    if isinstance(v, float) and (v != v or v in (float("inf"),
                                                 float("-inf"))):
        return "NaN" if v != v else ("+Inf" if v > 0 else "-Inf")
    return v


def _jsonable_snapshot(reg) -> Dict:
    """``MetricsRegistry.snapshot()`` with JSON-able series keys (the
    snapshot keys are label tuples) and strictly-JSON values (the
    histogram +Inf bucket bound, NaN gauges)."""
    out = {}
    for name, fam in reg.snapshot().items():
        series = []
        for key, val in fam["series"].items():
            if isinstance(val, dict) and "buckets" in val:
                val = {**val, "sum": _finite(val.get("sum")),
                       "buckets": [[_finite(le), c]
                                   for le, c in val["buckets"]]}
            else:
                val = _finite(val)
            series.append({"labels": dict(key), "value": val})
        out[name] = {"kind": fam["kind"], "help": fam["help"],
                     "series": series}
    return out


def _memory_section() -> Optional[Dict]:
    """The memory ledger's forensics section: every dump —
    breaker-open, overload latch, kv_exhausted, chaos fault, thread
    death — ships capacity context.  Imported lazily (the ledger
    imports nothing from here at module level, but the dump path must
    not order-couple the two) and guarded: a broken pool callback must
    never cost the dump that was trying to explain it."""
    try:
        from analytics_zoo_tpu_torch.observability import memory
        return memory.get_ledger().dump_section()
    except Exception:
        logger.exception("memory section failed; dumping without it")
        return None


class FlightRecorder:
    """Bounded black box: ``trigger()`` snapshots spans + events +
    metrics to one capped dump directory.  Thread-safe (triggers arrive
    from breaker callers, the engine reader, chaos'd stage threads)."""

    def __init__(self, dir: Optional[str] = None, max_dumps: int = 8,
                 span_limit: int = 512, event_limit: int = 256,
                 enabled: bool = True):
        # pid-scoped default: concurrent test/serving processes must not
        # evict each other's dumps
        self.dir = dir or os.path.join(
            tempfile.gettempdir(), f"zoo-flightrecorder-{os.getpid()}")
        self.max_dumps = max(1, int(max_dumps))
        self.span_limit = span_limit
        self.event_limit = event_limit
        self.enabled = enabled
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._last: Dict[tuple, float] = {}

    # ---- write side -------------------------------------------------------
    def trigger(self, reason: str, detail: Optional[str] = None,
                min_interval_s: float = 0.0) -> Optional[str]:
        """Snapshot now; returns the dump path (None when disabled,
        rate-limited, or the write failed — a full disk must never take
        down the serving thread that tripped the trigger)."""
        if not self.enabled:
            return None
        now = time.monotonic()
        # rate-limit key includes the detail: two DIFFERENT breakers
        # opening back to back both deserve their dump; the same one
        # flapping does not
        key = (reason, detail)
        with self._lock:
            if (min_interval_s
                    and now - self._last.get(key, -1e9) < min_interval_s):
                return None
            self._last[key] = now
            try:
                path = self._dump_locked(reason, detail)
            except Exception:
                logger.exception("flight-recorder dump failed (%s)", reason)
                return None
        try:
            _m_dumps().labels(trigger=reason).inc()
        except Exception:
            # same contract as the dump write: a broken/mismatched
            # registry must never hurt the path that tripped the trigger
            logger.exception("flight-recorder counter failed (%s)", reason)
        return path

    def _dump_locked(self, reason: str, detail: Optional[str]) -> str:
        tr = tracing.get_tracer()
        cur = tr.current()
        dump = {
            "reason": reason,
            "detail": detail,
            "ts": time.time(),
            # the triggering thread's live span: for a chaos fault this
            # IS the faulted span, events included, before it unwinds
            "active_span": cur.to_dict() if cur is not None else None,
            "spans": tr.export(limit=self.span_limit),
            "events": tr.export_events(limit=self.event_limit),
            "metrics": _jsonable_snapshot(get_registry()),
            "memory": _memory_section(),
        }
        os.makedirs(self.dir, exist_ok=True)
        # zero-padded ns timestamp + seq: lexicographic order == dump
        # order, so eviction and listing need no stat calls
        fname = (f"{_PREFIX}{time.time_ns():020d}_{next(self._seq):04d}_"
                 f"{_SAFE_RE.sub('-', reason)[:40]}.json")
        path = os.path.join(self.dir, fname)
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as fh:
                # allow_nan=False: a non-finite value sneaking in (a new
                # metric shape) must fail HERE, loudly, not produce a
                # dump that strict parsers reject
                json.dump(dump, fh, allow_nan=False)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)    # no orphaned .tmp litter on failure
            except OSError:
                pass
            raise
        for old in self._files()[:-self.max_dumps]:
            try:
                os.unlink(os.path.join(self.dir, old))
            except OSError:
                pass
        return path

    # ---- read side --------------------------------------------------------
    def _files(self) -> List[str]:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        return sorted(n for n in names
                      if n.startswith(_PREFIX) and n.endswith(".json"))

    def list_dumps(self) -> List[Dict]:
        """Oldest-first dump metadata (no file contents)."""
        out = []
        for name in self._files():
            parts = name[len(_PREFIX):-len(".json")].split("_", 2)
            try:
                ts = int(parts[0]) / 1e9
            except (ValueError, IndexError):
                ts = None
            try:
                size = os.path.getsize(os.path.join(self.dir, name))
            except OSError:
                continue
            out.append({"file": name, "ts": ts,
                        "reason": parts[2] if len(parts) > 2 else "?",
                        "bytes": size})
        return out

    def read_dump(self, name: str) -> Dict:
        """Load one dump by its listed basename.  Only names the listing
        produces resolve — a path with separators (traversal) raises."""
        if name != os.path.basename(name) or name not in self._files():
            raise KeyError(f"no such flight-recorder dump: {name!r}")
        with open(os.path.join(self.dir, name)) as fh:
            return json.load(fh)


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def get() -> FlightRecorder:
    """The process-default recorder (created lazily)."""
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def configure(**kwargs) -> FlightRecorder:
    """Replace the process-default recorder (tests point it at a tmp
    dir; servers at a persistent one).  ``configure()`` with no args
    resets to defaults."""
    global _recorder
    with _recorder_lock:
        _recorder = FlightRecorder(**kwargs)
        return _recorder
