"""Lightweight trace spans with context propagation.

A copy of ``analytics_zoo_tpu/observability/tracing.py``, unchanged but
for its imports: the wire trace context is byte-identical, so a
``trace_ctx`` or ``X-Zoo-Trace`` that one package stamps decodes in the
other, and ``chrome_trace`` gives the same JSON for the same spans.

The per-request/per-step attribution story the metrics registry cannot
tell: WHERE inside the serving queue→batch→dispatch→sink pipeline (or the
estimator's step loop) the time went.  Deliberately small:

- ``span("dispatch", batch=32)`` is a context manager; nesting on one
  thread links parent/child automatically via a ``contextvars``
  ContextVar.  Across threads (every serving stage runs on its own
  thread) the parent is handed over EXPLICITLY: capture ``current()`` (or
  a span id) on the producer side and pass ``span(..., parent=...)`` on
  the consumer side — the engine threads its dispatch span id through the
  pending queue this way.
- Across PROCESSES the parent rides the wire as a compact trace context
  (``encode_trace_context`` / ``decode_trace_context``: the
  ``trace_ctx`` stream field and the ``X-Zoo-Trace`` HTTP header, stamped
  the same way ``deadline_ts`` is).  A decoded ``(trace_id, span_id)``
  pair is a valid ``parent=`` — the receiving side's spans join the
  sender's trace instead of rooting a new one.
- Spans carry timestamped EVENTS (``add_event``): the resilience layer
  journals sheds/expiries/breaker transitions and the chaos harness its
  injections onto the active span, so a fault is visible INSIDE the
  trace it hit.  Every event also lands in a bounded tracer-wide journal
  (the flight recorder's "recent events" source) and counts into
  ``zoo_trace_events_total{kind}``.
- Finished spans land in a fixed-capacity ring buffer (old spans fall
  off; tracing never grows without bound on a long-lived server) and
  export as plain dicts (JSON-ready) via ``export()`` — filterable by
  name AND by ``trace_id``, so one request's spans can be pulled without
  client-side scanning.  ``chrome_trace()`` converts exported spans to
  ``chrome://tracing`` / Perfetto JSON.
- Durations are MONOTONIC (``perf_counter``): ``start``/``end`` stay
  wall-clock for export alignment, but ``duration_ms`` survives a
  wall-clock step (NTP slew mid-span used to yield negative durations).
- ``enabled=False`` reduces ``span(...)``/``add_event(...)`` to one flag
  check + a no-op, keeping the overhead contract.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import random
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

__all__ = [
    "Span", "Tracer", "add_event", "chrome_trace", "current_span",
    "decode_trace_context", "encode_trace_context", "get_tracer",
    "new_trace_context", "span",
]

#: a cross-thread/cross-process parent reference: (trace_id, parent span
#: id); span id 0 means "member of this trace, but no parent span"
TraceRef = Tuple[int, int]

#: sentinel distinguishing "attach to the current span" from an explicit
#: ``span=None`` ("journal only") in ``add_event``
_CURRENT = object()


def _event_counter():
    """``zoo_trace_events_total{kind}`` against the CURRENT default
    registry (events are rare — sheds, faults, breaker flips — so the
    per-call family lookup is fine and survives ``set_registry`` swaps).
    Imported lazily: metrics never imports tracing, so no cycle."""
    from analytics_zoo_tpu_torch.observability.metrics import get_registry
    return get_registry().counter(
        "zoo_trace_events_total",
        "span/journal events recorded, by kind", ["kind"])


class Span:
    __slots__ = ("name", "span_id", "parent_id", "trace_id", "start",
                 "end", "attrs", "error", "events", "tid",
                 "_start_mono", "_dur_s")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 trace_id: int, attrs: Dict):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.trace_id = trace_id
        self.start = time.time()
        self._start_mono = time.perf_counter()
        self.end: Optional[float] = None
        self._dur_s: Optional[float] = None
        self.attrs = attrs
        self.error: Optional[str] = None
        self.events: Optional[List] = None   # lazily created
        self.tid = threading.get_ident()

    @property
    def duration_ms(self) -> Optional[float]:
        """Monotonic duration: immune to wall-clock steps mid-span."""
        return None if self._dur_s is None else 1e3 * self._dur_s

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def add_event(self, name: str, **attrs) -> "Span":
        """Append a timestamped event to THIS span only.  Most callers
        want the module-level ``add_event`` (current span + journal +
        counter); this is the building block it uses."""
        if self.events is None:
            self.events = []
        self.events.append([time.time(), name, attrs])
        return self

    def to_dict(self) -> Dict:
        return {
            "name": self.name, "span_id": self.span_id,
            "parent_id": self.parent_id, "trace_id": self.trace_id,
            "start": self.start, "end": self.end,
            "duration_ms": self.duration_ms, "tid": self.tid,
            **({"error": self.error} if self.error else {}),
            **({"attrs": self.attrs} if self.attrs else {}),
            **({"events": self.events} if self.events else {}),
        }


class Tracer:
    """Span factory + ring buffer.  Thread-safe: ids come from an atomic
    counter, the deque append is atomic, and the active-span context is a
    ContextVar (per-thread/per-task)."""

    def __init__(self, capacity: int = 2048, enabled: bool = True,
                 event_capacity: int = 1024):
        self.enabled = enabled
        self._buf: deque = deque(maxlen=capacity)
        self._events: deque = deque(maxlen=event_capacity)
        self._ids = itertools.count(1)
        self._active: contextvars.ContextVar = contextvars.ContextVar(
            "zoo_active_span", default=None)
        self._lock = threading.Lock()
        # span_id -> trace_id for recent spans, so a BARE id handed
        # across threads still attaches the child to the parent's real
        # trace even when the parent is itself a nested span
        self._trace_ids: "OrderedDict[int, int]" = OrderedDict()
        self._trace_ids_cap = 4 * capacity

    # ---- recording --------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str,
             parent: Union["Span", TraceRef, int, None] = None,
             **attrs) -> Iterator[Optional[Span]]:
        if not self.enabled:
            yield None
            return
        if parent is None:
            parent = self._active.get()
        if isinstance(parent, Span):
            parent_id, trace_id = parent.span_id, parent.trace_id
        elif isinstance(parent, tuple):   # wire context (trace_id, span_id)
            trace_id = int(parent[0])
            parent_id = int(parent[1]) or None
        elif parent is not None:          # bare id handed across threads
            parent_id = int(parent)
            trace_id = self._trace_ids.get(parent_id, parent_id)
        else:
            parent_id, trace_id = None, None
        s = Span(name, next(self._ids), parent_id,
                 trace_id if trace_id is not None else 0, attrs)
        if trace_id is None:
            s.trace_id = s.span_id        # root: the trace is named by it
        with self._lock:
            self._trace_ids[s.span_id] = s.trace_id
            while len(self._trace_ids) > self._trace_ids_cap:
                self._trace_ids.popitem(last=False)
        token = self._active.set(s)
        try:
            yield s
        except BaseException as exc:
            s.error = f"{type(exc).__name__}: {exc}"
            raise
        finally:
            self._active.reset(token)
            dur = time.perf_counter() - s._start_mono
            s._dur_s = dur
            # wall end derived from the monotonic duration: a wall-clock
            # step mid-span shifts neither duration nor span extent
            s.end = s.start + dur
            self._buf.append(s)

    def reseed_ids(self, base: int) -> None:
        """Restart the span-id counter at ``base``.  Fleet worker and
        replica processes (forked: they inherit the parent's counter
        position) reseed into disjoint per-process ranges so span ids —
        and the parent links between them — stay unambiguous when one
        trace's spans from several processes are merged into one view
        (docs/serving.md fleet tier)."""
        self._ids = itertools.count(max(int(base), 1))

    def current(self) -> Optional[Span]:
        return self._active.get()

    def add_event(self, kind: str, span=_CURRENT,
                  trace_id: Optional[int] = None, **attrs) -> Optional[Dict]:
        """Journal one event: attached to ``span`` (default: the calling
        context's active span) when there is one, and ALWAYS appended to
        the tracer-wide bounded journal + counted into
        ``zoo_trace_events_total{kind}``.  ``span=None`` journals
        without attaching (reader-thread sheds, breaker flips on idle
        threads); an explicit ``trace_id`` tags such an event with the
        request trace it concerns.  One flag check when disabled."""
        if not self.enabled:
            return None
        if span is _CURRENT:
            span = self._active.get()
        ts = time.time()
        sid = None
        if span is not None:
            if span.events is None:
                span.events = []
            span.events.append([ts, kind, attrs])
            sid, trace_id = span.span_id, span.trace_id
        rec = {"ts": ts, "kind": kind, "span_id": sid,
               "trace_id": trace_id,
               **({"attrs": attrs} if attrs else {})}
        self._events.append(rec)
        try:
            _event_counter().labels(kind=kind).inc()
        except Exception:
            pass   # a broken registry must not break the journal
        return rec

    # ---- read side --------------------------------------------------------
    def export(self, name: Optional[str] = None,
               limit: Optional[int] = None,
               trace_id: Optional[int] = None) -> List[Dict]:
        """Finished spans as JSON-ready dicts, oldest first; optionally
        filtered by span name and/or ``trace_id`` and capped to the most
        recent ``limit`` (non-positive limits mean "no cap")."""
        spans = [s.to_dict() for s in list(self._buf)
                 if (name is None or s.name == name)
                 and (trace_id is None or s.trace_id == trace_id)]
        return spans[-limit:] if limit and limit > 0 else spans

    def export_events(self, limit: Optional[int] = None,
                      trace_id: Optional[int] = None) -> List[Dict]:
        """The tracer-wide event journal, oldest first."""
        evs = [e for e in list(self._events)
               if trace_id is None or e.get("trace_id") == trace_id]
        return evs[-limit:] if limit and limit > 0 else evs

    def clear(self) -> None:
        self._buf.clear()
        self._events.clear()
        with self._lock:
            self._trace_ids.clear()

    def __len__(self) -> int:
        return len(self._buf)


# ---- wire trace context ---------------------------------------------------

def encode_trace_context(ref: Union[Span, TraceRef]) -> str:
    """``"<trace_id>-<span_id>"`` — the compact wire form stamped on the
    serving stream (``trace_ctx`` field) and the ``X-Zoo-Trace`` HTTP
    header, the same way ``deadline_ts`` rides the wire."""
    if isinstance(ref, Span):
        return f"{ref.trace_id}-{ref.span_id}"
    return f"{int(ref[0])}-{int(ref[1])}"


def decode_trace_context(value) -> Optional[TraceRef]:
    """Inverse of ``encode_trace_context``; ``None``/malformed decode to
    ``None`` (an unparsable stamp must never fail the request carrying
    it — the trace just roots locally)."""
    if not value:
        return None
    head, _, tail = str(value).partition("-")
    try:
        return (int(head), int(tail))
    except ValueError:
        return None


def new_trace_context() -> TraceRef:
    """A fresh parentless trace reference for requests entering the wire
    with no active span.  Trace ids are random 63-bit with the 2^62 bit
    forced on, so wire-minted ids never collide with the small
    counter-assigned ids of locally rooted spans (and are collision-safe
    across client processes without coordination)."""
    return (random.getrandbits(62) | (1 << 62), 0)


# ---- Chrome-trace / Perfetto export ---------------------------------------

def chrome_trace(spans: Sequence[Dict],
                 events: Sequence[Dict] = (),
                 counters: Sequence[Dict] = ()) -> Dict:
    """Exported span dicts (``Tracer.export``) as ``chrome://tracing`` /
    Perfetto JSON: one complete ("X") event per span — ``pid`` is the
    trace, ``tid`` the recording thread, timestamps in µs — plus instant
    ("i") events for span events and journal entries.

    Traces map to SMALL sequential pids (named via process_name
    metadata), never the raw trace id: wire-minted ids are >= 2^62 and a
    JS/double-based viewer would silently round them — the real id rides
    ``args.trace_id`` as a string instead.  Journal entries duplicating
    a span-attached event (``add_event`` writes both) are emitted once,
    from the span.

    ``counters`` are ``{"name", "ts", "values": {series: number}}``
    samples (``MemoryLedger.counter_events``) emitted as Perfetto
    counter ("C") tracks on the reserved pid 0 — the trace pids start
    at 1, so the memory tracks render as their own process lane."""
    pids: Dict = {}

    def pid_of(trace_id):
        pid = pids.get(trace_id)
        if pid is None:
            pid = pids[trace_id] = len(pids) + 1
        return pid

    out = []
    for s in spans:
        args = {"span_id": s.get("span_id"),
                "parent_id": s.get("parent_id"),
                "trace_id": str(s.get("trace_id", 0))}
        args.update(s.get("attrs") or {})
        if s.get("error"):
            args["error"] = s["error"]
        pid = pid_of(s.get("trace_id", 0))
        out.append({
            "name": s.get("name", "?"), "ph": "X", "cat": "zoo",
            "ts": round(float(s.get("start", 0.0)) * 1e6, 3),
            "dur": round(float(s.get("duration_ms") or 0.0) * 1e3, 3),
            "pid": pid, "tid": s.get("tid", 0),
            "args": args,
        })
        for ts, name, attrs in s.get("events", ()):
            out.append({
                "name": name, "ph": "i", "s": "t", "cat": "zoo.event",
                "ts": round(float(ts) * 1e6, 3),
                "pid": pid, "tid": s.get("tid", 0),
                "args": dict(attrs or {}),
            })
    span_ids = {s.get("span_id") for s in spans}
    for e in events:
        if e.get("span_id") in span_ids:
            continue   # already emitted inline from its span's events
        out.append({
            "name": e.get("kind", "?"), "ph": "i", "s": "g",
            "cat": "zoo.journal",
            "ts": round(float(e.get("ts", 0.0)) * 1e6, 3),
            "pid": pid_of(e.get("trace_id") or 0), "tid": 0,
            "args": {**(e.get("attrs") or {}),
                     "trace_id": str(e.get("trace_id") or 0)},
        })
    for c in counters:
        out.append({
            "name": c.get("name", "mem"), "ph": "C", "cat": "zoo.memory",
            "ts": round(float(c.get("ts", 0.0)) * 1e6, 3),
            "pid": 0, "tid": 0,
            "args": {k: float(v)
                     for k, v in (c.get("values") or {}).items()},
        })
    meta = [{"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": f"trace {trace_id}"}}
            for trace_id, pid in pids.items()]
    if counters:
        meta.append({"name": "process_name", "ph": "M", "pid": 0,
                     "args": {"name": "memory"}})
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


_default_tracer = Tracer()


def get_tracer() -> Tracer:
    return _default_tracer


def span(name: str, parent: Union[Span, TraceRef, int, None] = None,
         **attrs):
    """``with span("dispatch", batch=n) as s:`` on the default tracer."""
    return _default_tracer.span(name, parent=parent, **attrs)


def current_span() -> Optional[Span]:
    return _default_tracer.current()


def add_event(kind: str, span=_CURRENT, trace_id: Optional[int] = None,
              **attrs) -> Optional[Dict]:
    """``Tracer.add_event`` on the default tracer."""
    return _default_tracer.add_event(kind, span=span, trace_id=trace_id,
                                     **attrs)
