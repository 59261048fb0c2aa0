"""Thread-safe metrics registry: Counter / Gauge / Histogram.

A copy of ``analytics_zoo_tpu/observability/metrics.py`` (the port cannot
import it: every ``analytics_zoo_tpu`` import loads jax), unchanged: the
same family names, label names and bucket layouts.

The unified telemetry substrate (ROADMAP: production-scale serving needs
per-request/per-step attribution; the reference surfaces only a TB
throughput curve).  Design goals, in order:

1. **Hot-path cheap.**  Counters and histograms accumulate into
   per-thread cells — ``inc()``/``observe()`` take NO lock after the
   first touch from a thread (CPython dict reads + ``+=`` on a cell the
   calling thread owns).  A registry-wide ``enabled`` flag turns every
   record call into one attribute check, so the instrumentation's cost
   can be read enabled-vs-disabled.
2. **Prometheus-shaped.**  Families carry a name/help/kind and optional
   label names; ``labels(...)`` returns a cached child series.  Histograms
   use FIXED log-spaced buckets by default (0.1ms .. ~200s upper bounds)
   so latency series from different processes aggregate exactly.
3. **Pull-model friendly.**  ``snapshot()`` is the structured API;
   ``exposition.render`` (and ``GET /metrics`` on the serving frontend)
   produce the text format.  ``register_collector`` runs callbacks at
   snapshot time for gauges that must be sampled lazily (queue depths,
   device health).
"""

from __future__ import annotations

import re
import threading
from bisect import bisect_left
from threading import get_ident
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "default_buckets", "get_registry", "set_registry",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def default_buckets(start: float = 1e-4, factor: float = 2.0,
                    count: int = 22) -> Tuple[float, ...]:
    """Fixed log-spaced upper bounds: ``start * factor**i``.  The default
    spans 0.1ms .. ~210s — wide enough for dispatch latencies and whole
    train epochs on one shared scale."""
    return tuple(start * factor ** i for i in range(count))


class _Cell:
    """Per-thread accumulation cell; only its owning thread writes it."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class _HistCell:
    __slots__ = ("counts", "total")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.total = 0.0


class _Series:
    """Base child: one labeled series of a family."""

    __slots__ = ("_family", "_lock", "labelvalues")

    def __init__(self, family, labelvalues: Tuple[str, ...]):
        self._family = family
        self._lock = threading.Lock()
        self.labelvalues = labelvalues


class Counter(_Series):
    """Monotonic counter.  ``inc()`` is lock-free per thread."""

    __slots__ = ("_cells",)

    def __init__(self, family, labelvalues):
        super().__init__(family, labelvalues)
        self._cells: Dict[int, _Cell] = {}

    def inc(self, amount: float = 1.0) -> None:
        if not self._family.registry.enabled:
            return
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        tid = get_ident()
        cell = self._cells.get(tid)
        if cell is None:
            with self._lock:
                cell = self._cells.setdefault(tid, _Cell())
        cell.value += amount

    @property
    def value(self) -> float:
        return sum(c.value for c in list(self._cells.values()))


class Gauge(_Series):
    """Last-write-wins value; ``set()`` is a single atomic assignment.
    ``set_function`` makes the gauge pull-time: the callable is sampled
    at every snapshot/render (queue depths, device health)."""

    __slots__ = ("_value", "_fn")

    def __init__(self, family, labelvalues):
        super().__init__(family, labelvalues)
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        if self._family.registry.enabled:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not self._family.registry.enabled:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_function(self, fn: Optional[Callable[[], float]]) -> "Gauge":
        """``None`` detaches a previous callable (the gauge falls back to
        its last ``set()`` value) — owners of short-lived resources must
        detach on teardown or the registry pins them alive."""
        self._fn = fn
        return self

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return float("nan")
        return self._value


class Histogram(_Series):
    """Fixed-bucket histogram; ``observe()`` is lock-free per thread."""

    __slots__ = ("_cells", "buckets")

    def __init__(self, family, labelvalues):
        super().__init__(family, labelvalues)
        self.buckets: Tuple[float, ...] = family.buckets
        self._cells: Dict[int, _HistCell] = {}

    def observe(self, value: float) -> None:
        if not self._family.registry.enabled:
            return
        tid = get_ident()
        cell = self._cells.get(tid)
        if cell is None:
            with self._lock:
                cell = self._cells.setdefault(
                    tid, _HistCell(len(self.buckets) + 1))
        # le-inclusive Prometheus semantics: first bound >= value
        cell.counts[bisect_left(self.buckets, value)] += 1
        cell.total += value

    def snapshot(self) -> Dict:
        """``{"buckets": [(le, cumulative_count), ...], "sum": s,
        "count": n}`` — cumulative, with the +Inf bucket last."""
        per = [0] * (len(self.buckets) + 1)
        total = 0.0
        for cell in list(self._cells.values()):
            for i, c in enumerate(cell.counts):
                per[i] += c
            total += cell.total
        cum, acc = [], 0
        for bound, c in zip(list(self.buckets) + [float("inf")], per):
            acc += c
            cum.append((bound, acc))
        return {"buckets": cum, "sum": total, "count": acc}

    @property
    def count(self) -> int:
        return self.snapshot()["count"]

    @property
    def sum(self) -> float:
        return self.snapshot()["sum"]


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _MetricFamily:
    """name + kind + label names; children cached per label-value tuple.
    A label-less family owns a single anonymous child and proxies the
    record methods straight to it."""

    def __init__(self, registry: "MetricsRegistry", kind: str, name: str,
                 help: str, labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.registry = registry
        self.kind = kind
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        if kind == "histogram":
            b = tuple(buckets) if buckets is not None else default_buckets()
            if list(b) != sorted(b) or len(set(b)) != len(b):
                raise ValueError("histogram buckets must be strictly "
                                 f"increasing, got {b}")
            self.buckets = b
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Series] = {}
        if not self.labelnames:
            self._default = self._make(())

    def _make(self, values: Tuple[str, ...]) -> _Series:
        child = _KINDS[self.kind](self, values)
        self._children[values] = child
        return child

    def labels(self, *values, **kv) -> _Series:
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "name, not both")
            try:
                values = tuple(kv[ln] for ln in self.labelnames)
            except KeyError as e:
                raise ValueError(f"missing label {e} for {self.name}") \
                    from None
            if len(kv) != len(self.labelnames):
                raise ValueError(
                    f"unexpected labels {sorted(set(kv) - set(self.labelnames))}"
                    f" for {self.name}")
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name} takes labels "
                             f"{self.labelnames}, got {values}")
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.get(values) or self._make(values)
        return child

    # ---- label-less convenience proxies ----------------------------------
    def _one(self) -> _Series:
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled "
                             f"{self.labelnames}; call .labels(...) first")
        return self._default

    def inc(self, amount: float = 1.0) -> None:
        self._one().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._one().dec(amount)

    def set(self, value: float) -> None:
        self._one().set(value)

    def set_function(self, fn: Callable[[], float]):
        return self._one().set_function(fn)

    def observe(self, value: float) -> None:
        self._one().observe(value)

    @property
    def value(self):
        return self._one().value

    @property
    def count(self):
        return self._one().count

    def children(self) -> List[_Series]:
        return list(self._children.values())


class MetricsRegistry:
    """Get-or-create metric families; snapshot + collector hooks.

    Re-declaring an existing name with the same kind returns the SAME
    family (instrument sites in different modules share series); a kind
    or label mismatch raises — silent divergence would split series."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._families: Dict[str, _MetricFamily] = {}
        self._collectors: List[Callable[[], None]] = []

    # ---- declaration ------------------------------------------------------
    def _family(self, kind: str, name: str, help: str,
                labelnames: Sequence[str] = (),
                buckets: Optional[Sequence[float]] = None) -> _MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}, not {kind}")
                if tuple(labelnames) != fam.labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{fam.labelnames}, not {tuple(labelnames)}")
                if (kind == "histogram" and buckets is not None
                        and tuple(buckets) != fam.buckets):
                    # an explicit re-declaration with DIFFERENT buckets
                    # would silently land observations in bounds the
                    # caller never asked for; None means "whatever the
                    # family already uses"
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {fam.buckets}, not {tuple(buckets)}")
                return fam
            fam = _MetricFamily(self, kind, name, help, labelnames,
                                buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> _MetricFamily:
        return self._family("counter", name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> _MetricFamily:
        return self._family("gauge", name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None
                  ) -> _MetricFamily:
        return self._family("histogram", name, help, labelnames, buckets)

    def register_collector(self, fn: Callable[[], None]) -> None:
        """``fn()`` runs before every snapshot/render — the place to
        refresh push-style gauges that are expensive to keep current."""
        with self._lock:
            self._collectors.append(fn)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._families.pop(name, None)

    def families(self) -> List[_MetricFamily]:
        with self._lock:
            return list(self._families.values())

    # ---- read side --------------------------------------------------------
    def collect(self) -> None:
        for fn in list(self._collectors):
            try:
                fn()
            except Exception:
                pass  # a broken collector must not break exposition

    def snapshot(self) -> Dict[str, Dict]:
        """``{name: {"kind", "help", "series": {labeltuple: value}}}``;
        histogram series values are their ``snapshot()`` dicts."""
        self.collect()
        out: Dict[str, Dict] = {}
        for fam in self.families():
            series = {}
            for child in fam.children():
                key = tuple(zip(fam.labelnames, child.labelvalues))
                series[key] = (child.snapshot()
                               if fam.kind == "histogram" else child.value)
            out[fam.name] = {"kind": fam.kind, "help": fam.help,
                             "series": series}
        return out


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry every built-in instrumentation
    point records into (and ``GET /metrics`` exposes)."""
    return _default_registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process default (tests); returns the previous one."""
    global _default_registry
    prev = _default_registry
    _default_registry = registry
    return prev
