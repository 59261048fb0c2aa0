"""Unified observability: metrics registry + trace spans + exposition.

A copy of ``analytics_zoo_tpu/observability/__init__.py`` (the port
cannot import it: every ``analytics_zoo_tpu`` import loads jax), with the
same names, metric families and defaults.  What differs:
``install_jax_compile_hook()`` keeps its name and returns ``False``, as
the JAX function does where ``jax.monitoring`` is missing; the port adds
no metric in its place.

One substrate for every layer's telemetry: the serving engine,
estimator train loop, orca front door, health monitor, timers and the
TensorBoard writers all record into the process-default
``MetricsRegistry`` / ``Tracer``, and one ``GET /metrics`` endpoint (or
``dump()``) exposes all of it in Prometheus text format.

Quick tour::

    from analytics_zoo_tpu_torch import observability as obs

    reqs = obs.counter("myapp_requests_total", "requests", ["route"])
    reqs.labels(route="/predict").inc()
    with obs.span("handle", route="/predict"):
        ...
    print(obs.dump())                      # Prometheus text
    obs.get_tracer().export(name="handle")  # JSON-ready span dicts

``set_enabled(False)`` turns every record call (metrics AND spans) into a
single flag check.
"""

from __future__ import annotations

from typing import Optional, Sequence

from analytics_zoo_tpu_torch.observability.exposition import (   # noqa: F401
    CONTENT_TYPE, dump, render, render_snapshot)
from analytics_zoo_tpu_torch.observability.metrics import (      # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, default_buckets,
    get_registry, set_registry)
from analytics_zoo_tpu_torch.observability.tracing import (      # noqa: F401
    Span, Tracer, add_event, chrome_trace, current_span,
    decode_trace_context, encode_trace_context, get_tracer,
    new_trace_context, span)
from analytics_zoo_tpu_torch.observability.flight_recorder import (  # noqa: F401
    FlightRecorder)
from analytics_zoo_tpu_torch.observability.flight_recorder import (  # noqa: F401
    configure as configure_flight_recorder)
from analytics_zoo_tpu_torch.observability.flight_recorder import (  # noqa: F401
    get as get_flight_recorder)
from analytics_zoo_tpu_torch.observability.memory import (       # noqa: F401
    MemoryLedger, MemoryPool, device_memory_stats,
    merge_memory_snapshots)
from analytics_zoo_tpu_torch.observability.memory import (       # noqa: F401
    configure as configure_memory_ledger)
from analytics_zoo_tpu_torch.observability.memory import (       # noqa: F401
    get_ledger as get_memory_ledger)

__all__ = [
    "CONTENT_TYPE", "Counter", "FlightRecorder", "Gauge", "Histogram",
    "MemoryLedger", "MemoryPool", "MetricsRegistry", "Span", "Tracer",
    "add_event", "chrome_trace", "configure_flight_recorder",
    "configure_memory_ledger", "counter", "current_span",
    "decode_trace_context", "default_buckets", "device_memory_stats",
    "dump", "encode_trace_context", "gauge", "get_flight_recorder",
    "get_memory_ledger", "get_registry", "get_tracer", "histogram",
    "install_health_gauges", "install_jax_compile_hook", "lazy_counter",
    "lazy_gauge", "lazy_histogram", "merge_memory_snapshots",
    "new_trace_context", "render", "render_snapshot", "set_enabled",
    "set_registry", "span",
]


# ---- default-registry declaration shorthands ----------------------------

def counter(name: str, help: str = "", labelnames: Sequence[str] = ()):
    return get_registry().counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames: Sequence[str] = ()):
    return get_registry().gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames: Sequence[str] = (),
              buckets: Optional[Sequence[float]] = None):
    return get_registry().histogram(name, help, labelnames, buckets)


def set_enabled(enabled: bool) -> None:
    """Master switch for the default registry AND tracer: disabled, every
    instrumentation point — metric records, spans, event journaling, and
    wire trace-context stamping — costs one attribute check."""
    get_registry().enabled = enabled
    get_tracer().enabled = enabled


class _LazyMetric:
    """Module-level metric handle that follows ``set_registry()``:
    resolves its family against the CURRENT default registry at each
    use (cached per registry object), so import-time instrumentation
    never writes into an orphaned registry after a swap."""

    __slots__ = ("_kind", "_args", "_kw", "_last")

    def __init__(self, kind: str, *args, **kw):
        self._kind = kind
        self._args = args
        self._kw = kw
        self._last = None

    def _fam(self):
        # identity-compare the cached registry: the hot path costs one
        # attribute read + `is` check, not a dict lookup
        reg = get_registry()
        last = self._last
        if last is not None and last[0] is reg:
            return last[1]
        fam = getattr(reg, self._kind)(*self._args, **self._kw)
        self._last = (reg, fam)
        return fam

    def __getattr__(self, name):
        return getattr(self._fam(), name)


def lazy_counter(name: str, help: str = "",
                 labelnames: Sequence[str] = ()) -> _LazyMetric:
    return _LazyMetric("counter", name, help, labelnames)


def lazy_gauge(name: str, help: str = "",
               labelnames: Sequence[str] = ()) -> _LazyMetric:
    return _LazyMetric("gauge", name, help, labelnames)


def lazy_histogram(name: str, help: str = "",
                   labelnames: Sequence[str] = (),
                   buckets: Optional[Sequence[float]] = None
                   ) -> _LazyMetric:
    return _LazyMetric("histogram", name, help, labelnames, buckets)


# ---- cross-subsystem integrations ---------------------------------------

import weakref as _weakref

_health_monitors: "_weakref.WeakSet" = _weakref.WeakSet()
_health_collector_state = {"registries": _weakref.WeakSet()}


def install_health_gauges(monitor) -> None:
    """Expose a ``HealthMonitor``'s device status as pull-time gauges:
    ``zoo_device_healthy{device=...}`` (1/0 per device, sampled from the
    monitor's last probe at scrape time) and ``zoo_health_probes``.
    Safe to call repeatedly; ONE registry collector serves every
    installed monitor through a WeakSet, so discarded monitors drop out
    instead of being kept alive by the registry (latest-probed monitor
    wins a contended device series)."""
    reg = get_registry()
    up = reg.gauge("zoo_device_healthy",
                   "1 if the device's last health probe succeeded",
                   ["device"])
    # gauge (it resets with its monitor), so no Prometheus-counter
    # ``_total`` suffix — TYPE-aware tooling lints that combination
    probes = reg.gauge("zoo_health_probes",
                       "health probes run by the current monitor")
    probes.set_function(lambda: _any_health_monitor_status().get(
        "probes", 0))
    healthy = reg.gauge("zoo_health_healthy",
                        "1 if every local device is healthy")
    healthy.set_function(
        lambda: 1.0 if _any_health_monitor_status().get("healthy", True)
        else 0.0)
    _health_monitors.add(monitor)
    if reg not in _health_collector_state["registries"]:
        _health_collector_state["registries"].add(reg)

        def _collect(up=up):
            for mon in list(_health_monitors):
                for dev, st in mon.status().get("devices", {}).items():
                    up.labels(device=dev).set(
                        1.0 if st.get("ok") else 0.0)

        reg.register_collector(_collect)


def _any_health_monitor_status() -> dict:
    """The most recently probed live monitor's status (empty if none)."""
    best: dict = {}
    for mon in list(_health_monitors):
        st = mon.status()
        if (st.get("last_probe_ts") or 0) >= (best.get("last_probe_ts")
                                              or 0):
            best = st
    return best


def install_jax_compile_hook() -> bool:
    """The JAX package routes ``jax.monitoring`` compile events into the
    registry here.  The port compiles no XLA program, so there is no
    listener to install: returns ``False``, as the JAX function does
    where ``jax.monitoring`` is missing."""
    return False
