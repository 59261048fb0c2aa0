"""Deterministic fault injection for the resilience layer.

A copy of ``analytics_zoo_tpu/testing/chaos.py`` (the port cannot import
it: every ``analytics_zoo_tpu`` import loads jax), unchanged but for its
imports: the same ``POINTS`` (all 21, including those whose modules are
not ported yet), ``FAULTS`` and plan semantics, so one plan fires at the
same call indices in both packages.

Every cancellation bug so far (the r5 sink/flush_batches class, the 12
graftlint defects) was found AFTER the fact; this harness makes the
fault paths first-class test surface.  Production code marks NAMED
injection points::

    from analytics_zoo_tpu_torch.testing import chaos
    ...
    chaos.fire("decode")        # no-op unless an injector is installed

and a test arms a seeded, deterministic schedule::

    inj = chaos.ChaosInjector()
    inj.plan("decode", fault="raise", at=[0, 2])       # 1st + 3rd call
    inj.plan("dispatch_submit", fault="cancel", times=1)
    with chaos.installed(inj):
        ...drive the system...
    assert inj.count("decode") >= 3

Fault classes (the chaos matrix of ``tests/test_resilience.py``):

- ``raise``  — raise ``ChaosError`` (an ordinary Exception),
- ``cancel`` — raise ``concurrent.futures.CancelledError`` (a
  BaseException since py3.8 — the guard-killing class),
- ``delay``  — sleep ``delay_s`` (push work past its deadline).

When nothing is installed, ``fire`` costs one module-global read and a
``None`` check — safe to leave in serving/training hot paths.

Every fault that actually triggers is self-documenting: it journals a
``chaos.<fault>`` event onto the ACTIVE span of the thread it hits (a
``dispatch_submit`` cancel lands inside that request's
``serving.dispatch`` span) and trips the flight recorder, so the dump
shows the faulted span with its injection event attached —
docs/observability.md "Flight recorder".
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import CancelledError
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional

from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.observability import flight_recorder

#: the injection points production code declares, in pipeline order
#: (``decode_step`` is the LLM engine's per-iteration point — one fault
#: hits a whole continuous-batching step, docs/llm-serving.md;
#: ``prefix_match`` fires inside the radix prefix-cache lookup, BEFORE
#: any block is adopted — a fault there must leave the cache's
#: refcount books exactly balanced — and ``prefill_chunk`` fires per
#: prefill chunk with cached-prefix blocks possibly already adopted at
#: refcount ≥ 2, the window where a fault must free the faulted
#: sequence's references without touching the cache's own;
#: ``weight_page`` is the multi-model pager's host->HBM transfer — one
#: fault fails exactly one model's page-in, docs/serving.md;
#: ``source_poll`` is the streaming source's read — fired BEFORE the
#: cursor advances, so a fault loses no records — and ``pane_publish``
#: sits between a pane's broker publish and its journal mark, the
#: exactly-once window where a fault forces a REPLAY and the consumer
#: dedup barrier must drop the duplicate, docs/streaming.md;
#: ``shard_read`` fires at the top of the sharded-ingest shard read,
#: BEFORE any record leaves the shard — a fault there must strand no
#: prefetch thread and the estimator's checkpoint-retry must resume
#: the epoch at the cursor with zero dropped/duplicated samples — and
#: ``transform_apply`` fires before an eager transform chain touches a
#: batch, so a fault never yields a half-transformed batch,
#: docs/data-plane.md;
#: ``wal_append`` fires before a durable-broker journal append and
#: ``wal_replay`` before each replayed record's application (replay
#: retries transient faults — a record is never silently skipped),
#: ``broker_promote`` at the top of a standby promotion (the
#: supervisor's failover loop retries a faulted promote), and
#: ``tenant_admit`` inside the per-tenant credit gate BEFORE any book
#: mutation — a fault there must leave the tenant credit books exactly
#: balanced, docs/control-plane.md;
#: ``batch_score`` fires at the top of each batch-scoring dispatch,
#: BEFORE the batch enters the compiled program — a fault there must
#: strand no scoring thread, leak no tenant credit, and resume at the
#: cursor with every record scored exactly once — and
#: ``segment_commit`` sits between a segment's WAL commit record and
#: its tmp→final rename, the exactly-once window where a crash leaves
#: a committed-but-unrenamed segment that resume must reconcile
#: without rescoring or duplicating a record, docs/batch-inference.md;
#: ``mem_reconcile`` fires at the top of the memory ledger's
#: reconciliation sweep, BEFORE any pool is probed or any divergence
#: verdict reached — a fault there must abort exactly that sweep (no
#: false ``mem_leak`` dump, no dead ``zoo-mem*`` thread) and the next
#: sweep must reconcile the books exactly, docs/observability.md
#: "Memory ledger")
POINTS = ("broker_read", "decode", "dispatch_submit", "device_execute",
          "checkpoint_write", "health_probe", "decode_step",
          "prefix_match", "prefill_chunk",
          "weight_page", "source_poll", "pane_publish",
          "shard_read", "transform_apply",
          "wal_append", "wal_replay", "broker_promote", "tenant_admit",
          "batch_score", "segment_commit", "mem_reconcile")

FAULTS = ("raise", "cancel", "delay")


class ChaosError(RuntimeError):
    """The injected ordinary-Exception fault."""


class _Plan:
    __slots__ = ("fault", "at", "times", "delay_s", "fired")

    def __init__(self, fault: str, at: Optional[Iterable[int]],
                 times: Optional[int], delay_s: float):
        self.fault = fault
        self.at = None if at is None else frozenset(int(i) for i in at)
        self.times = times
        self.delay_s = delay_s
        self.fired = 0

    def triggers(self, index: int) -> bool:
        if self.at is not None:
            return index in self.at
        return self.times is None or self.fired < self.times


class ChaosInjector:
    """A deterministic per-point fault schedule.

    ``plan(point, fault, at=..)`` fires at exact 0-based invocation
    indices of that point; ``times=N`` fires on the first N invocations;
    neither means every invocation.  Thread-safe: invocation counting is
    global per point, so a schedule is deterministic whenever the
    point's call order is (single reader thread, single exec thread...).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._plans: Dict[str, List[_Plan]] = {}
        self._counts: Dict[str, int] = {}

    def plan(self, point: str, fault: str = "raise",
             at: Optional[Iterable[int]] = None,
             times: Optional[int] = 1,
             delay_s: float = 0.0) -> "ChaosInjector":
        if point not in POINTS:
            raise ValueError(f"unknown injection point {point!r}; "
                             f"known: {POINTS}")
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
        with self._lock:
            self._plans.setdefault(point, []).append(
                _Plan(fault, at, times, delay_s))
        return self

    def count(self, point: str) -> int:
        """How many times ``point`` has fired (hit or not)."""
        with self._lock:
            return self._counts.get(point, 0)

    def injected(self, point: str) -> int:
        """How many faults actually triggered at ``point``."""
        with self._lock:
            return sum(p.fired for p in self._plans.get(point, ()))

    def fire(self, point: str) -> None:
        with self._lock:
            index = self._counts.get(point, 0)
            self._counts[point] = index + 1
            hit = None
            for p in self._plans.get(point, ()):
                if p.triggers(index):
                    p.fired += 1
                    hit = p
                    break
        if hit is None:
            return
        # the fault is about to hit THIS thread's active span (if any):
        # journal it there first, then snapshot — the dump's active_span
        # is the faulted span with its injection event attached
        obs.add_event("chaos." + hit.fault, point=point, index=index)
        # rate-limited per point:fault: an every-invocation plan on a hot
        # point must not turn each record into a synchronous ring+metrics
        # JSON dump (the first fault of a schedule always captures)
        flight_recorder.get().trigger("chaos",
                                      detail=f"{point}:{hit.fault}",
                                      min_interval_s=1.0)
        if hit.fault == "delay":
            time.sleep(hit.delay_s)
        elif hit.fault == "cancel":
            raise CancelledError(f"chaos[{point}] injected cancellation")
        else:
            raise ChaosError(f"chaos[{point}] injected failure")


#: the installed injector; production ``fire`` reads this once per call
_active: Optional[ChaosInjector] = None


def install(injector: ChaosInjector) -> None:
    global _active
    _active = injector


def uninstall() -> None:
    global _active
    _active = None


@contextmanager
def installed(injector: ChaosInjector):
    install(injector)
    try:
        yield injector
    finally:
        uninstall()


def fire(point: str) -> None:
    """The production-side hook: no-op unless an injector is installed."""
    inj = _active
    if inj is not None:
        inj.fire(point)
