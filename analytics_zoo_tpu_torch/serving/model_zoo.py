"""Multi-model serving: a model registry over one device's weight cache.

Port of ``analytics_zoo_tpu/serving/model_zoo.py``.  A named
``ModelRegistry`` holds many ``InferenceModel``s behind one byte budget
on the card:

- HOT models are **pinned**: paged in at registration, never evicted.
- COLD models stay in pinned host memory (``InferenceModel`` host
  staging: registering them allocates nothing on the card) and are paged
  host -> card by one pager thread.  The pager runs every ``place()``
  under a CUDA stream of its own, so a page-in overlaps the resident
  models' dispatches, which run on their workers' streams; ``place()``
  waits for its stream before the model is marked resident, and
  ``unplace()`` waits for the last dispatch that read the weights before
  their blocks go back to the caching allocator.
- Eviction is **LRU + pin count**: a model is evictable only when it is
  resident, not pinned and no dispatch holds it (every in-flight dispatch
  pins its model from submit to fetch).  The books (``used_bytes``,
  ``used_blocks``, per-owner attribution) move only under the registry
  lock; a failed transfer rolls its reservation back.  A model's bytes
  are ``numel * element_size`` of its parameters and buffers.
- ``swap`` replaces a model's weights with a new version while the old
  one keeps serving (both booked during the overlap).

Each entry owns an ``AdmissionController`` (its 429 knob), a
``CircuitBreaker`` (page-in and dispatch failures eject that model only)
and an optional default deadline; per-model series carry a ``model``
label.  The ``weight_page`` chaos point covers the transfer, inside the
``model.pagein`` span, and the ``model_weights`` / ``swap_staging`` pools
of the memory ledger read the books.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
from concurrent.futures import CancelledError
from typing import Callable, Dict, List, Optional

import torch

from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common.resilience import (
    AdmissionController, CircuitBreaker)
from analytics_zoo_tpu_torch.testing import chaos

logger = logging.getLogger("analytics_zoo_tpu_torch.serving")

__all__ = ["ModelEntry", "ModelRegistry", "PageInError",
           "validate_model_name"]


def validate_model_name(name: str) -> str:
    """The one model-name rule, shared by registration and the wire
    surfaces: non-empty, no ``/`` (the ``/predict/<model>`` route
    separator) and no control characters (``\\x1f`` is the wire field
    separator).  Enforcing it at ``register()`` turns a name the HTTP
    tier would reject on every request into a setup-time error.  Also
    rejects non-strings: the JSON body's ``"model"`` key is client
    input, and a type error here must surface as a 400, not a crash."""
    if (not isinstance(name, str) or not name or "/" in name
            or any(ord(c) < 0x20 for c in name)):
        raise ValueError(f"invalid model name {name!r}")
    return name

#: residency states (also the ``zoo_model_resident`` gauge encoding)
HOST, PAGING, DEVICE = "host", "paging", "device"
_STATE_CODE = {HOST: 0.0, PAGING: 1.0, DEVICE: 2.0}

_m_resident = obs.lazy_gauge(
    "zoo_model_resident",
    "weight residency: 0 host, 1 paging in, 2 device-resident", ["model"])
_m_weight_bytes = obs.lazy_gauge(
    "zoo_model_weight_bytes", "model weight working-set bytes", ["model"])
_m_pageins = obs.lazy_counter(
    "zoo_model_pageins_total", "host->HBM weight page-ins", ["model"])
_m_evictions = obs.lazy_counter(
    "zoo_model_evictions_total", "HBM->host weight evictions", ["model"])
_m_pagein_s = obs.lazy_histogram(
    "zoo_model_pagein_seconds", "host->HBM weight transfer time", ["model"])
_m_records = obs.lazy_counter(
    "zoo_model_records_total", "records served to completion per model",
    ["model"])
_m_errors = obs.lazy_counter(
    "zoo_model_errors_total", "records error-finished per model", ["model"])
_m_shed = obs.lazy_counter(
    "zoo_model_shed_total",
    "records shed by a model's admission credits or open breaker",
    ["model"])
_m_hbm_used = obs.lazy_gauge(
    "zoo_model_hbm_used_bytes",
    "weight-cache HBM bytes currently reserved")
_m_version = obs.lazy_gauge(
    "zoo_model_version",
    "serving weight version per model (bumped by each committed hot "
    "swap)", ["model"])
_m_swaps = obs.lazy_counter(
    "zoo_model_swaps_total", "committed weight hot swaps", ["model"])
_m_hbm_budget = obs.lazy_gauge(
    "zoo_model_hbm_budget_bytes",
    "configured weight-cache HBM budget (0 = unbounded)")


class PageInError(RuntimeError):
    """A model's host->HBM weight transfer failed (or timed out); the
    requests that needed it error-finish, other models are untouched."""


def _weight_nbytes(model) -> int:
    """The model's weight working set in bytes.  ``InferenceModel``
    exposes ``weight_nbytes``; JAX-free test fakes may expose a plain
    attribute; anything else accounts as zero (always admissible)."""
    n = getattr(model, "weight_nbytes", 0)
    return int(n() if callable(n) else n)


def _weight_blocks(model) -> int:
    """Weight buffers ("blocks") the model places in HBM — the unit of
    the exact-accounting assertions."""
    n = getattr(model, "weight_blocks", 0)
    return int(n() if callable(n) else n) or (
        1 if _weight_nbytes(model) else 0)


class ModelEntry:
    """One registered model: the ``InferenceModel`` (or any
    predict_async/fetch-protocol object), its residency state, and its
    OWN resilience surface — admission credits, circuit breaker, and an
    optional per-model default deadline."""

    __slots__ = (
        "name", "model", "pinned", "state", "pin_count", "last_used",
        "nbytes", "nblocks", "admission", "breaker", "default_deadline_ms",
        "_ready", "_error", "_page_deadline", "records_shed",
        "records_errored", "records_served", "version", "_swap_barrier",
        "_staging")

    def __init__(self, name: str, model, pinned: bool,
                 admission: AdmissionController, breaker: CircuitBreaker,
                 default_deadline_ms: Optional[float]):
        self.name = name
        self.model = model
        self.pinned = pinned
        self.state = HOST
        self.pin_count = 0
        self.last_used = time.monotonic()
        self.nbytes = _weight_nbytes(model)
        self.nblocks = _weight_blocks(model)
        self.admission = admission
        self.breaker = breaker
        self.default_deadline_ms = default_deadline_ms
        # page-in completion latch: waiters block on it, the pager sets
        # it with either DEVICE state or ``_error`` holding the failure
        self._ready = threading.Event()
        self._error: Optional[BaseException] = None
        # armed at prefetch(): the pager retries a space-blocked
        # page-in (requeue, never park) until this deadline passes
        self._page_deadline = 0.0
        self.records_shed = 0
        self.records_errored = 0
        self.records_served = 0
        # versioned weight ref (the hot swap): bumped by
        # every committed ``ModelRegistry.swap``; the barrier gates NEW
        # dispatch pins while a swap drains in-flight ones, so a batch
        # always runs against exactly one version
        self.version = 1
        self._swap_barrier = False
        # True for a swap's shadow entry only: its bytes book under
        # "<name>@swap" (the double-buffer staging owner) until the
        # flip transfers them to the serving name
        self._staging = False

    # ---- per-model accounting (engine calls these) ------------------------
    def count_served(self, k: int) -> None:
        self.records_served += k
        _m_records.labels(model=self.name).inc(k)

    def count_error(self, k: int = 1) -> None:
        self.records_errored += k
        _m_errors.labels(model=self.name).inc(k)

    def count_shed(self, k: int) -> None:
        self.records_shed += k
        _m_shed.labels(model=self.name).inc(k)

    @property
    def resident(self) -> bool:
        return self.state == DEVICE


class ModelRegistry:
    """Named model entries over one HBM weight cache.

    ``hbm_budget_bytes`` bounds the aggregate weight bytes resident on
    device (0 = unbounded — every model behaves as pinned once paged).
    The budget is CONFIGURABLE precisely so tests can simulate an
    HBM-sized working set on the CPU backend: accounting is identical,
    only the transfer medium differs.

    Thread-safety: one registry lock guards states, pins, LRU order and
    the byte/block books; the pager thread owns transfers; waiters park
    on per-entry events, never on the lock.
    """

    def __init__(self, hbm_budget_bytes: int = 0,
                 page_timeout_s: float = 30.0,
                 admission_max_inflight: int = 256,
                 breaker_failure_threshold: int = 3,
                 breaker_recovery_s: float = 2.0,
                 placer: Optional[Callable] = None,
                 unplacer: Optional[Callable] = None):
        self.budget_bytes = int(hbm_budget_bytes)
        self.page_timeout_s = float(page_timeout_s)
        self._adm_default = int(admission_max_inflight)
        self._brk_threshold = int(breaker_failure_threshold)
        self._brk_recovery = float(breaker_recovery_s)
        # the transfer/release hooks: tests inject a slow placer to make
        # the overlap window observable; default is the model's own
        # place()/unplace() (InferenceModel host-staging surface)
        self._placer = placer or (lambda m: m.place())
        self._unplacer = unplacer or (lambda m: m.unplace())
        # ONE registry lock (as a Condition: eviction-pressure waiters —
        # a page-in waiting for pins to drop — park on it too); every
        # state/books guard is `with self._space:` so the guard is
        # uniform for readers and the thread-safety analysis alike.
        # The default RLock lets already-holding callers re-enter
        # (`_evict_lru_locked` runs under the caller's guard)
        self._space = threading.Condition()
        self._entries: Dict[str, ModelEntry] = {}
        self._default: Optional[str] = None
        self.used_bytes = 0
        self.used_blocks = 0
        # per-owner attribution: owner -> [bytes, blocks],
        # stepped in lockstep with used_bytes/used_blocks by
        # _book_locked so `sum(owners) == totals` is an exact invariant
        # the ledger's leak sentinel reconciles every sweep
        self._owner_books: Dict[str, List[int]] = {}
        self.pageins = 0
        self.evictions = 0
        self._stop = threading.Event()
        self._q: "queue.Queue[str]" = queue.Queue()
        # the pager's own CUDA stream per device (made by the pager)
        self._streams: Dict[str, torch.cuda.Stream] = {}
        self._pager = threading.Thread(target=self._pager_loop,
                                       name="model-pager", daemon=True)
        self._pager.start()
        # the ledger is the ONE producer of the hbm_used/budget gauges
        # (set at scrape time from _mem_snapshot); the
        # swap_staging pool is a SUB-ACCOUNT view of the "<name>@swap"
        # owners, whose bytes also count in model_weights
        ledger = obs.get_memory_ledger()
        self._mem_pools = (
            ledger.register(
                "model_weights", self._mem_snapshot,
                reconcile_fn=self._mem_reconcile, owner=self,
                gauges=((_m_hbm_used, lambda s: s["used_bytes"]),
                        (_m_hbm_budget, lambda s: s["capacity_bytes"]))),
            ledger.register(
                "swap_staging", self._mem_staging_snapshot, owner=self),
        )

    # ---- registration -----------------------------------------------------
    def register(self, name: str, model, pinned: bool = False,
                 credits: Optional[int] = None,
                 default_deadline_ms: Optional[float] = None,
                 default: bool = False) -> ModelEntry:
        """Add a named model.  ``pinned`` pages the weights in NOW
        (synchronously — registration is setup, not the request path)
        and exempts them from eviction; cold models stay host-staged
        until first routed.  ``credits`` bounds the model's admitted
        in-flight records (its 429 knob); ``default_deadline_ms``
        applies when a request carries no deadline of its own."""
        validate_model_name(name)
        if not pinned and hasattr(model, "stage_host"):
            # evictable + already placed (eager load): capture the host
            # staging copy HERE, off the request path — eviction runs
            # under the registry lock, where a D2H weight read would
            # stall every model's admission for the transfer duration
            model.stage_host()
        with self._space:
            if name in self._entries:
                raise ValueError(f"model {name!r} already registered")
            entry = ModelEntry(
                name, model, pinned,
                AdmissionController(credits or self._adm_default,
                                    name=f"model:{name}"),
                CircuitBreaker(f"model:{name}",
                               failure_threshold=self._brk_threshold,
                               recovery_s=self._brk_recovery),
                default_deadline_ms)
            if getattr(model, "_placed", False):
                # an eagerly-placed model arrives already resident: the
                # books must reflect its HBM from the start
                entry.state = DEVICE
                entry._ready.set()
                self._book_locked(entry.name, entry.nbytes, entry.nblocks)
            self._entries[name] = entry
            if default or self._default is None:
                self._default = name
            _m_weight_bytes.labels(model=name).set(float(entry.nbytes))
            _m_resident.labels(model=name).set(_STATE_CODE[entry.state])
            _m_version.labels(model=name).set(float(entry.version))
        if pinned and not entry.resident:
            try:
                self.prefetch(entry)
                self.ensure_resident(entry)
            except BaseException:
                # roll the registration back: a pinned model that
                # cannot page in (never-fit, failed transfer) must not
                # stay registered — it may hold the default route, and
                # a corrective re-register would hit "already
                # registered", wedging the registry until restart
                with self._space:
                    popped = self._entries.pop(name, None)
                    if popped is not None and popped.state == DEVICE:
                        # the transfer won the race with this rollback
                        # (completed between our timeout and the lock):
                        # release it now; a still-PAGING transfer is
                        # released by the pager's own orphan check
                        self._release_orphan_locked(popped)
                    if self._default == name:
                        self._default = next(iter(self._entries), None)
                    _m_weight_bytes.labels(model=name).set(0.0)
                    _m_resident.labels(model=name).set(_STATE_CODE[HOST])
                raise
        return entry

    def resolve(self, name: Optional[str]) -> ModelEntry:
        """The entry for ``name`` (None -> the default model).  KeyError
        on an unknown name — the engine rejects that entry, it never
        reaches a device."""
        with self._space:
            key = name or self._default
            if key is None or key not in self._entries:
                raise KeyError(f"unknown model {name!r}; registered: "
                               f"{sorted(self._entries)}")
            return self._entries[key]

    def models(self) -> List[str]:
        with self._space:
            return sorted(self._entries)

    @property
    def default_entry(self) -> Optional[ModelEntry]:
        with self._space:
            return self._entries.get(self._default) if self._default else None

    # ---- paging -----------------------------------------------------------
    def prefetch(self, entry) -> None:
        """Hint that ``entry`` will be needed: enqueue an async page-in
        (idempotent; a resident or already-queued model is a no-op).
        The engine calls this at ADMISSION — by dispatch time the
        transfer has been overlapping other models' compute."""
        if isinstance(entry, str):
            entry = self.resolve(entry)
        with self._space:
            if entry.state != HOST or self._stop.is_set():
                return
            entry.state = PAGING
            entry._error = None
            entry._ready.clear()
            entry._page_deadline = time.monotonic() + self.page_timeout_s
            _m_resident.labels(model=entry.name).set(_STATE_CODE[PAGING])
        self._q.put(entry.name)

    def ensure_resident(self, entry, timeout: Optional[float] = None
                        ) -> ModelEntry:
        """Block until ``entry``'s weights are on device; raises
        ``PageInError`` when the transfer failed or timed out.  Called
        from the engine's COLD dispatch pool — a cold model's wait
        parks a cold-pool worker while the main pool keeps dispatching
        resident models (a page-in never stalls the pool as a whole)."""
        if isinstance(entry, str):
            entry = self.resolve(entry)
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else self.page_timeout_s)
        while True:
            if entry.resident:
                return entry
            self.prefetch(entry)          # re-arm after failure/eviction
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise PageInError(
                    f"model {entry.name!r} page-in timed out after "
                    f"{self.page_timeout_s:.1f}s")
            entry._ready.wait(min(remaining, 0.2))
            if entry._ready.is_set():
                err = entry._error
                if err is not None:
                    raise PageInError(
                        f"model {entry.name!r} page-in failed: "
                        f"{type(err).__name__}: {err}") from err
                if entry.resident:
                    return entry
                # evicted between the event and our wake: loop re-pages

    def _pager_loop(self) -> None:
        """The transfer worker: one host->HBM page-in at a time, issued
        OFF the request path.  The guard is cancellation-aware:
        a failed or cancelled transfer marks the entry failed — waking
        exactly its waiters — and the loop keeps serving other models."""
        while not self._stop.is_set():
            try:
                name = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            with self._space:
                entry = self._entries.get(name)
            if entry is None or entry.state != PAGING:
                continue
            try:
                self._page_in(entry)
            except (Exception, CancelledError) as exc:
                logger.exception("page-in failed for model %s", name)
                self._page_in_failed(entry, exc)

    def _page_in(self, entry: ModelEntry) -> None:
        # capture the weight ref + its accounting NOW: a concurrent
        # hot swap may flip entry.model/nbytes while the transfer runs,
        # and the completion below must judge (and, on staleness, undo)
        # exactly what IT placed and booked
        model = entry.model
        nbytes, nblocks = entry.nbytes, entry.nblocks
        if not self._reserve(entry):
            # transient HBM pressure (dispatch pins on every victim):
            # do NOT park the single pager thread waiting for it —
            # every other model's page-in would starve behind this
            # wait.  Requeue to the tail and keep serving the queue;
            # this entry's own deadline bounds the retries.
            if time.monotonic() > entry._page_deadline:
                raise PageInError(
                    f"model {entry.name!r} page-in timed out "
                    "waiting for evictable HBM (every resident "
                    "model pinned or in flight)")
            time.sleep(0.01)
            with self._space:
                requeue = (self._entries.get(entry.name) is entry
                           and entry.state == PAGING)
            if requeue:
                self._q.put(entry.name)
            return
        try:
            # the injection point covers the whole transfer: a fault
            # here is a failed host->HBM copy
            with obs.span("model.pagein", model=entry.name):
                t0 = time.monotonic()
                chaos.fire("weight_page")
                with self._pager_stream(model):
                    self._placer(model)
                _m_pagein_s.labels(model=entry.name).observe(
                    time.monotonic() - t0)
        except BaseException:
            self._unreserve(entry)
            raise
        with self._space:
            if self._entries.get(entry.name) is not entry:
                # the registration was rolled back (pinned register
                # failure/timeout) while the transfer ran: this entry
                # is an ORPHAN — nothing can ever route to it and no
                # eviction scan will find it, so undo the transfer here
                # or its bytes stay booked forever
                self._release_orphan_locked(entry)
                entry._ready.set()
                return
            if entry.model is not model:
                # a hot swap retired the ref this transfer placed while
                # it was in flight: the buffers belong to a version
                # nothing routes to anymore — undo exactly what WE
                # placed and booked (the swap owns the entry's state,
                # _ready, and the new ref's accounting)
                try:
                    self._unplacer(model)
                except (Exception, CancelledError):
                    logger.exception(
                        "unplace failed for the swapped-out version of "
                        "model %s", entry.name)
                self._book_locked(entry.name, -nbytes, -nblocks)
                self._space.notify_all()
                return
            entry.state = DEVICE
            entry.last_used = time.monotonic()
            self.pageins += 1
            _m_pageins.labels(model=entry.name).inc()
            _m_resident.labels(model=entry.name).set(_STATE_CODE[DEVICE])
            entry._ready.set()
            # a swap flip parked on this entry's PAGING state wakes here
            self._space.notify_all()

    def _pager_stream(self, model):
        """The pager's own stream on the model's card (a context that does
        nothing for a model on the CPU), so a page-in's copies overlap the
        resident models' dispatches on their streams."""
        dev = getattr(model, "device", None)
        if dev is None or torch.device(dev).type != "cuda":
            return contextlib.nullcontext()
        dev = torch.device(dev)
        stream = self._streams.get(str(dev))
        if stream is None:
            stream = self._streams[str(dev)] = torch.cuda.Stream(dev)
        return torch.cuda.stream(stream)

    def _page_in_failed(self, entry: ModelEntry, exc: BaseException) -> None:
        with self._space:
            entry.state = HOST
            entry._error = exc
            _m_resident.labels(model=entry.name).set(_STATE_CODE[HOST])
            entry._ready.set()
            # a swap flip parked on this entry's PAGING state wakes here
            self._space.notify_all()
        # the model's OWN breaker trips — repeated page-in failures
        # eject exactly this model while the rest of the zoo serves
        entry.breaker.record_failure()

    # ---- the byte/block books --------------------------------------------
    def _book_locked(self, owner: str, dbytes: int, dblocks: int) -> None:
        """EVERY ``used_bytes``/``used_blocks`` move goes through here:
        totals and per-owner attribution step together in one lock
        section, which is what lets the memory ledger's reconcile sweep
        hold ``sum(owner books) == totals`` as an exact invariant (a
        byte moved behind this helper's back IS a leak).  Lock held by
        caller (re-entered here — the Condition's RLock makes the guard
        explicit at every write)."""
        with self._space:
            self.used_bytes += dbytes
            self.used_blocks += dblocks
            book = self._owner_books.setdefault(owner, [0, 0])
            book[0] += dbytes
            book[1] += dblocks
            if book[0] == 0 and book[1] == 0:
                del self._owner_books[owner]

    def _transfer_books_locked(self, src: str, dst: str) -> None:
        """Move ``src``'s whole attribution to ``dst`` without touching
        the totals — the swap flip's staging->serving handover."""
        with self._space:
            book = self._owner_books.pop(src, None)
            if book is None:
                return
            tgt = self._owner_books.setdefault(dst, [0, 0])
            tgt[0] += book[0]
            tgt[1] += book[1]
            if tgt[0] == 0 and tgt[1] == 0:
                del self._owner_books[dst]

    @staticmethod
    def _owner_key(entry: ModelEntry) -> str:
        return entry.name + "@swap" if entry._staging else entry.name

    def _reserve(self, entry: ModelEntry) -> bool:
        """Reserve HBM for ``entry``, evicting LRU unpinned models as
        needed.  NON-BLOCKING: returns False under transient pressure
        (every candidate victim pinned or in flight) — the pager
        requeues rather than parking its single thread, so one model's
        space-wait can never starve other models' page-ins.  Raises
        ``PageInError`` when the model can NEVER fit (pinned working
        set + this model exceed the budget)."""
        if not entry.nbytes or not self.budget_bytes:
            # zero-byte fakes / unbounded budget: nothing to account
            # beyond the books themselves
            with self._space:
                self._book_locked(self._owner_key(entry),
                                  entry.nbytes, entry.nblocks)
            return True
        with self._space:
            # the NEVER-fit check counts only PERMANENTLY pinned
            # models: a dispatch pin is transient (it drops at the
            # sink) and must make this page-in RETRY, not fail
            pinned_bytes = sum(
                e.nbytes for e in self._entries.values()
                if e.state in (DEVICE, PAGING) and e is not entry
                and e.pinned)
            if entry.nbytes + pinned_bytes > self.budget_bytes:
                raise PageInError(
                    f"model {entry.name!r} ({entry.nbytes}B) can "
                    f"never fit: pinned working set "
                    f"{pinned_bytes}B of "
                    f"{self.budget_bytes}B budget")
            free = self.budget_bytes - self.used_bytes
            if entry.nbytes > free:
                evictable = sum(
                    e.nbytes for e in self._entries.values()
                    if e.state == DEVICE and not e.pinned
                    and e.pin_count == 0 and e is not entry)
                if entry.nbytes > free + evictable:
                    # cannot fit even after evicting EVERYTHING
                    # currently evictable: evict nothing.  A doomed
                    # attempt that evicts anyway thrashes smaller
                    # residents out (they page back in, the retry
                    # evicts them again — livelock between a blocked
                    # large model and a small one)
                    return False
                while self.used_bytes + entry.nbytes > self.budget_bytes:
                    if not self._evict_lru_locked(exclude=entry):
                        return False
            self._book_locked(self._owner_key(entry),
                              entry.nbytes, entry.nblocks)
            return True

    def _unreserve(self, entry: ModelEntry) -> None:
        with self._space:
            self._book_locked(self._owner_key(entry),
                              -entry.nbytes, -entry.nblocks)
            self._space.notify_all()

    def _release_orphan_locked(self, entry: ModelEntry) -> None:
        """Undo a page-in for an entry no longer in the registry (a
        rolled-back pinned registration).  The books are released even
        if the buffer drop fails — an orphan gets no retry, and a
        booked-forever leak is strictly worse than a logged failure.
        Lock held by caller (re-entered here — the Condition's RLock
        makes the guard explicit at every write)."""
        with self._space:
            try:
                self._unplacer(entry.model)
            except (Exception, CancelledError):
                logger.exception("unplace failed for orphaned model %s",
                                 entry.name)
            entry.state = HOST
            self._book_locked(entry.name, -entry.nbytes, -entry.nblocks)
            self._space.notify_all()

    def _evict_entry_locked(self, e: ModelEntry) -> bool:
        """Drop one resident entry's device buffers and restore host
        staging — the entry's compiled programs survive (same shardings
        on re-page).  Lock held by caller (re-entered here — the
        Condition's RLock makes the guard explicit at every write).
        The unplacer must be CHEAP (buffer release, no D2H): evictable
        models captured their host staging at registration
        (``stage_host``), so no transfer runs under the lock."""
        with self._space:
            try:
                self._unplacer(e.model)
            except (Exception, CancelledError):
                # an eviction failure must not corrupt the books: the
                # buffers may still be live, so the bytes stay accounted
                logger.exception("unplace failed for model %s", e.name)
                return False
            e.state = HOST
            e._ready.clear()
            self._book_locked(e.name, -e.nbytes, -e.nblocks)
            self.evictions += 1
            _m_evictions.labels(model=e.name).inc()
            _m_resident.labels(model=e.name).set(_STATE_CODE[HOST])
            self._space.notify_all()
            return True

    def _evict_lru_locked(self, exclude: Optional[ModelEntry] = None
                          ) -> bool:
        """Evict the least-recently-used evictable model; False when no
        candidate exists.  Lock held by caller."""
        with self._space:
            victims = [e for e in self._entries.values()
                       if e.state == DEVICE and not e.pinned
                       and e.pin_count == 0 and e is not exclude]
            if not victims:
                return False
            return self._evict_entry_locked(
                min(victims, key=lambda e: e.last_used))

    def evict(self, name: str) -> bool:
        """Explicitly evict one model (False when absent, host-staged,
        pinned, or held in flight by a dispatch pin)."""
        with self._space:
            e = self._entries.get(name)
            if (e is None or e.state != DEVICE or e.pinned
                    or e.pin_count > 0):
                return False
            return self._evict_entry_locked(e)

    # ---- versioned weight swap ----------------------------------------------
    def swap(self, name: str, new_model,
             timeout_s: Optional[float] = None) -> ModelEntry:
        """Atomically replace ``name``'s serving weights with
        ``new_model`` and bump the entry's version ref.

        The OLD version keeps serving while the new weights place into
        FRESH buffers (double-buffer: both versions' bytes are booked
        during the overlap, LRU eviction makes room like any page-in).
        The flip itself waits for in-flight dispatch pins to drain
        behind a barrier that parks NEW pins — so no request is ever
        dropped and no device batch ever runs against mixed versions —
        then swaps the weight ref, books, and version in one lock
        section.  The old buffers release after the flip.  Any failure
        (placement, never-fit, drain timeout) leaves the OLD version
        serving untouched and raises ``PageInError``.

        Identity-sensitive state survives the swap on purpose: the
        entry keeps its admission credits, circuit breaker, per-model
        counters and name — only the weights and version move."""
        entry = self.resolve(name)
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.page_timeout_s)
        if not entry.pinned and hasattr(new_model, "stage_host"):
            # evictable entries keep host staging (the register() rule):
            # capture it now, off the registry lock
            new_model.stage_host()
        # a still-PAGING old version must settle first: the pager's
        # completion writes entry.state against entry.model, and the
        # flip must never let it mark the NEW (unplaced) ref resident
        while True:
            with self._space:
                if entry.state != PAGING:
                    break
            if time.monotonic() > deadline:
                raise PageInError(
                    f"model {name!r} swap timed out waiting for an "
                    "in-flight page-in to settle")
            entry._ready.wait(0.05)
        # shadow entry: the incoming version's byte/block accounting
        # rides the SAME reservation machinery as a page-in, but the
        # shadow never enters _entries — nothing can route to it
        shadow = ModelEntry(name, new_model, entry.pinned,
                            entry.admission, entry.breaker,
                            entry.default_deadline_ms)
        shadow._staging = True
        place_new = entry.pinned or entry.state == DEVICE
        placed_here = False
        if place_new and not getattr(new_model, "_placed", False):
            shadow._page_deadline = deadline
            while not self._reserve(shadow):
                if time.monotonic() > deadline:
                    raise PageInError(
                        f"model {name!r} swap timed out waiting for "
                        "evictable HBM for the incoming version")
                with self._space:
                    self._space.wait(0.05)
            try:
                with obs.span("model.pagein", model=name,
                              version=entry.version + 1):
                    t0 = time.monotonic()
                    self._placer(new_model)
                    _m_pagein_s.labels(model=name).observe(
                        time.monotonic() - t0)
            except (Exception, CancelledError) as exc:
                self._unreserve(shadow)
                raise PageInError(
                    f"model {name!r} swap failed placing the new "
                    f"version: {type(exc).__name__}: {exc}") from exc
            placed_here = True
        elif place_new:
            # already placed by the caller: book its bytes
            with self._space:
                self._book_locked(self._owner_key(shadow),
                                  shadow.nbytes, shadow.nblocks)
        # ---- the flip: drain in-flight pins, then swap in one section
        with self._space:
            entry._swap_barrier = True
            try:
                # a page-in racing this flip (a prefetch re-armed the
                # entry between the settle check and here) must finish
                # first: while state is PAGING a transfer for the
                # OUTGOING ref is in flight, and its completion must
                # never observe a half-flipped entry (the stale-ref
                # check in _page_in covers the transfer that LOSES this
                # wait, not one running through the flip itself)
                while entry.state == PAGING:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise PageInError(
                            f"model {name!r} swap timed out waiting "
                            "for a racing page-in to settle")
                    self._space.wait(min(remaining, 0.05))
                while entry.pin_count > 0:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise PageInError(
                            f"model {name!r} swap timed out draining "
                            f"{entry.pin_count} in-flight dispatch "
                            "pin(s)")
                    self._space.wait(min(remaining, 0.05))
            except BaseException:
                entry._swap_barrier = False
                self._space.notify_all()
                if place_new:
                    # roll the incoming version back out: books first,
                    # then buffers (outside the failure path nothing
                    # else references them)
                    self._book_locked(self._owner_key(shadow),
                                      -shadow.nbytes, -shadow.nblocks)
                    if placed_here:
                        try:
                            self._unplacer(new_model)
                        except (Exception, CancelledError):
                            logger.exception(
                                "unplace failed rolling back swap of "
                                "model %s", name)
                raise
            old_model = entry.model
            old_nbytes, old_nblocks = entry.nbytes, entry.nblocks
            old_resident = entry.state == DEVICE
            entry.model = new_model
            entry.nbytes, entry.nblocks = shadow.nbytes, shadow.nblocks
            entry.version += 1
            entry._error = None
            entry.last_used = time.monotonic()
            if place_new:
                entry.state = DEVICE
                entry._ready.set()
                if placed_here:
                    self.pageins += 1
                    _m_pageins.labels(model=name).inc()
            else:
                entry.state = HOST
                entry._ready.clear()
            if old_resident:
                # the outgoing version's bytes release NOW (its buffers
                # drop right below); an unplace failure is logged, not
                # booked — the version left the registry, a
                # booked-forever leak is strictly worse (the orphan
                # discipline of _release_orphan_locked)
                self._book_locked(name, -old_nbytes, -old_nblocks)
            if place_new:
                # the staging overlap becomes the serving version's
                # booking in the same section that flips the weight
                # ref — attribution moves, the totals don't
                self._transfer_books_locked(name + "@swap", name)
            entry._swap_barrier = False
            _m_weight_bytes.labels(model=name).set(float(entry.nbytes))
            _m_resident.labels(model=name).set(_STATE_CODE[entry.state])
            _m_version.labels(model=name).set(float(entry.version))
            _m_swaps.labels(model=name).inc()
            self._space.notify_all()
        if old_resident:
            try:
                self._unplacer(old_model)
            except (Exception, CancelledError):
                logger.exception("unplace failed for the retired "
                                 "version of model %s", name)
        return entry

    # ---- pins (held across dispatch) --------------------------------------
    def pin(self, entry: ModelEntry) -> None:
        """Take one eviction pin.  The engine pins at dispatch SUBMIT
        and the pin rides the pending handle to the sink's fetch —
        a model with work in flight can never lose its weights.
        While a hot swap is draining, NEW pins park here until the flip
        completes (bounded by the in-flight dispatch latency): the
        weight ref read under the returned pin is therefore always one
        consistent version."""
        with self._space:
            while entry._swap_barrier:
                self._space.wait(0.05)
            entry.pin_count += 1
            entry.last_used = time.monotonic()

    def unpin(self, entry: ModelEntry) -> None:
        with self._space:
            entry.pin_count = max(0, entry.pin_count - 1)
            entry.last_used = time.monotonic()
            if entry.pin_count == 0:
                self._space.notify_all()

    def reset_admission(self) -> None:
        """Fresh per-model admission controllers (same capacities) —
        the engine calls this at every ``start()``, extending the
        single-model fresh-controller-per-start rule: entries dropped by
        a previous ``stop()`` (the wedged-broker path logs that their
        credits may be lost) must not pin stale credits and shrink a
        model's capacity across a restart."""
        with self._space:
            for e in self._entries.values():
                e.admission = AdmissionController(
                    e.admission.capacity, name=f"model:{e.name}")

    # ---- memory ledger pool ------------------------------------------------
    def _mem_snapshot(self) -> Dict[str, object]:
        """The ``model_weights`` pool contract: totals + per-model
        attribution read in ONE lock section, so the figures are
        torn-free by construction.  Swap staging (``<name>@swap``
        owners) counts in ``used_bytes`` here — the double-buffer
        overlap IS weight-cache HBM — and pins: staged bytes are
        unevictable until the flip."""
        with self._space:
            pinned = sum(
                e.nbytes for e in self._entries.values()
                if e.state == DEVICE and (e.pinned or e.pin_count > 0))
            pinned += sum(v[0] for k, v in self._owner_books.items()
                          if k.endswith("@swap"))
            return {"capacity_bytes": self.budget_bytes,
                    "used_bytes": self.used_bytes,
                    "pinned_bytes": pinned,
                    "blocks": self.used_blocks,
                    "owners": {k: v[0]
                               for k, v in self._owner_books.items()}}

    def _mem_staging_snapshot(self) -> Dict[str, object]:
        """The hot-swap double-buffer overlap as its own pool: bytes
        booked under ``<name>@swap`` between a swap's reserve and its
        flip.  A SUB-ACCOUNT of ``model_weights`` (the same bytes
        appear there) — dashboards watch it for swap pressure, the
        fleet view must not add it to the weight pool."""
        with self._space:
            owners = {k[:-len("@swap")]: v[0]
                      for k, v in self._owner_books.items()
                      if k.endswith("@swap")}
            blocks = sum(v[1] for k, v in self._owner_books.items()
                         if k.endswith("@swap"))
            used = sum(owners.values())
            return {"capacity_bytes": self.budget_bytes,
                    "used_bytes": used, "pinned_bytes": used,
                    "blocks": blocks, "owners": owners}

    def _mem_reconcile(self) -> List[str]:
        """The leak sentinel's ground truth: per-owner books sum
        exactly to the totals, never go negative, and a host-staged
        entry holds no HBM books (its staging copy is host DRAM)."""
        with self._space:
            lines: List[str] = []
            osum = sum(v[0] for v in self._owner_books.values())
            bsum = sum(v[1] for v in self._owner_books.values())
            if osum != self.used_bytes:
                lines.append(f"owner books sum to {osum}B, used_bytes "
                             f"says {self.used_bytes}B")
            if bsum != self.used_blocks:
                lines.append(f"owner books sum to {bsum} blocks, "
                             f"used_blocks says {self.used_blocks}")
            for owner, (b, n) in sorted(self._owner_books.items()):
                if b < 0 or n < 0:
                    lines.append(f"owner {owner!r} books negative: "
                                 f"{b}B/{n} blocks")
            for name, e in sorted(self._entries.items()):
                book = self._owner_books.get(name)
                if e.state == HOST and book and (book[0] or book[1]):
                    lines.append(
                        f"host-staged model {name!r} still books "
                        f"{book[0]}B/{book[1]} blocks")
            return lines

    # ---- lifecycle / introspection ----------------------------------------
    def stats(self) -> Dict[str, object]:
        with self._space:
            return {
                "budget_bytes": self.budget_bytes,
                "used_bytes": self.used_bytes,
                "used_blocks": self.used_blocks,
                "pageins": self.pageins,
                "evictions": self.evictions,
                "models": {
                    name: {"state": e.state, "pinned": e.pinned,
                           "pin_count": e.pin_count, "bytes": e.nbytes,
                           "blocks": e.nblocks, "version": e.version,
                           "served": e.records_served,
                           "shed": e.records_shed,
                           "errors": e.records_errored,
                           "breaker": e.breaker.state}
                    for name, e in sorted(self._entries.items())},
            }

    def stop(self) -> None:
        self._stop.set()
        self._pager.join(timeout=10)
        # drop OUR ledger pools only: close() is a no-op when a newer
        # registry instance already took the names
        for p in self._mem_pools:
            p.close()
        # wake anyone parked on a never-arriving page-in
        with self._space:
            entries = list(self._entries.values())
        for e in entries:
            if not e._ready.is_set():
                e._error = PageInError("registry stopped")
                e._ready.set()

    def __enter__(self) -> "ModelRegistry":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
