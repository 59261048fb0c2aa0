"""ClusterServing: the streaming inference engine.

Port of ``analytics_zoo_tpu/serving/engine.py`` over one
``InferenceModel``, or over a ``ModelRegistry`` of named models
(``serving/model_zoo.py``, pipelined mode only), in its two modes:

- pipelined (``ServingConfig(pipeline=True)``, the default): a reader
  thread admits stream entries (deadline gate, admission credits, shed
  with an explicit rejection past the bound), decode workers turn wire
  frames into arrays, an exec thread coalesces records for at most
  ``linger_ms`` (up to ``max_batch``; a client-batched entry stays one
  unit end to end) and submits each same-signature group to a small
  dispatch pool (``InferenceModel.predict_async``), and a sink thread
  fetches the results in submission order and writes them back in one
  bulk replace per group.  ``stop`` drains upstream to downstream, so an
  entry read off the stream always gets a result or an error.
- classic (``pipeline=False``): each replica thread reads up to
  ``batch_size`` entries, groups them by input signature, runs one
  ``InferenceModel.predict`` per group and writes the results back; a
  failing batch is retried entry by entry.

A multi-input model receives each batch as a dict of arrays by input name;
a model that takes a sequence (BERT: ``[input_ids, token_type_ids,
input_mask]``) is served through the ``InferenceModel`` preprocessor.
Results go back as ndarray frames or as top-N ``cls:prob`` pairs.

Observability as in the JAX engine: the ``zoo_serving_*`` series, the
wire trace context (``trace_ctx``) continued by the ``serving.decode`` →
``serving.dispatch`` → ``serving.sink`` spans (the dispatch span's id
rides the pending queue to the sink), the chaos points ``broker_read``,
``decode`` and ``dispatch_submit``, and a flight-recorder dump when a
stage thread dies or the overload latch closes.  The dispatch span covers
the submission (the launch is asynchronous); the device's time shows in
the sink span, which waits on the dispatch's CUDA event.  No record reads
a CUDA tensor.

Multi-model (``ClusterServing(registry)``): entries route by their wire
``model`` field (none: the registry's default model); each model gates
admission on its own credits and circuit breaker (both non-blocking at
the reader), the reader prefetches a cold model's weights on admission,
every dispatch pins its model from submit to the sink's fetch (so it
cannot be evicted mid-flight), a dispatch whose model is not resident
waits for its page-in on a small cold pool of its own, and batches never
merge across models.  The sink consumes finished dispatches as they
complete, so a page-in never holds up another model's results.

Tenancy (``ClusterServing(tenancy=)`` or ``ServingConfig.tenants``,
pipelined, single model): entries gate on their wire ``tenant``'s own
credit pool (``serving/tenancy.py``), a tenant over quota is shed with
``scope=tenant``, and the batched flush orders tenants by weighted
virtual time.  Tenancy with a registry raises ``ValueError``, as in the
JAX engine.

Not ported yet (ROADMAP Queue 1 item 1): server-side image decode and the
Redis / native / fleet / journaled brokers with the sink's publish
retries; the TensorBoard curves (item 6).
"""

from __future__ import annotations

import contextvars
import logging
import queue
import threading
import time
from collections import deque
from concurrent.futures import CancelledError, ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common.config import ServingConfig
from analytics_zoo_tpu_torch.common.resilience import (
    AdmissionController, Deadline, DeadlineExceeded, deadline_scope,
    record_expired)
from analytics_zoo_tpu_torch.common.unported import reject
from analytics_zoo_tpu_torch.serving.broker import get_broker
from analytics_zoo_tpu_torch.serving.codec import (
    ImageBytes, StringTensor, decode_items, encode_ndarray_output,
    encode_ndarray_output_bytes, reference_wire_forced)
from analytics_zoo_tpu_torch.serving.model_zoo import ModelRegistry
from analytics_zoo_tpu_torch.serving.tenancy import TenancyController
from analytics_zoo_tpu_torch.observability import flight_recorder
from analytics_zoo_tpu_torch.testing import chaos

logger = logging.getLogger("analytics_zoo_tpu_torch.serving")


def top_n_postprocess(arr: np.ndarray, n: int):
    """The reference post-processing topN filter (``topN(3)``)."""
    order = np.argsort(-arr)[:n]
    return [(int(i), float(arr[i])) for i in order]


def parse_filter(spec: str) -> int:
    """Parse the reference filter grammar ``filter_name(args)``; only
    ``topN(n)`` exists."""
    spec = spec.strip()
    if not spec.endswith(")") or spec.count("(") != 1:
        raise ValueError(
            "please check your filter format, should be "
            f"filter_name(filter_args); got {spec!r}")
    name, _, args = spec[:-1].partition("(")
    if name != "topN":
        raise ValueError(f"unknown post-processing filter {name!r}; "
                         "supported: topN(n)")
    parts = [a for a in args.split(",") if a.strip()]
    if len(parts) != 1:
        raise ValueError("topN filter only supports 1 argument")
    n = int(parts[0])
    if n <= 0:
        raise ValueError(f"topN argument must be positive, got {n}")
    return n


class _PreBatched:
    """A client-batched stream entry (or a merge of several) travelling
    the pipeline as ONE unit: per-record sids and uris and the decoded
    dict of (N, ...) arrays.  ``tref`` is the trace reference its dispatch
    span parents to (the entry's decode span, or the wire context); a
    merge of several entries keeps the first entry's parent and lists the
    other merged trace ids in ``links``.  ``ment`` is the routed
    ``ModelEntry`` (None with one model) and ``tstate`` the entry's
    ``TenantState`` (None without tenancy): batches merge only within one
    model and one tenant."""

    __slots__ = ("sids", "uris", "decoded", "n", "deadline", "tref",
                 "links", "ment", "tstate")

    def __init__(self, sids, uris, decoded, n, deadline=None, tref=None,
                 links=None, ment=None, tstate=None):
        self.sids = sids
        self.uris = uris
        self.decoded = decoded
        self.n = n
        self.deadline = deadline
        self.tref = tref
        self.links = links
        self.ment = ment
        self.tstate = tstate


class ClusterServing:
    """The serving daemon over one ``InferenceModel`` or a
    ``ModelRegistry`` of named models."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 broker=None, tenancy=None):
        self.config = config or ServingConfig()
        cfg = self.config
        reject("ClusterServing", 1, dict(image_chw=False),
               image_resize=cfg.image_resize, image_chw=cfg.image_chw,
               image_scale=cfg.image_scale)
        reject("ClusterServing", 6, tensorboard_dir=cfg.tensorboard_dir)
        # per-tenant isolation: an explicit controller, or one built from
        # the config's tenants rows
        self.tenancy = (tenancy if tenancy is not None
                        else TenancyController.from_config(cfg.tenants))
        if self.tenancy is not None and not cfg.pipeline:
            raise ValueError("tenancy needs the pipelined engine: "
                             "ServingConfig(pipeline=True)")
        if self.tenancy is not None and isinstance(model, ModelRegistry):
            raise ValueError("tenancy + multi-model registry is not "
                             "supported yet: per-model and per-tenant "
                             "credit gates would double-account")
        self.top_n = cfg.top_n
        if cfg.filter:
            n = parse_filter(cfg.filter)
            if self.top_n is not None and self.top_n != n:
                raise ValueError(
                    f"conflicting post-processing config: top_n="
                    f"{self.top_n} vs filter={cfg.filter!r}")
            self.top_n = n
        if isinstance(model, ModelRegistry):
            if not cfg.pipeline:
                # the classic loop predicts inline on one model; routing,
                # per-model credits and the pager live in the pipeline
                raise ValueError(
                    "multi-model serving (a ModelRegistry) requires the "
                    "pipelined engine: ServingConfig(pipeline=True)")
            self.registry, self.model = model, None
        else:
            self.registry, self.model = None, model
        self.broker = broker or get_broker(cfg.redis_url)
        self.stream = cfg.input_stream
        self.group = cfg.consumer_group
        self.broker.xgroup_create(self.stream, self.group)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._pipelined = False
        self.records_processed = 0
        self.records_shed = 0
        self.records_expired = 0
        self._metrics_lock = threading.Lock()
        self._window_start = time.monotonic()
        self._window_count = 0
        self.throughput = 0.0
        self.admission: Optional[AdmissionController] = None
        self._q_hwm: Dict[str, int] = {}
        # registry series: lazy handles shared process-wide, following
        # set_registry() swaps like every other instrumentation point
        self._m_records = obs.lazy_counter(
            "zoo_serving_records_total", "records served to completion")
        self._m_errors = obs.lazy_counter(
            "zoo_serving_errors_total", "entries finished with an error")
        self._m_disp_lat = obs.lazy_histogram(
            "zoo_serving_dispatch_latency_seconds",
            "device dispatch submit -> sink completion")
        self._m_fill = obs.lazy_histogram(
            "zoo_serving_batch_fill_ratio",
            "records per device dispatch / dispatch capacity "
            "(max_batch pipelined, batch_size classic)",
            buckets=(0.0625, 0.125, 0.25, 0.5, 0.75, 1.0))
        self._m_tput = obs.lazy_gauge(
            "zoo_serving_throughput_rps",
            "records/sec over the last ~1s window")
        self._m_qdepth = obs.lazy_gauge(
            "zoo_serving_queue_depth",
            "pipeline stage queue depths", ["queue"])
        self._m_qhwm = obs.lazy_gauge(
            "zoo_serving_queue_high_water",
            "max stage queue depth seen since start()", ["queue"])

    # ---- lifecycle --------------------------------------------------------
    def start(self) -> "ClusterServing":
        # restartable after stop(); refused while old threads still drain
        self._threads = [t for t in self._threads if t.is_alive()]
        if self._threads:
            raise RuntimeError(
                "previous drain threads still running; call stop() and "
                "wait for them to finish before restarting")
        if self.config.image_uint8 and any(
                getattr(m, "preprocessor", None) is None
                for m in self._served_models()):
            raise ValueError(
                "ServingConfig.image_uint8=True but the model has no "
                "preprocessor to widen the uint8 pixels on the device")
        self._stop.clear()
        if self.config.pipeline:
            self._start_pipeline()
            return self
        # classic mode: one drain loop per replica; predicts overlap
        # through the InferenceModel's execution slots
        self._pipelined = False
        for i in range(max(self.config.replicas, 1)):
            name = f"serving-{i}"
            self._spawn(name, lambda c=name: self.run(c))
        return self

    def _spawn(self, name: str, fn) -> None:
        t = threading.Thread(target=self._run_stage, args=(name, fn),
                             name=name, daemon=True)
        t.start()
        self._threads.append(t)

    def _start_pipeline(self) -> None:
        cfg = self.config
        mb = max(cfg.max_batch, 1)
        self._q_raw: queue.Queue = queue.Queue(maxsize=4 * mb)
        self._q_dec: queue.Queue = queue.Queue(maxsize=4 * mb)
        self._q_pend: queue.Queue = queue.Queue(maxsize=4)
        # pull-time gauges: depth is read at scrape, never maintained on
        # the hot path (the latest started engine owns the series)
        self._m_qdepth.labels(queue="raw").set_function(self._q_raw.qsize)
        self._m_qdepth.labels(queue="decoded").set_function(
            self._q_dec.qsize)
        self._m_qdepth.labels(queue="pending").set_function(
            self._q_pend.qsize)
        self._reader_done = threading.Event()
        self._decoders_done = threading.Event()
        self._exec_done = threading.Event()
        self._pipelined = True
        # the dispatch pool overlaps one batch's launch with the previous
        # one's fetch; per-uri result keys make publication order free
        concurrency = max(max((getattr(m, "concurrency", 1)
                               for m in self._served_models()),
                              default=1), 1)
        pool_workers = max(concurrency, 2)
        self._dispatch_pool = ThreadPoolExecutor(
            max_workers=pool_workers, thread_name_prefix="serving-dispatch")
        if self.registry is not None:
            # a dispatch whose model is not resident at submit waits for
            # its page-in on a pool of its own, never taking a worker
            # from the resident models; the one pager serialises the
            # transfers, so two waiters suffice
            self._cold_pool = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="serving-dispatch-cold")
        # dispatched-but-unfetched batches, taken in the exec thread
        # before a submit and returned by the sink after the fetch: at
        # most the model's own in-flight bound (2x its concurrency), so
        # no pool worker ever parks on that bound while the sink waits
        # for an earlier batch (submission order == permit order)
        self._permits = threading.Semaphore(2 * concurrency)
        # credits sized from the dispatch depth: the pool can usefully
        # hold 2x its workers' batches in flight; beyond that, queueing
        # is pure latency.  A fresh controller per start(): entries
        # dropped by an earlier stop() must not pin stale credits.
        self._q_hwm = {}
        if self.registry is not None:
            # admission is per model (each entry's own credits), fresh at
            # every start(): entries dropped by an earlier stop() must not
            # pin stale credits
            self.admission = None
            self.registry.reset_admission()
        elif self.tenancy is not None:
            # admission is per tenant (each tenant's own pool)
            self.admission = None
        elif cfg.admission_control:
            credits = cfg.admission_max_inflight or max(
                2 * pool_workers * mb, 4 * mb)
            self.admission = AdmissionController(credits, name="serving")
        else:
            self.admission = None
        for qname in ("raw", "decoded", "pending"):
            self._m_qhwm.labels(queue=qname).set(0.0)
        stages = [("serving-reader", self._reader_loop)]
        for i in range(max(cfg.decode_workers, 1)):
            stages.append((f"serving-decode-{i}", self._decode_loop))
        stages.append(("serving-exec", self._exec_loop))
        stages.append(("serving-sink", self._sink_loop))
        for name, fn in stages:
            self._spawn(name, fn)

    def _run_stage(self, name: str, fn) -> None:
        """Stage-thread entry: the loops guard their own bodies, so what
        escapes here is a dying worker thread, the moment the flight
        recorder exists for.  Snapshot, then let the thread die loudly."""
        try:
            fn()
        except BaseException as exc:
            logger.exception("stage thread %s died", name)
            obs.add_event("thread_death", span=None, thread=name,
                          error=f"{type(exc).__name__}: {exc}")
            flight_recorder.get().trigger("thread_death", detail=name)
            raise

    # ---- pipelined stages -------------------------------------------------
    # Shutdown contract: stop() drains upstream to downstream.  Every stage
    # keeps consuming until the stage above has finished AND its input
    # queue is empty (_reader_done / _decoders_done / _exec_done), so an
    # entry whose stream cursor advanced always gets a result or an error.
    # Producers retry their puts (the consumer below still drains), and
    # every stage body is guarded so one bad batch cannot kill a thread.

    def _put_forever(self, q, item, name: Optional[str] = None) -> None:
        while True:
            try:
                q.put(item, timeout=0.1)
                break
            except queue.Full:
                continue
        if name is not None:
            # high-water mark, sampled at put time; a lost update between
            # two decoders only blurs a tuning figure (credits, not this
            # number, bound the depth)
            depth = q.qsize()
            if depth > self._q_hwm.get(name, 0):
                self._q_hwm[name] = depth
                # gauge write only on a new max
                self._m_qhwm.labels(queue=name).set(float(depth))

    def _reader_loop(self) -> None:
        saturated = False   # overload latch, local to the reader thread
        while not self._stop.is_set():
            try:
                chaos.fire("broker_read")
                entries = self.broker.xreadgroup(
                    self.stream, self.group, "serving-reader",
                    count=self.config.max_batch, block_ms=20)
            except (Exception, CancelledError):
                logger.exception("reader failed; retrying")
                time.sleep(0.1)
                continue
            for entry in entries or []:
                saturated = self._admit(entry, saturated)

    # ---- admission + deadline gate ----------------------------------------
    # Runs in the reader thread, before work enters the stage queues: an
    # expired entry is rejected without taking a credit, and load beyond
    # the credit bound waits at most admission_timeout_ms before it is
    # shed with an explicit rejection (HTTP 429).  In sustained overload
    # only the first entry pays the wait: the latch sheds the backlog at
    # once until credits free up.

    @staticmethod
    def _trace_ref(fields):
        """The entry's wire trace context (``trace_ctx``, stamped by
        InputQueue) as a span parent, or None.  One flag check when
        tracing is disabled: no parsing on the disabled hot path."""
        if not obs.get_tracer().enabled:
            return None
        return obs.decode_trace_context(fields.get("trace_ctx"))

    @staticmethod
    def _dispatch_trace(trefs):
        """``(parent_ref, span_attrs)`` for a dispatch span covering
        entries with these trace refs.  The parent is the first traced
        entry, and every other distinct trace rides a ``links`` attr so
        none loses its dispatch."""
        parent = next((t for t in trefs if t is not None), None)
        links = sorted({t[0] for t in trefs if t is not None}
                       - ({parent[0]} if parent is not None else set()))
        return parent, ({"links": links} if links else {})

    def _served_models(self):
        """The model objects this engine dispatches to (one, or every
        registry entry's)."""
        if self.registry is None:
            return [self.model]
        return [self.registry.resolve(name).model
                for name in self.registry.models()]

    def _entry_deadline(self, fields, ment=None,
                        tstate=None) -> Optional[Deadline]:
        """The entry's wire deadline, else its model's or its tenant's
        default, else the configured default."""
        ts = fields.get("deadline_ts")
        if ts is not None:
            try:
                return Deadline.from_wall(float(ts))
            except (TypeError, ValueError):
                logger.warning("unparsable deadline_ts %r ignored", ts)
        if ment is not None and ment.default_deadline_ms:
            return Deadline(ment.default_deadline_ms / 1e3)
        if tstate is not None and tstate.policy.default_deadline_ms:
            return Deadline(tstate.policy.default_deadline_ms / 1e3)
        if self.config.default_deadline_ms:
            return Deadline(self.config.default_deadline_ms / 1e3)
        return None

    def _admit_model(self, sid, fields, n: int, tref) -> None:
        """The multi-model gate: resolve the entry's model, then its own
        credits and breaker, every check non-blocking, so one model's
        overload never holds up the shared reader."""
        try:
            ment = self.registry.resolve(fields.get("model") or None)
        except KeyError as exc:
            self._reject_entry(sid, fields, "error", str(exc), n=n,
                               tref=tref)
            return
        dl = self._entry_deadline(fields, ment)
        if dl is not None and dl.expired:
            self._reject_entry(sid, fields, "expired",
                               "deadline expired before admission", n=n,
                               tref=tref)
            return
        madm = ment.admission
        need = min(n, madm.capacity)
        if madm.try_acquire(need):
            if n > need:        # an oversized entry forces the excess
                madm.force_acquire(n - need)
        elif self._stop.is_set():
            # drain path: the cursor already advanced, never drop
            madm.force_acquire(n)
        else:
            self._shed_entry(sid, fields, n, tref=tref, ment=ment)
            return
        if not ment.breaker.allow():
            # the model is ejected (its page-ins or dispatches keep
            # failing): fail fast, retryable, and return the credits
            madm.release(n)
            self._shed_entry(
                sid, fields, n, tref=tref, ment=ment,
                msg=f"model {ment.name!r} circuit open; failing fast - "
                    "retry with backoff")
            return
        # by dispatch time the pager has overlapped this page-in with the
        # other models' work
        self.registry.prefetch(ment)
        self._put_forever(self._q_raw, (sid, fields, dl, n, tref, ment,
                                        None), name="raw")

    def _admit_tenant(self, sid, fields, n: int, tref) -> None:
        """The multi-tenant gate: resolve the entry's tenant, then its own
        credit pool, non-blocking, so a tenant past its quota sheds at its
        own gate and never holds up another tenant."""
        try:
            tstate = self.tenancy.resolve(fields.get("tenant") or None)
        except KeyError as exc:
            self._reject_entry(sid, fields, "error", str(exc), n=n,
                               tref=tref)
            return
        dl = self._entry_deadline(fields, tstate=tstate)
        if dl is not None and dl.expired:
            self._reject_entry(sid, fields, "expired",
                               "deadline expired before admission", n=n,
                               tref=tref, tstate=tstate)
            return
        need = min(n, tstate.admission.capacity)
        try:
            admitted = self.tenancy.tenant_acquire(tstate, need)
        except (Exception, CancelledError) as exc:
            # the gate faulted before any book moved: reject with the
            # books untouched
            logger.exception("tenant admission fault for %s", sid)
            self._reject_entry(sid, fields, "error",
                               f"tenant admission fault: {exc}", n=n,
                               tref=tref)
            return
        if admitted:
            if n > need:
                self.tenancy.tenant_force_acquire(tstate, n - need)
        elif self._stop.is_set():
            self.tenancy.tenant_force_acquire(tstate, n)
        else:
            self._shed_entry(
                sid, fields, n, tref=tref, tstate=tstate,
                msg=f"tenant {tstate.name!r} is over its credit quota; "
                    "shed at its own gate - retry with backoff")
            return
        self._put_forever(self._q_raw, (sid, fields, dl, n, tref, None,
                                        tstate), name="raw")

    def _admit(self, entry, saturated: bool) -> bool:
        """Gate one entry; returns the updated overload latch."""
        sid, fields = entry
        n = int(fields.get("batch", 0) or 0) or 1
        tref = self._trace_ref(fields)
        if self.registry is not None:
            self._admit_model(sid, fields, n, tref)
            return saturated
        if self.tenancy is not None:
            self._admit_tenant(sid, fields, n, tref)
            return saturated
        dl = self._entry_deadline(fields)
        if dl is not None and dl.expired:
            self._reject_entry(sid, fields, "expired",
                               "deadline expired before admission", n=n,
                               tref=tref)
            return saturated
        adm = self.admission
        if adm is not None:
            # an entry bigger than the whole pool can never fit: admit it
            # once the pool drains and force the remainder
            need = min(n, adm.capacity)
            if adm.try_acquire(need):
                saturated = False
            elif self._stop.is_set():
                # drain path: the stream cursor already advanced, the
                # entry must reach a result
                adm.force_acquire(need)
            elif saturated or not adm.acquire(
                    need, timeout=self.config.admission_timeout_ms / 1e3,
                    stop=self._stop):
                if self._stop.is_set():
                    adm.force_acquire(need)
                else:
                    if not saturated:
                        # latch transition = the start of a sustained
                        # overload episode: capture the moment once,
                        # rate-limited against latch flapping
                        flight_recorder.get().trigger(
                            "overload", detail=f"stream={self.stream}",
                            min_interval_s=5.0)
                    self._shed_entry(sid, fields, n, tref=tref)
                    return True
            else:
                saturated = False
            if n > need:
                adm.force_acquire(n - need)
        # the acquired credit count rides the work item: releases mirror
        # exactly what was acquired here, never the client's uri split
        self._put_forever(self._q_raw, (sid, fields, dl, n, tref, None,
                                        None), name="raw")
        return saturated

    def _shed_entry(self, sid, fields, n: int, tref=None, ment=None,
                    tstate=None,
                    msg: str = "server overloaded; admission control "
                               "shed this request - retry with backoff"
                    ) -> None:
        adm = (tstate.admission if tstate is not None
               else ment.admission if ment is not None else self.admission)
        if adm is not None:
            adm.shed(n, trace_id=tref[0] if tref else None)
        if ment is not None:
            ment.count_shed(n)
        if tstate is not None:
            self.tenancy.count_shed(tstate, n)
        with self._metrics_lock:
            self.records_shed += n
        # a shed at a tenant's own gate is that tenant's quota, not engine
        # overload: the result says so
        self._reject_entry(sid, fields, "shed", msg,
                           scope="tenant" if tstate is not None else None)

    def _count_expired(self, k: int, tref=None, tstate=None) -> None:
        """One accounting point for deadline-expired records: the
        registry series, the event journal, the ``metrics()`` counter and
        the tenant's book never diverge."""
        record_expired(k, trace_id=tref[0] if tref else None)
        if tstate is not None:
            self.tenancy.count_expired(tstate, k)
        with self._metrics_lock:
            self.records_expired += k

    def _reject_entry(self, sid, fields, code: str, msg: str,
                      n: Optional[int] = None, tref=None, tstate=None,
                      scope: Optional[str] = None) -> None:
        """Error-finish every record of a NOT-YET-ADMITTED entry (no
        credits to release) with a machine-readable code, in one bulk
        write.  ``n`` is the entry's declared record count, which expiry
        accounting uses (never the client-controlled uri split)."""
        uris = fields.get("uri", "?").split("\x1f")
        if code == "expired":
            self._count_expired(n if n is not None else
                                int(fields.get("batch", 0) or 0) or 1,
                                tref=tref, tstate=tstate)
        extra = {"scope": scope} if scope else {}
        try:
            self.broker.set_results(
                {f"result:{u}": {"error": msg, "code": code, **extra}
                 for u in uris})
        except (Exception, CancelledError):
            logger.exception("could not record %s results for entry %s",
                             code, sid)
        try:
            self.broker.xack(self.stream, self.group, sid)
        except (Exception, CancelledError):
            logger.exception("could not ack rejected entry %s", sid)

    def _decode_loop(self) -> None:
        # exit gates on _reader_done, not _stop: the reader can still be
        # between xreadgroup and _put_forever when _stop flips
        while not (self._reader_done.is_set() and self._q_raw.empty()):
            try:
                sid, fields, dl, n_adm, tref, ment, tstate = \
                    self._q_raw.get(timeout=0.05)
            except queue.Empty:
                continue
            uri = fields.get("uri", "?")
            if dl is not None and dl.expired:
                # admitted but out of budget: dropped before the decode;
                # credits release by the ACQUIRED count n_adm
                for u in uri.split("\x1f"):
                    self._try_finish_error(
                        sid, u, DeadlineExceeded(
                            "deadline expired before decode"),
                        code="expired", count_error=False, release=False,
                        ment=ment, tstate=tstate)
                self._count_expired(n_adm, tref=tref, tstate=tstate)
                self._release_admission(n_adm, ment, tstate)
                continue
            try:
                n = int(fields.get("batch", 0) or 0)
                if n:
                    # a batched entry stays batched end to end: one
                    # decode, one queue item, one dispatch, one sink write
                    uris = fields["uri"].split("\x1f")
                    if len(uris) != n:
                        raise ValueError(
                            f"batched entry carries {n} records but "
                            f"{len(uris)} uris")
                    with obs.span("serving.decode", parent=tref,
                                  records=n) as dsp, deadline_scope(dl):
                        decoded = self._decode_entry(fields, batch_n=n)
                    # downstream spans parent to the decode span, which
                    # carries the request's trace onward (wire context →
                    # decode → dispatch → sink, one trace end to end)
                    dref = ((dsp.trace_id, dsp.span_id)
                            if dsp is not None else tref)
                    # max_batch caps the device batch; client batches
                    # are cut to it
                    mb = max(self.config.max_batch, 1)
                    for lo in range(0, n, mb):
                        hi = min(lo + mb, n)
                        self._put_forever(self._q_dec, _PreBatched(
                            [sid] * (hi - lo), uris[lo:hi],
                            {k: v[lo:hi] for k, v in decoded.items()},
                            hi - lo, deadline=dl, tref=dref, ment=ment,
                            tstate=tstate),
                            name="decoded")
                else:
                    with obs.span("serving.decode", parent=tref,
                                  records=1) as dsp, deadline_scope(dl):
                        decoded1 = self._decode_entry(fields)
                    dref = ((dsp.trace_id, dsp.span_id)
                            if dsp is not None else tref)
                    self._put_forever(self._q_dec,
                                      (sid, uri, decoded1, dl, dref, ment,
                                       tstate),
                                      name="decoded")
            except (Exception, CancelledError) as exc:
                logger.exception("decode failed for %s", uri)
                for u in uri.split("\x1f"):
                    self._try_finish_error(sid, u, exc, release=False,
                                           ment=ment, tstate=tstate)
                self._release_admission(n_adm, ment, tstate)

    def _dispatch_group_list(self, groups: List[_PreBatched]) -> int:
        """Expire, merge and dispatch one same-signature list of
        prebatched groups; returns the records dispatched."""
        live = []
        for g in groups:
            if g.deadline is not None and g.deadline.expired:
                for sid, uri in zip(g.sids, g.uris):
                    self._expire_record(sid, uri, tref=g.tref, ment=g.ment,
                                        tstate=g.tstate)
            else:
                live.append(g)
        if not live:
            return 0
        if len(live) == 1:
            merged = live[0]
        else:
            # one device dispatch for the whole window: per-GROUP
            # concatenation, never per-record work
            names = list(live[0].decoded.keys())
            parent, link_attrs = self._dispatch_trace(
                [g.tref for g in live])
            merged = _PreBatched(
                [s for g in live for s in g.sids],
                [u for g in live for u in g.uris],
                {k: np.concatenate([g.decoded[k] for g in live])
                 for k in names},
                sum(g.n for g in live), tref=parent,
                links=link_attrs.get("links"), ment=live[0].ment,
                tstate=live[0].tstate)
        try:
            self._dispatch_prebatched(merged)
        except (Exception, CancelledError) as exc:
            # a failed submit (pool shut by a racing stop()) error-finishes
            # the merged batch, it does not kill the exec thread
            logger.exception("dispatch merged batch failed; erroring "
                             "entries")
            self._resolve_breaker(merged.ment, ok=False)
            for sid, uri in zip(merged.sids, merged.uris):
                self._try_finish_error(sid, uri, exc, ment=merged.ment,
                                       tstate=merged.tstate)
            return 0
        return merged.n

    def _exec_loop(self) -> None:
        mb = self.config.max_batch
        linger_s = self.config.linger_ms / 1e3
        pend: List = []                  # single records awaiting coalesce
        pendb: List[_PreBatched] = []    # same-signature client batches
        pendb_n = 0
        pendb_key = None
        # with tenancy every key's groups wait out the linger window, so
        # the flush can go in weighted-fair order
        pendb_map: Dict[tuple, List[_PreBatched]] = {}
        pendb_map_n = 0
        deadline = None                  # singles linger deadline
        deadline_b = None                # batches linger deadline

        def flush_singles():
            nonlocal pend, deadline
            batch, pend, deadline = pend, [], None
            # expired work is dropped HERE, before it takes a device slot
            live = []
            for item in batch:
                dl = item[3]
                if dl is not None and dl.expired:
                    self._expire_record(item[0], item[1], tref=item[4],
                                        ment=item[5], tstate=item[6])
                else:
                    live.append(item)
            if not live:
                return
            try:
                self._dispatch(live)
            except (Exception, CancelledError) as exc:
                logger.exception("dispatch batch failed; erroring entries")
                for sid, uri, _, _, _, ment, tstate in live:
                    self._try_finish_error(sid, uri, exc, ment=ment,
                                           tstate=tstate)

        def flush_batches():
            nonlocal pendb, pendb_n, pendb_key, deadline_b
            groups, pendb, pendb_n, pendb_key = pendb, [], 0, None
            deadline_b = None
            self._dispatch_group_list(groups)

        def flush_tenant_batches(drain: bool = False):
            # the window's budget (max_batch records) goes least virtual
            # time first, each tenant's virtual time advancing by records /
            # weight; an overfilled window's overflow (the largest virtual
            # times) waits for the next window.  A drain dispatches all.
            nonlocal pendb_map, pendb_map_n, deadline_b
            held, pendb_map, pendb_map_n = pendb_map, {}, 0
            deadline_b = None
            if not held:
                return
            by_tenant: Dict[str, List[tuple]] = {}
            for key, groups in held.items():
                by_tenant.setdefault(key[0] or "", []).append((key, groups))
            budget = max(mb, 1)
            spent = 0
            for tname in self.tenancy.scheduler.order(by_tenant):
                for key, groups in by_tenant[tname]:
                    if not drain and spent >= budget:
                        pendb_map.setdefault(key, []).extend(groups)
                        pendb_map_n += sum(g.n for g in groups)
                        continue
                    served = self._dispatch_group_list(groups)
                    spent += served
                    if served and groups[0].tstate is not None:
                        self.tenancy.scheduler.charge(
                            tname, served, groups[0].tstate.policy.weight)
            if pendb_map:
                deadline_b = time.monotonic() + linger_s

        def sig_of(pb):
            # the model and the tenant are part of the key: a dispatch runs
            # one model and is charged to one tenant
            return (pb.tstate.name if pb.tstate is not None else None,
                    pb.ment.name if pb.ment is not None else None,
                    tuple(sorted((k, v.shape[1:], str(v.dtype))
                                 for k, v in pb.decoded.items())))

        while not (self._stop.is_set() and self._decoders_done.is_set()
                   and self._q_dec.empty()
                   and not (pend or pendb or pendb_map)):
            timeout = 0.05
            waits = [d for d in (deadline if pend else None,
                                 deadline_b if (pendb or pendb_map)
                                 else None)
                     if d is not None]
            if waits:
                timeout = max(min(waits) - time.monotonic(), 0.0)
            item = None
            try:
                item = self._q_dec.get(timeout=timeout)
            except queue.Empty:
                pass
            if isinstance(item, _PreBatched):
                flush_singles()           # keep arrival order
                key = sig_of(item)
                if self.tenancy is not None:
                    if not pendb_map:
                        deadline_b = time.monotonic() + linger_s
                    pendb_map.setdefault(key, []).append(item)
                    pendb_map_n += item.n
                    if pendb_map_n >= mb or self._stop.is_set():
                        flush_tenant_batches(drain=self._stop.is_set())
                    continue
                if pendb and (key != pendb_key or pendb_n + item.n > mb):
                    flush_batches()
                if not pendb:
                    deadline_b = time.monotonic() + linger_s
                pendb.append(item)
                pendb_key = key
                pendb_n += item.n
                if pendb_n >= mb or self._stop.is_set():
                    flush_batches()
                continue
            if item is not None:
                flush_batches()           # keep arrival order
                flush_tenant_batches(drain=self._stop.is_set())
                if not pend:
                    deadline = time.monotonic() + linger_s
                pend.append(item)
            now = time.monotonic()
            if pendb and (self._stop.is_set()
                          or (deadline_b is not None and now >= deadline_b)):
                flush_batches()
            if pendb_map and (self._stop.is_set()
                              or (deadline_b is not None
                                  and now >= deadline_b)):
                flush_tenant_batches(drain=self._stop.is_set())
            if pend and (len(pend) >= mb or self._stop.is_set()
                         or (deadline is not None and now >= deadline)):
                flush_singles()

    def _dispatch(self, batch) -> None:
        sids = [item[0] for item in batch]
        uris = [item[1] for item in batch]
        tensors = [item[2] for item in batch]
        trefs = [item[4] for item in batch]
        ments = [item[5] for item in batch]
        tstates = [item[6] for item in batch]
        # the group key holds the tensor NAMES too (clients with different
        # input signatures may share one linger window), the model (a
        # dispatch runs one) and the tenant (a dispatch is charged to one)
        shape_of = lambda t: tuple(sorted((n, v.shape, v.dtype.str)
                                          for n, v in t.items()))
        groups: Dict[tuple, list] = {}
        for idx, t in enumerate(tensors):
            groups.setdefault(
                (ments[idx].name if ments[idx] is not None else None,
                 tstates[idx].name if tstates[idx] is not None else None,
                 shape_of(t)), []).append(idx)
        for idxs in groups.values():
            ment, tstate = ments[idxs[0]], tstates[idxs[0]]
            # failure containment is per GROUP: a group already submitted
            # is the sink's (result or error, and its credits); a later
            # group's failure must not error-finish it a second time
            try:
                names = list(tensors[idxs[0]].keys())
                gx = {n: np.stack([tensors[i][n] for i in idxs])
                      for n in names}
                x = gx[names[0]] if len(names) == 1 else gx
                # published one group at a time, so the sink can fetch
                # (returning a permit) before a later group needs one
                parent, attrs = self._dispatch_trace(
                    [trefs[i] for i in idxs])
                if ment is not None:
                    attrs["model"] = ment.name
                if tstate is not None:
                    attrs["tenant"] = tstate.name
                with obs.span("serving.dispatch", parent=parent,
                              records=len(idxs), **attrs) as sp:
                    self._m_fill.observe(
                        len(idxs) / max(self.config.max_batch, 1))
                    fut = self._submit_dispatch(x, ment)
            except (Exception, CancelledError) as exc:
                logger.exception("dispatch group failed; erroring its "
                                 "entries")
                self._resolve_breaker(ment, ok=False)
                for i in idxs:
                    self._try_finish_error(sids[i], uris[i], exc,
                                           ment=ment, tstate=tstate)
                continue
            self._put_forever(self._q_pend,
                              (sids, uris, [(idxs, fut)], time.monotonic(),
                               sp.span_id if sp else None, ment, tstate),
                              name="pending")

    def _submit_dispatch(self, x, ment=None):
        """Submit one device dispatch to the pool.  The pool worker runs it
        in a copy of this thread's context, so the ``serving.dispatch``
        span is its active span: a fault at ``device_execute`` lands on
        that span.

        One model: an engine permit is taken here, in the exec thread
        (permit order == submission order), and the sink returns it.
        Multi-model: the model is pinned here (the pin rides the handle to
        the sink, so a model with work in flight cannot be evicted) and
        its weights are read under the pin; a resident model's permit
        (``reserve``, where the model has one) is taken here, while a
        dispatch whose model is not resident goes to the cold pool, whose
        worker waits for the page-in and then takes the permit itself, so
        the exec thread never blocks behind a transfer."""
        chaos.fire("dispatch_submit")
        run = contextvars.copy_context().run
        if ment is None:
            self._permits.acquire()
            try:
                return self._dispatch_pool.submit(
                    run, self.model.predict_async, x)
            except BaseException:
                self._permits.release()
                raise
        self.registry.pin(ment)
        model = ment.model
        try:
            cold = not ment.resident
            pool = self._cold_pool if cold else self._dispatch_pool
            reserved = hasattr(model, "reserve")
            if reserved and cold:
                return pool.submit(run, self._paged_predict, ment, x,
                                   reserved, True)
            if reserved:
                model.reserve()
            try:
                fut = pool.submit(run, self._paged_predict, ment, x,
                                  reserved)
            except BaseException:
                if reserved:
                    model.release_reservation()
                raise
            if reserved:
                # a task cancelled before it ran (stop()'s
                # cancel_futures) would otherwise keep its permit
                fut.add_done_callback(lambda f: model.release_reservation()
                                      if f.cancelled() else None)
            return fut
        except BaseException:
            # never submitted: the sink will not see this handle
            self.registry.unpin(ment)
            raise

    def _paged_predict(self, ment, x, reserved: bool,
                       acquire: bool = False):
        """Pool-worker body of one multi-model dispatch: wait for the
        model's weights (the pager began at admission), then dispatch.  A
        failed page-in raises here and error-finishes exactly this group
        at the sink.  ``acquire``: the permit is taken here, after the
        page-in (a cold dispatch), not at submit."""
        try:
            self.registry.ensure_resident(ment)
        except BaseException:
            if reserved and not acquire:
                ment.model.release_reservation()
            raise
        if not reserved:
            return ment.model.predict_async(x)
        if acquire:
            ment.model.reserve()
        return ment.model.predict_async(x, reserved=True)

    def _resolve_breaker(self, ment, ok: bool) -> None:
        """One dispatch outcome on the model's breaker (nothing with one
        model).  Fed from the model path only (page-in, dispatch, device),
        never from a client's payload, so one bad client cannot eject a
        healthy model."""
        if ment is None:
            return
        if ok:
            ment.breaker.record_success()
        else:
            ment.breaker.record_failure()

    def _dispatch_prebatched(self, pb: _PreBatched) -> None:
        names = list(pb.decoded.keys())
        x = pb.decoded[names[0]] if len(names) == 1 else pb.decoded
        attrs = {"links": pb.links} if pb.links else {}
        if pb.ment is not None:
            attrs["model"] = pb.ment.name
        if pb.tstate is not None:
            attrs["tenant"] = pb.tstate.name
        with obs.span("serving.dispatch", parent=pb.tref,
                      records=pb.n, **attrs) as sp:
            self._m_fill.observe(pb.n / max(self.config.max_batch, 1))
            fut = self._submit_dispatch(x, pb.ment)
        self._put_forever(self._q_pend,
                          (pb.sids, pb.uris, [(list(range(pb.n)), fut)],
                           time.monotonic(), sp.span_id if sp else None,
                           pb.ment, pb.tstate),
                          name="pending")

    def _sink_loop(self) -> None:
        # a cold model's dispatch completes only after its page-in: items
        # whose future is not done wait in ``stash`` and are consumed as
        # they complete, so finished results of other models never queue
        # behind a transfer; at drain the stash is consumed blocking
        stash: deque = deque()
        while not (self._stop.is_set() and self._exec_done.is_set()
                   and self._q_pend.empty() and not stash):
            draining = (self._stop.is_set() and self._exec_done.is_set()
                        and self._q_pend.empty())
            item = None
            for _ in range(len(stash)):
                cand = stash.popleft()
                if draining or cand[2][0][1].done():
                    item = cand
                    break
                stash.append(cand)
            if item is None:
                try:
                    item = self._q_pend.get(timeout=0.005 if stash
                                            else 0.05)
                except queue.Empty:
                    continue
                if not draining and not item[2][0][1].done():
                    stash.append(item)
                    continue
            self._sink_item(*item)

    def _sink_item(self, sids, uris, handles, t_disp, parent, ment,
                   tstate) -> None:
        model = ment.model if ment is not None else self.model
        for idxs, pending in handles:
            # CancelledError is a BaseException: a future cancelled by
            # stop()'s pool shutdown must error-finish its entries, not
            # kill the sink
            try:
                try:
                    # the fetch waits on the dispatch's CUDA event: the
                    # device's time shows in this span
                    with obs.span("serving.sink", parent=parent,
                                  records=len(idxs)):
                        out = np.asarray(model.fetch(pending.result()))
                        # one bulk result write, one xack per group
                        self.broker.set_results(
                            {f"result:{uris[i]}":
                             {"value": self._encode_result(out[j])}
                             for j, i in enumerate(idxs)})
                        self.broker.xack(self.stream, self.group,
                                         *[sids[i] for i in idxs])
                except (Exception, CancelledError) as exc:
                    logger.exception("sink failed for %d entries",
                                     len(idxs))
                    # the model path failed (page-in, dispatch, device):
                    # its breaker hears it, unless the future was cancelled
                    # before it ran (a shutdown, not the model's fault)
                    if not pending.cancelled():
                        self._resolve_breaker(ment, ok=False)
                    for i in idxs:
                        self._try_finish_error(sids[i], uris[i], exc,
                                               ment=ment, tstate=tstate)
                    continue
            finally:
                # the permit (one model) or the dispatch pin (a registry)
                # returns exactly once per handle, result or error
                if ment is None:
                    self._permits.release()
                else:
                    self.registry.unpin(ment)
            # the group is PUBLISHED: its credits return exactly once,
            # outside the publish guard
            self._resolve_breaker(ment, ok=True)
            if ment is not None:
                ment.count_served(len(idxs))
            if tstate is not None:
                self.tenancy.count_served(tstate, len(idxs))
            self._release_admission(len(idxs), ment, tstate)
            try:
                self._m_disp_lat.observe(time.monotonic() - t_disp)
                self._count(len(idxs))
            except (Exception, CancelledError):
                logger.exception("post-publish accounting failed")

    def _try_finish_error(self, sid, uri, exc, code: str = "error",
                          count_error: bool = True,
                          release: bool = True, ment=None,
                          tstate=None) -> None:
        """Error-finish one ADMITTED record: write the error result and
        return its admission credit (each record takes one credit at the
        reader and returns it on exactly one completion path).  Decode
        callers pass ``release=False`` and return the entry's acquired
        count in one call; expiries pass ``count_error=False`` (they
        count as expired, not as errors).  ``ment`` / ``tstate`` route the
        release and the counts to the record's model and tenant."""
        if count_error:
            self._m_errors.inc()
            if ment is not None:
                ment.count_error()
            if tstate is not None:
                self.tenancy.count_error(tstate)
        if ment is not None and ment.breaker.state == "half_open":
            # while half-open the only admitted records are the breaker's
            # probes: one dying off the model path (expired, undecodable)
            # would spend the probe with no verdict and leave the model
            # ejected for good; a failure restarts the recovery clock
            ment.breaker.record_failure()
        if release:
            self._release_admission(1, ment, tstate)
        try:
            # some exceptions stringify empty (CancelledError): the client
            # must still see what failed
            self.broker.set_results({f"result:{uri}": {
                "error": str(exc) or type(exc).__name__, "code": code}})
            self.broker.xack(self.stream, self.group, sid)
        except (Exception, CancelledError):
            logger.exception("could not record error result for %s", uri)

    def _expire_record(self, sid, uri, tref=None, ment=None,
                       tstate=None) -> None:
        self._count_expired(1, tref=tref, tstate=tstate)
        self._try_finish_error(
            sid, uri, DeadlineExceeded("deadline expired before device "
                                       "dispatch"), code="expired",
            count_error=False, ment=ment, tstate=tstate)

    def _release_admission(self, k: int, ment=None, tstate=None) -> None:
        if tstate is not None:
            self.tenancy.tenant_release(tstate, k)
            return
        adm = ment.admission if ment is not None else self.admission
        if adm is not None:
            adm.release(k)

    def stop(self) -> None:
        self._stop.set()
        if self._pipelined:
            # drain upstream to downstream so nothing already read off
            # the stream is dropped
            by_name = {t.name: t for t in self._threads}
            reader = by_name.get("serving-reader")
            if reader:
                # wait until it is really gone: a reader blocked in
                # _put_forever still holds entries read off the stream
                deadline = time.monotonic() + 60
                while reader.is_alive() and time.monotonic() < deadline:
                    reader.join(timeout=5)
                if reader.is_alive():
                    logger.warning("reader still blocked after 60s; "
                                   "entries it holds may be dropped")
            self._reader_done.set()
            for name, t in by_name.items():
                if name.startswith("serving-decode"):
                    t.join(timeout=10)
            self._decoders_done.set()
            if "serving-exec" in by_name:
                by_name["serving-exec"].join(timeout=30)
            self._exec_done.set()
            if "serving-sink" in by_name:
                by_name["serving-sink"].join(timeout=30)
            # detach the queue-depth gauges if they still point at this
            # engine's queues (a newer engine may own the series): a
            # registry-held qsize would pin the stopped queues forever
            for qname, q in (("raw", self._q_raw), ("decoded", self._q_dec),
                             ("pending", self._q_pend)):
                child = self._m_qdepth.labels(queue=qname)
                if getattr(child, "_fn", None) == q.qsize:
                    child.set_function(None)
                    child.set(0.0)
            pool = getattr(self, "_dispatch_pool", None)
            if pool is not None:
                # the sink drained q_pend, so every future is resolved;
                # cancel_futures fails a never-started task loudly
                pool.shutdown(wait=False, cancel_futures=True)
                self._dispatch_pool = None
            cold = getattr(self, "_cold_pool", None)
            if cold is not None:
                cold.shutdown(wait=False, cancel_futures=True)
                self._cold_pool = None
        else:
            for t in self._threads:
                t.join(timeout=5)
        # a thread that outlived its join stays tracked, so a restart
        # cannot orphan it against a cleared stop flag
        self._threads = [t for t in self._threads if t.is_alive()]

    # ---- classic mode -----------------------------------------------------
    def run(self, consumer: str = "serving-0") -> None:
        while not self._stop.is_set():
            try:
                chaos.fire("broker_read")
                entries = self.broker.xreadgroup(
                    self.stream, self.group, consumer,
                    count=self.config.batch_size, block_ms=50)
            except (Exception, CancelledError):
                # a transient broker failure must not kill the drain thread
                logger.exception("classic read failed; retrying")
                time.sleep(0.1)
                continue
            live = []
            for sid, fields in entries or []:
                dl = self._entry_deadline(fields)
                if dl is not None and dl.expired:
                    self._reject_entry(sid, fields, "expired",
                                       "deadline expired before execution",
                                       tref=self._trace_ref(fields))
                else:
                    live.append((sid, fields))
            entries = live
            if not entries:
                continue
            try:
                self._process_batch(entries)
            except (Exception, CancelledError):
                # one malformed request must not poison the batch: retry
                # each entry alone; failures get an error result so
                # clients do not block until their timeout
                logger.exception("batch failed; retrying entries singly")
                for entry in entries:
                    try:
                        self._process_batch([entry])
                    except (Exception, CancelledError) as exc:
                        uri = entry[1].get("uri", "?")
                        logger.exception("entry %s failed", uri)
                        # a batched entry's error lands on every uri in it
                        self._m_errors.inc(len(uri.split("\x1f")))
                        self.broker.set_results(
                            {f"result:{u}": {"error": str(exc)
                                             or type(exc).__name__,
                                             "code": "error"}
                             for u in uri.split("\x1f")})
            self.broker.xack(self.stream, self.group,
                             *[sid for sid, _ in entries])

    def _process_batch(self, entries) -> None:
        t0 = time.perf_counter()
        uris, tensor_lists, trefs = [], [], []
        for _, fields in entries:
            tref = self._trace_ref(fields)
            for uri, decoded in self._expand_entry(fields):
                uris.append(uri)
                tensor_lists.append(decoded)
                trefs.append(tref)
        # group by input signature: heterogeneous entries must not poison
        # the whole batch
        shape_of = lambda t: tuple(sorted((n, v.shape, v.dtype.str)
                                          for n, v in t.items()))
        groups: Dict[tuple, list] = {}
        for idx, t in enumerate(tensor_lists):
            groups.setdefault(shape_of(t), []).append(idx)
        preds = [None] * len(tensor_lists)
        for idxs in groups.values():
            names = list(tensor_lists[idxs[0]].keys())
            batch = {n: np.stack([tensor_lists[i][n] for i in idxs])
                     for n in names}
            x = batch[names[0]] if len(names) == 1 else batch
            parent, attrs = self._dispatch_trace([trefs[i] for i in idxs])
            with obs.span("serving.dispatch", parent=parent,
                          records=len(idxs), **attrs):
                # a client-batched entry can expand past the classic
                # read bound; the ratio stays in the declared [0, 1]
                self._m_fill.observe(
                    min(1.0, len(idxs) / max(self.config.batch_size, 1)))
                t_disp = time.monotonic()
                out = np.asarray(self.model.predict(x))
                self._m_disp_lat.observe(time.monotonic() - t_disp)
            for j, i in enumerate(idxs):
                preds[i] = out[j]
        # replace, don't merge: a stale error field from an earlier failed
        # attempt must not shadow this result
        self.broker.set_results(
            {f"result:{uri}": {"value": self._encode_result(preds[i])}
             for i, uri in enumerate(uris)})
        self._count(len(uris))
        logger.debug("batch of %d in %.1fms", len(uris),
                     1000 * (time.perf_counter() - t0))

    # ---- shared -----------------------------------------------------------
    def _encode_result(self, value):
        if self.top_n:
            pairs = top_n_postprocess(value.ravel(), self.top_n)
            return ";".join(f"{c}:{p:.6f}" for c, p in pairs)
        if reference_wire_forced():
            return encode_ndarray_output(value)
        return encode_ndarray_output_bytes(value)

    def _count(self, k: int) -> None:
        self._m_records.inc(k)
        with self._metrics_lock:
            self.records_processed += k
            self._window_count += k
            now = time.monotonic()
            if now - self._window_start >= 1.0:
                self.throughput = self._window_count / (now
                                                        - self._window_start)
                self._m_tput.set(self.throughput)
                self._window_start, self._window_count = now, 0

    def _expand_entry(self, fields):
        """``[(uri, decoded)]`` for one stream entry: a batched entry
        (``InputQueue.enqueue_batch``) expands to its records."""
        n = int(fields.get("batch", 0) or 0)
        if not n:
            return [(fields.get("uri", "?"), self._decode_entry(fields))]
        uris = fields["uri"].split("\x1f")
        if len(uris) != n:
            raise ValueError(f"batched entry carries {n} records but "
                             f"{len(uris)} uris")
        decoded = self._decode_entry(fields, batch_n=n)
        return [(uris[j], {k: v[j] for k, v in decoded.items()})
                for j in range(n)]

    def _decode_entry(self, fields, batch_n=None) -> Dict[str, np.ndarray]:
        chaos.fire("decode")
        decoded = {}
        for name, v in decode_items(fields["data"]).items():
            if isinstance(v, ImageBytes):
                raise NotImplementedError(
                    f"image payload {name!r}: server-side image decode is "
                    "not ported yet (ROADMAP Queue 1 item 1)")
            if isinstance(v, StringTensor):
                raise ValueError(
                    f"string tensor {name!r} reached the inference "
                    "engine; string inputs need a text-model pipeline")
            decoded[name] = v
        if batch_n is not None:
            # every tensor of a batched entry must carry one row per record
            for name, v in decoded.items():
                arr_n = getattr(v, "shape", ())[:1]
                if not arr_n or arr_n[0] != batch_n:
                    raise ValueError(
                        f"batched entry tensor {name!r} has leading dim "
                        f"{arr_n[0] if arr_n else 'none'}, expected "
                        f"{batch_n}")
        return decoded

    def metrics(self) -> Dict[str, object]:
        with self._metrics_lock:
            shed, expired = self.records_shed, self.records_expired
        out = {"records_processed": self.records_processed,
               "throughput_rps": round(self.throughput, 2),
               "records_shed": shed,
               "records_expired": expired,
               "queue_high_water": dict(self._q_hwm)}
        adm = self.admission
        if adm is not None:
            out["admission"] = {"capacity": adm.capacity,
                                "in_flight": adm.in_flight}
        if self.registry is not None:
            out["models"] = self.registry.stats()
        if self.tenancy is not None:
            out["tenants"] = self.tenancy.usage()
        return out
