"""ClusterServing: the streaming inference engine.

Port of ``analytics_zoo_tpu/serving/engine.py`` over ONE
``InferenceModel``, in its two modes:

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

Not ported yet (ROADMAP Queue 1 item 1): the model registry, tenancy,
server-side image decode and the Redis / native / fleet brokers with the
sink's publish retries; the spans, metric series and TensorBoard curves
(item 6).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import CancelledError, ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from analytics_zoo_tpu_torch.common.config import ServingConfig
from analytics_zoo_tpu_torch.common.resilience import (
    AdmissionController, Deadline, DeadlineExceeded, deadline_scope,
    record_expired)
from analytics_zoo_tpu_torch.common.unported import reject
from analytics_zoo_tpu_torch.serving.broker import get_broker
from analytics_zoo_tpu_torch.serving.codec import (
    ImageBytes, StringTensor, decode_items, encode_ndarray_output,
    encode_ndarray_output_bytes, reference_wire_forced)

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
    dict of (N, ...) arrays."""

    __slots__ = ("sids", "uris", "decoded", "n", "deadline")

    def __init__(self, sids, uris, decoded, n, deadline=None):
        self.sids = sids
        self.uris = uris
        self.decoded = decoded
        self.n = n
        self.deadline = deadline


class ClusterServing:
    """The serving daemon over ONE ``InferenceModel``."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 broker=None, tenancy=None):
        self.config = config or ServingConfig()
        cfg = self.config
        reject("ClusterServing", 1, dict(image_chw=False), tenancy=tenancy,
               tenants=cfg.tenants, image_resize=cfg.image_resize,
               image_chw=cfg.image_chw, image_scale=cfg.image_scale)
        reject("ClusterServing", 6, tensorboard_dir=cfg.tensorboard_dir)
        self.top_n = cfg.top_n
        if cfg.filter:
            n = parse_filter(cfg.filter)
            if self.top_n is not None and self.top_n != n:
                raise ValueError(
                    f"conflicting post-processing config: top_n="
                    f"{self.top_n} vs filter={cfg.filter!r}")
            self.top_n = n
        self.model = model
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

    # ---- lifecycle --------------------------------------------------------
    def start(self) -> "ClusterServing":
        # restartable after stop(); refused while old threads still drain
        self._threads = [t for t in self._threads if t.is_alive()]
        if self._threads:
            raise RuntimeError(
                "previous drain threads still running; call stop() and "
                "wait for them to finish before restarting")
        if self.config.image_uint8 and getattr(
                self.model, "preprocessor", None) is None:
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
        self._reader_done = threading.Event()
        self._decoders_done = threading.Event()
        self._exec_done = threading.Event()
        self._pipelined = True
        # the dispatch pool overlaps one batch's launch with the previous
        # one's fetch; the sink resolves the futures in q_pend
        # (= submission) order, so result semantics are unchanged
        concurrency = max(getattr(self.model, "concurrency", 1), 1)
        pool_workers = max(concurrency, 2)
        self._dispatch_pool = ThreadPoolExecutor(
            max_workers=pool_workers, thread_name_prefix="serving-dispatch")
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
        if cfg.admission_control:
            credits = cfg.admission_max_inflight or max(
                2 * pool_workers * mb, 4 * mb)
            self.admission = AdmissionController(credits, name="serving")
        else:
            self.admission = None
        stages = [("serving-reader", self._reader_loop)]
        for i in range(max(cfg.decode_workers, 1)):
            stages.append((f"serving-decode-{i}", self._decode_loop))
        stages.append(("serving-exec", self._exec_loop))
        stages.append(("serving-sink", self._sink_loop))
        for name, fn in stages:
            self._spawn(name, fn)

    @staticmethod
    def _run_stage(name: str, fn) -> None:
        """Stage-thread entry: the loops guard their own bodies, so what
        escapes here is a dying worker thread; log it and let it die."""
        try:
            fn()
        except BaseException:
            logger.exception("stage thread %s died", name)
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

    def _reader_loop(self) -> None:
        saturated = False   # overload latch, local to the reader thread
        while not self._stop.is_set():
            try:
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

    def _entry_deadline(self, fields) -> Optional[Deadline]:
        """The entry's wire deadline, else the configured default."""
        ts = fields.get("deadline_ts")
        if ts is not None:
            try:
                return Deadline.from_wall(float(ts))
            except (TypeError, ValueError):
                logger.warning("unparsable deadline_ts %r ignored", ts)
        if self.config.default_deadline_ms:
            return Deadline(self.config.default_deadline_ms / 1e3)
        return None

    def _admit(self, entry, saturated: bool) -> bool:
        """Gate one entry; returns the updated overload latch."""
        sid, fields = entry
        n = int(fields.get("batch", 0) or 0) or 1
        dl = self._entry_deadline(fields)
        if dl is not None and dl.expired:
            self._reject_entry(sid, fields, "expired",
                               "deadline expired before admission", n=n)
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
                    self._shed_entry(sid, fields, n)
                    return True
            else:
                saturated = False
            if n > need:
                adm.force_acquire(n - need)
        # the acquired credit count rides the work item: releases mirror
        # exactly what was acquired here, never the client's uri split
        self._put_forever(self._q_raw, (sid, fields, dl, n), name="raw")
        return saturated

    def _shed_entry(self, sid, fields, n: int,
                    msg: str = "server overloaded; admission control "
                               "shed this request - retry with backoff"
                    ) -> None:
        if self.admission is not None:
            self.admission.shed(n)
        with self._metrics_lock:
            self.records_shed += n
        self._reject_entry(sid, fields, "shed", msg)

    def _count_expired(self, k: int) -> None:
        """One accounting point for deadline-expired records."""
        record_expired(k)
        with self._metrics_lock:
            self.records_expired += k

    def _reject_entry(self, sid, fields, code: str, msg: str,
                      n: Optional[int] = None) -> None:
        """Error-finish every record of a NOT-YET-ADMITTED entry (no
        credits to release) with a machine-readable code, in one bulk
        write.  ``n`` is the entry's declared record count, which expiry
        accounting uses (never the client-controlled uri split)."""
        uris = fields.get("uri", "?").split("\x1f")
        if code == "expired":
            self._count_expired(n if n is not None else
                                int(fields.get("batch", 0) or 0) or 1)
        try:
            self.broker.set_results(
                {f"result:{u}": {"error": msg, "code": code} for u in uris})
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
                sid, fields, dl, n_adm = self._q_raw.get(timeout=0.05)
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
                        code="expired", release=False)
                self._count_expired(n_adm)
                self._release_admission(n_adm)
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
                    with deadline_scope(dl):
                        decoded = self._decode_entry(fields, batch_n=n)
                    # max_batch caps the device batch; client batches
                    # are cut to it
                    mb = max(self.config.max_batch, 1)
                    for lo in range(0, n, mb):
                        hi = min(lo + mb, n)
                        self._put_forever(self._q_dec, _PreBatched(
                            [sid] * (hi - lo), uris[lo:hi],
                            {k: v[lo:hi] for k, v in decoded.items()},
                            hi - lo, deadline=dl), name="decoded")
                else:
                    with deadline_scope(dl):
                        decoded1 = self._decode_entry(fields)
                    self._put_forever(self._q_dec, (sid, uri, decoded1, dl),
                                      name="decoded")
            except (Exception, CancelledError) as exc:
                logger.exception("decode failed for %s", uri)
                for u in uri.split("\x1f"):
                    self._try_finish_error(sid, u, exc, release=False)
                self._release_admission(n_adm)

    def _dispatch_group_list(self, groups: List[_PreBatched]) -> int:
        """Expire, merge and dispatch one same-signature list of
        prebatched groups; returns the records dispatched."""
        live = []
        for g in groups:
            if g.deadline is not None and g.deadline.expired:
                for sid, uri in zip(g.sids, g.uris):
                    self._expire_record(sid, uri)
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
            merged = _PreBatched(
                [s for g in live for s in g.sids],
                [u for g in live for u in g.uris],
                {k: np.concatenate([g.decoded[k] for g in live])
                 for k in names},
                sum(g.n for g in live))
        try:
            self._dispatch_prebatched(merged)
        except (Exception, CancelledError) as exc:
            # a failed submit (pool shut by a racing stop()) error-finishes
            # the merged batch, it does not kill the exec thread
            logger.exception("dispatch merged batch failed; erroring "
                             "entries")
            for sid, uri in zip(merged.sids, merged.uris):
                self._try_finish_error(sid, uri, exc)
            return 0
        return merged.n

    def _exec_loop(self) -> None:
        mb = self.config.max_batch
        linger_s = self.config.linger_ms / 1e3
        pend: List = []                  # single records awaiting coalesce
        pendb: List[_PreBatched] = []    # same-signature client batches
        pendb_n = 0
        pendb_key = None
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
                    self._expire_record(item[0], item[1])
                else:
                    live.append(item)
            if not live:
                return
            try:
                self._dispatch(live)
            except (Exception, CancelledError) as exc:
                logger.exception("dispatch batch failed; erroring entries")
                for sid, uri, _, _ in live:
                    self._try_finish_error(sid, uri, exc)

        def flush_batches():
            nonlocal pendb, pendb_n, pendb_key, deadline_b
            groups, pendb, pendb_n, pendb_key = pendb, [], 0, None
            deadline_b = None
            self._dispatch_group_list(groups)

        def sig_of(pb):
            return tuple(sorted((k, v.shape[1:], str(v.dtype))
                                for k, v in pb.decoded.items()))

        while not (self._stop.is_set() and self._decoders_done.is_set()
                   and self._q_dec.empty() and not (pend or pendb)):
            timeout = 0.05
            waits = [d for d in (deadline if pend else None,
                                 deadline_b if pendb else None)
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
                if not pend:
                    deadline = time.monotonic() + linger_s
                pend.append(item)
            now = time.monotonic()
            if pendb and (self._stop.is_set()
                          or (deadline_b is not None and now >= deadline_b)):
                flush_batches()
            if pend and (len(pend) >= mb or self._stop.is_set()
                         or (deadline is not None and now >= deadline)):
                flush_singles()

    def _dispatch(self, batch) -> None:
        sids = [item[0] for item in batch]
        uris = [item[1] for item in batch]
        tensors = [item[2] for item in batch]
        # the group key holds the tensor NAMES too: clients with different
        # input signatures may share one linger window
        shape_of = lambda t: tuple(sorted((n, v.shape, v.dtype.str)
                                          for n, v in t.items()))
        groups: Dict[tuple, list] = {}
        for idx, t in enumerate(tensors):
            groups.setdefault(shape_of(t), []).append(idx)
        for idxs in groups.values():
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
                fut = self._submit_dispatch(x)
            except (Exception, CancelledError) as exc:
                logger.exception("dispatch group failed; erroring its "
                                 "entries")
                for i in idxs:
                    self._try_finish_error(sids[i], uris[i], exc)
                continue
            self._put_forever(self._q_pend,
                              (sids, uris, [(idxs, fut)], time.monotonic()),
                              name="pending")

    def _submit_dispatch(self, x):
        """Submit one device dispatch to the pool, after taking a permit
        in the exec thread (permit order == submission order == the sink's
        order)."""
        self._permits.acquire()
        try:
            fut = self._dispatch_pool.submit(self.model.predict_async, x)
        except BaseException:
            self._permits.release()
            raise
        return fut

    def _dispatch_prebatched(self, pb: _PreBatched) -> None:
        names = list(pb.decoded.keys())
        x = pb.decoded[names[0]] if len(names) == 1 else pb.decoded
        fut = self._submit_dispatch(x)
        self._put_forever(self._q_pend,
                          (pb.sids, pb.uris, [(list(range(pb.n)), fut)],
                           time.monotonic()),
                          name="pending")

    def _sink_loop(self) -> None:
        while not (self._stop.is_set() and self._exec_done.is_set()
                   and self._q_pend.empty()):
            try:
                item = self._q_pend.get(timeout=0.05)
            except queue.Empty:
                continue
            sids, uris, handles, t_disp = item
            for idxs, pending in handles:
                # CancelledError is a BaseException: a future cancelled by
                # stop()'s pool shutdown must error-finish its entries,
                # not kill the sink
                try:
                    try:
                        out = np.asarray(self.model.fetch(pending.result()))
                        # one bulk result write, one xack per group
                        self.broker.set_results(
                            {f"result:{uris[i]}":
                             {"value": self._encode_result(out[j])}
                             for j, i in enumerate(idxs)})
                        self.broker.xack(self.stream, self.group,
                                         *[sids[i] for i in idxs])
                    finally:
                        self._permits.release()
                except (Exception, CancelledError) as exc:
                    logger.exception("sink failed for %d entries",
                                     len(idxs))
                    for i in idxs:
                        self._try_finish_error(sids[i], uris[i], exc)
                    continue
                # the group is PUBLISHED: its credits return exactly once,
                # outside the publish guard
                self._release_admission(len(idxs))
                try:
                    self._count(len(idxs))
                except (Exception, CancelledError):
                    logger.exception("post-publish accounting failed")

    def _try_finish_error(self, sid, uri, exc, code: str = "error",
                          release: bool = True) -> None:
        """Error-finish one ADMITTED record: write the error result and
        return its admission credit (each record takes one credit at the
        reader and returns it on exactly one completion path).  Decode
        callers pass ``release=False`` and return the entry's acquired
        count in one call."""
        if release:
            self._release_admission(1)
        try:
            # some exceptions stringify empty (CancelledError): the client
            # must still see what failed
            self.broker.set_results({f"result:{uri}": {
                "error": str(exc) or type(exc).__name__, "code": code}})
            self.broker.xack(self.stream, self.group, sid)
        except (Exception, CancelledError):
            logger.exception("could not record error result for %s", uri)

    def _expire_record(self, sid, uri) -> None:
        self._count_expired(1)
        self._try_finish_error(
            sid, uri, DeadlineExceeded("deadline expired before device "
                                       "dispatch"), code="expired")

    def _release_admission(self, k: int) -> None:
        if self.admission is not None:
            self.admission.release(k)

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
            pool = getattr(self, "_dispatch_pool", None)
            if pool is not None:
                # the sink drained q_pend, so every future is resolved;
                # cancel_futures fails a never-started task loudly
                pool.shutdown(wait=False, cancel_futures=True)
                self._dispatch_pool = None
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
                                       "deadline expired before execution")
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
                        self.broker.set_results(
                            {f"result:{u}": {"error": str(exc)
                                             or type(exc).__name__,
                                             "code": "error"}
                             for u in uri.split("\x1f")})
            self.broker.xack(self.stream, self.group,
                             *[sid for sid, _ in entries])

    def _process_batch(self, entries) -> None:
        t0 = time.perf_counter()
        uris, tensor_lists = [], []
        for _, fields in entries:
            for uri, decoded in self._expand_entry(fields):
                uris.append(uri)
                tensor_lists.append(decoded)
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
            out = np.asarray(self.model.predict(x))
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
        with self._metrics_lock:
            self.records_processed += k
            self._window_count += k
            now = time.monotonic()
            if now - self._window_start >= 1.0:
                self.throughput = self._window_count / (now
                                                        - self._window_start)
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
        return out
