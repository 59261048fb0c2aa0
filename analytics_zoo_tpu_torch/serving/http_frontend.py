"""HTTP frontend for serving.

Port of ``analytics_zoo_tpu/serving/http_frontend.py``: a threaded stdlib
HTTP/1.1 server (keep-alive, TCP_NODELAY) in front of ``ClusterServing``
and/or ``LLMServing``.

- ``POST /predict`` negotiates the wire.  A JSON body
  ``{"uri": ..., "inputs": {name: nested-list}}`` gets a JSON answer;
  ``Content-Type: application/x-zoo-fastwire`` carries ONE raw wire frame
  (``codec.encode_items_bytes``) and gets a fast-wire frame back
  (``prediction``, or ``topn`` as an (n, 2) float32 tensor), with the
  optional ``X-Zoo-Uri`` header naming the record.  A malformed or
  truncated frame, like malformed JSON, gets a 400 and the connection
  goes on.  ``X-Zoo-Deadline-Ms`` is the request's budget: an expired
  deadline answers 504, an admission shed 429 with an integer
  ``Retry-After``, an engine failure 500.  Tensor-only requests coalesce:
  handler threads hand their records to a micro-batcher that writes one
  ``enqueue_batch`` per bounded window (``ServingConfig.http_coalesce*``)
  while each handler waits on its own ``result:<uri>`` key.
- A fast-wire request carrying a ``tokens`` tensor, or the
  ``X-Zoo-Generate: 1`` header, streams one chunk per generated token
  from the ``LLMServing`` engine (``u32-le length + one frame`` each, the
  terminal frame carrying ``done`` / ``n`` / ``code``).  The first stream
  entry is awaited before the headers, so a shed or expired request still
  answers 429 / 504; a broken client write cancels the sequence at the
  engine.
- ``GET /metrics.json`` gives the engines' ``metrics()``, ``GET /`` a
  welcome.

Observability, as in the JAX frontend:

- ``GET /metrics``: Prometheus text for the whole process registry
  (serving, LLM, training, resilience, memory ledger series);
- ``GET /spans``: the tracer ring buffer as JSON (``?name=``,
  ``?trace_id=`` and ``?limit=`` filters; a bad query answers 400);
- ``GET /debug/memory?topk=``: the memory ledger's snapshot (every
  pool's books with top-K owners, and the card's allocator figures);
- ``GET /debug/flightrecorder``: the flight-recorder dump listing
  (``?name=<file>`` serves one dump).

In a fleet worker (below) ``/metrics``, ``/spans`` and ``/debug/memory``
answer for the whole fleet, merging every process's published snapshot;
``?local=1`` keeps this process's own view.  ``POST /predict``
accepts an ``X-Zoo-Trace`` header (``trace_id-span_id``) and parents its
``http.predict`` (or ``http.generate``) span to it; every response
carries the span's own context back in ``X-Zoo-Trace``, so a client can
pull exactly its request's spans via ``/spans?trace_id=...``.
``zoo_http_requests_total{route, code}`` counts the answers and
``zoo_http_coalesce_*`` the coalescer's flushes.

Multi-model and tenancy: ``POST /predict/<model>`` (or the ``X-Zoo-Model``
header, or the JSON body's ``"model"`` key) routes to a named model of a
``ClusterServing`` over a ``ModelRegistry``; a bad or non-string name
answers 400 and the connection goes on.  ``X-Zoo-Tenant`` (or the JSON
``"tenant"`` key) charges the request to a tenant's credit pool; an
unknown tenant is refused by the engine's gate.  Both ride the wire beside
the deadline and join the coalescer's grouping key: a batch entry targets
one model and one tenant.

Fleet-worker mode (``serving.fleet``): no local engine; ``broker`` (a
``RemoteBroker`` of the fleet bridge), ``config`` and ``stream``, a
``FleetRouter`` that picks each request's partition inside a
``fleet.route`` span (an open breaker or a set overload latch routes
around a partition; a fleet whose every healthy partition is latched
sheds with 429 before any broker round trip; no live replica answers
503), a ``FleetContext`` for the fleet-wide views, ``worker_id`` (sent
back as ``X-Zoo-Fleet-Worker``) and ``reuse_port``, which binds with
``SO_REUSEPORT`` so N worker processes accept on one port.
"""

from __future__ import annotations

import base64
import itertools
import json
import logging
import math
import socket
import struct
import sys
import threading
import time
from concurrent.futures import CancelledError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common.resilience import Deadline, deadline_scope
from analytics_zoo_tpu_torch.serving.client import (
    FASTWIRE_CONTENT_TYPE, TOKEN_STREAM_CONTENT_TYPE, InputQueue,
    OutputQueue, ServingDeadlineError, ServingShedError)
from analytics_zoo_tpu_torch.serving.codec import (
    decode_items_bytes, encode_items_bytes)
from analytics_zoo_tpu_torch.serving.engine import ClusterServing
from analytics_zoo_tpu_torch.serving.model_zoo import validate_model_name

logger = logging.getLogger("analytics_zoo_tpu_torch.serving")


class _RequestCoalescer:
    """Frontend micro-batcher: handler threads ``submit`` one record each;
    one flush worker groups same-signature tensor dicts and writes ONE
    ``enqueue_batch`` per bounded window (size or time, whichever fills
    first).  Submitters go straight back to waiting on their own
    ``result:<uri>`` key.

    The grouping key is the tensor signature (names x shape x dtype) plus
    the deadline's power-of-two remaining-budget bucket: an un-deadlined
    record never merges with a deadlined one, and two deadlined records
    merge only when their budgets are within 2x, so the minimum budget a
    merged entry carries costs a member at most half its own.  A flush
    failure error-finishes exactly the failed group's records.  A merged
    entry carries the first member's trace context (the engine's
    first-wins rule for merged client batches).  ``flushes`` /
    ``records`` count the stream entries written and the records in
    them, as do ``zoo_http_coalesce_flushes_total`` /
    ``zoo_http_coalesce_records_total``."""

    def __init__(self, input_queue: InputQueue, broker,
                 max_records: int, window_ms: float):
        self._inq = input_queue
        self._broker = broker
        self._max = max(int(max_records), 1)
        self._window_s = max(float(window_ms), 0.0) / 1e3
        self._cond = threading.Condition()
        self._pending: List[tuple] = []
        self._stop = threading.Event()
        self.flushes = 0
        self.records = 0
        self._m_flushes = obs.lazy_counter(
            "zoo_http_coalesce_flushes_total",
            "coalescer stream appends (entries written)")
        self._m_records = obs.lazy_counter(
            "zoo_http_coalesce_records_total",
            "records flushed through the HTTP coalescer")
        self._thread = threading.Thread(target=self._run,
                                        name="http-coalesce", daemon=True)
        self._thread.start()

    def submit(self, uri: str, raw: Optional[bytes], items: dict,
               deadline: Optional[Deadline],
               trace_ctx: Optional[str] = None, inq=None,
               partition: Optional[int] = None,
               model: Optional[str] = None,
               tenant: Optional[str] = None) -> None:
        """Hand one record to the flush worker.  ``raw`` is the encoded
        fast-wire frame when the record arrived binary: a single-record
        flush passes it to the stream verbatim.  ``trace_ctx`` is the
        handler's span context, stamped on the entry.  ``inq`` /
        ``partition`` (fleet workers) pin the record to its routed
        partition's queue; ``partition``, ``model`` and ``tenant`` join
        the grouping key, so a batch entry lands on one stream, targets
        one model and charges one tenant."""
        rec = (uri, raw, items, deadline, trace_ctx, time.monotonic(),
               inq if inq is not None else self._inq, partition, model,
               tenant)
        with self._cond:
            if self._stop.is_set():
                raise RuntimeError("coalescer is stopped")
            self._pending.append(rec)
            n = len(self._pending)
            # the first record arms the window timer, a full window wakes
            # the worker early
            if n == 1 or n >= self._max:
                self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._pending:
                    if self._stop.is_set():
                        return
                    self._cond.wait(0.1)
                flush_at = self._pending[0][5] + self._window_s
                while (len(self._pending) < self._max
                       and not self._stop.is_set()):
                    remaining = flush_at - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                batch = self._pending[:self._max]
                del self._pending[:self._max]
            # a flush failure error-finishes its records, it never kills
            # the flush worker
            try:
                self._flush(batch)
            except (Exception, CancelledError) as exc:
                logger.exception("coalesced flush failed; erroring its "
                                 "records")
                self._fail(batch, exc)

    @staticmethod
    def _deadline_bucket(dl) -> Optional[int]:
        """log2 bucket of the remaining budget (ms); None when
        un-deadlined."""
        if dl is None:
            return None
        return max(0, int(max(dl.remaining(), 1e-3) * 1e3)).bit_length()

    def _flush(self, batch: List[tuple]) -> None:
        groups: dict = {}
        for rec in batch:
            key = (tuple(sorted((k, v.shape, str(v.dtype))
                                for k, v in rec[2].items())),
                   self._deadline_bucket(rec[3]),
                   rec[7],       # fleet partition: one stream per entry
                   rec[8],       # model: one batch entry, one model
                   rec[9])       # tenant: one batch entry, one tenant
            groups.setdefault(key, []).append(rec)
        for recs in groups.values():
            try:
                self._flush_group(recs)
            except (Exception, CancelledError) as exc:
                logger.exception("coalesced group flush failed; erroring "
                                 "its records")
                self._fail(recs, exc)

    def _flush_group(self, recs: List[tuple]) -> None:
        self.flushes += 1
        self.records += len(recs)
        self._m_flushes.inc()
        self._m_records.inc(len(recs))
        inq, model, tenant = recs[0][6], recs[0][8], recs[0][9]
        if len(recs) == 1:
            uri, raw, items, dl, tctx = recs[0][:5]
            if raw is not None:
                inq.enqueue_raw(uri, raw, deadline=dl, trace_ctx=tctx,
                                model=model, tenant=tenant)
            else:
                inq.enqueue_items(uri, items, deadline=dl, trace_ctx=tctx,
                                  model=model, tenant=tenant)
            return
        uris = [r[0] for r in recs]
        stacked = {k: np.stack([r[2][k] for r in recs]) for k in recs[0][2]}
        dls = [r[3] for r in recs if r[3] is not None]
        dl = min(dls, key=lambda d: d.remaining()) if dls else None
        tctx = next((r[4] for r in recs if r[4]), None)
        inq.enqueue_batch_items(uris, stacked, deadline=dl, trace_ctx=tctx,
                                model=model, tenant=tenant)

    def _fail(self, recs: List[tuple], exc: BaseException) -> None:
        results = {f"result:{r[0]}": {"error": str(exc)
                                      or type(exc).__name__,
                                      "code": "error"} for r in recs}
        try:
            self._broker.set_results(results)
        except (Exception, CancelledError):
            logger.exception("could not record coalescer error results")

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        self._thread.join(timeout=10)


class ServingFrontend:
    """The HTTP front door, serving one-shot inference
    (``ClusterServing``) and/or generative streaming (``LLMServing``):
    pass either engine or both; the same ``/predict`` route negotiates
    between them.  ``port=0`` binds an ephemeral port, which ``port``
    holds after ``start``.

    Fleet-worker mode: no local engine; pass ``broker`` / ``config`` /
    ``stream`` with a ``FleetRouter`` and the same handler stack runs in N
    worker processes accepting on one port (``reuse_port``), each
    enqueuing onto the routed partition's stream and waiting on its own
    ``result:<uri>`` key at the shared bridge broker.  ``fleet`` (a
    ``FleetContext``) makes ``/metrics``, ``/spans`` and ``/debug/memory``
    fleet-wide (``?local=1`` keeps this process's own view)."""

    def __init__(self, serving: Optional[ClusterServing] = None,
                 port: int = 10020, host: Optional[str] = None,
                 llm=None, broker=None, config=None, stream=None,
                 router=None, fleet=None, worker_id: Optional[str] = None,
                 reuse_port: bool = False):
        if serving is None and llm is None and broker is None:
            raise ValueError("need a ClusterServing and/or an LLMServing "
                             "engine, or a fleet broker + config")
        self.serving = serving
        self.llm = llm
        self.router = router
        self.fleet = fleet
        self.worker_id = worker_id
        self.reuse_port = reuse_port
        self.port = port
        if config is not None:
            cfg = config
        elif serving is not None:
            cfg = serving.config
        elif llm is not None:
            cfg = llm.config
        else:
            # before any config is read: a broker alone gets this message,
            # not an AttributeError
            raise ValueError("fleet worker mode needs an explicit config")
        self.config = cfg
        self.broker = broker if broker is not None else (
            serving.broker if serving is not None else None)
        if stream is None and serving is not None:
            stream = serving.stream
        # the bind address from ServingConfig; 127.0.0.1 stays the default
        self.host = host or getattr(cfg, "http_host", "127.0.0.1")
        if self.broker is not None:
            self.input_queue: Optional[InputQueue] = InputQueue(
                broker=self.broker,
                stream=stream if stream is not None else "serving_stream")
            self.output_queue: Optional[OutputQueue] = OutputQueue(
                broker=self.broker)
        else:
            self.input_queue = self.output_queue = None
        if llm is not None:
            from analytics_zoo_tpu_torch.llm.client import GenerationClient
            self._llm_client = GenerationClient(broker=llm.broker,
                                                stream=llm.stream)
        else:
            self._llm_client = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        # itertools.count.__next__ is atomic under the GIL
        self._uri_seq = itertools.count(1)
        self._coalescer: Optional[_RequestCoalescer] = None
        # RFC 9110 Retry-After delta-seconds is 1*DIGIT: a float string
        # is discarded by standard clients
        self._retry_after = str(max(1, math.ceil(float(
            getattr(cfg, "shed_retry_after_s", 1.0)))))
        self._m_http = obs.counter("zoo_http_requests_total",
                                   "frontend requests by route and code",
                                   ["route", "code"])

    def _next_uri(self) -> str:
        return f"http-{next(self._uri_seq)}"

    def make_handler(frontend):
        class Handler(BaseHTTPRequestHandler):
            # keep-alive: a closed-loop client reusing its connection
            # skips a TCP handshake per request
            protocol_version = "HTTP/1.1"
            # without TCP_NODELAY the headers/body write pair meets Nagle
            # against the client's delayed ACK
            disable_nagle_algorithm = True

            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, payload: dict, headers=None):
                self._send_raw(code, json.dumps(payload).encode(),
                               "application/json", headers=headers)

            _ROUTES = frozenset(
                ("/", "/predict", "/metrics", "/metrics.json", "/spans",
                 "/debug/flightrecorder", "/debug/memory"))

            def _count(self, code: int) -> None:
                # bounded label cardinality: a scanner probing random
                # paths must not mint one series per URL
                path = urlparse(self.path).path
                if path in self._ROUTES:
                    route = path
                elif path.startswith("/predict/"):
                    route = "/predict"
                else:
                    route = "other"
                frontend._m_http.labels(route=route, code=str(code)).inc()

            def _send_raw(self, code: int, blob: bytes, ctype: str,
                          headers=None):
                self._count(code)
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(blob)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                # status line, headers and body leave in ONE write
                self._headers_buffer.append(b"\r\n")
                self._headers_buffer.append(blob)
                self.wfile.write(b"".join(self._headers_buffer))
                self._headers_buffer = []

            def do_GET(self):
                url = urlparse(self.path)
                path = url.path
                q = parse_qs(url.query)
                # a fleet worker answers for the whole fleet unless
                # ?local=1 asks for this process's own view
                fleet = (frontend.fleet if (q.get("local") or ["0"])[0]
                         in ("0", "") else None)
                if path == "/metrics":
                    # Prometheus text for the whole process registry, or
                    # the fleet-wide merge of every process's snapshot
                    text = (fleet.merged_metrics_text() if fleet is not None
                            else obs.render())
                    self._send_raw(200, text.encode(), obs.CONTENT_TYPE)
                elif path == "/metrics.json":
                    m = (frontend.serving.metrics()
                         if frontend.serving is not None else {})
                    if frontend.llm is not None:
                        m = dict(m)
                        m["llm"] = frontend.llm.metrics()
                    self._send(200, m)
                elif path == "/spans":
                    try:
                        limit = q.get("limit")
                        limit = int(limit[0]) if limit else None
                        if limit is not None and limit < 0:
                            raise ValueError(limit)
                        trace_id = q.get("trace_id")
                        trace_id = int(trace_id[0]) if trace_id else None
                    except ValueError:  # bad query: 400, not a crash
                        self._send(400, {"error": "limit/trace_id must "
                                                  "be non-negative ints"})
                        return
                    name = (q.get("name") or [None])[0]
                    if fleet is not None:
                        # one trace's chain spans the frontend worker and
                        # the engine replica process
                        spans = fleet.merged_spans(
                            name=name, limit=limit, trace_id=trace_id)
                    else:
                        spans = obs.get_tracer().export(
                            name=name, limit=limit, trace_id=trace_id)
                    self._send(200, {"spans": spans})
                elif path == "/debug/memory":
                    try:
                        topk = q.get("topk")
                        topk = int(topk[0]) if topk else 10
                        if topk < 0:
                            raise ValueError(topk)
                    except ValueError:
                        self._send(400, {"error": "topk must be a "
                                                  "non-negative int"})
                        return
                    self._send(200, fleet.merged_memory(topk)
                               if fleet is not None
                               else obs.get_memory_ledger().snapshot(
                                   top_k=topk))
                elif path == "/debug/flightrecorder":
                    rec = obs.get_flight_recorder()
                    name = (q.get("name") or [None])[0]
                    if name:
                        try:
                            self._send(200, rec.read_dump(name))
                        except (KeyError, ValueError, OSError):
                            self._send(404, {"error": "no such dump"})
                    else:
                        self._send(200, {"dir": rec.dir,
                                         "dumps": rec.list_dumps()})
                elif path == "/":
                    self._send(200, {"status": "welcome to zoo serving"})
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                path = urlparse(self.path).path
                # the body is always read in full first, so an early
                # answer never strands unread bytes on the connection
                raw = self.rfile.read(length)
                # /predict/<model> routes to a named model; bare /predict
                # serves the registry's default (or the one model)
                model = None
                if path.startswith("/predict/"):
                    from urllib.parse import unquote
                    model = unquote(path[len("/predict/"):])
                    try:
                        validate_model_name(model)
                    except ValueError:
                        self._send(400, {"error": "bad model name in "
                                                  "/predict/<model>"})
                        return
                elif path != "/predict":
                    self._send(404, {"error": "not found"})
                    return
                if model is None:
                    model = self.headers.get("X-Zoo-Model") or None
                # an unknown tenant is refused by the engine's gate: no
                # pool is ever made from request traffic
                tenant = self.headers.get("X-Zoo-Tenant") or None
                ctype = (self.headers.get("Content-Type") or "") \
                    .split(";")[0].strip().lower()
                binary = ctype == FASTWIRE_CONTENT_TYPE
                try:
                    if binary:
                        # malformed / truncated frames raise ValueError in
                        # the codec: 400, the same contract as bad JSON
                        inputs = decode_items_bytes(raw)
                        if not inputs:
                            raise ValueError("empty fast-wire frame")
                        uri = (self.headers.get("X-Zoo-Uri")
                               or frontend._next_uri())
                    else:
                        body = json.loads(raw)

                        # str values are base64 image content; JSON ints
                        # stay integral (embedding ids), the rest rides
                        # the f32 wire
                        def to_arr(v):
                            if isinstance(v, str):
                                return base64.b64decode(v)
                            a = np.asarray(v)
                            return (a.astype(np.int32)
                                    if np.issubdtype(a.dtype, np.integer)
                                    else a.astype(np.float32))
                        inputs = {k: to_arr(v)
                                  for k, v in body["inputs"].items()}
                        uri = body.get("uri") or frontend._next_uri()
                        model = model or body.get("model") or None
                        tenant = tenant or body.get("tenant") or None
                except Exception as exc:  # bad payloads: 400, not a crash
                    self._send(400, {"error": str(exc)})
                    return
                if model is not None:
                    # the path form's rule for header and body names too,
                    # a non-string body "model" included: a client error
                    try:
                        validate_model_name(model)
                    except ValueError:
                        self._send(400, {"error": "bad model name"})
                        return
                dl = None
                hdr = self.headers.get("X-Zoo-Deadline-Ms")
                if hdr:
                    try:
                        dl = Deadline(float(hdr) / 1e3)
                    except ValueError:
                        self._send(400, {"error": "X-Zoo-Deadline-Ms "
                                                  "must be a number"})
                        return
                # X-Zoo-Trace carries the caller's trace context in; the
                # request's span joins it (or roots a new trace)
                pctx = obs.decode_trace_context(
                    self.headers.get("X-Zoo-Trace"))
                if frontend.llm is not None and binary and (
                        self.headers.get("X-Zoo-Generate") == "1"
                        or "tokens" in inputs):
                    self._do_generate(uri, inputs, dl, pctx)
                    return
                if frontend.input_queue is None:
                    self._send(503, {"error": "no one-shot serving "
                                              "engine attached"})
                    return
                self._do_predict(uri, inputs, raw if binary else None, dl,
                                 pctx, model, tenant)

            def _do_predict(self, uri, inputs, raw, dl, pctx, model=None,
                            tenant=None):
                binary = raw is not None
                coal = frontend._coalescer
                # tensor-only records coalesce; image / string payloads
                # and uris holding the batch separator go one by one
                use_coal = (coal is not None and "\x1f" not in uri
                            and bool(inputs)
                            and all(isinstance(v, np.ndarray)
                                    for v in inputs.values()))
                router = frontend.router
                with obs.span("http.predict", parent=pctx,
                              uri=uri) as hsp, deadline_scope(dl):
                    # every answer hands the span's own context back, so
                    # /spans?trace_id= pulls exactly this request's spans
                    thdr = ({"X-Zoo-Trace": obs.encode_trace_context(hsp)}
                            if hsp is not None else {})
                    if frontend.worker_id:
                        thdr["X-Zoo-Fleet-Worker"] = frontend.worker_id
                    tctx = thdr.get("X-Zoo-Trace")
                    # fleet routing: the partition whose replica serves
                    # this request; an open breaker or a set latch routes
                    # around a partition, an all-latched fleet sheds here
                    # before any broker round trip
                    part, inq = None, frontend.input_queue
                    if router is not None:
                        try:
                            # keyed by model: one model's requests land
                            # on the replica that holds its weights
                            with obs.span("fleet.route", uri=uri) as rsp:
                                part, inq, _probe = router.route(
                                    uri, key=model)
                                if rsp is not None:
                                    rsp.set(partition=part)
                        except ServingShedError as exc:
                            self._send(429, {"error": str(exc)},
                                       headers={"Retry-After":
                                                frontend._retry_after,
                                                **thdr})
                            return
                        except Exception as exc:  # no live replica
                            self._send(503, {"error": str(exc)},
                                       headers=thdr)
                            return
                    try:
                        if use_coal:
                            coal.submit(uri, raw, inputs, dl, tctx, inq=inq,
                                        partition=part, model=model,
                                        tenant=tenant)
                        elif binary:
                            # the frame goes on the stream verbatim
                            inq.enqueue_raw(uri, raw, deadline=dl,
                                            trace_ctx=tctx, model=model,
                                            tenant=tenant)
                        else:
                            # explicit dict: a tensor named like an
                            # enqueue parameter cannot shadow it
                            inq.enqueue_items(uri, inputs, model=model,
                                              tenant=tenant)
                    except Exception as exc:  # broker down: 503
                        # a granted half-open probe needs its verdict even
                        # though the request never reached the replica,
                        # or the partition's breaker would wedge; the
                        # failure restarts its recovery clock
                        if router is not None and part is not None:
                            router.note_result(part, timed_out=True)
                        self._send(503, {"error": str(exc)}, headers=thdr)
                        return
                    timeout = 30.0 if dl is None else dl.timeout(30.0)
                    try:
                        result = frontend.output_queue.query_blocking(
                            uri, timeout=timeout)
                    except ServingShedError as exc:
                        # retryable, with a pacing hint.  The replica
                        # answered: an engine-overload shed arms its
                        # partition's latch; a shed at the tenant's own
                        # credit gate is that tenant's quota, not overload
                        if router is not None and part is not None:
                            if getattr(exc, "scope", None) == "tenant":
                                router.note_result(part, timed_out=False)
                            else:
                                router.note_shed(part)
                        self._send(429, {"error": str(exc)},
                                   headers={"Retry-After":
                                            frontend._retry_after, **thdr})
                        return
                    except ServingDeadlineError as exc:
                        if router is not None and part is not None:
                            router.note_result(part, timed_out=False)
                        self._send(504, {"error": str(exc)}, headers=thdr)
                        return
                    except RuntimeError as exc:  # engine failure: 500
                        if router is not None and part is not None:
                            router.note_result(part, timed_out=False)
                        self._send(500, {"error": str(exc)}, headers=thdr)
                        return
                if router is not None and part is not None:
                    # no result at all is the breaker's failure signal: a
                    # replica that answered anything is alive
                    router.note_result(part, timed_out=result is None)
                if result is None:
                    self._send(504, {"error": "timeout"}, headers=thdr)
                elif binary:
                    if isinstance(result, np.ndarray):
                        frame = encode_items_bytes({"prediction": result})
                    else:
                        frame = encode_items_bytes(
                            {"topn": np.asarray(result, np.float32)})
                    self._send_raw(200, frame, FASTWIRE_CONTENT_TYPE,
                                   headers={"X-Zoo-Uri": uri, **thdr})
                else:
                    # ndarray -> nested list; topN -> [[cls, prob], ...]
                    pred = (result.tolist() if isinstance(result, np.ndarray)
                            else [[c, p] for c, p in result])
                    self._send(200, {"uri": uri, "prediction": pred},
                               headers=thdr)

            # ---- token streaming --------------------------------------
            def _do_generate(self, uri, inputs, dl, pctx):
                """Relay one generation as a chunked token stream inside an
                ``http.generate`` span parented to the caller's
                ``X-Zoo-Trace``; the span's context rides the request to
                the engine and comes back on every answer."""
                if "tokens" not in inputs:
                    self._send(400, {"error": "generation requests need a "
                                              "`tokens` tensor"})
                    return
                with obs.span("http.generate", parent=pctx,
                              uri=uri) as hsp, deadline_scope(dl):
                    thdr = ({"X-Zoo-Trace": obs.encode_trace_context(hsp)}
                            if hsp is not None else {})
                    self._relay_generate(uri, inputs, dl, thdr)

            def _relay_generate(self, uri, inputs, dl, thdr):
                """The stream is bounded per TOKEN (30 s of inactivity),
                not in total; a deadlined request gets its remaining
                budget plus 5 s of slack, in which the engine's expired
                terminal frame arrives (the engine enforces the deadline
                per token)."""
                llm = frontend.llm
                try:
                    frontend._llm_client.submit(
                        uri, inputs["tokens"],
                        max_new_tokens=(
                            int(np.asarray(inputs["max_new_tokens"])
                                .reshape(()))
                            if "max_new_tokens" in inputs else None),
                        priority=(int(np.asarray(inputs["priority"])
                                      .reshape(()))
                                  if "priority" in inputs else 0),
                        deadline=dl, trace_ctx=thdr.get("X-Zoo-Trace"))
                except Exception as exc:
                    self._send(503, {"error": str(exc)}, headers=thdr)
                    return
                from analytics_zoo_tpu_torch.llm.engine import (
                    token_stream_name)
                stream = token_stream_name(uri)
                group = f"http-{uri}"
                inactivity_s = 30.0
                last_entry = time.monotonic()
                started = False
                try:
                    while True:
                        remaining = last_entry + inactivity_s \
                            - time.monotonic()
                        if dl is not None:
                            remaining = min(remaining, dl.remaining() + 5.0)
                        if remaining <= 0:
                            if not started:
                                self._send(504, {"error": "timeout"},
                                           headers=thdr)
                            else:
                                llm.cancel(uri)
                                self.close_connection = True
                            return
                        entries = llm.broker.xreadgroup(
                            stream, group, "http", count=64,
                            block_ms=int(min(remaining, 0.05) * 1e3) or 1)
                        if entries:
                            last_entry = time.monotonic()
                        for _, fields in entries or []:
                            done = bool(fields.get("done"))
                            if done and not started:
                                code = fields.get("code", "ok")
                                status, headers = {
                                    "shed": (429, {"Retry-After":
                                                   frontend._retry_after}),
                                    "expired": (504, {}),
                                    "ok": (200, {}),
                                }.get(code, (500, {}))
                                if status != 200:
                                    self._send(status, {"error": fields.get(
                                        "error", code)},
                                        headers={**headers, **thdr})
                                    return
                            if not started:
                                self._begin_stream({**thdr, "X-Zoo-Uri": uri})
                                started = True
                            self._write_stream_frame(fields["frame"])
                            if done:
                                self.wfile.write(b"0\r\n\r\n")
                                self.wfile.flush()
                                return
                except OSError:
                    # the client went away mid-stream (a broken pipe or a
                    # reset): free the sequence's KV blocks now instead of
                    # decoding to a dead socket
                    llm.cancel(uri)
                    self.close_connection = True
                finally:
                    drop = getattr(llm.broker, "delete_stream", None)
                    if drop is not None:
                        try:
                            drop(stream)
                        except Exception:
                            logger.exception("could not drop %s", stream)

            def _begin_stream(self, headers):
                self._count(200)
                self.send_response(200)
                self.send_header("Content-Type", TOKEN_STREAM_CONTENT_TYPE)
                self.send_header("Transfer-Encoding", "chunked")
                for k, v in headers.items():
                    self.send_header(k, v)
                self._headers_buffer.append(b"\r\n")
                self.wfile.write(b"".join(self._headers_buffer))
                self._headers_buffer = []
                self.wfile.flush()

            def _write_stream_frame(self, frame: bytes):
                payload = struct.pack("<I", len(frame)) + frame
                self.wfile.write(b"%X\r\n" % len(payload) + payload
                                 + b"\r\n")
                # one flush per frame: tokens go out as they decode
                self.wfile.flush()

        return Handler

    def start(self) -> "ServingFrontend":
        frontend = self

        class _Server(ThreadingHTTPServer):
            # keep-alive clients connect at once; the stdlib backlog of 5
            # resets the rest
            request_queue_size = 128
            daemon_threads = True

            def server_bind(self):
                # fleet workers: N processes accept on ONE port, the
                # kernel spreading connections over the listeners
                if frontend.reuse_port:
                    if not hasattr(socket, "SO_REUSEPORT"):
                        raise OSError("SO_REUSEPORT unsupported on this "
                                      "platform; fleet workers need it")
                    self.socket.setsockopt(socket.SOL_SOCKET,
                                           socket.SO_REUSEPORT, 1)
                super().server_bind()

            def handle_error(self, request, client_address):
                # a client that went away between requests is no error
                if not isinstance(sys.exc_info()[1], (BrokenPipeError,
                                                      ConnectionResetError)):
                    super().handle_error(request, client_address)

        cfg = self.config
        if self.input_queue is not None \
                and (self.serving is not None or self.router is not None) \
                and getattr(cfg, "http_coalesce", True) \
                and self._coalescer is None:
            self._coalescer = _RequestCoalescer(
                self.input_queue, self.broker,
                getattr(cfg, "http_coalesce_records", 64),
                getattr(cfg, "http_coalesce_window_ms", 1.0))
        self._httpd = _Server((self.host, self.port), self.make_handler())
        # port=0 binds an ephemeral port: reflect the kernel's choice
        self.port = self._httpd.server_address[1]
        # a short poll interval: stop() waits up to one interval
        threading.Thread(target=self._httpd.serve_forever, args=(0.05,),
                         name="http-serve", daemon=True).start()
        return self

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._coalescer is not None:
            # after the listener closes: the worker drains every record
            # already submitted, then exits
            self._coalescer.stop()
            self._coalescer = None
