"""Serving clients: ``InputQueue.enqueue`` / ``OutputQueue.dequeue`` and
``FastWireHttpClient``.

Port of ``analytics_zoo_tpu/serving/client.py`` over the in-memory broker.
Requests go on the stream as raw wire frames
(``codec.encode_items_bytes``), or as base64 strings when
``ZOO_SERVING_WIRE=arrow`` asks for the reference wire; results come back
from ``result:<uri>`` hashes.  ``FastWireHttpClient`` is the HTTP face of
the same frames: ``predict`` POSTs one binary frame per request
(``Content-Type: application/x-zoo-fastwire``) and decodes the binary
response; ``generate`` reads a frame-per-token stream.  Every enqueue
carries a wire trace context (``trace_ctx``) as the JAX client stamps
it, and ``FastWireHttpClient`` sends a given one as ``X-Zoo-Trace``.
``model=`` stamps the wire ``model`` field (a multi-model engine routes by
it; ``FastWireHttpClient`` posts to ``/predict/<model>``) and ``tenant=``
the ``tenant`` field (``X-Zoo-Tenant`` over HTTP).  Transport retries are
not ported yet (the Redis broker, ROADMAP Queue 1 item 1).
"""

from __future__ import annotations

import http.client
import json
import logging
import struct
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common.resilience import (
    Deadline, current_deadline)
from analytics_zoo_tpu_torch.serving.broker import get_broker
from analytics_zoo_tpu_torch.serving.codec import (
    ImageBytes, StringTensor, decode_items_bytes, decode_output,
    encode_items, encode_items_bytes, reference_wire_forced)

#: the binary /predict negotiation token
FASTWIRE_CONTENT_TYPE = "application/x-zoo-fastwire"
#: the chunked frame-per-token response type: each chunk payload is
#: u32-le length + one fast-wire frame
TOKEN_STREAM_CONTENT_TYPE = "application/x-zoo-token-stream"

logger = logging.getLogger(__name__)

#: a result is an ndarray, or [(class, prob), ...] when top_n is configured
Result = Union[np.ndarray, List[Tuple[int, float]]]


class ServingError(RuntimeError):
    """The engine finished this request with an error result."""
    code = "error"


class ServingShedError(ServingError):
    """Admission control rejected the request (server overloaded)."""
    code = "shed"


class ServingDeadlineError(ServingError):
    """The request's deadline expired before the engine served it."""
    code = "expired"


_ERROR_BY_CODE = {cls.code: cls for cls in
                  (ServingError, ServingShedError, ServingDeadlineError)}

#: numeric terminal-frame codes of the token-stream wire (mirrors
#: llm.engine.TERMINAL_CODES)
_TERMINAL_CODE_NAMES = {0: "ok", 1: "error", 2: "shed", 3: "expired",
                        4: "cancelled"}


def _deadline_fields(deadline_s: Optional[float],
                     deadline: Optional[Deadline] = None) -> dict:
    """The wire stamp for an explicit ``Deadline``, an explicit relative
    budget, or the ambient ``deadline_scope`` deadline (in that
    precedence): the absolute wall-clock deadline the engine checks
    (empty when there is none)."""
    dl = deadline if deadline is not None else (
        Deadline(deadline_s) if deadline_s else current_deadline())
    return {"deadline_ts": repr(dl.wall())} if dl is not None else {}


def _model_fields(model: Optional[str]) -> dict:
    """The wire stamp routing a record to a named model of a multi-model
    engine; empty means the registry's default model.  A model name must
    not hold the record separator, which joins batch uris on the wire."""
    if not model:
        return {}
    if "\x1f" in model:
        raise ValueError("model name must not contain the unit "
                         "separator (\\x1f)")
    return {"model": str(model)}


def _tenant_fields(tenant: Optional[str]) -> dict:
    """The wire stamp charging a record to a tenant's credit pool; empty
    means the engine's ``default`` tenant (under tenancy) or none."""
    if not tenant:
        return {}
    if "\x1f" in tenant:
        raise ValueError("tenant name must not contain the unit "
                         "separator (\\x1f)")
    return {"tenant": str(tenant)}


def _trace_fields(trace_ctx: Optional[str] = None) -> dict:
    """The wire trace-context stamp: an explicit wire context when given
    (cross-thread enqueues: the HTTP coalescer stamps the handler's span,
    not the flush worker's), else the ambient span's context when one is
    active, so the engine's stage spans join the caller's trace, or a
    fresh wire-minted trace id otherwise.  One flag check when tracing
    is disabled."""
    if trace_ctx:
        return {"trace_ctx": trace_ctx}
    tracer = obs.get_tracer()
    if not tracer.enabled:
        return {}
    cur = tracer.current()
    ref = cur if cur is not None else obs.new_trace_context()
    return {"trace_ctx": obs.encode_trace_context(ref)}


def _encode_wire(items) -> Union[bytes, str]:
    if reference_wire_forced():
        return encode_items(items)
    return encode_items_bytes(items)


class InputQueue:
    def __init__(self, broker=None, url: Optional[str] = None,
                 stream: str = "serving_stream"):
        self.broker = broker or get_broker(url)
        self.stream = stream

    def enqueue(self, uri: str, deadline_s: Optional[float] = None,
                **data) -> str:
        """``enqueue(uri, t1=ndarray, ...)``: one record.  ndarray values
        are tensors (dtype kept); bytes are encoded image content; a list
        of str is a string tensor.  ``deadline_s`` stamps an end-to-end
        budget: the engine drops the record unserved once it has passed
        and the client sees ``ServingDeadlineError``."""
        return self.enqueue_items(uri, data, deadline_s=deadline_s)

    def enqueue_items(self, uri: str, data: Dict[str, object],
                      deadline_s: Optional[float] = None,
                      deadline: Optional[Deadline] = None,
                      trace_ctx: Optional[str] = None,
                      model: Optional[str] = None,
                      tenant: Optional[str] = None) -> str:
        """``enqueue`` with the payload as an explicit dict, so any tensor
        name is valid; ``deadline`` stamps an explicit ``Deadline`` in
        place of ``deadline_s`` and ``trace_ctx`` an explicit wire trace
        context (for callers enqueuing on behalf of another thread).
        ``model`` routes the record to a named model, ``tenant`` charges
        it to a tenant."""
        items = {}
        for k, v in data.items():
            if isinstance(v, (bytes, bytearray)):
                items[k] = ImageBytes(bytes(v))
            elif isinstance(v, StringTensor) or (
                    isinstance(v, list)
                    and any(isinstance(e, str) for e in v)):
                items[k] = StringTensor(v)
            elif isinstance(v, str):
                raise ValueError(
                    f"{k}={v!r}: a str value is an image file path in the "
                    "JAX client; image payloads are not ported yet, pass "
                    "arrays")
            else:
                items[k] = np.asarray(v)
        return self.broker.xadd(self.stream, {
            "uri": uri, "data": _encode_wire(items),
            **_deadline_fields(deadline_s, deadline),
            **_trace_fields(trace_ctx), **_model_fields(model),
            **_tenant_fields(tenant)})

    def enqueue_raw(self, uri: str, frame: bytes,
                    deadline: Optional[Deadline] = None,
                    trace_ctx: Optional[str] = None,
                    model: Optional[str] = None,
                    tenant: Optional[str] = None) -> str:
        """An already-encoded wire frame (a fast-wire HTTP body) goes on
        the stream verbatim: no decode, no re-encode.  The engine's decode
        stage error-finishes an undecodable frame."""
        return self.broker.xadd(self.stream, {
            "uri": uri, "data": bytes(frame),
            **_deadline_fields(None, deadline),
            **_trace_fields(trace_ctx), **_model_fields(model),
            **_tenant_fields(tenant)})

    def enqueue_batch(self, uris, deadline_s: Optional[float] = None,
                      **data) -> str:
        """N records in ONE stream entry with ONE wire payload (arrays keep
        their leading batch axis): one encode for the batch."""
        return self.enqueue_batch_items(uris, data, deadline_s=deadline_s)

    def enqueue_batch_items(self, uris, data: Dict[str, object],
                            deadline_s: Optional[float] = None,
                            deadline: Optional[Deadline] = None,
                            trace_ctx: Optional[str] = None,
                            model: Optional[str] = None,
                            tenant: Optional[str] = None) -> str:
        """``enqueue_batch`` with the payload as an explicit dict; the
        other arguments as ``enqueue_items``."""
        uris = [str(u) for u in uris]
        n = len(uris)
        if n == 0:
            raise ValueError("enqueue_batch needs at least one uri")
        if any("\x1f" in u for u in uris):
            raise ValueError("uris must not contain the unit separator "
                             "(\\x1f): it joins them on the wire")
        items = {}
        for k, v in data.items():
            a = np.asarray(v)
            if a.dtype == object or a.ndim == 0 or a.shape[0] != n:
                raise ValueError(
                    f"batch payload {k!r} must be an array with leading "
                    f"dim {n}, got shape {getattr(a, 'shape', ())}")
            items[k] = a
        return self.broker.xadd(self.stream, {
            "uri": "\x1f".join(uris), "batch": str(n),
            "data": _encode_wire(items),
            **_deadline_fields(deadline_s, deadline),
            **_trace_fields(trace_ctx), **_model_fields(model),
            **_tenant_fields(tenant)})


class OutputQueue:
    def __init__(self, broker=None, url: Optional[str] = None):
        self.broker = broker or get_broker(url)

    def _parse_result(self, uri: str, h: dict) -> Optional[Result]:
        if not h:
            return None
        if "error" in h:
            # typed by the engine's code field; ``scope`` "tenant" marks a
            # shed at the tenant's own credit gate
            cls = _ERROR_BY_CODE.get(h.get("code", "error"), ServingError)
            err = cls(f"serving failed for {uri}: {h['error']}")
            err.scope = h.get("scope")
            raise err
        if "value" not in h:
            return None
        return decode_output(h["value"])

    def query(self, uri: str) -> Optional[Result]:
        """One result or None."""
        return self._parse_result(uri, self.broker.hgetall(f"result:{uri}"))

    def query_blocking(self, uri: str, timeout: float = 10.0
                       ) -> Optional[Result]:
        """Wait (on the broker's result condition, no polling) up to
        ``timeout`` seconds for ``uri``'s result."""
        if self.broker.wait_result(f"result:{uri}", timeout):
            return self.query(uri)
        return None

    def dequeue(self) -> Dict[str, Result]:
        """Drain all results.  Errored requests are dropped (logged), not
        raised: one failure must not hide the remaining results."""
        out = {}
        for key in self.broker.keys("result:*"):
            uri = key[len("result:"):]
            try:
                r = self.query(uri)
            except RuntimeError as exc:
                logger.warning("dropping errored result %s: %s", uri, exc)
                self.broker.delete(key)
                continue
            if r is not None:
                out[uri] = r
                self.broker.delete(key)
        return out


def _http_error(resp, blob: bytes) -> ServingError:
    """The typed error of a non-200 answer: 429 shed, 504 deadline, any
    other ``ServingError``; ``retry_after_s`` holds ``Retry-After``."""
    try:
        msg = json.loads(blob).get("error", "")
    except ValueError:
        msg = blob[:200].decode("utf-8", "replace")
    cls = {429: ServingShedError,
           504: ServingDeadlineError}.get(resp.status, ServingError)
    err = cls(f"/predict returned {resp.status}: {msg}")
    ra = resp.headers.get("Retry-After")
    err.retry_after_s = float(ra) if ra else None
    return err


class FastWireHttpClient:
    """Binary ``/predict`` over one keep-alive connection, the fast-wire
    face of ``ServingFrontend``: ``predict`` POSTs the request tensors as
    ONE raw frame and decodes the binary response frame.  429 (shed)
    raises ``ServingShedError`` (``retry_after_s`` holds the server's
    pacing hint), 504 (deadline or timeout) ``ServingDeadlineError``,
    other non-200s ``ServingError``; error bodies are JSON on every
    wire.  ``trace_ctx`` rides the ``X-Zoo-Trace`` header, ``model`` the
    ``/predict/<model>`` path and ``tenant`` the ``X-Zoo-Tenant``
    header."""

    def __init__(self, host: str = "127.0.0.1", port: int = 10020,
                 timeout: float = 30.0):
        self._conn = http.client.HTTPConnection(host, port, timeout=timeout)

    def _post(self, frame: bytes, headers: dict, path: str = "/predict"):
        try:
            self._conn.request("POST", path, frame, headers)
            return self._conn.getresponse()
        except ConnectionError:
            # stale keep-alive: the server closed the idle connection
            # before taking the request (zero response bytes), so one
            # reconnect and resend is safe.  Read failures and timeouts
            # are not retried: the server may be running the request.
            self._conn.close()
            self._conn.request("POST", path, frame, headers)
            return self._conn.getresponse()

    @staticmethod
    def _headers(uri, deadline_ms, trace_ctx) -> dict:
        headers = {"Content-Type": FASTWIRE_CONTENT_TYPE}
        if uri:
            headers["X-Zoo-Uri"] = str(uri)
        if deadline_ms is not None:
            headers["X-Zoo-Deadline-Ms"] = repr(float(deadline_ms))
        if trace_ctx:
            headers["X-Zoo-Trace"] = trace_ctx
        return headers

    def predict(self, uri: Optional[str] = None,
                deadline_ms: Optional[float] = None,
                trace_ctx: Optional[str] = None,
                model: Optional[str] = None,
                tenant: Optional[str] = None, **inputs) -> Result:
        """One round trip: tensors in, prediction (ndarray) or top-N
        pairs out.  ``uri`` rides the ``X-Zoo-Uri`` header (the server
        makes one when absent), ``deadline_ms`` the ``X-Zoo-Deadline-Ms``
        budget, ``trace_ctx`` the ``X-Zoo-Trace`` context the server's
        spans join, ``model`` names the model of a multi-model frontend
        (``/predict/<model>``) and ``tenant`` the ``X-Zoo-Tenant``
        header."""
        from urllib.parse import quote
        frame = encode_items_bytes(
            {k: np.asarray(v) for k, v in inputs.items()})
        headers = self._headers(uri, deadline_ms, trace_ctx)
        if tenant:
            headers["X-Zoo-Tenant"] = str(tenant)
        path = "/predict"
        if model:
            # fail fast here: a name the server's route parser rejects
            # would cost a round trip to learn the same error
            from analytics_zoo_tpu_torch.serving.model_zoo import (
                validate_model_name)
            validate_model_name(str(model))
            path = f"/predict/{quote(str(model), safe='')}"
        resp = self._post(frame, headers, path)
        blob = resp.read()
        if resp.status != 200:
            raise _http_error(resp, blob)
        out = decode_items_bytes(blob)
        if "topn" in out:
            return [(int(c), float(p)) for c, p in out["topn"]]
        return out["prediction"]

    def generate(self, tokens, uri: Optional[str] = None,
                 max_new_tokens: Optional[int] = None,
                 priority: int = 0,
                 deadline_ms: Optional[float] = None,
                 trace_ctx: Optional[str] = None):
        """Streamed generation: POSTs one frame carrying the ``tokens``
        prompt and returns an ITERATOR of ``(index, token_id)`` read from
        the chunked frame-per-token response.  Failures before the first
        token raise as ``predict`` does (429 shed, 504 deadline); a non-ok
        terminal frame raises the typed error of its code."""
        items = {"tokens": np.asarray(tokens, np.int32).reshape(-1)}
        if max_new_tokens is not None:
            items["max_new_tokens"] = np.asarray(max_new_tokens, np.int32)
        if priority:
            items["priority"] = np.asarray(priority, np.int32)
        headers = self._headers(uri, deadline_ms, trace_ctx)
        headers["X-Zoo-Generate"] = "1"
        resp = self._post(encode_items_bytes(items), headers)
        if resp.status != 200:
            raise _http_error(resp, resp.read())

        def read_exact(n: int) -> bytes:
            parts, got = [], 0
            while got < n:
                chunk = resp.read(n - got)
                if not chunk:
                    raise ServingError("token stream truncated mid-frame")
                parts.append(chunk)
                got += len(chunk)
            return b"".join(parts)

        def frames():
            # leaving this iterator early leaves a half-read chunked
            # answer on the connection: close it, so the next request
            # reconnects and the server's next write cancels the sequence
            done = False
            try:
                while True:
                    (n,) = struct.unpack("<I", read_exact(4))
                    out = decode_items_bytes(read_exact(n))
                    if "done" in out:
                        code = out["code"].item() if "code" in out else 0
                        if code:
                            name = _TERMINAL_CODE_NAMES.get(code, "error")
                            cls = _ERROR_BY_CODE.get(name, ServingError)
                            n_tok = out["n"].item() if "n" in out else 0
                            raise cls(
                                f"generation for {uri or '?'} ended with "
                                f"code {name!r} after {n_tok} tokens")
                        resp.read()      # the chunked EOF
                        done = True
                        return
                    yield out["index"].item(), out["token"].item()
            finally:
                if not done:
                    self._conn.close()

        return frames()

    def close(self) -> None:
        self._conn.close()

    def __enter__(self) -> "FastWireHttpClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
