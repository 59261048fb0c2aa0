"""Serving clients: ``InputQueue.enqueue`` / ``OutputQueue.dequeue``.

Port of the queue clients of ``analytics_zoo_tpu/serving/client.py`` over
the in-memory broker.  Requests go on the stream as raw wire frames
(``codec.encode_items_bytes``), or as base64 strings when
``ZOO_SERVING_WIRE=arrow`` asks for the reference wire; results come back
from ``result:<uri>`` hashes.  The HTTP client, transport retries, trace
context, model routing and tenancy stamps are not ported yet: their
arguments raise ``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from analytics_zoo_tpu_torch.common.resilience import Deadline
from analytics_zoo_tpu_torch.common.unported import reject
from analytics_zoo_tpu_torch.serving.broker import get_broker
from analytics_zoo_tpu_torch.serving.codec import (
    ImageBytes, StringTensor, decode_output, encode_items,
    encode_items_bytes, reference_wire_forced)

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


def _deadline_fields(deadline_s: Optional[float],
                     deadline: Optional[Deadline] = None) -> dict:
    """The wire stamp for an explicit ``Deadline`` or, failing that, a
    relative budget: the absolute wall-clock deadline the engine checks
    (empty when neither is given)."""
    dl = deadline if deadline is not None else (
        Deadline(deadline_s) if deadline_s else None)
    return {"deadline_ts": repr(dl.wall())} if dl is not None else {}


def _reject_stamps(where: str, trace_ctx, model, tenant) -> None:
    reject(where, 6, trace_ctx=trace_ctx)
    reject(where, 1, model=model, tenant=tenant)


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
        place of ``deadline_s``.  ``trace_ctx``, ``model`` and ``tenant``
        are not ported yet and raise ``NotImplementedError``."""
        _reject_stamps("InputQueue.enqueue_items", trace_ctx, model, tenant)
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
            **_deadline_fields(deadline_s, deadline)})

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
        _reject_stamps("InputQueue.enqueue_batch_items", trace_ctx, model,
                       tenant)
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
            **_deadline_fields(deadline_s, deadline)})


class OutputQueue:
    def __init__(self, broker=None, url: Optional[str] = None):
        self.broker = broker or get_broker(url)

    def _parse_result(self, uri: str, h: dict) -> Optional[Result]:
        if not h:
            return None
        if "error" in h:
            cls = _ERROR_BY_CODE.get(h.get("code", "error"), ServingError)
            raise cls(f"serving failed for {uri}: {h['error']}")
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
