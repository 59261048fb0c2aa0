"""Generation client: submit prompts, stream tokens off the broker.

Port of ``analytics_zoo_tpu/llm/client.py``, the broker-native face of the
token-streaming wire: ``submit`` XADDs one request entry — the same
``uri`` / ``data`` / ``deadline_ts`` fields as every other serving
workload — and ``stream_tokens`` tails the request's ``llmtok:<uri>``
stream, yielding ``(index, token)`` in order until the terminal entry,
with the typed errors (``ServingShedError`` / ``ServingDeadlineError``) of
one-shot serving.  The HTTP face of the same stream is
``serving.client.FastWireHttpClient.generate`` against
``serving.http_frontend.ServingFrontend(llm=...)``.
"""

from __future__ import annotations

import itertools
import time
from typing import Iterator, Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.common.resilience import Deadline
from analytics_zoo_tpu_torch.common.unported import reject
from analytics_zoo_tpu_torch.llm.engine import token_stream_name
from analytics_zoo_tpu_torch.serving.broker import get_broker
from analytics_zoo_tpu_torch.serving.client import (
    _ERROR_BY_CODE, ServingDeadlineError, ServingError, _deadline_fields)
from analytics_zoo_tpu_torch.serving.codec import (
    decode_items_bytes, encode_items_bytes)

_reader_ids = itertools.count(1)


class GenerationClient:
    def __init__(self, broker=None, url: Optional[str] = None,
                 stream: str = "llm_stream"):
        self.broker = broker or get_broker(url)
        self.stream = stream

    def submit(self, uri: str, tokens, max_new_tokens: Optional[int] = None,
               priority: int = 0, deadline_s: Optional[float] = None,
               deadline: Optional[Deadline] = None,
               trace_ctx: Optional[str] = None) -> str:
        """Queue a generation request; ``trace_ctx`` is not ported yet and
        raises ``NotImplementedError``."""
        reject("GenerationClient.submit", 6, trace_ctx=trace_ctx)
        items = {"tokens": np.asarray(tokens, np.int32).reshape(-1)}
        if max_new_tokens is not None:
            items["max_new_tokens"] = np.asarray(max_new_tokens, np.int32)
        if priority:
            items["priority"] = np.asarray(priority, np.int32)
        self.broker.xadd(self.stream, {
            "uri": uri, "data": encode_items_bytes(items),
            **_deadline_fields(deadline_s, deadline)})
        return uri

    def stream_tokens(self, uri: str, timeout: float = 30.0
                      ) -> Iterator[Tuple[int, int]]:
        """Yield ``(index, token_id)`` as the engine publishes them;
        raises the typed error on a non-ok terminal.  Each call reads
        the stream from the start under its own consumer group, so a
        late reader still sees every token (within the engine's
        retention window)."""
        stream = token_stream_name(uri)
        group = f"tok-reader-{next(_reader_ids)}"
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ServingDeadlineError(
                    f"timed out streaming tokens for {uri}")
            entries = self.broker.xreadgroup(
                stream, group, "client", count=64,
                block_ms=int(min(remaining, 0.1) * 1000) or 1)
            for sid, fields in entries or []:
                if fields.get("done"):
                    code = fields.get("code", "ok")
                    if code != "ok":
                        cls = _ERROR_BY_CODE.get(code, ServingError)
                        raise cls(f"generation failed for {uri}: "
                                  f"{fields.get('error', code)}")
                    return
                frame = decode_items_bytes(fields["frame"])
                yield (frame["index"].item(), frame["token"].item())

    def generate(self, uri: str, tokens, max_new_tokens: int,
                 timeout: float = 30.0, **kw) -> np.ndarray:
        """Submit + drain: the generated token ids as an int32 array."""
        self.submit(uri, tokens, max_new_tokens, **kw)
        return np.asarray([t for _, t in
                           self.stream_tokens(uri, timeout=timeout)],
                          np.int32)
