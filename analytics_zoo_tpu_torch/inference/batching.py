"""BatchingService: concurrent predict through the native micro-batcher.

Port of ``analytics_zoo_tpu/inference/batching.py`` over the port's
``native.RequestQueue``; one batched ``InferenceModel.predict`` runs on
the card per popped batch.

Reference role: ``InferenceModel.doPredict`` concurrency — the reference
keeps N CPU model copies behind a BlockingQueue
(``InferenceModel.scala:791-838``); on an accelerator the throughput move is
coalescing concurrent single requests into ONE batched device execution.
Client threads push onto the C++ queue (GIL-free blocking), a single device
thread pops adaptive batches, stacks them, runs the forward once,
and publishes per-request results.
"""

from __future__ import annotations

import io
import itertools
import threading
from concurrent.futures import CancelledError
from typing import Optional

import numpy as np

from analytics_zoo_tpu_torch.common.resilience import (
    CircuitBreaker, CircuitOpenError)
from analytics_zoo_tpu_torch.testing import chaos


def _dumps(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()


def _loads(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data), allow_pickle=False)


class BatchingService:
    """Wraps an InferenceModel (or any ``predict(x)`` callable)."""

    def __init__(self, model, max_batch: int = 32,
                 max_delay_ms: int = 5,
                 breaker: Optional[CircuitBreaker] = None):
        from analytics_zoo_tpu_torch.native import RequestQueue
        self.model = model
        self.max_batch = max_batch
        self.max_delay_ms = max_delay_ms
        # per-replica circuit breaker: consecutive
        # dispatch failures OPEN the circuit and every queued/new batch
        # fails fast with CircuitOpenError — a router in front of N
        # replicas ejects this one instead of feeding it work it will
        # poison — until a half-open probe batch succeeds and CLOSES it
        self.breaker = breaker
        self.queue = RequestQueue()
        self._ids = itertools.count(1)
        self._id_lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._device_loop,
                                        daemon=True)
        self._running = True
        self._thread.start()

    # ---- device side ------------------------------------------------------
    def _device_loop(self):
        predict = (self.model.predict if hasattr(self.model, "predict")
                   else self.model)
        while self._running:
            batch = self.queue.pop_batch(self.max_batch,
                                         timeout_ms=self.max_delay_ms)
            if batch is None:       # closed + drained
                return
            if not batch:
                continue
            ids = [b[0] for b in batch]
            if self.breaker is not None and not self.breaker.allow():
                # circuit open: fail fast, no device dispatch — the sick
                # replica must not hold every waiter for a full timeout.
                # A DEDICATED marker, not self._error: the shared error
                # slot can be overwritten by a later batch before this
                # batch's waiters wake, and the typed CircuitOpenError
                # contract (routers re-route on it) must not race.
                for rid in ids:
                    self.queue.complete(rid, b"__circuit_open__")
                continue
            try:
                chaos.fire("device_execute")
                arrays = [_loads(b[1]) for b in batch]
                rows = [a.shape[0] for a in arrays]
                stacked = np.concatenate(arrays, axis=0)
                preds = np.asarray(predict(stacked))
                # verdict BEFORE publishing: a waiter woken by complete()
                # must never observe a stale half-open state for a
                # dispatch that already succeeded
                if self.breaker is not None:
                    self.breaker.record_success()
                off = 0
                for rid, n in zip(ids, rows):
                    self.queue.complete(rid, _dumps(preds[off:off + n]))
                    off += n
            except (Exception, CancelledError) as exc:
                # surface to every waiter.  CancelledError included: the
                # wrapped predict may be an arbitrary callable (a model
                # forwarding through futures); a cancellation escaping
                # this guard would kill the single device thread and
                # strand EVERY later request until timeout (the
                # sink-thread bug class)
                if self.breaker is not None:
                    self.breaker.record_failure()
                self._error = exc
                for rid in ids:
                    self.queue.complete(rid, b"__error__")

    # ---- client side ------------------------------------------------------
    def predict(self, x: np.ndarray, timeout_ms: int = 30000) -> np.ndarray:
        """Thread-safe; blocks until this request's rows come back."""
        with self._id_lock:
            rid = next(self._ids)
        self.queue.push(rid, _dumps(np.asarray(x)))
        out = self.queue.wait(rid, timeout_ms=timeout_ms)
        if out is None:
            raise TimeoutError(f"request {rid} timed out")
        if out == b"__circuit_open__":
            # typed: a router catches this to re-route to a healthy
            # replica instead of treating it as a model failure
            raise CircuitOpenError(
                f"circuit {self.breaker.name!r} is open; "
                "replica ejected pending a successful probe")
        if out == b"__error__":
            raise RuntimeError(
                f"batched inference failed: {self._error!r}")
        return _loads(out)

    def stats(self) -> dict:
        return self.queue.stats()

    def stop(self) -> None:
        self._running = False
        self.queue.close()
        self._thread.join(timeout=5)
        self.queue.destroy()
