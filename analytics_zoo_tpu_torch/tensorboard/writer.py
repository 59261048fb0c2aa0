"""Event-file writers: ``SummaryWriter``, ``TrainSummary``,
``ValidationSummary`` and ``read_scalar``.

A copy of ``analytics_zoo_tpu/tensorboard/writer.py`` (host-only, copied
because any ``analytics_zoo_tpu`` import loads jax), with its count of
events in the metrics registry (``zoo_tb_events_total``).  Events are
queued and written by a daemon thread; curves go under
``<log_dir>/<app_name>/train`` (loss, throughput, learning rate) and
``.../validation``.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from queue import Queue
from typing import Optional

from analytics_zoo_tpu_torch import observability as _obs
from analytics_zoo_tpu_torch.tensorboard.events import (
    decode_scalar_events,
    encode_event,
    encode_histogram_summary,
    encode_scalar_summary,
    frame_record,
)


def read_scalar(log_dir: str, tag: str):
    """All ``(step, value, wall_time)`` records for ``tag`` under
    ``log_dir``, step-sorted, as a float64 (n, 3) ndarray — the
    reference's ``TrainSummary.read_scalar`` contract
    (``Topology.scala:207-246``, pyzoo ``topology.py`` summary
    accessors), for in-notebook loss/metric plotting."""
    import numpy as np
    recs = []
    if os.path.isdir(log_dir):
        for fname in sorted(os.listdir(log_dir)):
            if "tfevents" not in fname:
                continue
            for wall, step, t, v in decode_scalar_events(
                    os.path.join(log_dir, fname)):
                if t == tag:
                    recs.append((step, v, wall))
    recs.sort(key=lambda r: (r[0], r[2]))
    return np.asarray(recs, dtype=np.float64).reshape(-1, 3)


class SummaryWriter:
    """Writes `events.out.tfevents.*` files readable by TensorBoard.

    Events are queued and flushed by a daemon thread, matching the reference's
    async ``EventWriter`` design.
    """

    _seq = 0

    def __init__(self, log_dir: str, flush_secs: float = 2.0):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        SummaryWriter._seq += 1
        fname = "events.out.tfevents.%d.%s.%d.%d" % (
            int(time.time()), socket.gethostname(), os.getpid(),
            SummaryWriter._seq)
        self.path = os.path.join(log_dir, fname)
        self._fh = open(self.path, "ab")
        self._queue: "Queue[Optional[bytes]]" = Queue()
        self._flush_secs = flush_secs
        self._closed = False
        # version header event
        self._queue.put(frame_record(encode_event(file_version="brain.Event:2")))
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    _m_events = _obs.lazy_counter("zoo_tb_events_total",
                                  "TensorBoard events enqueued for writing")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        ev = encode_event(encode_scalar_summary(tag, float(value)), step=step)
        self._queue.put(frame_record(ev))
        self._m_events.inc()

    def add_histogram(self, tag: str, values, step: int) -> None:
        ev = encode_event(encode_histogram_summary(tag, values), step=step)
        self._queue.put(frame_record(ev))
        self._m_events.inc()

    def read_scalar(self, tag: str):
        """Read back this writer's own curve (flushes first); (n, 3)
        ndarray of (step, value, wall_time)."""
        self.flush()
        return read_scalar(self.log_dir, tag)

    def _run(self) -> None:
        import queue as _queue_mod
        last_flush = time.monotonic()
        stop = False
        broken = False
        while not stop:
            try:
                item = self._queue.get(timeout=self._flush_secs)
            except _queue_mod.Empty:
                if not broken:
                    try:
                        self._fh.flush()
                    except OSError:
                        broken = True
                last_flush = time.monotonic()
                continue
            # a write error (ENOSPC, EIO) must NOT kill the drain loop:
            # flush() joins the queue, and items never marked done would
            # deadlock every later flush()/close() caller
            try:
                if item is None:
                    stop = True
                elif not broken:
                    self._fh.write(item)
                if not broken and (stop or time.monotonic() - last_flush
                                   >= self._flush_secs):
                    self._fh.flush()
                    last_flush = time.monotonic()
            except OSError:
                broken = True
            finally:
                self._queue.task_done()

    def flush(self) -> None:
        if not self._closed:
            self._queue.join()  # waits for written-and-task_done, not just dequeued
            self._fh.flush()

    def close(self) -> None:
        if self._closed:
            return
        self._queue.put(None)
        self._thread.join(timeout=5)
        self._fh.flush()
        self._fh.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TrainSummary(SummaryWriter):
    """Training-side curves (Loss / Throughput / LearningRate), written under
    ``<log_dir>/<app_name>/train`` like the reference's ``TrainSummary``."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(os.path.join(log_dir, app_name, "train"))

    def record_step(self, step: int, loss: float, throughput: float,
                    lr: Optional[float] = None) -> None:
        self.add_scalar("Loss", loss, step)
        self.add_scalar("Throughput", throughput, step)
        if lr is not None:
            self.add_scalar("LearningRate", lr, step)


class ValidationSummary(SummaryWriter):
    def __init__(self, log_dir: str, app_name: str):
        super().__init__(os.path.join(log_dir, app_name, "validation"))

    def record_metric(self, step: int, name: str, value: float) -> None:
        self.add_scalar(name, value, step)
