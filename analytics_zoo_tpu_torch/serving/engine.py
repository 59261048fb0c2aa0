"""ClusterServing: the streaming inference engine, classic mode.

Port of the classic loop of ``analytics_zoo_tpu/serving/engine.py``
(``ServingConfig(pipeline=False)``): each replica thread reads up to
``batch_size`` stream entries, drops entries whose deadline has passed,
groups the records by input signature, runs one ``InferenceModel.predict``
per group (padded to a power-of-two bucket there), and writes every
result back in one bulk replace, as an ndarray frame or as top-N
``cls:prob`` pairs.  A failing batch is retried entry by entry so one bad
request cannot poison the others.

A multi-input model receives each batch as a dict of arrays by input name;
a model that takes a sequence (BERT: ``[input_ids, token_type_ids,
input_mask]``) is served through the ``InferenceModel`` preprocessor.

Not ported yet: the pipelined engine (decode || dispatch || sink),
admission control, tenancy, the model registry, server-side image decode
and the observability spans.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import CancelledError
from typing import Dict, List, Optional

import numpy as np

from analytics_zoo_tpu_torch.common.config import ServingConfig
from analytics_zoo_tpu_torch.common.unported import reject
from analytics_zoo_tpu_torch.serving.broker import get_broker
from analytics_zoo_tpu_torch.serving.codec import (
    ImageBytes, StringTensor, decode_items, encode_ndarray_output,
    encode_ndarray_output_bytes, reference_wire_forced)

logger = logging.getLogger("analytics_zoo_tpu_torch.serving")

_PIPELINE_SLICE = ("the pipelined engine is not ported yet (ROADMAP Queue "
                   "1: pipelined ClusterServing and the HTTP frontend); "
                   "use ServingConfig(pipeline=False)")


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


class ClusterServing:
    """The serving daemon over ONE ``InferenceModel``."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 broker=None, tenancy=None):
        reject("ClusterServing", 1, tenancy=tenancy)
        self.config = config or ServingConfig()
        if self.config.pipeline:
            raise NotImplementedError(_PIPELINE_SLICE)
        self.top_n = self.config.top_n
        if self.config.filter:
            n = parse_filter(self.config.filter)
            if self.top_n is not None and self.top_n != n:
                raise ValueError(
                    f"conflicting post-processing config: top_n="
                    f"{self.top_n} vs filter={self.config.filter!r}")
            self.top_n = n
        self.model = model
        self.broker = broker or get_broker(self.config.redis_url)
        self.stream = self.config.input_stream
        self.group = self.config.consumer_group
        self.broker.xgroup_create(self.stream, self.group)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.records_processed = 0
        self.records_expired = 0
        self._metrics_lock = threading.Lock()
        self._window_start = time.monotonic()
        self._window_count = 0
        self.throughput = 0.0

    # ---- lifecycle --------------------------------------------------------
    def start(self) -> "ClusterServing":
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
        # one drain loop per replica; predicts overlap through the
        # InferenceModel's execution slots
        for i in range(max(self.config.replicas, 1)):
            name = f"serving-{i}"
            t = threading.Thread(target=self.run, args=(name,), name=name,
                                 daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        # a thread that outlived the join stays tracked, so a restart
        # cannot orphan it against a cleared stop flag
        self._threads = [t for t in self._threads if t.is_alive()]

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
                if self._expired(fields):
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

    @staticmethod
    def _expired(fields) -> bool:
        ts = fields.get("deadline_ts")
        if ts is None:
            return False
        try:
            return time.time() >= float(ts)
        except (TypeError, ValueError):
            logger.warning("unparsable deadline_ts %r ignored", ts)
            return False

    def _reject_entry(self, sid, fields, code: str, msg: str) -> None:
        uris = fields.get("uri", "?").split("\x1f")
        if code == "expired":
            with self._metrics_lock:
                self.records_expired += int(fields.get("batch", 0) or 0) or 1
        self.broker.set_results({f"result:{u}": {"error": msg, "code": code}
                                 for u in uris})
        self.broker.xack(self.stream, self.group, sid)

    # ---- the per-batch map ------------------------------------------------
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
                    "not ported yet (ROADMAP Queue 1: pipelined serving)")
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

    def metrics(self) -> Dict[str, float]:
        with self._metrics_lock:
            return {"records_processed": self.records_processed,
                    "throughput_rps": round(self.throughput, 2),
                    "records_shed": 0,
                    "records_expired": self.records_expired,
                    "queue_high_water": {}}
