"""Configuration: copies of the JAX package's ``ServingConfig``, of the
``TrainConfig`` fields the estimator reads, and of ``compute_dtype``.

Copied from ``analytics_zoo_tpu/common/config.py`` (the port cannot import
that module: every ``analytics_zoo_tpu`` import loads jax), so a config
written for one package reads the same in the other.  The classic serving
loop of this port reads ``batch_size``, ``replicas``, ``top_n``,
``filter``, ``input_stream``, ``consumer_group``, ``redis_url``,
``pipeline`` and ``image_uint8``; the other serving fields belong to parts
not ported yet (the pipelined engine, the HTTP frontend, tenancy), and
``ClusterServing`` refuses ``pipeline=True``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class TrainConfig:
    checkpoint_dir: Optional[str] = None
    gradient_clip_norm: Optional[float] = None
    gradient_clip_value: Optional[float] = None  # clip to [-v, v]
    # sharded optimizer update over the data axis (not ported: one card)
    shard_optimizer: bool = False
    # microbatches per optimizer step (only 1 is ported)
    grad_accum_steps: int = 1


@dataclass
class ZooConfig:
    train: TrainConfig = field(default_factory=TrainConfig)
    # the forward / backward dtype of mixed-precision training
    compute_dtype: str = "bfloat16"


@dataclass
class ServingConfig:
    # serving config.yaml parity (ClusterServingHelper.scala:91+)
    redis_url: str = "redis://localhost:6379"
    input_stream: str = "serving_stream"
    consumer_group: str = "serving"
    batch_size: int = 4
    replicas: int = 1
    http_port: int = 10020
    http_host: str = "127.0.0.1"  # bind address; 0.0.0.0 for deployment
    model_path: Optional[str] = None
    top_n: Optional[int] = None
    # reference filter grammar "filter_name(args)" (PostProcessing.scala
    # :95-115): e.g. filter: topN(3) — parsed into top_n by the engine
    filter: Optional[str] = None
    # server-side image decode (PreProcessing.scala:90-104 parity):
    # resize to (h, w) after decode; chw=True emits CHW like the
    # reference's chwFlag; scale divides pixels (e.g. 255.0 -> [0,1])
    image_resize: Optional[tuple] = None
    image_chw: bool = False
    image_scale: Optional[float] = None
    # keep decoded pixels uint8 on the host->device wire (4x fewer bytes
    # than f32; the transfer is the serving bottleneck on a
    # remote-attached chip) and widen/scale ON DEVICE via the
    # InferenceModel preprocessor hook; image_scale is ignored host-side
    # when set
    image_uint8: bool = False
    # pipelined engine (decode || execute || sink): requests coalesce up
    # to max_batch (padded to the InferenceModel's pow-2 AOT buckets — the
    # FlinkInference batch-regrouping role) after waiting at most
    # linger_ms for stragglers; decode_workers parallelize host-side
    # image decode.  pipeline=False keeps the simple per-replica loop.
    pipeline: bool = True
    max_batch: int = 256
    linger_ms: float = 2.0
    decode_workers: int = 2
    # TB serving curves (ref InferenceSummary.scala): when set, the
    # engine writes Throughput records under <dir>/<app_name>/inference
    tensorboard_dir: Optional[str] = None
    app_name: str = "serving"
    # resilience layer (docs/resilience.md).  admission_control bounds
    # ADMITTED-but-unfinished records so offered load past the
    # saturation knee queues boundedly or sheds with an explicit
    # rejection (HTTP 429) instead of thrashing every stage queue (the
    # r5 post-knee collapse); pipelined engine only.
    admission_control: bool = True
    # 0 = auto-size from the dispatch depth: 2 x dispatch-pool
    # concurrency x max_batch (the records the dispatch layer can
    # usefully hold in flight, matching InferenceModel's 2x-concurrency
    # in-flight bound) with a 4*max_batch floor
    admission_max_inflight: int = 0
    # bounded queueing: how long one entry may wait for credits before
    # being shed.  In SUSTAINED overload only the first entry waits;
    # the backlog then sheds immediately until credits free up.
    admission_timeout_ms: float = 200.0
    # implicit per-request deadline applied at broker read when the
    # entry carries none (0 = unlimited); clients/frontends stamp
    # explicit deadlines via enqueue(deadline_s=..) / X-Zoo-Deadline-Ms
    default_deadline_ms: float = 0.0
    # Retry-After hint (seconds) on HTTP 429 shed responses
    shed_retry_after_s: float = 1.0
    # frontend micro-batch coalescing (docs/serving.md): concurrent
    # /predict handler threads hand their records to a small coalescer
    # that flushes ONE enqueue_batch per bounded window (size OR time,
    # whichever fills first) instead of issuing one xadd per request —
    # at 192 connections the per-request stream appends, not the
    # engine, were the HTTP front door's bound.  Per-uri result
    # delivery is unchanged (each handler still waits on its own
    # result key).  Requests carrying non-tensor payloads (images,
    # string tensors) bypass the coalescer.
    http_coalesce: bool = True
    # flush when this many records are pending...
    http_coalesce_records: int = 64
    # ...or when the oldest pending record has lingered this long
    http_coalesce_window_ms: float = 1.0
    # multi-tenant SLO isolation (docs/control-plane.md): rows of
    # (name, credits, weight) — each tenant gets its OWN admission
    # credit pool (sheds at its own gate; non-blocking, so one tenant's
    # overload never head-of-line blocks another) and a weighted-fair
    # share of the batching engine's flush order.  None = tenancy off
    # (the single global admission controller, unchanged).  Stays a
    # plain tuple so the config pickles across the fleet fork boundary.
    tenants: Optional[tuple] = None

