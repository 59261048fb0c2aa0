"""Configuration: copies of the JAX package's ``MeshConfig``,
``TrainConfig``, ``DataConfig``, ``ServingConfig``, ``FleetConfig``,
``LLMServingConfig`` and ``ZooConfig``, and ``load_config``, which builds a
``ZooConfig`` from defaults < json/yaml file < environment (``ZOO_TPU_*``)
< explicit overrides, as the JAX package does (the serving
``config.yaml`` reads the same in both packages).

Copied from ``analytics_zoo_tpu/common/config.py`` (the port cannot import
that module: every ``analytics_zoo_tpu`` import loads jax).  Fields whose
machinery is not ported take the JAX default, and any other value raises
``NotImplementedError`` naming the ROADMAP item that ports it
(``common/unported.py``): the unported ``TrainConfig`` fields (item 2).
``ZooConfig``'s ``coordinator_address``, ``num_processes`` and
``process_id`` are taken as the JAX package takes them:
``init_zoo_context`` rendezvouses over ``torch.distributed``.  ``DataConfig`` and ``FleetConfig`` are fields only: the port has
no fleet, and its estimator reads no data tier setting.  ``ServingConfig`` fields that
need the tenancy, image decode or TensorBoard machinery are refused by
``ClusterServing``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Optional

from analytics_zoo_tpu_torch.common.unported import reject


@dataclass
class MeshConfig:
    """Device-mesh layout. Axis sizes of -1 mean "fill with remaining devices"."""

    data: int = -1          # data-parallel axis ("dp")
    model: int = 1          # tensor-parallel axis ("tp")
    sequence: int = 1       # sequence/context-parallel axis ("sp")
    expert: int = 1         # expert-parallel axis ("ep")
    pipeline: int = 1       # pipeline axis ("pp")
    axis_names: tuple = ("data", "model", "sequence", "expert", "pipeline")


#: TrainConfig fields whose machinery is Queue 1 item 2 (the JAX
#: package's buffer donation and PRNG implementation have no counterpart)
_TRAIN_UNPORTED = ("failure_retry_window_sec", "donate_state", "rng_impl")


@dataclass
class TrainConfig:
    failure_retry_times: int = 5
    failure_retry_window_sec: int = 0
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    gradient_clip_norm: Optional[float] = None
    gradient_clip_value: Optional[float] = None  # clip to [-v, v]
    donate_state: bool = True
    rng_impl: str = "rbg"
    # ZeRO: the optimizer state and the update sharded over "data"
    shard_optimizer: bool = False
    # Megatron-placed weights over "model" (when the mesh has model > 1)
    shard_model: bool = True
    # microbatches per optimizer step
    grad_accum_steps: int = 1
    max_steps_per_dispatch: int = 1024

    def __post_init__(self):
        defaults = {f.name: f.default for f in fields(self)
                    if f.name in _TRAIN_UNPORTED}
        reject("TrainConfig", 2, defaults,
               **{name: getattr(self, name) for name in defaults})


@dataclass
class DataConfig:
    # memory-tier surface kept from FeatureSet.scala:663-684
    memory_type: str = "DRAM"  # DRAM | DIRECT | DISK_AND_DRAM:<numSlice> | PMEM
    shuffle: bool = True
    sequential_order: bool = False
    prefetch: int = 2


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


@dataclass
class FleetConfig:
    """Multi-process serving fleet, read by ``serving.fleet.FleetSupervisor``:
    N frontend worker PROCESSES accepting on one port via SO_REUSEPORT,
    M engine replica processes behind partitioned broker streams, a
    broker bridge in the supervisor, and a metrics-driven replica
    autoscaler — the tier that shards the serving front door past one
    Python process's GIL."""
    # frontend worker processes sharing fleet_http_port via SO_REUSEPORT
    frontend_workers: int = 2
    # engine replica processes at start (partitions 0..replicas-1)
    replicas: int = 1
    # autoscaler bounds: replicas never leave [min_replicas, max_replicas]
    min_replicas: int = 1
    max_replicas: int = 4
    # broker bridge bind (port 0 = OS-assigned)
    bridge_host: str = "127.0.0.1"
    bridge_port: int = 0
    # per-process registry/span snapshots publish at this cadence; any
    # worker's GET /metrics / /spans merges the latest snapshots into
    # fleet-wide series
    snapshot_interval_s: float = 0.5
    # span ring entries carried per snapshot (bounds snapshot size)
    snapshot_span_limit: int = 512
    # frontends re-read the active-partition count this often
    router_refresh_s: float = 0.25
    # a partition that shed (429) is routed around for this long; when
    # EVERY healthy partition is latched the frontend sheds immediately
    # without a broker round trip (the engine's overload latch, lifted
    # into the fleet routing path)
    overload_latch_s: float = 0.25
    # per-partition circuit breaker (fed by result timeouts — a replica
    # that stops answering is ejected and probed back)
    breaker_failure_threshold: int = 3
    breaker_recovery_s: float = 2.0
    # autoscaler loop: evaluates the fleet queue signal (summed
    # zoo_serving_queue_depth across replica snapshots, floored by
    # high-water growth) against the thresholds; see ReplicaAutoscaler
    autoscale_interval_s: float = 0.5
    # per-replica queue-depth thresholds (hysteresis band between them)
    scale_up_queue_depth: float = 32.0
    scale_down_queue_depth: float = 2.0
    # sustained-signal windows + cooldown (anti-oscillation)
    scale_up_sustain_s: float = 1.0
    scale_down_sustain_s: float = 3.0
    autoscale_cooldown_s: float = 2.0
    # scale-down drain: frontends stop routing to the retiring partition
    # (router refresh), then the replica gets this long to drain before
    # SIGTERM
    drain_grace_s: float = 1.0
    # ---- durable control plane ----
    # durable=True moves the broker into its OWN supervised process
    # backed by a write-ahead log, plus a warm standby replica that is
    # promoted on kill -9 of the owner — acknowledged requests survive
    # either process dying
    durable: bool = False
    # WAL root (one subdirectory per broker generation); None = a
    # fresh temp directory per supervisor start
    wal_dir: Optional[str] = None
    # broker bridge port the CURRENT primary binds (0 = pick a free
    # port at start); the address stays stable across failovers, so
    # frontends/replicas reconnect with bounded retry instead of
    # re-discovering
    broker_port: int = 0
    # WAL segment roll size and group-commit linger
    wal_segment_bytes: int = 4 << 20
    wal_commit_interval_ms: float = 0.0
    # fsync per group commit (kill -9 safety needs only the default
    # page-cache flush; True additionally survives host power loss)
    wal_sync: bool = False
    # pending-entry ledger: delivered-but-unacked entries idle this
    # long are redelivered (claim-on-death)
    redeliver_idle_s: float = 3.0
    # supervisor liveness poll for the broker owner/standby processes
    failover_poll_s: float = 0.25


@dataclass
class LLMServingConfig:
    """Generative serving: continuous batching over a paged KV cache with
    frame-per-token streaming."""
    redis_url: str = "memory://"
    input_stream: str = "llm_stream"
    consumer_group: str = "llm"
    # decode batch slots — the fixed width of the decode step;
    # continuous batching refills these mid-batch
    max_active: int = 8
    # KV block pool: num_blocks fixed-size blocks of block_size tokens
    # (plus one reserved scratch page for dead slots)
    num_blocks: int = 256
    block_size: int = 16
    # prompt + generated tokens bound (also the block-table width,
    # ceil(max_model_len / block_size))
    max_model_len: int = 512
    max_new_tokens_default: int = 64
    # legacy whole-prefill rationing knob, superseded by the
    # chunked-prefill token budget below; kept for config compat
    prefills_per_step: int = 1
    # chunked prefill: TOTAL prompt tokens prefilled per engine step,
    # round-robined across pending prefills and interleaved with decode
    # steps — one long prompt can stall the decode lanes for at most
    # one chunk's compute, and TTFT of a short prompt behind it stays
    # bounded (docs/llm-serving.md "Chunked prefill")
    prefill_chunk_tokens: int = 32
    # cross-request radix prefix cache over the KV block pool: a shared
    # prompt prefix prefills once and is adopted by refcount bump
    # (LRU-by-leaf eviction under pool pressure)
    prefix_cache: bool = True
    # shard one model's decode across this many devices along KV heads
    # (n_kv_heads % model_parallel must be 0)
    model_parallel: int = 1
    # credit-based admission (AdmissionController "llm"): one credit
    # per ADMITTED sequence; acquisition is non-blocking — the decode
    # loop must never park on credits — so overload sheds immediately
    # (HTTP 429).  0 = auto-size 4 x max_active.
    admission_control: bool = True
    admission_max_inflight: int = 0
    # implicit per-request deadline when the entry carries none
    # (0 = unlimited); deadlines are enforced PER TOKEN — an expired
    # sequence is retired mid-generation at the next step
    default_deadline_ms: float = 0.0
    # generation stops at this token id (in addition to max_new_tokens);
    # -1 = no eos in the vocab
    eos_id: int = -1
    # "continuous" (default) or "static" — static admits only into an
    # EMPTY batch (padded-batching baseline for the regression bar)
    scheduling: str = "continuous"
    # completed token streams retained on the broker before GC (late
    # readers past this window see a truncated stream)
    token_stream_retention: int = 256
    shed_retry_after_s: float = 1.0
    app_name: str = "llm"


@dataclass
class ZooConfig:
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    # multi-process bootstrap ("host:port" of process 0's rendezvous;
    # common.context.init_zoo_context)
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    # where init_zoo_context lays its mesh: None, "cuda" or "gpu" the
    # card(s), "cpu" the host
    platform: Optional[str] = None
    log_output: bool = False
    default_dtype: str = "float32"
    # the forward / backward dtype of mixed-precision training
    compute_dtype: str = "bfloat16"

    def replace(self, **kw) -> "ZooConfig":
        return dataclasses.replace(self, **kw)


def _apply_overrides(cfg: Any, flat: Dict[str, Any], prefix: str = "") -> None:
    for f in dataclasses.fields(cfg):
        key = f"{prefix}{f.name}"
        val = getattr(cfg, f.name)
        if dataclasses.is_dataclass(val):
            _apply_overrides(val, flat, prefix=key + ".")
        elif key in flat:
            raw = flat[key]
            tname = f.type if isinstance(f.type, str) else getattr(
                f.type, "__name__", str(f.type))
            if isinstance(raw, str):
                if "bool" in tname:
                    raw = raw.lower() in ("1", "true", "yes")
                elif "int" in tname:
                    raw = int(raw)
                elif "float" in tname:
                    raw = float(raw)
                elif "tuple" in tname:
                    # e.g. image_resize: 224,224 (or 224x224) and
                    # axis_names: data,model: numeric elements become
                    # ints, everything else stays a string
                    parts = [p.strip() for p in raw.split(",") if p.strip()]
                    if len(parts) == 1 and "x" in parts[0] and all(
                            s.strip().lstrip("-").isdigit()
                            for s in parts[0].split("x")):
                        parts = [s.strip() for s in parts[0].split("x")]
                    raw = tuple(int(p) if p.lstrip("-").isdigit() else p
                                for p in parts)
            setattr(cfg, f.name, raw)


def _check(cfg: Any) -> None:
    """Run every section's ``__post_init__`` again: ``_apply_overrides``
    sets fields after construction, and a refused value must raise as it
    does in the constructor."""
    for f in dataclasses.fields(cfg):
        val = getattr(cfg, f.name)
        if dataclasses.is_dataclass(val):
            _check(val)
    post = getattr(cfg, "__post_init__", None)
    if post is not None:
        post()


def _env_overrides() -> Dict[str, Any]:
    """ZOO_TPU_TRAIN__GRADIENT_CLIP_NORM=1 -> {"train.gradient_clip_norm":
    "1"}; top-level fields use no separator: ZOO_TPU_PLATFORM=cpu ->
    {"platform": "cpu"}."""
    out = {}
    for k, v in os.environ.items():
        if k.startswith("ZOO_TPU_"):
            path = k[len("ZOO_TPU_"):].lower().replace("__", ".")
            out[path] = v
    return out


def load_config(path: Optional[str] = None, **overrides) -> ZooConfig:
    """Build a ZooConfig from defaults < json/yaml file < env < overrides.
    A key that names no field is ignored, as in the JAX package."""
    cfg = ZooConfig()
    flat: Dict[str, Any] = {}
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(f"config file not found: {path}")
        with open(path) as fh:
            text = fh.read()
        try:
            loaded = json.loads(text)
        except json.JSONDecodeError:
            loaded = _parse_simple_yaml(text)
        flat.update(_flatten(loaded))
    flat.update(_env_overrides())
    flat.update({k.replace("__", "."): v for k, v in overrides.items()})
    _apply_overrides(cfg, flat)
    _check(cfg)
    return cfg


def _flatten(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix=f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _parse_simple_yaml(text: str) -> Dict[str, Any]:
    """Tiny two-level yaml subset parser (serving config.yaml parity
    without a yaml dependency)."""
    root: Dict[str, Any] = {}
    current = root
    for line in text.splitlines():
        if not line.strip() or line.strip().startswith("#"):
            continue
        indent = len(line) - len(line.lstrip())
        key, _, val = line.strip().partition(":")
        val = _strip_inline_comment(val).strip()
        if indent == 0:
            if val == "":
                current = root.setdefault(key, {})
            else:
                root[key] = _coerce(val)
                current = root
        else:
            current[key] = _coerce(val)
    return root


def _strip_inline_comment(val: str) -> str:
    """YAML semantics: '#' starts a comment only at value start or after
    whitespace; a quoted value keeps everything inside the quotes."""
    stripped = val.strip()
    if stripped[:1] in ("'", '"'):
        end = stripped.find(stripped[0], 1)
        if end != -1:
            return stripped[: end + 1]     # quotes removed later by _coerce
    for i, ch in enumerate(val):
        if ch == "#" and (i == 0 or val[i - 1] in " \t"):
            return val[:i]
    return val


def _coerce(v: str) -> Any:
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v.strip("\"'")
