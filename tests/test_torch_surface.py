"""The port's public names take the JAX names' arguments.

Walks every public function and class (constructor and public methods)
of ``analytics_zoo_tpu_torch`` that has a namesake in the same module of
``analytics_zoo_tpu``, and compares their parameter names.  A difference
passes only where ``DIFFERENCES`` lists it, with its reason: one of the
deliberate differences of the port (below).  An argument whose machinery
a ROADMAP Queue 1 item has still to port is taken, at its JAX default,
and any other value raises ``NotImplementedError`` naming the item
(``test_unported_argument_names_its_item``).  An entry that no longer
differs fails too, so the list stays exact.  Names the port keeps
as stubs (``*args, **kwargs``) must raise ``NotImplementedError`` naming
ROADMAP.  Then one test per argument repaired to the JAX surface.
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import analytics_zoo_tpu  # noqa: F401  (the reference surface)
import analytics_zoo_tpu_torch


@pytest.fixture(autouse=True)
def _fresh_port_context():
    """The port's context is process-wide, as the JAX package's is: each
    test starts and ends without one."""
    from analytics_zoo_tpu_torch.common.context import reset_context
    reset_context()
    yield
    reset_context()

# deliberate differences of the port
RNG = "a JAX PRNG key becomes an int seed or a torch.Generator"
DEVICE = "device= is added: entry points default to the card"
LAYOUT = "nn.Module constructors and methods follow the module layout"
OPTAX = "optax's transformation and its state have no counterpart"
BACKEND = "backend= picks the kernel or its plain version"
PREDICT = "predict batches on the host, so it takes the batch size"


#: name -> (parameters of the JAX name the port lacks, parameters the
#: port adds, why)
DIFFERENCES = {
    "common.context.init_zoo_context": ("", "devices", DEVICE),
    "common.health.HealthMonitor.__init__": ("", "device", DEVICE),
    "data.sharded.ShardedFeatureSet.batches": ("", "device", DEVICE),
    "data.featureset.FeatureSet.batches": ("", "device", DEVICE),
    "data.featureset.FeatureSet.batches_with_counts": ("", "device",
                                                       DEVICE),
    "data.featureset.DeviceFeatureSet.batches": ("", "device", DEVICE),
    "data.featureset.DeviceFeatureSet.batches_with_counts": (
        "", "device", DEVICE),
    "data.featureset.DeviceFeatureSet.stacked_epoch": ("", "device",
                                                       DEVICE),
    "estimator.estimator.Estimator.__init__": ("", "config device",
                                               DEVICE),
    "estimator.estimator.Estimator.train": ("rng", "seed", RNG),
    "inference.inference_model.InferenceModel.__init__": ("", "device",
                                                          DEVICE),
    "keras.engine.Layer.build": ("rng", "", f"{LAYOUT}; {RNG}"),
    "keras.engine.Layer.init": ("rng", "generator", f"{LAYOUT}; {RNG}"),
    "keras.engine.Layer.param_count": ("params", "", LAYOUT),
    "keras.engine.KerasNet.fit": ("rng", "seed", RNG),
    "keras.engine.KerasNet.load": ("", "device", DEVICE),
    "keras.engine.KerasNet.predict_fn": ("params state", "", LAYOUT),
    "keras.engine.Model.__init__": ("", "device", DEVICE),
    "keras.engine.Sequential.__init__": ("", "device", DEVICE),
    "keras.engine.Sequential.build": ("rng", "", f"{LAYOUT}; {RNG}"),
    "keras.layers.core.Dense.build": ("rng", "", f"{LAYOUT}; {RNG}"),
    "keras.layers.normalization.LayerNorm.__init__": (
        "kw", "hidden_size name", LAYOUT),
    "keras.layers.self_attention.MultiHeadAttention.__init__": (
        "kw", "name backend", f"{LAYOUT}; {BACKEND}"),
    "keras.layers.self_attention.PositionwiseFFN.__init__": ("kw", "name",
                                                             LAYOUT),
    "keras.layers.self_attention.TransformerBlock.__init__": ("kw", "name",
                                                              LAYOUT),
    "keras.layers.self_attention.TransformerLayer.__init__": ("kw", "name",
                                                              LAYOUT),
    "keras.layers.self_attention.BERT.__init__": ("kw", "name", LAYOUT),
    "keras.optimizers.Optimizer.__init__": ("tx", "", OPTAX),
    "keras.optimizers.Optimizer.update": ("opt_state", "state", OPTAX),
    "llm.engine.LLMServing.__init__": ("", "device", DEVICE),
    "models.common.ZooModel.__init__": ("", "device", DEVICE),
    "llm.kv_cache.PagedKVCache.__init__": ("", "device", DEVICE),
    "models.generation.DecoderLM.__init__": (
        "params", "hidden n_layers intermediate generator device",
        f"{LAYOUT}; {RNG}; {DEVICE}"),
    "models.generation.DecoderLM.tiny": ("rng", "generator device",
                                         f"{RNG}; {DEVICE}"),
    "ops.attention.flash_forward_with_lse": ("", "backend", BACKEND),
    "ops.paged_attention.paged_chunk_attention": ("", "backend", BACKEND),
    "tfpark.text_estimators.BERTBaseEstimator.__init__": ("", "device",
                                                          DEVICE),
    "tfpark.text_estimators.BERTBaseEstimator.train": ("rng", "seed", RNG),
    "tfpark.text_estimators.BERTBaseEstimator.predict": ("", "batch_size",
                                                         PREDICT),
    "tfpark.text_estimators.BERTClassifier.__init__": (
        "", "device generator", f"{DEVICE}; {RNG}"),
    "tfpark.text_estimators.BERTNER.__init__": (
        "", "device generator", f"{DEVICE}; {RNG}"),
    "tfpark.text_estimators.BERTSQuAD.__init__": (
        "", "device generator", f"{DEVICE}; {RNG}"),
    "estimator.local_estimator.LocalEstimator.fit": ("rng", "seed", RNG),
    "models.seq2seq.Seq2seq.__init__": ("", "device generator",
                                        f"{DEVICE}; {RNG}"),
    "parallel.moe.init_moe_params": ("rng", "generator device",
                                     f"{RNG}; {DEVICE}"),
}
# a layer whose weights wait for its input's shape creates them from that
# shape alone; its initializers take a torch.Generator in init()
DIFFERENCES.update({
    f"keras.layers.{name}.build": ("rng", "", f"{LAYOUT}; {RNG}")
    for name in (
        "advanced_activations.PReLU", "advanced_activations.SReLU",
        "convolutional.Deconvolution2D", "convolutional.LocallyConnected1D",
        "convolutional.LocallyConnected2D",
        "convolutional.SeparableConvolution2D", "convolutional.ShareConv2D",
        "convolutional.ShareConvolution2D", "core.Highway",
        "core.KerasLayerWrapper", "core.MaxoutDense", "core.Scale",
        "normalization.BatchNormalization", "recurrent.Bidirectional",
        "recurrent.ConvLSTM2D", "recurrent.Recurrent",
        "recurrent.TimeDistributed")})
DIFFERENCES.update({
    "keras.layers.recurrent.LSTM.scan_with_state": ("params", "", LAYOUT),
    "models.anomalydetection.AnomalyDetector.fit": ("rng", "seed", RNG),
})
# the initializers fill a tensor in place from a torch.Generator
DIFFERENCES.update({
    f"keras.initializers.{name}": ("rng shape dtype", "t generator",
                                   f"{LAYOUT}; {RNG}")
    for name in ("glorot_uniform", "glorot_normal", "he_normal",
                 "he_uniform", "lecun_uniform", "uniform", "normal", "zero",
                 "one")})


def _params(fn):
    try:
        return list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return None


def _pairs():
    """(name, port callable, JAX callable) for every public port name
    with a JAX namesake, in a fixed order."""
    out = []
    prefix = analytics_zoo_tpu_torch.__name__ + "."
    modules = pkgutil.walk_packages(analytics_zoo_tpu_torch.__path__, prefix)
    for info in sorted(modules, key=lambda m: m.name):
        port = importlib.import_module(info.name)
        try:
            ref = importlib.import_module(
                "analytics_zoo_tpu." + info.name[len(prefix):])
        except ImportError:
            continue                          # a port-only module
        for attr, obj in sorted(vars(port).items()):
            if attr.startswith("_") or getattr(obj, "__module__",
                                               None) != info.name:
                continue
            jobj = getattr(ref, attr, None)
            if jobj is None or not (inspect.isfunction(obj)
                                    or inspect.isclass(obj)):
                continue
            short = f"{info.name[len(prefix):]}.{attr}"
            if not inspect.isclass(obj):
                out.append((short, obj, jobj))
                continue
            out.append((f"{short}.__init__", obj.__init__, jobj.__init__))
            for meth in sorted(vars(obj)):
                if meth.startswith("_") or inspect.getattr_static(
                        jobj, meth, None) is None:
                    continue
                f, jf = getattr(obj, meth), getattr(jobj, meth)
                if callable(f) and callable(jf):
                    out.append((f"{short}.{meth}", f, jf))
    return [(n, f, jf) for n, f, jf in out
            if _params(f) is not None and _params(jf) is not None]


PAIRS = _pairs()
STUBS = [n for n, f, _ in PAIRS if _params(f) == ["args", "kwargs"]]
COMPARED = [n for n, _, _ in PAIRS if n not in STUBS]


def test_the_walk_finds_the_ported_surface():
    # the names this file was written against are still walked
    assert len(COMPARED) > 150
    assert set(DIFFERENCES) <= set(COMPARED)
    for name in ("ops.attention.flash_attention",
                 "serving.client.InputQueue.enqueue_items",
                 "llm.client.GenerationClient.submit",
                 "common.config.load_config",
                 "common.resilience.deadline_scope",
                 "serving.client.FastWireHttpClient.generate",
                 "serving.http_frontend.ServingFrontend.__init__",
                 "keras.layers.core.Dropout.__init__",
                 "keras.layers.core.GaussianSampler.__init__",
                 "keras.layers.convolutional.Deconvolution2D.__init__",
                 "keras.layers.pooling.MaxPooling1D.__init__",
                 "keras.layers.recurrent.LSTM.scan_with_state",
                 "keras.layers.normalization.BatchNormalization.__init__",
                 "keras.layers.embedding.WordEmbedding.__init__",
                 "keras.metrics.AUC.__init__",
                 "models.textclassification.TextClassifier.__init__",
                 "models.recommendation.SessionRecommender"
                 ".recommend_for_session",
                 "models.anomalydetection.AnomalyDetector.detect_anomalies",
                 "models.imageclassification.ImageClassifier.label_output"):
        assert name in COMPARED


def test_every_jax_layer_metric_and_zoo_model_is_walked():
    """Every name of the JAX layer catalogue, every metric and the four
    zoo models of the slice have a port counterpart that the walk
    compares (constructor included)."""
    import analytics_zoo_tpu.keras.layers as jlayers
    from analytics_zoo_tpu.keras import metrics as jmetrics
    import analytics_zoo_tpu_torch.keras.layers as tlayers
    names = [n for n in dir(jlayers) if n[0].isupper()]
    assert len(names) > 90
    for name in names:
        port = getattr(tlayers, name)
        module = port.__module__[len("analytics_zoo_tpu_torch."):]
        if module == "keras.engine" or name.startswith("Conv") and len(
                name) == 6:
            continue          # Input / Lambda / Layer, and Keras-1 aliases
        assert f"{module}.{port.__name__}.__init__" in COMPARED, name
    for name in ("Accuracy", "SparseCategoricalAccuracy", "Top5Accuracy",
                 "MAE", "MSE", "Loss", "AUC"):
        assert hasattr(jmetrics, name)
        assert f"keras.metrics.{name}.__init__" in COMPARED
    for name in ("textclassification.TextClassifier",
                 "recommendation.SessionRecommender",
                 "anomalydetection.AnomalyDetector",
                 "imageclassification.ImageClassifier"):
        assert f"models.{name}.__init__" in COMPARED


def test_the_heads_autograd_and_feeds_are_walked():
    """The NER / SQuAD heads, autograd, the local estimator, KNRM with the
    Ranker, Seq2seq, the TFRecord codec and the FeatureSet / TFDataset
    factories are compared with their JAX namesakes."""
    from analytics_zoo_tpu import autograd as jautograd
    names = [f"autograd.{n}" for n in jautograd.__all__
             if n not in ("Parameter", "Constant", "CustomLoss", "Variable",
                          "Lambda", "Input")]
    names += [f"autograd.{c}.__init__" for c in ("Parameter", "Constant",
                                                 "CustomLoss")]
    names += ["autograd.Parameter.to_variable",
              "autograd.Constant.to_variable", "autograd.CustomLoss.forward",
              "autograd.CustomLoss.backward"]
    names += [f"tfpark.text_estimators.{c}.__init__"
              for c in ("BERTNER", "BERTSQuAD")]
    names += [f"estimator.local_estimator.LocalEstimator.{m}"
              for m in ("__init__", "fit", "evaluate", "predict")]
    names += ["models.textmatching.KNRM.__init__",
              "models.common.Ranker.evaluate_ndcg",
              "models.common.Ranker.evaluate_map",
              "models.seq2seq.Seq2seq.__init__",
              "models.seq2seq.Seq2seq.infer"]
    names += [f"data.tfrecord.{n}" for n in (
        "read_records", "write_records", "parse_example", "build_example",
        "read_example_file", "examples_to_arrays", "crc32c", "iter_fields",
        "emit_bytes")]
    names += [f"data.featureset.FeatureSet.{m}" for m in (
        "from_dataframe", "from_tfrecord_file", "from_generator", "disk",
        "from_sources", "to_disk", "size")]
    names += [f"data.featureset.{c}.{m}"
              for c in ("GeneratorFeatureSet", "DiskFeatureSet")
              for m in ("__init__", "local_batches", "steps_per_epoch")]
    names += [f"tfpark.tf_dataset.TFDataset.{m}" for m in (
        "from_dataframe", "from_tfrecord_file", "from_feature_set",
        "from_generator")]
    missing = [n for n in names if n not in COMPARED]
    assert not missing, missing
    for name in ("from_rdd", "from_image_set", "from_text_set",
                 "from_string_rdd", "from_bytes_rdd",
                 "from_tf_data_dataset"):
        assert f"tfpark.tf_dataset.TFDataset.{name}" in STUBS


def test_observability_and_chaos_are_walked():
    """The observability modules and the chaos harness are compared with
    their JAX namesakes, and none of them is a stub."""
    from analytics_zoo_tpu import observability as jobs
    names = [f"observability.{n}" for n in (
        "counter", "gauge", "histogram", "set_enabled", "lazy_counter",
        "lazy_gauge", "lazy_histogram", "install_health_gauges",
        "install_jax_compile_hook")]
    names += [f"observability.metrics.{n}" for n in (
        "MetricsRegistry.__init__", "MetricsRegistry.counter",
        "MetricsRegistry.histogram", "MetricsRegistry.snapshot",
        "MetricsRegistry.register_collector", "default_buckets",
        "get_registry", "set_registry")]
    names += [f"observability.tracing.{n}" for n in (
        "Tracer.__init__", "Tracer.span", "Tracer.add_event",
        "Tracer.export", "Tracer.export_events", "encode_trace_context",
        "decode_trace_context", "new_trace_context", "chrome_trace",
        "span", "add_event", "current_span", "get_tracer")]
    names += [f"observability.exposition.{n}" for n in (
        "render", "render_snapshot", "dump")]
    names += [f"observability.flight_recorder.{n}" for n in (
        "FlightRecorder.__init__", "FlightRecorder.trigger",
        "FlightRecorder.list_dumps", "FlightRecorder.read_dump", "get",
        "configure")]
    names += [f"observability.memory.{n}" for n in (
        "MemoryLedger.__init__", "MemoryLedger.register",
        "MemoryLedger.snapshot", "MemoryLedger.reconcile_once",
        "MemoryLedger.sample_once", "MemoryLedger.on_pressure",
        "merge_memory_snapshots", "device_memory_stats", "get_ledger",
        "configure")]
    names += ["observability.trace_cli.main"]
    names += [f"testing.chaos.{n}" for n in (
        "ChaosInjector.plan", "ChaosInjector.fire", "ChaosInjector.count",
        "ChaosInjector.injected", "install", "uninstall", "installed",
        "fire")]
    missing = [n for n in names if n not in COMPARED]
    assert not missing, missing
    assert not [n for n in STUBS if n.startswith(("observability.",
                                                   "testing."))]
    assert "CONTENT_TYPE" in jobs.__all__


def test_the_rest_of_serving_is_walked():
    """The host library, ``BatchingService``, the native-queue and Redis
    brokers, the WAL, the journaled broker with its standby and the fleet
    are compared with their JAX namesakes, and none of them is a stub."""
    names = [f"native.{n}" for n in (
        "load_library", "crc32c", "resize_bilinear", "crop", "normalize",
        "NativeSampleCache.__init__", "NativeSampleCache.get",
        "NativeSampleCache.recount", "RequestQueue.push",
        "RequestQueue.pop_batch", "RequestQueue.wait")]
    names += [f"inference.batching.BatchingService.{m}"
              for m in ("__init__", "predict", "stats", "stop")]
    names += [f"serving.broker.{n}" for n in (
        "redis_wire_value", "redis_unwire_value", "get_broker",
        "NativeQueueBroker.__init__", "NativeQueueBroker.xreadgroup",
        "NativeQueueBroker.wait_result", "RedisBroker.__init__",
        "RedisBroker.set_results")]
    names += [f"common.wal.{n}" for n in (
        "list_segments", "WriteAheadLog.__init__", "WriteAheadLog.append",
        "WriteAheadLog.commit", "WriteAheadLog.replay", "WriteAheadLog.tail",
        "WriteAheadLog.gc")]
    names += [f"serving.durability.{n}" for n in (
        "replay_dir", "DurableBroker.__init__", "DurableBroker.xadd",
        "DurableBroker.xreadgroup", "DurableBroker.pending",
        "DurableBroker.checkpoint", "DurableBroker.wal_tail",
        "BrokerReplica.__init__", "BrokerReplica.promote")]
    names += [f"serving.fleet.{n}" for n in (
        "partition_for", "partition_stream", "merge_snapshots",
        "fleet_queue_signal", "BrokerBridge.__init__",
        "RemoteBroker.__init__", "RemoteBroker.wait_hgetall",
        "FleetPublisher.__init__", "FleetContext.merged_spans",
        "FleetRouter.__init__", "FleetRouter.route",
        "FleetRouter.note_result", "ReplicaAutoscaler.__init__",
        "ReplicaAutoscaler.tick", "FleetSupervisor.__init__",
        "FleetSupervisor.start", "FleetSupervisor.kill_broker_owner",
        "FleetSupervisor.kill_replica", "FleetSupervisor.autoscale_tick")]
    names += ["common.config.FleetConfig.__init__",
              "serving.client.OutputQueue.query_blocking"]
    missing = [n for n in names if n not in COMPARED]
    assert not missing, missing
    assert not [n for n in STUBS if n.startswith((
        "native.", "inference.batching.", "common.wal.",
        "serving.durability.", "serving.fleet.", "serving.broker."))]


def test_model_parallel_serving_is_walked():
    """The process-wide context, the sharding rules, the ZeRO specs, MoE,
    the pipeline and the sharded serving ops are compared with their JAX
    namesakes, and none of them is a stub."""
    names = [f"common.context.{n}" for n in (
        "get_context", "current_context", "context_scope.__init__",
        "device_scope.__init__", "reset_context", "set_context",
        "init_zoo_context", "ZooContext.__init__", "ZooContext.sharding",
        "ZooContext.replicate")]
    names += [f"parallel.sharding.{n}" for n in (
        "ShardingRule.__init__", "ShardingRule.matches", "partition_specs",
        "named_shardings", "partition_params")]
    names += [f"parallel.zero.{n}" for n in (
        "zero_partition_spec", "zero_shardings", "replicated_shardings",
        "tree_bytes", "bytes_per_device")]
    names += [f"parallel.moe.{n}" for n in (
        "init_moe_params", "partition_moe_params", "moe_ffn")]
    names += [f"parallel.pipeline.{n}" for n in (
        "stack_stage_params", "pipeline_apply")]
    names += ["ops.paged_attention.sharded_paged_decode_attention",
              "ops.paged_attention.sharded_paged_chunk_attention",
              "ops.attention.sharded_flash_attention",
              "models.generation.DecoderLM.shard",
              "llm.kv_cache.PagedKVCache.__init__"]
    missing = [n for n in names if n not in COMPARED]
    assert not missing, missing
    assert not [n for n in STUBS if n.startswith(("parallel.",
                                                   "common.context."))]


@pytest.mark.parametrize("name", COMPARED)
def test_parameters_match_the_jax_name(name):
    fn, jfn = next((f, jf) for n, f, jf in PAIRS if n == name)
    port, ref = _params(fn), _params(jfn)
    missing = {p for p in ref if p not in port}
    added = {p for p in port if p not in ref}
    want_missing, want_added, why = DIFFERENCES.get(name, ("", "", ""))
    assert (missing, added) == (set(want_missing.split()),
                                set(want_added.split())), (
        f"{name}: lacks {sorted(missing)}, adds {sorted(added)}; listed: "
        f"{want_missing!r} / {want_added!r} ({why or 'none'})")


@pytest.mark.parametrize("name", STUBS)
def test_stub_raises_naming_roadmap(name):
    fn = next(f for n, f, _ in PAIRS if n == name)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fn()


# --- the arguments repaired to the JAX surface ----------------------------

class _Capture:
    """A broker that keeps what is queued."""

    def __init__(self):
        self.entries = []

    def xadd(self, stream, fields):
        self.entries.append(fields)
        return f"{len(self.entries)}-0"


def _queues():
    from analytics_zoo_tpu_torch.serving.client import InputQueue
    broker = _Capture()
    return broker, InputQueue(broker=broker)


def _last_entry(broker):
    return broker.entries[-1]


def test_enqueue_items_takes_an_explicit_deadline():
    from analytics_zoo_tpu_torch.common.resilience import Deadline
    broker, q = _queues()
    dl = Deadline(30.0)
    q.enqueue_items("a", {"x": np.ones(3, np.float32)}, deadline=dl)
    assert abs(float(_last_entry(broker)["deadline_ts"]) - dl.wall()) < 1e-3


def test_enqueue_batch_items_takes_an_explicit_deadline():
    from analytics_zoo_tpu_torch.common.resilience import Deadline
    broker, q = _queues()
    dl = Deadline(30.0)
    q.enqueue_batch_items(["a", "b"], {"x": np.ones((2, 3), np.float32)},
                          deadline=dl)
    fields = _last_entry(broker)
    assert abs(float(fields["deadline_ts"]) - dl.wall()) < 1e-3
    assert fields["batch"] == "2"


@pytest.mark.parametrize("method", ["enqueue_items", "enqueue_batch_items",
                                    "enqueue_raw"])
@pytest.mark.parametrize("arg,item", [("trace_ctx", 6), ("model", 1),
                                      ("tenant", 1)])
def test_enqueue_unported_stamp_names_its_item(method, arg, item):
    from analytics_zoo_tpu_torch.serving.codec import encode_items_bytes
    broker, q = _queues()
    call = {
        "enqueue_items": lambda **kw: q.enqueue_items(
            "a", {"x": np.ones(2)}, **kw),
        "enqueue_batch_items": lambda **kw: q.enqueue_batch_items(
            ["a"], {"x": np.ones((1, 2))}, **kw),
        "enqueue_raw": lambda **kw: q.enqueue_raw(
            "a", encode_items_bytes({"x": np.ones(2)}), **kw)}[method]
    if arg == "trace_ctx":
        # item 6's trace context is ported: the stamp rides the entry as
        # the JAX client writes it
        call(trace_ctx="7-9")
        assert _last_entry(broker)["trace_ctx"] == "7-9"
        return
    # item 1's model and tenant stamps are ported: each rides the entry
    # under its JAX field name, and a name holding the record separator
    # raises before anything is queued
    call(**{arg: "x"})
    assert _last_entry(broker)[arg] == "x"
    n = len(broker.entries)
    with pytest.raises(ValueError, match="separator"):
        call(**{arg: "x\x1fy"})
    assert len(broker.entries) == n
    call()                                       # None stamps nothing
    assert arg not in _last_entry(broker)


@pytest.mark.parametrize("arg,item", [("trace_ctx", 6), ("model", 1),
                                      ("tenant", 1)])
def test_http_predict_unported_stamp_names_its_item(arg, item):
    from analytics_zoo_tpu_torch.serving.client import FastWireHttpClient
    if arg == "trace_ctx":
        # ported: the context rides the X-Zoo-Trace header
        headers = FastWireHttpClient._headers("u", None, "7-9")
        assert headers["X-Zoo-Trace"] == "7-9"
        assert "X-Zoo-Trace" not in FastWireHttpClient._headers(
            "u", None, None)
        return
    # item 1's stamps are ported: the model names the /predict/<model>
    # route, the tenant rides X-Zoo-Tenant (captured before any send)
    client = FastWireHttpClient(port=0)       # never connects
    seen = {}

    class _Sent(Exception):
        pass

    def post(frame, headers, path="/predict"):
        seen.update(headers=headers, path=path)
        raise _Sent

    client._post = post
    with pytest.raises(_Sent):
        client.predict(x=np.ones(2), **{arg: "x"})
    if arg == "model":
        assert seen["path"] == "/predict/x"
        assert "X-Zoo-Tenant" not in seen["headers"]
        with pytest.raises(ValueError):
            client.predict(x=np.ones(2), model="a/b")
    else:
        assert seen["path"] == "/predict"
        assert seen["headers"]["X-Zoo-Tenant"] == "x"


def test_enqueue_takes_the_ambient_deadline():
    from analytics_zoo_tpu_torch.common.resilience import (
        Deadline, deadline_scope)
    broker, q = _queues()
    dl = Deadline(30.0)
    with deadline_scope(dl):
        q.enqueue_items("a", {"x": np.ones(2)})
    assert abs(float(_last_entry(broker)["deadline_ts"]) - dl.wall()) < 1e-3
    q.enqueue_items("b", {"x": np.ones(2)})
    assert "deadline_ts" not in _last_entry(broker)


def test_generation_submit_trace_ctx_names_item_6():
    # item 6's trace context is ported: an explicit context is stamped as
    # given, and an unstamped submit gets a fresh one while tracing is on
    from analytics_zoo_tpu_torch import observability as obs
    from analytics_zoo_tpu_torch.llm.client import GenerationClient
    broker = _Capture()
    client = GenerationClient(broker=broker)
    assert client.submit("r", [1, 2, 3], trace_ctx="00-ab-cd-01") == "r"
    assert broker.entries[-1]["trace_ctx"] == "00-ab-cd-01"
    assert client.submit("r", [1, 2, 3], trace_ctx=None) == "r"
    assert obs.decode_trace_context(
        broker.entries[-1]["trace_ctx"]) is not None


def test_admission_shed_trace_id_names_item_6():
    # ported: the shed is journaled with the request's trace id
    from analytics_zoo_tpu_torch import observability as obs
    from analytics_zoo_tpu_torch.common.resilience import AdmissionController
    ctl = AdmissionController(capacity=4)
    ctl.shed(1, trace_id=7)
    ctl.shed(1)
    assert ctl.shed_count == 2
    ev = obs.get_tracer().export_events(trace_id=7)
    assert [e["kind"] for e in ev][-1:] == ["shed"]


def test_record_expired_trace_id_names_item_6():
    # ported: the expiry is journaled with the request's trace id
    from analytics_zoo_tpu_torch import observability as obs
    from analytics_zoo_tpu_torch.common import resilience
    before = resilience.expired_counts.get("surface", 0)
    resilience.record_expired(1, scope="surface", trace_id=8)
    resilience.record_expired(2, scope="surface")
    assert resilience.expired_counts["surface"] == before + 3
    ev = obs.get_tracer().export_events(trace_id=8)
    assert [e["kind"] for e in ev][-1:] == ["expired"]


def test_trigger_state_has_a_score():
    from analytics_zoo_tpu.common.triggers import TriggerState as JState
    from analytics_zoo_tpu_torch.common.triggers import TriggerState
    assert TriggerState().score is None
    s = TriggerState(epoch=2, iteration=10, score=0.75)
    assert s.score == 0.75
    assert JState(epoch=2, iteration=10, score=0.75).score == s.score


def test_featureset_sequential_order_keeps_record_order():
    from analytics_zoo_tpu.data.featureset import FeatureSet as JFeatureSet
    from analytics_zoo_tpu_torch.data.featureset import FeatureSet
    x = np.arange(10, dtype=np.float32)[:, None]
    fs = FeatureSet(x, x[:, 0], shuffle=True, sequential_order=True, seed=3)
    assert not fs.shuffle
    got = [b[0][:, 0] for b in fs.local_batches(4, epoch=1)]
    np.testing.assert_array_equal(np.concatenate(got), np.arange(8))
    jfs = JFeatureSet(x, x[:, 0], shuffle=True, sequential_order=True,
                      seed=3)
    want = [b[0][:, 0] for b in jfs.local_batches(4, epoch=1)]
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    # without it the epoch is shuffled
    shuffled = np.concatenate([b[0][:, 0] for b in FeatureSet(
        x, x[:, 0], seed=3).local_batches(4, epoch=1)])
    assert not np.array_equal(shuffled, np.arange(8))


def _qkv(seed=0, B=2, H=2, T=16, D=32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, H, T, D),
                                                 dtype=np.float32))
            for _ in range(3)]


def test_flash_attention_tile_hints_are_no_ops():
    from analytics_zoo_tpu_torch.ops.attention import flash_attention
    q, k, v = _qkv()
    base = flash_attention(q, k, v, causal=True)
    hinted = flash_attention(q, k, v, causal=True, block_q=64, block_k=32)
    assert torch.equal(base, hinted)
    # positional order is the JAX one: ..., sm_scale, block_q, block_k
    assert torch.equal(flash_attention(q, k, v, None, True, None, 8, 8),
                       base)


def test_flash_forward_with_lse_tile_hints_are_no_ops():
    from analytics_zoo_tpu_torch.ops.attention import flash_forward_with_lse
    q, k, v = _qkv(1)
    o, lse = flash_forward_with_lse(q, k, v, causal=True)
    o2, lse2 = flash_forward_with_lse(q, k, v, causal=True, block_q=64,
                                      block_k=64, interpret=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_flash_attention_dropout_rng_names_dropout_seed():
    from analytics_zoo_tpu_torch.ops.attention import flash_attention
    q, k, v = _qkv()
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, k, v, dropout_rate=0.1,
                        dropout_rng=np.array([0, 42], np.uint32))


def test_paged_decode_pages_per_compute_block_is_a_no_op():
    from analytics_zoo_tpu_torch.ops.paged_attention import (
        paged_decode_attention)
    rng = np.random.default_rng(2)
    B, H, D, P, bs, nb = 2, 4, 32, 6, 4, 3
    q = torch.from_numpy(rng.standard_normal((B, H, D), dtype=np.float32))
    pages = [torch.from_numpy(rng.standard_normal((P, bs, H, D),
                                                  dtype=np.float32))
             for _ in range(2)]
    lengths = torch.tensor([5, 9], dtype=torch.int32)
    tables = torch.tensor([[1, 2, 0], [3, 4, 5]], dtype=torch.int32)
    base = paged_decode_attention(q, *pages, lengths, tables)
    hinted = paged_decode_attention(q, *pages, lengths, tables,
                                    pages_per_compute_block=8)
    assert torch.equal(base, hinted)


def test_predict_async_reserved_names_item_1():
    # item 1's reserved= is ported: a permit taken by reserve() is given
    # back when the dispatch fails before launching
    from analytics_zoo_tpu_torch.inference.inference_model import (
        InferenceModel)
    model = InferenceModel(device="cpu")
    model.reserve()
    assert model._inflight._value == 1
    with pytest.raises(RuntimeError, match="no model loaded"):
        model.predict_async(np.zeros((1, 2), np.float32), reserved=True)
    assert model._inflight._value == 2


# --- arguments taken at their JAX default, machinery not ported -----------

def _unported_calls():
    """(case id, call, argument, Queue 1 item) for every argument the port
    takes at its JAX default and refuses otherwise."""
    from analytics_zoo_tpu_torch.common import config as cfg
    from analytics_zoo_tpu_torch.common.triggers import EveryEpoch
    from analytics_zoo_tpu_torch.estimator import Estimator
    from analytics_zoo_tpu_torch.inference.inference_model import (
        InferenceModel)
    from analytics_zoo_tpu_torch.keras.layers import Embedding
    from analytics_zoo_tpu_torch.models import generation
    from analytics_zoo_tpu_torch.serving.client import FastWireHttpClient
    from analytics_zoo_tpu_torch.serving.engine import ClusterServing
    from analytics_zoo_tpu_torch.tfpark import TFDataset
    from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
    from analytics_zoo_tpu_torch.serving.tenancy import (TenancyController,
                                                         TenantPolicy)
    tenancy = TenancyController([TenantPolicy("t")])
    x = (np.zeros((4, 2), np.float32), np.zeros(4, np.int32))
    calls = [(f"TrainConfig.{k}", lambda k=k, v=v: cfg.TrainConfig(**{k: v}),
              k, item) for k, v, item in (
        ("failure_retry_window_sec", 60, 2), ("donate_state", False, 2),
        ("rng_impl", "threefry", 2))]
    # ported since: the call takes the argument and keeps what it says
    calls += [(f"TrainConfig.{k}",
               lambda k=k, v=v: getattr(cfg.TrainConfig(**{k: v}), k) == v,
               k, None) for k, v in (
        ("failure_retry_times", 3), ("keep_checkpoints", 1),
        ("max_steps_per_dispatch", 8), ("shard_model", False))]
    calls += [(f"ZooConfig.{k}", lambda k=k, v=v: cfg.ZooConfig(**{k: v}),
               k, 5) for k, v in (
        ("coordinator_address", "host:1234"), ("num_processes", 2),
        ("process_id", 1))]
    trigger = EveryEpoch()
    net = lambda: torch.nn.Linear(2, 2)
    calls += [
        ("Estimator.app_name",
         lambda: Estimator(net(), app_name="app", device="cpu").app_name
         == "app", "app_name", None),
        ("Estimator.checkpoint_trigger",
         lambda: Estimator(net(), checkpoint_trigger=trigger,
                           device="cpu").checkpoint_trigger is trigger,
         "checkpoint_trigger", None),
        ("InferenceModel.place_on_load",
         lambda: InferenceModel(place_on_load=False,
                                device="cpu").place_on_load is False,
         "place_on_load", None),
        ("InferenceModel.load_keras.place",
         lambda: not InferenceModel(device="cpu").load_keras(
             net(), place=False).placed, "place", None),
        ("ClusterServing.tenancy",
         lambda: ClusterServing(None, broker=InMemoryBroker(),
                                tenancy=tenancy).tenancy is tenancy,
         "tenancy", None),
        ("FastWireHttpClient.generate.trace_ctx",
         lambda: FastWireHttpClient._headers(None, None, "t")[
             "X-Zoo-Trace"] == "t", "trace_ctx", None),
        ("TFDataset.validation_featureset",
         lambda: TFDataset(None, batch_size=2, validation_featureset=x)
         .get_validation_data() is x, "validation_featureset", None),
        ("TFDataset.from_ndarrays.val_tensors",
         lambda: len(TFDataset.from_ndarrays(x, batch_size=2, val_tensors=x)
                     .get_validation_data()) == 4, "val_tensors", None),
        ("prefill_chunk.mesh",
         lambda: _sharded_entry_matches(generation, "prefill_chunk"),
         "mesh", None),
        ("decode_step.mesh",
         lambda: _sharded_entry_matches(generation, "decode_step"),
         "mesh", None),
        ("Embedding.partition",
         lambda: Embedding(4, 2, partition="model").partition == "model",
         "partition", None),
    ]
    return calls


def _sharded_entry_matches(generation, name) -> bool:
    """``generation.<name>(..., mesh=)`` over two CPU shards gives the
    unsharded call's logits and pages (within 1e-6: the plain attention
    over fewer heads may sum in another order)."""
    from analytics_zoo_tpu_torch.parallel import Mesh
    model = generation.DecoderLM.tiny(device="cpu")
    toks = torch.arange(5, dtype=torch.int32)
    slots = torch.arange(5, dtype=torch.long) + 4
    table = torch.tensor([1, 2, 0], dtype=torch.int32)
    out = []
    for mesh in (None, Mesh(["cpu"] * 2, ("model",))):
        pages = [torch.zeros(2, 4, 4, 2, 16) for _ in range(2)]
        if name == "prefill_chunk":
            logits = generation.prefill_chunk(model, toks, 0, 5, table,
                                              *pages, slots, 2, mesh=mesh)
        else:
            logits = generation.decode_step(
                model, toks[:2], toks[:2], torch.tensor([1, 2], dtype=torch.int32),
                table[None].repeat(2, 1), *pages, slots[:2], 2, mesh=mesh)
        out.append([logits[0]] + pages)
    return all(torch.allclose(a, b, atol=1e-6, rtol=0)
               for a, b in zip(*out))


UNPORTED = _unported_calls()


@pytest.mark.parametrize("call,arg,item", [c[1:] for c in UNPORTED],
                         ids=[c[0] for c in UNPORTED])
def test_unported_argument_names_its_item(call, arg, item):
    if item is None:          # ported since: the call keeps what it takes
        assert call() is True
        return
    with pytest.raises(NotImplementedError,
                       match=f"{arg}=.*Queue 1 item {item}"):
        call()


def test_unported_arguments_at_their_jax_default_run():
    from analytics_zoo_tpu.common import config as jcfg
    from analytics_zoo_tpu_torch.common import config as cfg
    from analytics_zoo_tpu_torch.inference.inference_model import (
        InferenceModel)
    from analytics_zoo_tpu_torch.tfpark import TFDataset
    jtrain = jcfg.TrainConfig()
    train = cfg.TrainConfig(**{
        k: getattr(jtrain, k) for k in (
            "failure_retry_times", "failure_retry_window_sec",
            "keep_checkpoints", "donate_state", "rng_impl", "shard_model",
            "max_steps_per_dispatch")})
    assert train == cfg.TrainConfig()
    jzoo = jcfg.ZooConfig()
    zoo = cfg.ZooConfig(
        serving=cfg.ServingConfig(), coordinator_address=None,
        num_processes=None, process_id=None, platform=None,
        log_output=jzoo.log_output, default_dtype=jzoo.default_dtype)
    assert zoo == cfg.ZooConfig()
    model = InferenceModel(place_on_load=True, device="cpu")
    net = torch.nn.Linear(2, 2)
    for place in (None, True):
        assert model.load_keras(net, place=place).model is net
    x = (np.zeros((4, 2), np.float32), np.zeros(4, np.int32))
    assert len(TFDataset.from_ndarrays(x, batch_size=2,
                                       val_tensors=None)) == 4


def test_tfdataset_has_labels_as_the_jax_name():
    from analytics_zoo_tpu.tfpark.tf_dataset import TFDataset as JTFDataset
    from analytics_zoo_tpu_torch.tfpark import TFDataset
    feats = np.zeros((8, 3), np.float32)
    labels = np.zeros(8, np.int32)
    for tensors in ((feats, labels), (feats,)):
        got = TFDataset.from_ndarrays(tensors, batch_size=8)
        want = JTFDataset.from_ndarrays(tensors, batch_size=8)
        assert got.has_labels == want.has_labels
    assert TFDataset(None, batch_size=8, has_labels=False).has_labels is False


# --- the JAX package's backend names ---------------------------------------

def _paged_case(seed=3):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
    q, pages = f(2, 4, 32), [f(6, 4, 2, 32) for _ in range(2)]
    lengths = torch.tensor([5, 9], dtype=torch.int32)
    tables = torch.tensor([[1, 2, 0], [3, 4, 5]], dtype=torch.int32)
    return q, pages, lengths, tables


def _alias_calls():
    """name -> call(backend name) for every op that takes the JAX
    package's backend names."""
    from analytics_zoo_tpu_torch.ops.attention import (
        flash_attention, flash_forward_with_lse)
    from analytics_zoo_tpu_torch.ops.paged_attention import (
        paged_chunk_attention, paged_decode_attention)
    from analytics_zoo_tpu_torch.parallel import Mesh, ring_attention
    q, k, v = _qkv(4)
    pq, pages, lengths, tables = _paged_case()
    mesh = Mesh(["cpu"] * 4, ("sequence",))
    return {
        "flash_attention": lambda b: flash_attention(q, k, v, causal=True,
                                                     backend=b),
        "flash_forward_with_lse": lambda b: flash_forward_with_lse(
            q, k, v, backend=b),
        "paged_decode_attention": lambda b: paged_decode_attention(
            pq, *pages, lengths, tables, backend=b),
        "paged_chunk_attention": lambda b: paged_chunk_attention(
            pq[:1].expand(3, 4, 32), *pages, tables[1], 2, backend=b),
        "ring_attention": lambda b: ring_attention(q, k, v, mesh,
                                                   causal=True, impl=b),
    }


ALIAS_OPS = ["flash_attention", "flash_forward_with_lse",
             "paged_decode_attention", "paged_chunk_attention",
             "ring_attention"]


@pytest.mark.parametrize("op", ALIAS_OPS)
def test_jnp_names_the_plain_version(op):
    call = _alias_calls()[op]
    got, want = call("jnp"), call("plain")
    for g, w in zip(*(t if isinstance(t, tuple) else (t,)
                      for t in (got, want))):
        assert torch.equal(g, w)


@pytest.mark.parametrize("op", ALIAS_OPS)
def test_pallas_names_the_kernel(op):
    # the kernels have no interpret mode: on CPU tensors "pallas" raises,
    # as "cuda" does
    call = _alias_calls()[op]
    for name in ("pallas", "cuda"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call(name)
    with pytest.raises(ValueError, match="pallas"):
        call("triton")


def test_attention_layers_take_the_jax_backend_names():
    from analytics_zoo_tpu_torch.keras.layers.self_attention import (
        MultiHeadAttention, set_attention_backend)
    mha = MultiHeadAttention(8, 2, backend="jnp")
    assert mha.backend == "plain"
    set_attention_backend(mha, "pallas")
    assert mha.backend == "cuda"
    with pytest.raises(ValueError, match="backend"):
        set_attention_backend(mha, "xla")
