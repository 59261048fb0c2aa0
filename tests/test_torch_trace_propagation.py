"""End-to-end trace propagation and the ``zoo_*`` series of the port's
serving, LLM-serving and training paths, against the JAX package's, on the
CPU.

- The wire stamp: ``InputQueue`` writes ``trace_ctx`` as the JAX client
  writes it (the ambient span's context, else a fresh wire-minted one;
  nothing while tracing is off).
- A tiny BERT classifier behind each package's pipelined ``ClusterServing``
  and ``ServingFrontend`` (port 0): an ``X-Zoo-Trace`` request gets its
  context echoed, and the port's spans form the JAX chain ``http.predict``
  → ``serving.decode`` → ``serving.dispatch`` → ``serving.sink`` under one
  trace id; after the same requests both packages' registries hold the
  same ``zoo_serving_*`` / ``zoo_http_*`` families with the same types
  and the same record and request counts (not latencies, and not the
  coalescer's flush count, which follows timing).
- ``DecoderLM.tiny()`` behind ``LLMServing`` and the frontend: one
  ``http.generate`` span, ``llm.prefill`` spans under it, one
  ``llm.token`` event per streamed token and the ``zoo_llm_*`` counts.
- The estimator (a small Keras ``Sequential``, host tier, checkpoints):
  the span names and parent links, ``zoo_train_steps_total`` /
  ``zoo_train_epochs_total`` and the family types of the JAX estimator
  over the same training.

Ids are random, so spans compare by names, links, attributes and counts.
Every test starts from fresh registries and emptied tracers in both
packages; servers bind port 0 and stop in a ``finally``.
"""

import http.client
import json
import time
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu import observability as jobs
from analytics_zoo_tpu_torch import observability as tobs

BOTH = (jobs, tobs)
WAIT = 5.0
CFG = dict(vocab=50, hidden_size=32, n_block=2, n_head=2, seq_len=16,
           intermediate_size=64, hidden_drop=0.0, attn_drop=0.0)
NAMES = ("input_ids", "token_type_ids", "input_mask")


@pytest.fixture(autouse=True)
def fresh(tmp_path):
    prev = [O.set_registry(O.MetricsRegistry()) for O in BOTH]
    for O, name in zip(BOTH, ("jax", "torch")):
        O.get_tracer().clear()
        O.set_enabled(True)
        O.configure_flight_recorder(dir=str(tmp_path / name))
    yield
    for O, p in zip(BOTH, prev):
        O.set_enabled(True)
        O.get_tracer().clear()
        O.configure_flight_recorder()
        O.set_registry(p)


#: gauges first set once a full second of work has passed: present or not
#: after a short run by timing alone
TIMED = ("zoo_serving_throughput_rps", "zoo_llm_tokens_per_s")


def _families(O, prefixes):
    """``{name: kind}`` of the registry's families under ``prefixes``."""
    return {name: fam["kind"] for name, fam in
            O.get_registry().snapshot().items()
            if name.startswith(prefixes) and name not in TIMED}


def _series(O, name):
    fam = O.get_registry().snapshot().get(name)
    return {} if fam is None else dict(fam["series"])


def _chain(O, trace_id, names):
    """The trace's spans, once every one of ``names`` has landed."""
    deadline = time.monotonic() + WAIT
    while True:
        spans = O.get_tracer().export(trace_id=trace_id)
        if {s["name"] for s in spans} >= set(names) \
                or time.monotonic() > deadline:
            return spans
        time.sleep(0.01)


def test_enqueue_stamps_as_the_jax_client():
    from analytics_zoo_tpu.serving.broker import InMemoryBroker as JBroker
    from analytics_zoo_tpu.serving.client import InputQueue as JInputQueue
    from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
    from analytics_zoo_tpu_torch.serving.client import InputQueue
    views = []
    for O, Q, B in ((jobs, JInputQueue, JBroker),
                    (tobs, InputQueue, InMemoryBroker)):
        broker = B()
        q = Q(broker=broker)
        last = lambda: broker._streams["serving_stream"][-1][1]
        x = {"x": np.ones(2, np.float32)}
        q.enqueue_items("minted", x)
        minted = O.decode_trace_context(last()["trace_ctx"])
        with O.span("caller") as sp:
            q.enqueue_batch_items(["a", "b"],
                                  {"x": np.ones((2, 2), np.float32)})
        ambient = O.decode_trace_context(last()["trace_ctx"])
        q.enqueue_items("given", x, trace_ctx="5-6")
        given = last()["trace_ctx"]
        O.set_enabled(False)
        try:
            q.enqueue_items("off", x)
            off = "trace_ctx" in last()
        finally:
            O.set_enabled(True)
        views.append((minted[0] >= 1 << 62, minted[1],
                      ambient == (sp.trace_id, sp.span_id), given, off))
    assert views[0] == views[1] == (True, 0, True, "5-6", False)


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w = torch.nn.Parameter(torch.randn(4, 3, generator=g))

    def predict_fn(self, x):
        return x @ self.w


def test_the_pipelined_engine_continues_the_wire_trace():
    from analytics_zoo_tpu_torch.common.config import ServingConfig
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
    from analytics_zoo_tpu_torch.serving.client import (
        InputQueue, OutputQueue)
    from analytics_zoo_tpu_torch.serving.engine import ClusterServing
    broker = InMemoryBroker()
    serving = ClusterServing(InferenceModel(device="cpu").load_keras(_Net()),
                             ServingConfig(redis_url="memory://"),
                             broker=broker).start()
    try:
        ctx = tobs.new_trace_context()
        InputQueue(broker=broker).enqueue_items(
            "w-1", {"x": np.ones(4, np.float32)},
            trace_ctx=tobs.encode_trace_context(ctx))
        assert OutputQueue(broker=broker).query_blocking(
            "w-1", timeout=WAIT) is not None
        names = ("serving.decode", "serving.dispatch", "serving.sink")
        spans = _chain(tobs, ctx[0], names)
    finally:
        serving.stop()
    by = {s["name"]: s for s in spans}
    assert sorted(by) == sorted(names) and len(spans) == 3
    assert by["serving.decode"]["parent_id"] is None
    assert by["serving.dispatch"]["parent_id"] == \
        by["serving.decode"]["span_id"]
    assert by["serving.sink"]["parent_id"] == \
        by["serving.dispatch"]["span_id"]
    assert by["serving.dispatch"]["attrs"] == {"records": 1}
    assert _series(tobs, "zoo_serving_records_total") == {(): 1.0}


def _weights(jnet, seed):
    """Random weights in the JAX net's parameter tree (its shapes from
    ``eval_shape``: the init itself is seconds of small ops on the CPU)."""
    shapes, state = jax.eval_shape(
        lambda: jnet.build(jax.random.PRNGKey(0)))
    rs = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda s: (0.05 * rs.standard_normal(s.shape)).astype(s.dtype),
        shapes)
    return params, state


def _bert_requests(n, seed=0):
    rs = np.random.default_rng(seed)
    T = CFG["seq_len"]
    out = []
    for _ in range(n):
        length = int(rs.integers(2, T + 1))
        out.append({
            "input_ids": rs.integers(0, CFG["vocab"], T).astype(np.int32),
            "token_type_ids": np.zeros(T, np.int32),
            "input_mask": (np.arange(T) < length).astype(np.int32)})
    return out


def _bert_servers():
    """The JAX and the port's tiny BERT in pipelined engines, same
    weights."""
    from analytics_zoo_tpu.common.config import ServingConfig as JConfig
    from analytics_zoo_tpu.inference import InferenceModel as JInference
    from analytics_zoo_tpu.serving.broker import InMemoryBroker as JBroker
    from analytics_zoo_tpu.serving.engine import ClusterServing as JServing
    from analytics_zoo_tpu.serving.http_frontend import (
        ServingFrontend as JFrontend)
    from analytics_zoo_tpu.tfpark.text_estimators import (
        BERTClassifier as JBERT)
    from analytics_zoo_tpu_torch.common.config import ServingConfig
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
    from analytics_zoo_tpu_torch.serving.engine import ClusterServing
    from analytics_zoo_tpu_torch.serving.http_frontend import ServingFrontend
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier as TBERT
    pre = lambda d: [d[n] for n in NAMES]
    jb = JBERT(num_classes=2, bert_config=CFG)
    params, state = _weights(jb.net, seed=0)
    jim = JInference().load_keras(jb.net, (params, state), preprocessor=pre)
    tb = TBERT(num_classes=2, bert_config=CFG, device="cpu")
    tim = InferenceModel(device="cpu").load_keras(
        tb.net, (params, state), preprocessor=pre)
    return ((JServing(jim, JConfig(redis_url="memory://"),
                      broker=JBroker()), JFrontend),
            (ClusterServing(tim, ServingConfig(redis_url="memory://"),
                            broker=InMemoryBroker()), ServingFrontend))


def _drive(O, serving, frontend_cls, reqs):
    """Requests one at a time (JSON and fast-wire in turn, each with its
    own ``X-Zoo-Trace``), a bad ``/spans`` query and a 404; returns each
    request's (sent context, echoed context, answer)."""
    from analytics_zoo_tpu_torch.serving.codec import encode_items_bytes
    serving.start()
    fe = None
    out = []
    try:
        fe = frontend_cls(serving, port=0).start()
        conn = http.client.HTTPConnection("127.0.0.1", fe.port,
                                          timeout=WAIT)
        try:
            for i, r in enumerate(reqs):
                ctx = O.new_trace_context()
                hdr = {"X-Zoo-Trace": O.encode_trace_context(ctx)}
                if i % 2:
                    body = encode_items_bytes(r)
                    hdr["Content-Type"] = "application/x-zoo-fastwire"
                else:
                    body = json.dumps({"uri": f"q-{i}", "inputs": {
                        k: v.tolist() for k, v in r.items()}})
                    hdr["Content-Type"] = "application/json"
                conn.request("POST", "/predict", body, hdr)
                resp = conn.getresponse()
                blob = resp.read()
                assert resp.status == 200, blob
                out.append((ctx, O.decode_trace_context(
                    resp.headers["X-Zoo-Trace"])))
            for path in ("/spans?trace_id=abc", "/nowhere"):
                conn.request("GET", path)
                conn.getresponse().read()
        finally:
            conn.close()
    finally:
        if fe is not None:
            fe.stop()
        serving.stop()
    return out


def test_http_predict_four_linked_spans_and_the_jax_families():
    reqs = _bert_requests(4)
    (jserv, jfe), (tserv, tfe) = _bert_servers()
    _drive(jobs, jserv, jfe, reqs)
    sent = _drive(tobs, tserv, tfe, reqs)
    names = ("http.predict", "serving.decode", "serving.dispatch",
             "serving.sink")
    for ctx, echoed in sent:
        assert echoed[0] == ctx[0] and echoed[1] != ctx[1]
        spans = _chain(tobs, ctx[0], names)
        by = {s["name"]: s for s in spans}
        assert len(spans) == 4 and sorted(by) == sorted(names)
        assert by["http.predict"]["parent_id"] is None
        assert by["http.predict"]["span_id"] == echoed[1]
        for child, parent in zip(names[1:], names):
            assert by[child]["parent_id"] == by[parent]["span_id"]
    prefixes = ("zoo_serving_", "zoo_http_", "zoo_resilience_",
                "zoo_trace_")
    assert _families(tobs, prefixes) == _families(jobs, prefixes)
    for name in ("zoo_serving_records_total", "zoo_http_requests_total",
                 "zoo_http_coalesce_records_total",
                 "zoo_serving_errors_total"):
        assert _series(tobs, name) == _series(jobs, name), name
    assert _series(tobs, "zoo_http_requests_total") == {
        (("route", "/predict"), ("code", "200")): 4.0,
        (("route", "/spans"), ("code", "400")): 1.0,
        (("route", "other"), ("code", "404")): 1.0}


def test_http_generate_prefill_span_and_token_events():
    from analytics_zoo_tpu_torch.common.config import LLMServingConfig
    from analytics_zoo_tpu_torch.llm import LLMServing
    from analytics_zoo_tpu_torch.models.generation import DecoderLM
    from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
    from analytics_zoo_tpu_torch.serving.client import FastWireHttpClient
    from analytics_zoo_tpu_torch.serving.http_frontend import ServingFrontend
    model = DecoderLM.tiny(generator=torch.Generator().manual_seed(0),
                           device="cpu")
    eng = LLMServing(model, LLMServingConfig(
        num_blocks=64, block_size=8, max_active=4, max_model_len=256,
        prefill_chunk_tokens=16, prefix_cache=True),
        broker=InMemoryBroker(), device="cpu").start()
    fe = None
    streams = {}
    try:
        fe = ServingFrontend(llm=eng, port=0).start()
        with FastWireHttpClient(port=fe.port, timeout=WAIT) as fw:
            for uri, n in (("g-0", 6), ("g-1", 4)):
                ctx = tobs.new_trace_context()
                toks = [t for _, t in fw.generate(
                    list(range(1, 41)), uri=uri, max_new_tokens=n,
                    trace_ctx=tobs.encode_trace_context(ctx))]
                streams[uri] = (ctx, toks)
        deadline = time.monotonic() + WAIT
        while eng.scheduler.has_work() and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        if fe is not None:
            fe.stop()
        eng.stop()
    for uri, (ctx, toks) in streams.items():
        spans = tobs.get_tracer().export(trace_id=ctx[0])
        by = Counter(s["name"] for s in spans)
        gen = [s for s in spans if s["name"] == "http.generate"]
        assert len(gen) == 1 and by["llm.prefill"] >= 1
        assert set(by) == {"http.generate", "llm.prefill"}
        assert all(s["parent_id"] == gen[0]["span_id"] for s in spans
                   if s["name"] == "llm.prefill")
        events = tobs.get_tracer().export_events(trace_id=ctx[0])
        kinds = Counter(e["kind"] for e in events)
        assert kinds["llm.token"] == len(toks)
        assert [e["attrs"]["idx"] for e in events
                if e["kind"] == "llm.token"] == list(range(len(toks)))
        assert [e["attrs"]["code"] for e in events
                if e["kind"] == "llm.finish"] == ["ok"]
    assert _series(tobs, "zoo_llm_tokens_total") == {(): 10.0}
    assert _series(tobs, "zoo_llm_sequences_total") == {
        (("outcome", "ok"),): 2.0}
    assert _series(tobs, "zoo_llm_prefix_hits_total") == {(): 1.0}
    # families declared at first use: those this run reaches (the
    # tokens/s gauge needs a full second of decoding)
    assert _families(tobs, ("zoo_llm_",)).items() >= {
        "zoo_llm_batch_occupancy": "histogram",
        "zoo_llm_intertoken_seconds": "histogram",
        "zoo_llm_kv_block_utilization": "gauge",
        "zoo_llm_kv_blocks_in_use": "gauge",
        "zoo_llm_prefill_chunks_total": "counter",
        "zoo_llm_prefix_bytes_saved_total": "counter",
        "zoo_llm_prefix_cached_blocks": "gauge",
        "zoo_llm_prefix_hits_total": "counter",
        "zoo_llm_prefix_misses_total": "counter",
        "zoo_llm_prefix_tokens_saved_total": "counter",
        "zoo_llm_sequences_total": "counter",
        "zoo_llm_tokens_total": "counter",
        "zoo_llm_ttft_seconds": "histogram"}.items()


def _span_shape(O):
    """Span name counts and each name's parent names."""
    spans = O.get_tracer().export()
    by_id = {s["span_id"]: s["name"] for s in spans}
    parents = {}
    for s in spans:
        parents.setdefault(s["name"], set()).add(
            by_id.get(s["parent_id"]))
    return Counter(s["name"] for s in spans), parents


def test_estimator_spans_and_counters_are_jax_s(tmp_path):
    from analytics_zoo_tpu.data import FeatureSet as JFeatureSet
    from analytics_zoo_tpu.estimator import estimator as JE
    from analytics_zoo_tpu.keras import engine as JEng
    from analytics_zoo_tpu.keras import layers as JL
    from analytics_zoo_tpu.keras.optimizers import Adam as JAdam
    from analytics_zoo_tpu_torch.data.featureset import FeatureSet
    from analytics_zoo_tpu_torch.estimator import estimator as TE
    from analytics_zoo_tpu_torch.keras import engine as TEng
    from analytics_zoo_tpu_torch.keras import layers as TL
    from analytics_zoo_tpu_torch.keras.optimizers import Adam as TAdam
    rs = np.random.default_rng(0)
    x = rs.standard_normal((32, 4)).astype(np.float32)
    y = rs.integers(0, 3, 32).astype(np.int32)
    loss = "sparse_categorical_crossentropy"
    JEng.reset_uids()
    jnet = JEng.Sequential([JL.Dense(8, activation="relu", input_shape=(4,)),
                            JL.Dense(3, activation="softmax")])
    params, state = jax.tree_util.tree_map(
        np.array, jnet.init(jax.random.PRNGKey(3)))
    jest = JE.Estimator(jnet, JAdam(), loss,
                        checkpoint_dir=str(tmp_path / "j"))
    jest.train(JFeatureSet.from_ndarrays(x, y), batch_size=8, epochs=2,
               variables=(params, state))
    TEng.reset_uids()
    tnet = TEng.Sequential([TL.Dense(8, activation="relu", input_shape=(4,)),
                            TL.Dense(3, activation="softmax")], device="cpu")
    tnet.set_weights((params, state))
    test = TE.Estimator(tnet, TAdam(), loss, device="cpu",
                        checkpoint_dir=str(tmp_path / "t"))
    test.train(FeatureSet.from_ndarrays(x, y), batch_size=8, epochs=2)
    jshape, tshape = _span_shape(jobs), _span_shape(tobs)
    assert tshape == jshape
    assert tshape[0] == {"train.epoch": 2, "train.step": 8,
                         "train.prefetch": 2, "train.checkpoint": 3}
    assert tshape[1]["train.step"] == {"train.epoch"}
    assert tshape[1]["train.checkpoint"] == {None, "train.epoch"}
    for name in ("zoo_train_steps_total", "zoo_train_epochs_total",
                 "zoo_train_accum_microbatches"):
        assert _series(tobs, name) == _series(jobs, name), name
    assert _series(tobs, "zoo_train_steps_total") == {(): 8.0}
    timer = _series(tobs, "zoo_train_seconds")[(("name", "train_step"),)]
    assert timer["count"] == 8
    prefixes = ("zoo_train_", "zoo_estimator_")
    assert _families(tobs, prefixes) == _families(jobs, prefixes)
    # one card: every mesh axis of the JAX layout, each of size 1
    assert _series(tobs, "zoo_train_mesh_shape") == {
        (("axis", a),): 1.0
        for a in ("data", "model", "sequence", "expert", "pipeline")}
    assert set(_series(tobs, "zoo_train_mesh_shape")) == \
        set(_series(jobs, "zoo_train_mesh_shape"))
    loss_gauge = _series(tobs, "zoo_train_loss")[()]
    assert loss_gauge == pytest.approx(test.history[-1]["loss"])


def test_graph_dispatches_are_one_step_span_each(monkeypatch):
    # K = 4 on the DEVICE tier: one train.step span per dispatch of four
    # steps (on the card four graph replays), the counter per step
    from analytics_zoo_tpu_torch.data.featureset import FeatureSet
    from analytics_zoo_tpu_torch.estimator import estimator as TE
    from analytics_zoo_tpu_torch.keras.optimizers import SGD
    rs = np.random.default_rng(1)
    x = rs.standard_normal((32, 4)).astype(np.float32)
    y = rs.integers(0, 3, 32).astype(np.int32)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(4, 3))

        def forward(self, x, seed=None):
            return x @ self.w

    est = TE.Estimator(Net(), SGD(lr=0.1), "sparse_categorical_"
                       "crossentropy", steps_per_dispatch=4, device="cpu")
    est.train(FeatureSet.from_ndarrays(x, y).cache_device(), batch_size=8,
              epochs=2)
    steps = [s for s in tobs.get_tracer().export()
             if s["name"] == "train.step"]
    assert [s["attrs"]["steps"] for s in steps] == [4, 4]
    assert _series(tobs, "zoo_train_steps_total") == {(): 8.0}
    assert _series(tobs, "zoo_train_epochs_total") == {(): 2.0}
