"""The client, engine and LLM wiring of the rest of serving.

- Every enqueue carries a ``dedup_id``; an enqueue whose acknowledgement
  is lost and which the client retries lands once in the journaled
  broker, as in the JAX client.
- The engine's sink retries a result write that a broker wrapper fails
  twice with a transient error, and the result arrives once.
- ``LLMServing`` over ``native://`` streams exactly the JAX package's
  ``greedy_reference``.
"""

import threading

import jax
import numpy as np
import pytest

from analytics_zoo_tpu.models.generation import (
    greedy_reference, init_decoder_params)
from analytics_zoo_tpu.serving import client as jclient
from analytics_zoo_tpu.serving.broker import InMemoryBroker as JBroker
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.common.config import (
    LLMServingConfig, ServingConfig)
from analytics_zoo_tpu_torch.llm import GenerationClient, LLMServing
from analytics_zoo_tpu_torch.models.generation import DecoderLM
from analytics_zoo_tpu_torch.serving import broker as tbroker
from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
from analytics_zoo_tpu_torch.serving.client import InputQueue, OutputQueue
from analytics_zoo_tpu_torch.serving.durability import DurableBroker
from analytics_zoo_tpu_torch.serving.engine import ClusterServing


class _LostAck:
    """Passes every call through; the first ``fail`` xadds raise a
    transient error AFTER the inner broker took them (an acknowledgement
    lost on the wire)."""

    def __init__(self, inner, fail=1):
        self.inner, self.fail = inner, fail

    def xadd(self, stream, fields):
        sid = self.inner.xadd(stream, fields)
        if self.fail:
            self.fail -= 1
            raise ConnectionError("connection reset after the write")
        return sid

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _entries(broker, stream="serving_stream"):
    broker.xgroup_create(stream, "g")
    return broker.xreadgroup(stream, "g", "c", count=64, block_ms=10)


def test_every_enqueue_carries_a_dedup_id_as_jax_does():
    x = np.ones((2, 3), np.float32)
    ids = []
    for mod, broker in ((None, InMemoryBroker()), (jclient, JBroker())):
        iq = (InputQueue if mod is None else mod.InputQueue)(broker=broker)
        iq.enqueue("a", x=x[0])
        iq.enqueue_items("b", {"x": x[0]})
        iq.enqueue_raw("c", b"\x00frame")
        iq.enqueue_batch(["d", "e"], x=x)
        got = [f for _, f in _entries(broker)]
        assert [f["uri"] for f in got] == ["a", "b", "c", "d\x1fe"]
        ids.append([f["dedup_id"] for f in got])
    port, jax_ids = ids
    assert len(set(port)) == 4
    # the same shape of id: hex pid, hex monotonic ns, a counter
    assert [len(i.split("-")) for i in port] == [
        len(i.split("-")) for i in jax_ids] == [3] * 4
    assert {i.split("-")[0] for i in port} == {
        i.split("-")[0] for i in jax_ids}


def test_a_retried_enqueue_lands_once_in_the_journaled_broker(tmp_path):
    durable = DurableBroker(str(tmp_path))
    iq = InputQueue(broker=_LostAck(durable, fail=2))
    sid = iq.enqueue_items("u1", {"x": np.ones(2, np.float32)})
    got = _entries(durable)
    assert [(s, f["uri"]) for s, f in got] == [(sid, "u1")]
    assert iq.enqueue_items("u2", {"x": np.ones(2, np.float32)}) != sid
    durable.close()


def test_without_the_barrier_the_retry_shows_as_a_duplicate():
    # the in-memory broker has no dedup barrier: the retried enqueue is
    # a second entry carrying the same dedup_id
    broker = InMemoryBroker()
    InputQueue(broker=_LostAck(broker)).enqueue_items(
        "u1", {"x": np.ones(2, np.float32)})
    got = [f for _, f in _entries(broker)]
    assert len(got) == 2 and got[0]["dedup_id"] == got[1]["dedup_id"]


class _FlakyResults:
    """``set_results`` fails ``fail`` times with a transient error before
    passing through; every call is counted."""

    def __init__(self, inner, fail=2):
        self.inner, self.fail, self.calls = inner, fail, 0
        self._lock = threading.Lock()

    def set_results(self, results):
        with self._lock:
            self.calls += 1
            if self.fail:
                self.fail -= 1
                raise ConnectionError("bridge reconnecting")
        self.inner.set_results(results)

    def __getattr__(self, name):
        return getattr(self.inner, name)


class _Twice:
    concurrency = 1

    def predict_async(self, x):
        return np.asarray(x, np.float32) * 2.0

    def fetch(self, pending):
        return pending

    def predict(self, x):
        return np.asarray(x, np.float32) * 2.0


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "classic"])
def test_the_sink_retries_a_transient_result_write(pipeline):
    inner = InMemoryBroker()
    broker = _FlakyResults(inner)
    serving = ClusterServing(_Twice(), ServingConfig(
        redis_url="memory://", pipeline=pipeline, max_batch=8,
        linger_ms=1.0, decode_workers=1), broker=broker).start()
    try:
        InputQueue(broker=inner).enqueue_items(
            "u1", {"x": np.ones(3, np.float32)})
        out = OutputQueue(broker=inner).query_blocking("u1", timeout=10)
    finally:
        serving.stop()
    np.testing.assert_array_equal(out, np.full(3, 2.0))
    assert broker.calls == 3 and broker.fail == 0       # 2 faults, 1 write
    assert serving.metrics()["records_processed"] == 1


def test_llm_serving_over_the_native_broker_is_the_greedy_reference():
    params = init_decoder_params(jax.random.PRNGKey(0), 96, 32, 2, 2, 64,
                                 512)
    model = interop.load_jax_params(
        DecoderLM.tiny(device="cpu"),
        jax.tree_util.tree_map(np.asarray, params))
    # prompts of one length: the reference's eager ops meet few shapes
    prompts = ([5, 9, 2, 7], [1, 2, 3, 4], [40, 41, 42, 43])
    refs = [greedy_reference(params, p, 4, 2) for p in prompts]
    eng = LLMServing(model, LLMServingConfig(
        redis_url="native://", num_blocks=64, block_size=8, max_active=4,
        max_model_len=256), device="cpu")
    assert isinstance(eng.broker, tbroker.NativeQueueBroker)
    eng.start()
    cli = GenerationClient(broker=eng.broker)
    try:
        for i, p in enumerate(prompts):
            cli.submit(f"n{i}", p, 4)
        for i, ref in enumerate(refs):
            assert [t for _, t in cli.stream_tokens(f"n{i}",
                                                    timeout=60)] == ref
        assert OutputQueue(broker=eng.broker).query_blocking(
            "n0", timeout=10).tolist() == refs[0]
    finally:
        eng.stop()
        eng.broker.close()
