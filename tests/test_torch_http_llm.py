"""LLM token streaming over the port's HTTP frontend, on the CPU.

``ServingFrontend(llm=..., port=0)`` in front of ``LLMServing`` serving
a ``DecoderLM.tiny()``-sized model whose weights come from the JAX model:
every stream read through ``FastWireHttpClient.generate`` must EQUAL the
JAX package's ``greedy_reference``, one frame per token with indices in
order, for prompts sent from 4 client threads.  The references run
``greedy_reference`` itself with its ``dense_logits`` forward under
``jax.jit`` (one compile per length instead of one per operation and
length), and every prompt has the same length, so they cost a few
compiles.  A deadline that expires mid-stream raises
``ServingDeadlineError`` and the client serves the next request; a
deadline that expires before the first token answers 504 on a connection
that goes on; a client that closes mid-stream cancels its sequence at the
engine.  ``leak_check`` reads zero live tables after each.
"""

import http.client
import threading
import time

import jax
import numpy as np
import pytest

from analytics_zoo_tpu.models import generation as jgen
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.common.config import LLMServingConfig
from analytics_zoo_tpu_torch.llm import LLMServing
from analytics_zoo_tpu_torch.models.generation import DecoderLM
from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
from analytics_zoo_tpu_torch.serving.client import (
    FastWireHttpClient, OutputQueue, ServingDeadlineError, ServingError)
from analytics_zoo_tpu_torch.serving.codec import encode_items_bytes
from analytics_zoo_tpu_torch.serving.http_frontend import ServingFrontend

N_HEAD = 2
WAIT = 5.0
NEW = 6
PROMPTS = ([5, 9, 2, 7, 1], [1, 2, 3, 8, 8], [4] * 5, [20, 21, 22, 23, 24],
           [7, 7, 1, 2, 9])


@pytest.fixture(scope="module")
def jparams():
    return jgen.init_decoder_params(jax.random.PRNGKey(0), 96, 32, N_HEAD,
                                    2, 64, 512)


@pytest.fixture(scope="module")
def refs(jparams):
    plain = jgen.dense_logits
    jgen.dense_logits = jax.jit(plain, static_argnums=2)
    try:
        return [jgen.greedy_reference(jparams, p, NEW, N_HEAD)
                for p in PROMPTS]
    finally:
        jgen.dense_logits = plain


@pytest.fixture
def served(jparams):
    model = interop.load_jax_params(
        DecoderLM.tiny(device="cpu"),
        jax.tree_util.tree_map(np.asarray, jparams))
    eng = LLMServing(model, LLMServingConfig(
        num_blocks=64, block_size=8, max_active=4, max_model_len=512),
        broker=InMemoryBroker(), device="cpu").start()
    try:
        fe = ServingFrontend(llm=eng, port=0).start()
    except BaseException:
        eng.stop()
        raise
    try:
        yield eng, fe
    finally:
        fe.stop()
        eng.stop()


def _idle_and_clean(eng):
    deadline = time.monotonic() + WAIT
    while eng.scheduler.has_work() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not eng.scheduler.has_work()
    lk = eng.cache.leak_check()
    assert lk["tables"] == 0 and lk["held_blocks"] == 0, lk
    assert eng.admission.in_flight == 0


def test_streams_equal_greedy_reference(refs, served):
    eng, fe = served
    frames = [None] * 4

    def client(i):
        with FastWireHttpClient(port=fe.port, timeout=WAIT) as c:
            frames[i] = list(c.generate(PROMPTS[i], uri=f"g{i}",
                                        max_new_tokens=NEW))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads)
    for i in range(4):
        assert [k for k, _ in frames[i]] == list(range(NEW))
        assert [tok for _, tok in frames[i]] == refs[i]
    # one keep-alive connection, two streams in a row
    with FastWireHttpClient(port=fe.port, timeout=WAIT) as c:
        for _ in range(2):
            assert [t for _, t in c.generate(
                PROMPTS[1], max_new_tokens=NEW)] == refs[1]
    _idle_and_clean(eng)


def test_deadline_mid_stream_then_the_client_serves_on(refs, served):
    eng, fe = served
    with FastWireHttpClient(port=fe.port, timeout=WAIT) as c:
        list(c.generate([1, 2], max_new_tokens=2))      # warm-up
        got = []
        with pytest.raises(ServingDeadlineError, match="expired"):
            for _, tok in c.generate([1, 2, 3], max_new_tokens=480,
                                     deadline_ms=100):
                got.append(tok)
        assert 0 < len(got) < 480
        assert [t for _, t in c.generate(
            PROMPTS[4], max_new_tokens=NEW)] == refs[4]
    _idle_and_clean(eng)


def test_deadline_before_the_first_token_is_504(served):
    eng, fe = served
    conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=WAIT)
    frame = encode_items_bytes({"tokens": np.arange(1, 9, dtype=np.int32)})
    try:
        conn.request("POST", "/predict", frame, {
            "Content-Type": "application/x-zoo-fastwire",
            "X-Zoo-Generate": "1", "X-Zoo-Deadline-Ms": "0.001"})
        resp = conn.getresponse()
        assert resp.status == 504, resp.read()
        resp.read()
        conn.request("POST", "/predict", encode_items_bytes(
            {"max_new_tokens": np.asarray(2, np.int32)}), {
            "Content-Type": "application/x-zoo-fastwire",
            "X-Zoo-Generate": "1"})
        resp = conn.getresponse()
        assert resp.status == 400 and b"tokens" in resp.read()
        conn.request("POST", "/predict", frame, {
            "Content-Type": "application/x-zoo-fastwire"})
        resp = conn.getresponse()        # a `tokens` tensor also streams
        assert resp.status == 200
        assert resp.headers["Content-Type"] == \
            "application/x-zoo-token-stream"
        resp.read()
    finally:
        conn.close()
    _idle_and_clean(eng)


def test_closed_client_cancels_its_sequence(served):
    eng, fe = served
    with FastWireHttpClient(port=fe.port, timeout=WAIT) as c:
        stream = c.generate([3, 1, 4], uri="gone", max_new_tokens=480)
        assert next(stream)[0] == 0
        stream.close()                   # closes the connection
    deadline = time.monotonic() + WAIT
    result = {}
    while not result and time.monotonic() < deadline:
        result = eng.broker.hgetall("result:gone")
        time.sleep(0.01)
    assert result.get("code") == "cancelled", result
    with pytest.raises(ServingError, match="cancelled"):
        OutputQueue(broker=eng.broker).query("gone")
    assert eng.metrics()["tokens_generated"] < 480
    _idle_and_clean(eng)
