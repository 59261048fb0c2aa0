"""The port's serving path against the JAX package's, on the CPU.

``ClusterServing`` (classic mode, in-memory broker, ``device="cpu"``)
serves a tiny BERT classifier whose weights come from the JAX model; every
answer read back through ``OutputQueue`` must equal JAX
``InferenceModel.predict`` on the same inputs (1e-5 absolute).  The port's
codec must produce the JAX codec's bytes.
"""

import time

import jax
import numpy as np
import pytest

from analytics_zoo_tpu.common.config import ServingConfig as JConfig
from analytics_zoo_tpu.inference import InferenceModel as JInference
from analytics_zoo_tpu.serving import codec as jcodec
from analytics_zoo_tpu.tfpark.text_estimators import BERTClassifier as JBERT
from analytics_zoo_tpu_torch.common.config import ServingConfig
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.serving import codec as tcodec
from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
from analytics_zoo_tpu_torch.serving.client import (
    InputQueue, OutputQueue, ServingDeadlineError)
from analytics_zoo_tpu_torch.serving.engine import ClusterServing
from analytics_zoo_tpu_torch.tfpark.text_estimators import (
    BERTClassifier as TBERT)

CFG = dict(vocab=50, hidden_size=32, n_block=2, n_head=2, seq_len=16,
           intermediate_size=64)
NAMES = ("input_ids", "token_type_ids", "input_mask")


def _bert_inputs(d):
    return [d["input_ids"], d["token_type_ids"], d["input_mask"]]


def _requests(n, seed=0):
    """n records padded to seq_len, with ragged valid lengths."""
    rs = np.random.default_rng(seed)
    T = CFG["seq_len"]
    out = {}
    for i in range(n):
        length = int(rs.integers(1, T + 1))
        out[f"req-{i}"] = {
            "input_ids": rs.integers(0, CFG["vocab"], T).astype(np.int32),
            "token_type_ids": rs.integers(0, 2, T).astype(np.int32),
            "input_mask": (np.arange(T) < length).astype(np.int32)}
    return out


@pytest.fixture
def models(ctx):
    jb = JBERT(num_classes=3, bert_config=CFG)
    params, state = jb.net.build(jax.random.PRNGKey(0))
    jim = JInference().load_keras(jb.net, (params, state),
                                  preprocessor=_bert_inputs)
    tb = TBERT(num_classes=3, bert_config=CFG, device="cpu")
    tim = InferenceModel(device="cpu").load_keras(
        tb.net, (jax.tree_util.tree_map(np.asarray, params), state),
        preprocessor=_bert_inputs)
    return jim, tim


def _stack(reqs, uris):
    return {n: np.stack([reqs[u][n] for u in uris]) for n in NAMES}


def _serve(tim, config, feed, uris, timeout=60):
    broker = InMemoryBroker()
    serving = ClusterServing(tim, config, broker=broker).start()
    try:
        feed(InputQueue(broker=broker))
        oq = OutputQueue(broker=broker)
        results = {u: oq.query_blocking(u, timeout=timeout) for u in uris}
    finally:
        serving.stop()
    assert not serving._threads
    return results, serving


def test_served_results_equal_jax_predict(models):
    jim, tim = models
    reqs = _requests(13)

    def feed(iq):
        for uri, d in reqs.items():
            iq.enqueue(uri, **d)
    results, serving = _serve(
        tim, ServingConfig(pipeline=False, batch_size=4,
                           redis_url="memory://"), feed, list(reqs))
    want = jim.predict(_stack(reqs, list(reqs)))
    for i, uri in enumerate(reqs):
        assert results[uri] is not None, uri
        np.testing.assert_allclose(results[uri], want[i], atol=1e-5,
                                   rtol=0)
    assert serving.metrics()["records_processed"] == 13


def test_batched_entry_and_top_n(models):
    jim, tim = models
    reqs = _requests(6, seed=1)
    uris = list(reqs)

    def feed(iq):
        iq.enqueue_batch(uris, **_stack(reqs, uris))
    results, _ = _serve(
        tim, ServingConfig(pipeline=False, batch_size=4, filter="topN(2)",
                           redis_url="memory://"), feed, uris)
    want = jim.predict(_stack(reqs, uris))
    for i, uri in enumerate(uris):
        order = np.argsort(-want[i])[:2]
        got = results[uri]
        assert [c for c, _ in got] == [int(c) for c in order]
        np.testing.assert_allclose([p for _, p in got], want[i][order],
                                   atol=1e-5)


def test_expired_request_is_rejected(models):
    _, tim = models
    reqs = _requests(1)
    uri, d = next(iter(reqs.items()))
    broker = InMemoryBroker()
    InputQueue(broker=broker).enqueue(uri, deadline_s=1e-6, **d)
    time.sleep(0.01)
    serving = ClusterServing(tim, ServingConfig(pipeline=False),
                             broker=broker).start()
    try:
        oq = OutputQueue(broker=broker)
        assert broker.wait_result(f"result:{uri}", 30)
        with pytest.raises(ServingDeadlineError):
            oq.query(uri)
    finally:
        serving.stop()
    assert serving.metrics()["records_expired"] == 1


def test_bucket_padding_trims_rows(models):
    _, tim = models
    reqs = _requests(3, seed=2)
    x = _stack(reqs, list(reqs))
    seen = []
    inner = tim.model.predict_fn
    tim.model.predict_fn = lambda xt: (seen.append(xt[0].shape[0]),
                                       inner(xt))[1]
    try:
        out = tim.predict(x)
        single = tim.predict({n: v[:1] for n, v in x.items()})
    finally:
        del tim.model.predict_fn
    assert seen == [4, 1] and out.shape == (3, 3)
    np.testing.assert_allclose(single[0], out[0], atol=1e-6)


def test_unported_modes_raise(models):
    _, tim = models
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ClusterServing(tim, ServingConfig())            # pipeline=True
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ClusterServing(tim, ServingConfig(pipeline=False))  # redis://
    with pytest.raises(ValueError, match="topN"):
        ClusterServing(tim, ServingConfig(pipeline=False, filter="top(2)",
                                          redis_url="memory://"))


def test_config_fields_match_jax():
    import dataclasses
    jf = [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(ServingConfig)]
    assert tf == jf


@pytest.mark.parametrize("items", [
    {"a": np.arange(6, dtype=np.float32).reshape(2, 3)},
    {"ids": np.arange(16, dtype=np.int32), "m": np.ones(16, np.int8),
     "x": np.float64(2.5).reshape(())},
    {"big": np.linspace(0, 1, 1 << 19).astype(np.float32)},  # arrow wire
], ids=["f32", "mixed", "arrow"])
def test_codec_bytes_equal_jax(items):
    tb = tcodec.encode_items_bytes(items)
    assert tb == jcodec.encode_items_bytes(items)
    for dec in (tcodec.decode_items_bytes, jcodec.decode_items_bytes):
        back = dec(tb)
        for k, v in items.items():
            np.testing.assert_array_equal(back[k], v)
            assert back[k].dtype == v.dtype
    out = np.linspace(0, 1, 7).astype(np.float32)
    assert (tcodec.encode_ndarray_output_bytes(out)
            == jcodec.encode_ndarray_output_bytes(out))
    assert tcodec.encode_ndarray_output(out) == \
        jcodec.encode_ndarray_output(out)
    assert tcodec.encode_items(items) == jcodec.encode_items(items)
