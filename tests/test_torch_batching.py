"""``BatchingService`` against the JAX package's.

A 2-block BERT classifier on the CPU, its weights the JAX model's through
``interop.load_jax_params``, behind the port's ``BatchingService``; the
JAX model behind the JAX ``BatchingService``.  Requests from 4 threads
carry the three BERT inputs packed in one int32 array (N, 3, T), which the
service concatenates into one batched predict.  Then the per-replica
breaker: ``device_execute`` faults open it, a half-open probe closes it.
"""

import threading

import jax
import numpy as np
import pytest

from analytics_zoo_tpu.inference import BatchingService as JBatching
from analytics_zoo_tpu.inference import InferenceModel as JInference
from analytics_zoo_tpu.tfpark.text_estimators import BERTClassifier as JBERT
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.common.resilience import (
    CircuitBreaker, CircuitOpenError)
from analytics_zoo_tpu_torch.inference import BatchingService, InferenceModel
from analytics_zoo_tpu_torch.tfpark.text_estimators import (
    BERTClassifier as TBERT)
from analytics_zoo_tpu_torch.testing import chaos

CFG = dict(vocab=50, hidden_size=32, n_block=2, n_head=2, seq_len=16,
           intermediate_size=64)


def _unpack(x):
    """(N, 3, T) -> the three BERT inputs."""
    return [x[:, 0], x[:, 1], x[:, 2]]


@pytest.fixture
def models(ctx):
    jb = JBERT(num_classes=3, bert_config=CFG)
    params, state = jb.net.build(jax.random.PRNGKey(0))
    jim = JInference().load_keras(jb.net, (params, state),
                                  preprocessor=_unpack)
    tb = TBERT(num_classes=3, bert_config=CFG, device="cpu")
    interop.load_jax_params(tb.net, jax.tree_util.tree_map(np.asarray,
                                                           params))
    tim = InferenceModel(device="cpu").load_keras(tb.net,
                                                  preprocessor=_unpack)
    return jim, tim


def _requests(n, seed=0):
    rs = np.random.default_rng(seed)
    T = CFG["seq_len"]
    out = []
    for _ in range(n):
        rows = int(rs.integers(1, 3))
        x = np.zeros((rows, 3, T), np.int32)
        for r in range(rows):
            length = int(rs.integers(1, T + 1))
            x[r, 0] = rs.integers(1, CFG["vocab"], T)
            x[r, 1] = rs.integers(0, 2, T)
            x[r, 2] = np.arange(T) < length
        out.append(x)
    return out


def _serve(svc, reqs, threads=4):
    got, errs = [None] * len(reqs), []

    def client(k):
        try:
            for i in range(k, len(reqs), threads):
                got[i] = svc.predict(reqs[i], timeout_ms=60000)
        except Exception as exc:        # pragma: no cover
            errs.append(exc)
    ts = [threading.Thread(target=client, args=(k,)) for k in range(threads)]
    [t.start() for t in ts]
    [t.join(timeout=120) for t in ts]
    assert not errs
    return got


def test_batched_answers_match_jax_from_four_threads(models):
    jim, tim = models
    reqs = _requests(24)
    calls = []
    inner = tim.predict
    tim.predict = lambda x: (calls.append(len(x)), inner(x))[1]
    svc = BatchingService(tim, max_batch=32, max_delay_ms=5)
    jsvc = JBatching(jim, max_batch=32, max_delay_ms=5)
    try:
        got = _serve(svc, reqs)
        want = _serve(jsvc, reqs)
        stats = svc.stats()
    finally:
        svc.stop()
        jsvc.stop()
        del tim.predict
    for x, g, w in zip(reqs, got, want):
        assert g.shape == w.shape == (len(x), 3)
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    assert sum(calls) == sum(len(x) for x in reqs)   # every row once
    assert len(calls) < len(reqs)                    # and coalesced
    assert stats["enqueued"] == stats["completed"] == len(reqs)
    assert not svc._thread.is_alive()


def test_device_execute_faults_open_the_breaker_and_a_probe_closes_it():
    now = [0.0]
    breaker = CircuitBreaker("replica-0", failure_threshold=3,
                             recovery_s=5.0, clock=lambda: now[0])
    svc = BatchingService(lambda x: x * 2.0, max_batch=8, max_delay_ms=2,
                          breaker=breaker)
    x = np.ones((1, 2), np.float32)
    inj = chaos.ChaosInjector()
    inj.plan("device_execute", fault="raise", times=3)
    try:
        with chaos.installed(inj):
            for _ in range(3):
                with pytest.raises(RuntimeError, match="batched inference "
                                                       "failed"):
                    svc.predict(x, timeout_ms=5000)
            assert inj.injected("device_execute") == 3
            assert breaker.state == "open"
            # open: fail fast with the typed error, no dispatch
            with pytest.raises(CircuitOpenError, match="replica-0"):
                svc.predict(x, timeout_ms=5000)
            assert inj.count("device_execute") == 3
            now[0] = 6.0                       # past recovery_s
            np.testing.assert_array_equal(svc.predict(x, timeout_ms=5000),
                                          x * 2.0)   # the probe
            assert breaker.state == "closed"
            np.testing.assert_array_equal(svc.predict(x, timeout_ms=5000),
                                          x * 2.0)
    finally:
        svc.stop()
    assert not svc._thread.is_alive()
