"""The port's pipelined ``ClusterServing`` against the JAX package's, on the
CPU.

A small NeuralCF is built in both packages with the JAX ``init`` weights;
the same single and client-batched requests go through the JAX pipelined
engine and the port's, each under a default ``ServingConfig()`` (pipeline
on) over an in-memory broker, and the answers must agree within 1e-5
(f32).  Then the port's engine alone, after ``tests/test_serving.py``'s
pipelined cases: many input shapes in one linger window (no deadlock at
the model's in-flight bound), client batches cut to ``max_batch``, a bad
entry getting an error result while later ones are served, expiry before
admission, shed under ``admission_max_inflight`` (typed
``ServingShedError``, the credits balanced after), a drain on ``stop``,
and a restart refused while a stage thread is still alive.  Every wait is
bounded; every engine stops in a ``finally``.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common.config import ServingConfig as JConfig
from analytics_zoo_tpu.inference import InferenceModel as JInference
from analytics_zoo_tpu.keras import engine as jengine
from analytics_zoo_tpu.models import recommendation as JR
from analytics_zoo_tpu.serving.broker import InMemoryBroker as JBroker
from analytics_zoo_tpu.serving.client import InputQueue as JInputQueue
from analytics_zoo_tpu.serving.client import OutputQueue as JOutputQueue
from analytics_zoo_tpu.serving.engine import ClusterServing as JServing
from analytics_zoo_tpu_torch.common.config import ServingConfig
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.keras import engine as tengine
from analytics_zoo_tpu_torch.models import recommendation as TR
from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
from analytics_zoo_tpu_torch.serving.client import (
    InputQueue, OutputQueue, ServingDeadlineError, ServingError,
    ServingShedError)
from analytics_zoo_tpu_torch.serving.engine import ClusterServing

USERS, ITEMS = 30, 20
SMALL = dict(user_count=USERS, item_count=ITEMS, user_embed=8, item_embed=6,
             mf_embed=4, hidden_layers=(16, 8))
WAIT = 5.0


@pytest.fixture(scope="module")
def ncf():
    """The JAX NeuralCF (initialised) and the port's with its weights."""
    jengine.reset_uids()
    jm = JR.NeuralCF(**SMALL)
    params, state = jm.init(jax.random.PRNGKey(0))
    tengine.reset_uids()
    tm = TR.NeuralCF(device="cpu", **SMALL)
    tm.set_weights(jax.tree_util.tree_map(np.asarray, (params, state)))
    return jm, (params, state), tm


def _ids(n, seed):
    rs = np.random.RandomState(seed)
    return (rs.randint(1, USERS + 1, (n, 1)).astype(np.int32),
            rs.randint(1, ITEMS + 1, (n, 1)).astype(np.int32))


def _feed(iq, users, items):
    """12 single records, then batches of 3 and 5: 20 uris in all."""
    uris = [f"r-{i}" for i in range(len(users))]
    for i in range(12):
        iq.enqueue(uris[i], user=users[i], item=items[i])
    iq.enqueue_batch(uris[12:15], user=users[12:15], item=items[12:15])
    iq.enqueue_batch(uris[15:20], user=users[15:20], item=items[15:20])
    return uris


def test_default_config_serves_as_the_jax_pipelined_engine(ncf):
    jm, variables, tm = ncf
    users, items = _ids(20, seed=1)
    jbroker = JBroker()
    jserving = JServing(JInference().load_keras(jm, variables),
                        JConfig(redis_url="memory://"), broker=jbroker)
    jserving.start()
    try:
        uris = _feed(JInputQueue(broker=jbroker), users, items)
        joq = JOutputQueue(broker=jbroker)
        want = {u: joq.query_blocking(u, timeout=WAIT) for u in uris}
    finally:
        jserving.stop()
    broker = InMemoryBroker()
    config = ServingConfig()
    assert config.pipeline and config == ServingConfig(pipeline=True)
    serving = ClusterServing(InferenceModel(device="cpu").load_keras(tm),
                             config, broker=broker).start()
    try:
        _feed(InputQueue(broker=broker), users, items)
        oq = OutputQueue(broker=broker)
        got = {u: oq.query_blocking(u, timeout=WAIT) for u in uris}
    finally:
        serving.stop()
    assert not serving._threads
    for u in uris:
        assert got[u] is not None and want[u] is not None, u
        assert got[u].shape == want[u].shape == (2,)
        np.testing.assert_allclose(got[u], want[u], atol=1e-5, rtol=0)
    m = serving.metrics()
    assert m["records_processed"] == 20
    assert m["admission"] == {"capacity": 1024, "in_flight": 0}
    assert set(m) == set(jserving.metrics())


class _Net(torch.nn.Module):
    """``x @ W`` over any leading shape; ``gate``, when set, holds every
    dispatch until it opens."""

    def __init__(self, d=4, k=3):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w = torch.nn.Parameter(torch.randn(d, k, generator=g))
        self.gate = None
        self.entered = threading.Event()

    def predict_fn(self, x):
        self.entered.set()
        if self.gate is not None:
            assert self.gate.wait(WAIT)
        return x @ self.w


def _engine(net=None, **cfg):
    net = net or _Net()
    im = InferenceModel(device="cpu").load_keras(net)
    broker = InMemoryBroker()
    serving = ClusterServing(im, ServingConfig(**cfg), broker=broker)
    return serving, im, broker


def _results(broker, uris):
    oq = OutputQueue(broker=broker)
    out = {}
    for u in uris:
        try:
            out[u] = oq.query_blocking(u, timeout=WAIT)
        except ServingError as exc:
            out[u] = exc
    return out


def test_many_shapes_in_one_window_do_not_deadlock():
    # 5 row counts -> 5 groups in one 200 ms window, past the model's
    # in-flight bound of 2 (concurrency 1)
    serving, im, broker = _engine(max_batch=32, linger_ms=200.0)
    assert im.concurrency == 1
    serving.start()
    try:
        iq = InputQueue(broker=broker)
        rs = np.random.RandomState(0)
        xs = {f"m-{i}": rs.randn(rows, 4).astype(np.float32)
              for i, rows in enumerate((1, 2, 3, 5, 7))}
        for u, x in xs.items():
            iq.enqueue(u, input=x)
        got = _results(broker, xs)
    finally:
        serving.stop()
    for u, x in xs.items():
        np.testing.assert_allclose(got[u], im.predict(x[None])[0],
                                   atol=1e-6)


def test_client_batch_is_cut_to_max_batch():
    seen = []
    net = _Net()
    inner = net.predict_fn
    net.predict_fn = lambda x: (seen.append(x.shape[0]), inner(x))[1]
    serving, im, broker = _engine(net, max_batch=4, linger_ms=1.0)
    serving.start()
    try:
        x = np.random.RandomState(3).randn(10, 4).astype(np.float32)
        uris = [f"b-{i}" for i in range(10)]
        InputQueue(broker=broker).enqueue_batch(uris, input=x)
        got = _results(broker, uris)
    finally:
        serving.stop()
    want = x @ net.w.detach().numpy()
    for i, u in enumerate(uris):
        np.testing.assert_allclose(got[u], want[i], atol=1e-6)
    # 4 + 4 + 2 rows, the last padded to its power-of-two bucket
    assert sorted(seen) == [2, 4, 4]


def test_bad_entry_gets_an_error_and_the_engine_serves_on():
    serving, im, broker = _engine(max_batch=8, linger_ms=1.0)
    serving.start()
    try:
        broker.xadd(serving.stream, {"uri": "bad", "data": b"!!not a frame"})
        iq = InputQueue(broker=broker)
        iq.enqueue_batch(["short-0", "short-1"],
                         input=np.ones((2, 4), np.float32))
        broker.xadd(serving.stream, {"uri": "x\x1fy", "batch": "3",
                                     "data": b"\x00"})
        iq.enqueue("ok", input=np.ones(4, np.float32))
        got = _results(broker, ["bad", "x", "y", "short-0", "ok"])
    finally:
        serving.stop()
    for u in ("bad", "x", "y"):
        assert isinstance(got[u], ServingError), (u, got[u])
    assert got["short-0"].shape == got["ok"].shape == (3,)
    assert serving.metrics()["admission"]["in_flight"] == 0


def test_expired_entry_is_rejected_before_admission():
    serving, im, broker = _engine()
    iq = InputQueue(broker=broker)
    iq.enqueue("late", deadline_s=1e-6, input=np.ones(4, np.float32))
    iq.enqueue_batch(["late-0", "late-1"], deadline_s=1e-6,
                     input=np.ones((2, 4), np.float32))
    time.sleep(0.01)
    serving.start()
    try:
        iq.enqueue("fine", deadline_s=WAIT, input=np.ones(4, np.float32))
        got = _results(broker, ["late", "late-0", "late-1", "fine"])
    finally:
        serving.stop()
    for u in ("late", "late-0", "late-1"):
        assert isinstance(got[u], ServingDeadlineError), got[u]
    assert got["fine"].shape == (3,)
    assert serving.metrics()["records_expired"] == 3


def test_shed_under_admission_max_inflight():
    net = _Net()
    net.gate = threading.Event()
    serving, im, broker = _engine(net, max_batch=1,
                                  admission_max_inflight=1,
                                  admission_timeout_ms=1.0)
    serving.start()
    try:
        iq = InputQueue(broker=broker)
        iq.enqueue("held", input=np.ones(4, np.float32))
        assert net.entered.wait(WAIT)          # its credit is taken
        for i in range(3):
            iq.enqueue(f"over-{i}", input=np.ones(4, np.float32))
        shed = _results(broker, [f"over-{i}" for i in range(3)])
        net.gate.set()
        held = _results(broker, ["held"])["held"]
        iq.enqueue("after", input=np.ones(4, np.float32))
        after = _results(broker, ["after"])["after"]
    finally:
        net.gate.set()
        serving.stop()
    assert all(isinstance(e, ServingShedError) for e in shed.values()), shed
    assert held.shape == after.shape == (3,)
    m = serving.metrics()
    assert m["records_shed"] == 3
    assert m["admission"] == {"capacity": 1, "in_flight": 0}
    assert serving.admission.shed_count == 3


def test_stop_drains_what_was_read():
    net = _Net()
    net.gate = threading.Event()
    serving, im, broker = _engine(net, max_batch=4, linger_ms=1.0)
    serving.start()
    iq = InputQueue(broker=broker)
    uris = [f"d-{i}" for i in range(6)]
    try:
        for u in uris:
            iq.enqueue(u, input=np.ones(4, np.float32))
        assert net.entered.wait(WAIT)
        # all 6 admitted (read off the stream, credits taken) and held in
        # flight while stop() begins
        deadline = time.monotonic() + WAIT
        while (serving.admission.in_flight < len(uris)
               and time.monotonic() < deadline):
            time.sleep(0.005)
        assert serving.admission.in_flight == len(uris)
        threading.Timer(0.05, net.gate.set).start()
    finally:
        serving.stop()
        net.gate.set()
    assert not serving._threads
    got = _results(broker, uris)
    assert all(isinstance(r, np.ndarray) for r in got.values()), got


def test_restart_is_refused_while_a_thread_drains():
    serving, im, broker = _engine()
    serving.start()
    serving.stop()
    hold = threading.Event()
    straggler = threading.Thread(target=hold.wait, args=(WAIT,),
                                 daemon=True)
    straggler.start()
    serving._threads.append(straggler)
    try:
        with pytest.raises(RuntimeError, match="previous drain threads"):
            serving.start()
    finally:
        hold.set()
        straggler.join(WAIT)
    assert not straggler.is_alive()
    serving.start()
    try:
        InputQueue(broker=broker).enqueue("again",
                                          input=np.ones(4, np.float32))
        assert _results(broker, ["again"])["again"].shape == (3,)
    finally:
        serving.stop()


def test_unported_serving_fields_name_their_item():
    im = InferenceModel(device="cpu")
    for kw, item in ((dict(image_resize=(8, 8)), 1),
                     (dict(tensorboard_dir="tb"), 6)):
        with pytest.raises(NotImplementedError,
                           match=f"{next(iter(kw))}=.*Queue 1 item {item}"):
            ClusterServing(im, ServingConfig(redis_url="memory://", **kw))
    # item 1's tenants are ported: the rows build the engine's tenancy
    tenancy = ClusterServing(im, ServingConfig(
        redis_url="memory://", tenants=(("a", 4, 1.0),))).tenancy
    assert tenancy.tenants() == ["a"]
    assert tenancy.usage()["a"]["credits"] == 4
