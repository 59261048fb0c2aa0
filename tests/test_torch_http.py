"""The port's ``ServingFrontend`` and ``FastWireHttpClient`` against the JAX
package's, on the CPU.

A small NeuralCF (the JAX ``init`` weights in both packages) is served by
each package's pipelined ``ClusterServing`` behind its own
``ServingFrontend``, both bound to port 0; the same JSON and fast-wire
requests must get the same answers from both (1e-5, f32), and the JSON
and fast-wire answers of one frontend must be equal.  Then the port's
frontend alone: 400 on a malformed frame or body, 429 with an integer
``Retry-After`` on a shed, 504 on an expired deadline, each followed by a
request served on the same keep-alive connection; the coalescer on and
off; the ``uri`` echo; the observability routes (``/metrics``,
``/spans``, ``/debug/*``) and the routes that are not ported answering 501.
No more than 4 client threads; every server stops in a ``finally``.
"""

import http.client
import json
import threading

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common.config import ServingConfig as JConfig
from analytics_zoo_tpu.inference import InferenceModel as JInference
from analytics_zoo_tpu.keras import engine as jengine
from analytics_zoo_tpu.models import recommendation as JR
from analytics_zoo_tpu.serving.broker import InMemoryBroker as JBroker
from analytics_zoo_tpu.serving.client import (
    FastWireHttpClient as JFastWireHttpClient)
from analytics_zoo_tpu.serving.engine import ClusterServing as JServing
from analytics_zoo_tpu.serving.http_frontend import (
    ServingFrontend as JFrontend)
from analytics_zoo_tpu_torch.common.config import ServingConfig
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.keras import engine as tengine
from analytics_zoo_tpu_torch.models import recommendation as TR
from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
from analytics_zoo_tpu_torch.serving.client import (
    FastWireHttpClient, InputQueue, ServingDeadlineError, ServingShedError)
from analytics_zoo_tpu_torch.serving.codec import encode_items_bytes
from analytics_zoo_tpu_torch.serving.engine import ClusterServing
from analytics_zoo_tpu_torch.serving.http_frontend import (
    ServingFrontend, _RequestCoalescer)

USERS, ITEMS = 30, 20
SMALL = dict(user_count=USERS, item_count=ITEMS, user_embed=8, item_embed=6,
             mf_embed=4, hidden_layers=(16, 8))
WAIT = 5.0
FASTWIRE = {"Content-Type": "application/x-zoo-fastwire"}
JSON = {"Content-Type": "application/json"}


@pytest.fixture(scope="module")
def ncf():
    jengine.reset_uids()
    jm = JR.NeuralCF(**SMALL)
    params, state = jm.init(jax.random.PRNGKey(0))
    tengine.reset_uids()
    tm = TR.NeuralCF(device="cpu", **SMALL)
    tm.set_weights(jax.tree_util.tree_map(np.asarray, (params, state)))
    return jm, (params, state), tm


class _Served:
    """An engine and its frontend on port 0, stopped by ``close``."""

    def __init__(self, serving, frontend_cls, **fe_kw):
        self.serving = serving.start()
        try:
            self.fe = frontend_cls(serving, port=0, **fe_kw).start()
        except BaseException:
            serving.stop()
            raise

    def conn(self):
        return http.client.HTTPConnection("127.0.0.1", self.fe.port,
                                          timeout=WAIT)

    def close(self):
        try:
            self.fe.stop()
        finally:
            self.serving.stop()


def _post(conn, body, headers):
    conn.request("POST", "/predict", body, headers)
    resp = conn.getresponse()
    return resp.status, dict(resp.headers), resp.read()


def _requests(n=6, seed=2):
    rs = np.random.RandomState(seed)
    return [{"user": [int(rs.randint(1, USERS + 1))],
             "item": [int(rs.randint(1, ITEMS + 1))]} for _ in range(n)]


def _ask(served, reqs):
    """Every request as JSON and as a fast-wire frame, on one keep-alive
    connection; returns the two lists of answers."""
    conn = served.conn()
    try:
        as_json, as_frames = [], []
        for i, r in enumerate(reqs):
            status, _, blob = _post(conn, json.dumps(
                {"uri": f"j-{i}", "inputs": r}), JSON)
            assert status == 200, blob
            body = json.loads(blob)
            assert body["uri"] == f"j-{i}"
            as_json.append(np.asarray(body["prediction"], np.float32))
        with FastWireHttpClient(port=served.fe.port, timeout=WAIT) as c:
            for r in reqs:
                as_frames.append(c.predict(
                    **{k: np.asarray(v, np.int32) for k, v in r.items()}))
    finally:
        conn.close()
    return as_json, as_frames


def test_both_wires_answer_as_the_jax_frontend(ncf):
    jm, variables, tm = ncf
    reqs = _requests()
    jserved = _Served(JServing(JInference().load_keras(jm, variables),
                               JConfig(redis_url="memory://"),
                               broker=JBroker()), JFrontend)
    try:
        jjson, jframes = _ask(jserved, reqs)
    finally:
        jserved.close()
    served = _Served(ClusterServing(
        InferenceModel(device="cpu").load_keras(tm),
        ServingConfig(redis_url="memory://"), broker=InMemoryBroker()),
        ServingFrontend)
    try:
        tjson, tframes = _ask(served, reqs)
        # the JAX client reads the port's frames too
        with JFastWireHttpClient(port=served.fe.port, timeout=WAIT) as c:
            cross = c.predict(**{k: np.asarray(v, np.int32)
                                 for k, v in reqs[0].items()})
    finally:
        served.close()
    for i in range(len(reqs)):
        np.testing.assert_array_equal(tjson[i], tframes[i])
        np.testing.assert_array_equal(jjson[i], jframes[i])
        np.testing.assert_allclose(tframes[i], jframes[i], atol=1e-5,
                                   rtol=0)
    np.testing.assert_array_equal(cross, tframes[0])


class _Net(torch.nn.Module):
    """``x @ W``; ``gate``, when set, holds every dispatch until it opens."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w = torch.nn.Parameter(torch.randn(4, 3, generator=g))
        self.gate = None
        self.entered = threading.Event()

    def predict_fn(self, x):
        self.entered.set()
        if self.gate is not None:
            assert self.gate.wait(WAIT)
        return x @ self.w


def _served(net=None, **cfg):
    im = InferenceModel(device="cpu").load_keras(net or _Net())
    cfg.setdefault("redis_url", "memory://")
    return _Served(ClusterServing(im, ServingConfig(**cfg),
                                  broker=InMemoryBroker()), ServingFrontend)


X = np.arange(4, dtype=np.float32)


def test_malformed_frame_and_body_get_400_and_the_connection_serves_on():
    served = _served()
    conn = served.conn()
    try:
        frame = encode_items_bytes({"x": X})
        for body, headers in ((frame[:len(frame) // 2], FASTWIRE),
                              (b"\x00garbage", FASTWIRE), (b"", FASTWIRE),
                              (b"{not json", JSON),
                              (b'{"uri": "no-inputs"}', JSON)):
            status, _, blob = _post(conn, body, headers)
            assert status == 400, (body, blob)
            assert "error" in json.loads(blob)
        status, headers, blob = _post(conn, frame,
                                      {**FASTWIRE, "X-Zoo-Uri": "mine"})
        assert status == 200 and headers["X-Zoo-Uri"] == "mine"
        status, _, blob = _post(conn, b"{}", {**JSON,
                                              "X-Zoo-Deadline-Ms": "soon"})
        assert status == 400
        status, _, blob = _post(conn, json.dumps({"inputs": {"x": [1, 2]}}),
                                JSON)
        assert status == 500          # the model cannot take 2 columns
        status, _, blob = _post(conn, json.dumps({"inputs": {"x": X.tolist()}}),
                                JSON)
        assert status == 200 and json.loads(blob)["uri"].startswith("http-")
    finally:
        conn.close()
        served.close()


def test_shed_is_429_with_an_integer_retry_after():
    net = _Net()
    net.gate = threading.Event()
    # coalescing off: one entry per request makes the shed deterministic
    served = _served(net, max_batch=1, admission_max_inflight=1,
                     admission_timeout_ms=1.0, shed_retry_after_s=1.5,
                     http_coalesce=False)
    first = {}

    def held():
        with FastWireHttpClient(port=served.fe.port, timeout=WAIT) as c:
            first["out"] = c.predict(x=X)

    t = threading.Thread(target=held, daemon=True)
    conn = served.conn()
    try:
        t.start()
        assert net.entered.wait(WAIT)
        status, headers, blob = _post(conn, encode_items_bytes({"x": X}),
                                      FASTWIRE)
        assert status == 429 and headers["Retry-After"] == "2", blob
        with FastWireHttpClient(port=served.fe.port, timeout=WAIT) as c:
            with pytest.raises(ServingShedError) as err:
                c.predict(x=X)
            assert err.value.retry_after_s == 2.0
        net.gate.set()
        t.join(WAIT)
        assert not t.is_alive() and first["out"].shape == (3,)
        status, _, _ = _post(conn, encode_items_bytes({"x": X}), FASTWIRE)
        assert status == 200
    finally:
        net.gate.set()
        conn.close()
        served.close()
    assert served.serving.metrics()["records_shed"] == 2


def test_expired_deadline_is_504_and_the_connection_serves_on():
    net = _Net()
    net.gate = threading.Event()
    served = _served(net, http_coalesce=False)
    try:
        with FastWireHttpClient(port=served.fe.port, timeout=WAIT) as c:
            # held at the model past its 50 ms budget
            with pytest.raises(ServingDeadlineError):
                c.predict(x=X, deadline_ms=50)
            net.gate.set()
            with pytest.raises(ServingDeadlineError):
                c.predict(x=X, deadline_ms=1e-3)
            np.testing.assert_allclose(c.predict(x=X),
                                       X @ net.w.detach().numpy(),
                                       atol=1e-6)
    finally:
        net.gate.set()
        served.close()


@pytest.mark.parametrize("coalesce", [True, False], ids=["on", "off"])
def test_coalescer_on_and_off(coalesce):
    served = _served(http_coalesce=coalesce, http_coalesce_window_ms=20.0)
    rs = np.random.RandomState(5)
    xs = [rs.randn(4).astype(np.float32) for _ in range(8)]
    got = [None] * len(xs)

    def client(k):
        with FastWireHttpClient(port=served.fe.port, timeout=WAIT) as c:
            for i in range(k, len(xs), 4):
                got[i] = c.predict(uri=f"c-{i}", x=xs[i])

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
        coal = served.fe._coalescer
        if coalesce:
            assert coal.records == len(xs) and 1 <= coal.flushes <= len(xs)
        else:
            assert coal is None
    finally:
        served.close()
    w = served.serving.model.model.w.detach().numpy()
    for i, x in enumerate(xs):
        np.testing.assert_allclose(got[i], x @ w, atol=1e-6)


def test_coalescer_merges_one_window_into_one_entry():
    broker = InMemoryBroker()
    coal = _RequestCoalescer(InputQueue(broker=broker), broker,
                             max_records=4, window_ms=500.0)
    try:
        for i in range(4):
            coal.submit(f"u-{i}", None, {"x": np.full(4, i, np.float32)},
                        None)
        entries = broker.xreadgroup("serving_stream", "g", "c",
                                    block_ms=int(WAIT * 1e3))
    finally:
        coal.stop()
    assert (coal.flushes, coal.records) == (1, 4)
    assert len(entries) == 1
    assert entries[0][1]["uri"].split("\x1f") == [f"u-{i}" for i in range(4)]
    assert entries[0][1]["batch"] == "4"


def test_get_routes_and_the_unported_ones():
    served = _served()
    conn = served.conn()
    try:
        for path, code in (("/", 200), ("/metrics.json", 200),
                           ("/spans", 200), ("/spans?limit=x", 400),
                           ("/debug/memory?local=1", 200),
                           ("/debug/memory?topk=-1", 400),
                           ("/debug/flightrecorder", 200),
                           ("/debug/flightrecorder?name=../x", 404),
                           ("/nowhere", 404)):
            conn.request("GET", path)
            resp = conn.getresponse()
            body = json.loads(resp.read())
            assert resp.status == code, (path, body)
        conn.request("GET", "/metrics?local=1")
        resp = conn.getresponse()
        text = resp.read().decode()
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith("text/plain")
        assert "# TYPE zoo_http_requests_total counter" in text
        conn.request("GET", "/metrics.json")
        assert "records_processed" in json.loads(conn.getresponse().read())
        frame = encode_items_bytes({"x": X})
        status, _, want = _post(conn, frame, FASTWIRE)
        assert status == 200
        # the model and tenant stamps are ported: a one-model engine
        # without tenancy serves them as a bare /predict, as the JAX
        # engine does; a bad model name is a 400 on a connection that
        # keeps serving
        for path, headers in (("/predict/m", FASTWIRE),
                              ("/predict", {**FASTWIRE, "X-Zoo-Model": "m"}),
                              ("/predict", {**FASTWIRE,
                                            "X-Zoo-Tenant": "t"})):
            conn.request("POST", path, frame, headers)
            resp = conn.getresponse()
            assert resp.status == 200, path
            assert resp.read() == want
        conn.request("POST", "/predict/a%2Fb", frame, FASTWIRE)
        resp = conn.getresponse()
        assert resp.status == 400
        assert "bad model name" in json.loads(resp.read())["error"]
        status, _, _ = _post(conn, frame, FASTWIRE)
        assert status == 200
    finally:
        conn.close()
        served.close()


@pytest.mark.parametrize("arg", ["broker", "router", "fleet", "worker_id",
                                 "reuse_port"])
def test_fleet_worker_arguments_name_item_1(arg):
    with pytest.raises(NotImplementedError,
                       match=f"{arg}=.*Queue 1 item 1"):
        ServingFrontend(None, port=0, **{arg: True if arg == "reuse_port"
                                         else "x"})
