"""Multi-model serving in the port: the registry, its pager, host staging
of ``InferenceModel`` weights, routing through the pipelined engine and
the HTTP frontend, on the CPU.

The registry and engine tests use small fake models with the
place / unplace / predict_async / fetch protocol and a budget in bytes, as
the JAX package's own tests do (``tests/test_model_zoo.py``); the same
churn of page-ins, pins and evictions drives the JAX registry and the
port's to equal books.  Host staging uses the port's real
``InferenceModel`` on the CPU: a place / unplace / place cycle keeps the
weights bit for bit.  Every server binds port 0; every engine and
registry stops in a ``finally``; every wait is bounded.
"""

import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common.config import ServingConfig
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
from analytics_zoo_tpu_torch.serving.client import (
    FastWireHttpClient, InputQueue, OutputQueue, ServingError,
    ServingShedError)
from analytics_zoo_tpu_torch.serving.codec import encode_items_bytes
from analytics_zoo_tpu_torch.serving.engine import ClusterServing
from analytics_zoo_tpu_torch.serving.http_frontend import ServingFrontend
from analytics_zoo_tpu_torch.serving.model_zoo import (
    DEVICE, HOST, ModelRegistry, PageInError, validate_model_name)
from analytics_zoo_tpu_torch.testing import chaos


class PagedFakeModel:
    """The place / unplace + predict_async / fetch protocol without
    tensors: the books are plain byte counts.  ``predict_async`` asserts
    residency, the bug class the pin discipline prevents."""

    concurrency = 2

    def __init__(self, scale=2.0, nbytes=100, nblocks=2, place_s=0.0,
                 per_dispatch_s=0.0):
        self.scale = scale
        self.weight_nbytes = nbytes
        self.weight_blocks = nblocks
        self.place_s = place_s
        self.per_dispatch_s = per_dispatch_s
        self.on_device = False
        self.place_calls = 0
        self.unplace_calls = 0

    def place(self):
        if self.place_s:
            time.sleep(self.place_s)
        self.place_calls += 1
        self.on_device = True
        return self

    def unplace(self):
        self.unplace_calls += 1
        self.on_device = False
        return self

    def predict_async(self, x):
        assert self.on_device, "dispatched against non-resident weights"
        if self.per_dispatch_s:
            time.sleep(self.per_dispatch_s)
        arr = x if isinstance(x, np.ndarray) else next(iter(x.values()))
        return np.asarray(arr, np.float32) * self.scale

    def fetch(self, pending):
        return pending


class ReservingPagedFakeModel(PagedFakeModel):
    """The fake plus the reserve / fetch permit protocol of
    ``InferenceModel``."""

    def __init__(self, *a, permits=2, **kw):
        super().__init__(*a, **kw)
        self._sem = threading.Semaphore(permits)

    def reserve(self):
        self._sem.acquire()

    def release_reservation(self):
        self._sem.release()

    def predict_async(self, x, reserved=False):
        return (reserved, super().predict_async(x))

    def fetch(self, pending):
        reserved, out = pending
        if reserved:
            self._sem.release()
        return out


def _registry(**kw):
    kw.setdefault("page_timeout_s", 5.0)
    return ModelRegistry(**kw)


def _engine(broker, reg, **cfg_kw):
    cfg_kw.setdefault("max_batch", 8)
    cfg_kw.setdefault("linger_ms", 1.0)
    cfg_kw.setdefault("decode_workers", 2)
    return ClusterServing(reg, ServingConfig(**cfg_kw), broker=broker)


def _wait_all_finished(broker, uris, timeout=10.0):
    deadline = time.monotonic() + timeout
    out = {}
    for uri in uris:
        while True:
            h = broker.hgetall(f"result:{uri}")
            if h:
                out[uri] = h
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"request {uri} stranded")
            time.sleep(0.005)
    return out


def _books_balance(reg):
    with reg._space:
        resident = [e for e in reg._entries.values() if e.state == DEVICE]
        return (reg.used_bytes == sum(e.nbytes for e in resident)
                and reg.used_blocks == sum(e.nblocks for e in resident))


# --- host staging of InferenceModel weights ----------------------------------

def _net(seed=0):
    torch.manual_seed(seed)
    net = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.BatchNorm1d(8),
                              torch.nn.Linear(8, 3))
    net.predict_fn = net.forward
    return net.eval()


def test_host_staging_place_unplace_keeps_weights_bit_for_bit():
    net = _net()
    want = {k: v.clone() for k, v in net.state_dict().items()}
    x = np.random.RandomState(0).randn(4, 4).astype(np.float32)
    with torch.no_grad():
        y = net(torch.from_numpy(x)).numpy()
    im = InferenceModel(place_on_load=False, device="cpu").load_keras(net)
    assert not im.placed and im._host is not None
    assert im.weight_nbytes == sum(t.numel() * t.element_size()
                                   for t in want.values())
    assert im.weight_blocks == len(want)
    with pytest.raises(RuntimeError, match="host-staged"):
        im.predict(x)
    params = list(net.parameters())
    for _ in range(2):
        im.place()
        assert im.placed
        # the module's parameter objects stay; only their storage moves
        assert list(net.parameters()) == params
        np.testing.assert_array_equal(im.predict(x), y)
        im.unplace()
        assert not im.placed
    im.place()
    for k, v in net.state_dict().items():
        assert torch.equal(v, want[k]), k
    # a model placed at load stages its host copy on first unplace
    eager = InferenceModel(device="cpu").load_keras(_net())
    assert eager.placed and eager._host is None
    eager.unplace()
    assert not eager.placed and eager._host is not None
    with pytest.raises(RuntimeError, match="no weights"):
        InferenceModel(device="cpu").place()


def test_reserved_permit_protocol():
    im = InferenceModel(device="cpu").load_keras(_net())
    x = np.zeros((2, 4), np.float32)
    for _ in range(4):                    # 2x concurrency permits
        im.reserve()
        im.fetch(im.predict_async(x, reserved=True))
    im.reserve()
    with pytest.raises(Exception):
        im.predict_async("not an array", reserved=True)
    # the failed reserved dispatch gave its permit back
    assert im._inflight._value == 2


def test_registry_pages_real_inference_models():
    nets = [_net(s) for s in range(3)]
    x = np.random.RandomState(1).randn(4, 4).astype(np.float32)
    want = []
    for n in nets:
        with torch.no_grad():
            want.append(n(torch.from_numpy(x)).numpy())
    ims = [InferenceModel(place_on_load=False, device="cpu").load_keras(n)
           for n in nets]
    nb = ims[0].weight_nbytes
    reg = _registry(hbm_budget_bytes=2 * nb)
    try:
        es = [reg.register(f"m{k}", im) for k, im in enumerate(ims)]
        assert reg.used_bytes == 0
        for k in (0, 1, 2, 0, 2, 1):
            reg.ensure_resident(es[k])
            reg.pin(es[k])
            np.testing.assert_array_equal(es[k].model.predict(x), want[k])
            reg.unpin(es[k])
            assert _books_balance(reg) and reg.used_bytes <= 2 * nb
        assert reg.evictions >= 2
        assert sum(im.placed for im in ims) == 2
        assert "model_weights" not in \
            obs.get_memory_ledger().reconcile_once()
    finally:
        reg.stop()


# --- the registry ------------------------------------------------------------

def test_register_resolve_default_and_names():
    reg = _registry()
    try:
        a = reg.register("a", PagedFakeModel())
        b = reg.register("b", PagedFakeModel())
        assert reg.resolve("a") is a and reg.resolve("b") is b
        assert reg.resolve(None) is a
        c = reg.register("c", PagedFakeModel(), default=True)
        assert reg.resolve(None) is c
        with pytest.raises(KeyError):
            reg.resolve("missing")
        with pytest.raises(ValueError):
            reg.register("a", PagedFakeModel())
        for bad in ("a/b", "/", "", "x\x1fy", "x\ny", "x\x00", 3):
            with pytest.raises(ValueError):
                validate_model_name(bad)
            if isinstance(bad, str):
                with pytest.raises(ValueError):
                    reg.register(bad, PagedFakeModel())
        assert reg.models() == ["a", "b", "c"]
        cli = FastWireHttpClient(port=0)      # never connects
        with pytest.raises(ValueError):
            cli.predict(model="a/b", x=np.ones(2, np.float32))
    finally:
        reg.stop()


def test_cold_and_pinned_registration_and_rollback():
    reg = _registry(hbm_budget_bytes=1000)
    try:
        for k in range(4):
            reg.register(f"m{k}", PagedFakeModel(nbytes=500))
        assert reg.used_bytes == 0 and reg.used_blocks == 0
        assert all(e.state == HOST for e in reg._entries.values())
        e = reg.register("hot", PagedFakeModel(nbytes=400), pinned=True)
        assert e.state == DEVICE and e.model.on_device
        assert reg.used_bytes == 400
    finally:
        reg.stop()
    reg = _registry(hbm_budget_bytes=100)
    try:
        with pytest.raises(PageInError):
            reg.register("big", PagedFakeModel(nbytes=200), pinned=True)
        assert reg.models() == [] and reg.default_entry is None
        assert reg.used_bytes == 0 and _books_balance(reg)
        e = reg.register("big", PagedFakeModel(nbytes=50), pinned=True)
        assert e.state == DEVICE and reg.resolve(None) is e
    finally:
        reg.stop()


def test_lru_eviction_pins_and_explicit_evict():
    reg = _registry(hbm_budget_bytes=200)
    try:
        a = reg.register("a", PagedFakeModel(nbytes=100))
        b = reg.register("b", PagedFakeModel(nbytes=100))
        c = reg.register("c", PagedFakeModel(nbytes=100))
        reg.ensure_resident(a)
        reg.ensure_resident(b)
        reg.pin(a)
        reg.unpin(a)                 # a touched: b is the LRU
        reg.ensure_resident(c)
        assert b.state == HOST and a.state == DEVICE and c.state == DEVICE
        assert reg.evictions == 1 and _books_balance(reg)
        reg.pin(a)
        assert not reg.evict("a")    # a dispatch in flight
        reg.unpin(a)
        assert reg.evict("a") and a.state == HOST
    finally:
        reg.stop()
    reg = _registry(hbm_budget_bytes=200)
    try:
        hot = reg.register("hot", PagedFakeModel(nbytes=150), pinned=True)
        cold = reg.register("cold", PagedFakeModel(nbytes=100))
        with pytest.raises(PageInError, match="never fit"):
            reg.ensure_resident(cold, timeout=1.0)
        assert hot.state == DEVICE and hot.model.unplace_calls == 0
    finally:
        reg.stop()


def test_dispatch_pin_holds_a_waiting_pagein():
    reg = _registry(hbm_budget_bytes=100)
    try:
        a = reg.register("a", PagedFakeModel(nbytes=100))
        b = reg.register("b", PagedFakeModel(nbytes=100))
        reg.ensure_resident(a)
        reg.pin(a)
        got = {}

        def want_b():
            try:
                reg.ensure_resident(b, timeout=4.0)
                got["e"] = None
            except PageInError as exc:
                got["e"] = exc

        t = threading.Thread(target=want_b, daemon=True)
        t.start()
        time.sleep(0.2)
        assert a.state == DEVICE
        reg.unpin(a)
        t.join(timeout=5.0)
        assert not t.is_alive() and got["e"] is None
        assert b.state == DEVICE and a.state == HOST and _books_balance(reg)
    finally:
        reg.stop()


def _churn(reg_cls, fake_cls):
    """One fixed churn of page-ins, pins, evictions and a swap; returns
    the registry's stats with the books checked at every step."""
    reg = reg_cls(hbm_budget_bytes=250, page_timeout_s=5.0)
    try:
        es = [reg.register(f"m{k}", fake_cls(nbytes=100, nblocks=3))
              for k in range(5)]
        rng = np.random.default_rng(7)
        for step in range(40):
            e = es[int(rng.integers(len(es)))]
            reg.ensure_resident(e)
            reg.pin(e)
            reg.unpin(e)
            assert _books_balance(reg), step
        reg.swap("m1", fake_cls(nbytes=60, nblocks=2))
        assert _books_balance(reg)
        stats = reg.stats()
        for e in es:
            reg.evict(e.name)
        assert reg.used_bytes == 0 and reg.used_blocks == 0
        return stats
    finally:
        reg.stop()


def test_churn_books_equal_the_jax_registry():
    from analytics_zoo_tpu.serving.model_zoo import ModelRegistry as JReg
    got = _churn(ModelRegistry, PagedFakeModel)
    want = _churn(JReg, PagedFakeModel)
    assert got == want
    assert got["pageins"] >= got["evictions"] > 0


def test_prefetch_idempotent_and_repage_after_eviction():
    reg = _registry(hbm_budget_bytes=100)
    try:
        a = reg.register("a", PagedFakeModel(nbytes=100))
        reg.prefetch(a)
        reg.prefetch(a)
        reg.ensure_resident(a)
        assert a.model.place_calls == 1
        assert reg.evict("a")
        reg.ensure_resident(a)
        assert a.model.place_calls == 2 and a.state == DEVICE
        s = reg.stats()
        assert s["models"]["a"]["state"] == DEVICE
        assert s["models"]["a"]["breaker"] == "closed"
    finally:
        reg.stop()


# --- the pipelined engine over a registry ------------------------------------

def _serve(reg, **cfg):
    broker = InMemoryBroker()
    serving = _engine(broker, reg, **cfg).start()
    return broker, serving, InputQueue(broker=broker), \
        OutputQueue(broker=broker)


def test_engine_routes_by_model_and_never_merges_models():
    reg = _registry()
    reg.register("a", PagedFakeModel(2.0))
    reg.register("b", ReservingPagedFakeModel(5.0))
    broker, serving, iq, oq = _serve(reg)
    try:
        x = np.ones(4, np.float32)
        uris = []
        for k in range(12):
            m = "a" if k % 2 == 0 else "b"
            uris.append((f"mix-{k}", 2.0 if m == "a" else 5.0))
            iq.enqueue_items(f"mix-{k}", {"x": x}, model=m)
        iq.enqueue_items("dflt", {"x": x})                 # default: a
        iq.enqueue_batch_items(["b0", "b1"], {"x": np.ones((2, 4),
                                                          np.float32)},
                               model="b")
        res = _wait_all_finished(broker, [u for u, _ in uris]
                                 + ["dflt", "b0", "b1"])
        assert all("error" not in h for h in res.values())
        for uri, scale in uris:
            np.testing.assert_allclose(oq.query(uri), scale * x)
        np.testing.assert_allclose(oq.query("dflt"), 2.0 * x)
        np.testing.assert_allclose(oq.query("b1"), 5.0 * x)
        iq.enqueue_items("r-x", {"x": x}, model="nope")
        with pytest.raises(ServingError, match="unknown model"):
            oq.query_blocking("r-x", timeout=5.0)
        m = serving.metrics()["models"]["models"]
        assert m["a"]["served"] == 7 and m["b"]["served"] == 8
        assert reg.resolve("b").model._sem._value == 2   # permits back
    finally:
        serving.stop()
        reg.stop()
    with pytest.raises(ValueError, match="pipeline"):
        ClusterServing(reg, ServingConfig(pipeline=False),
                       broker=InMemoryBroker())


def test_open_breaker_and_restart_credits():
    reg = _registry(breaker_failure_threshold=1, breaker_recovery_s=60.0,
                    admission_max_inflight=4)
    reg.register("sick", PagedFakeModel(2.0))
    reg.register("ok", PagedFakeModel(3.0))
    reg.resolve("sick").breaker.record_failure()
    broker, serving, iq, oq = _serve(reg)
    try:
        x = np.ones(4, np.float32)
        iq.enqueue_items("s-1", {"x": x}, model="sick")
        iq.enqueue_items("o-1", {"x": x}, model="ok")
        with pytest.raises(ServingShedError, match="circuit open"):
            oq.query_blocking("s-1", timeout=5.0)
        np.testing.assert_allclose(oq.query_blocking("o-1", timeout=5.0),
                                   3.0 * x)
        assert reg.resolve("sick").model.on_device is False
        serving.stop()
        adm = reg.resolve("ok").admission
        adm.force_acquire(adm.capacity)           # a leak across stop()
        serving.start()
        assert reg.resolve("ok").admission.in_flight == 0
        iq.enqueue_items("o-2", {"x": x}, model="ok")
        np.testing.assert_allclose(oq.query_blocking("o-2", timeout=5.0),
                                   3.0 * x)
    finally:
        serving.stop()
        reg.stop()


def test_weight_page_fault_contained_to_its_model():
    reg = _registry(page_timeout_s=1.0, breaker_failure_threshold=2,
                    breaker_recovery_s=0.3)
    hot = reg.register("hot", PagedFakeModel(2.0), pinned=True)
    cold = reg.register("cold", PagedFakeModel(3.0))
    broker, serving, iq, oq = _serve(reg)
    inj = chaos.ChaosInjector()
    inj.plan("weight_page", fault="raise", times=None)
    try:
        x = np.ones(4, np.float32)
        with chaos.installed(inj):
            cold_uris = [f"c-{k}" for k in range(4)]
            hot_uris = [f"h-{k}" for k in range(8)]
            for u in cold_uris:
                iq.enqueue_items(u, {"x": x}, model="cold")
            for u in hot_uris:
                iq.enqueue_items(u, {"x": x}, model="hot")
            res = _wait_all_finished(broker, cold_uris + hot_uris)
        assert inj.injected("weight_page") >= 1
        assert all("error" in res[u] for u in cold_uris)
        assert all("error" not in res[u] for u in hot_uris)
        assert cold.state == HOST and reg.used_bytes == hot.nbytes
        assert _books_balance(reg)
        assert cold.breaker.state != "closed"
        assert hot.breaker.state == "closed"
        t_end = time.monotonic() + 5.0
        k = 0
        while True:
            u = f"c-after-{k}"
            k += 1
            iq.enqueue_items(u, {"x": x}, model="cold")
            try:
                np.testing.assert_allclose(
                    oq.query_blocking(u, timeout=5.0), 3.0 * x)
                break
            except ServingShedError:
                assert time.monotonic() < t_end
                time.sleep(0.1)
    finally:
        serving.stop()
        reg.stop()


def test_cold_dispatch_never_blocks_resident_models():
    # the cold page-in is held until every hot request has its answer
    gate = threading.Event()

    def placer(m):
        if m.scale == 3.0:
            assert gate.wait(10.0)
        return m.place()

    reg = _registry(placer=placer, page_timeout_s=10.0)
    reg.register("hot", ReservingPagedFakeModel(2.0, permits=1),
                 pinned=True)
    cold = reg.register("cold", ReservingPagedFakeModel(3.0))
    broker, serving, iq, oq = _serve(reg)
    try:
        x = np.ones(4, np.float32)
        iq.enqueue_items("c", {"x": x}, model="cold")
        for k in range(5):
            iq.enqueue_items(f"h{k}", {"x": x}, model="hot")
            np.testing.assert_allclose(
                oq.query_blocking(f"h{k}", timeout=5.0), 2.0 * x)
        assert cold.state != DEVICE and oq.query("c") is None
        gate.set()
        np.testing.assert_allclose(oq.query_blocking("c", timeout=5.0),
                                   3.0 * x)
    finally:
        gate.set()
        serving.stop()
        reg.stop()


# --- the HTTP frontend -------------------------------------------------------

FASTWIRE = {"Content-Type": "application/x-zoo-fastwire"}


def test_http_routes_models_on_both_wires():
    reg = _registry()
    reg.register("a", PagedFakeModel(2.0))
    reg.register("b", PagedFakeModel(3.0))
    broker = InMemoryBroker()
    serving = _engine(broker, reg).start()
    fe = ServingFrontend(serving, port=0).start()
    conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=10)
    cli = FastWireHttpClient(port=fe.port)
    try:
        x = np.ones(4, np.float32)
        np.testing.assert_allclose(cli.predict(x=x), 2.0 * x)
        np.testing.assert_allclose(cli.predict(model="b", x=x), 3.0 * x)
        frame = encode_items_bytes({"x": x})
        cases = [("/predict/b", FASTWIRE, frame, 3.0),
                 ("/predict", {**FASTWIRE, "X-Zoo-Model": "b"}, frame, 3.0),
                 ("/predict/a", {}, json.dumps(
                     {"inputs": {"x": x.tolist()}}).encode(), 2.0),
                 ("/predict", {}, json.dumps(
                     {"model": "b", "inputs": {"x": x.tolist()}}).encode(),
                  3.0)]
        for path, headers, body, scale in cases:
            conn.request("POST", path, body, headers)
            resp = conn.getresponse()
            blob = resp.read()
            assert resp.status == 200, (path, blob)
            if headers:
                from analytics_zoo_tpu_torch.serving.codec import (
                    decode_items_bytes)
                got = decode_items_bytes(blob)["prediction"]
            else:
                got = np.asarray(json.loads(blob)["prediction"])
            np.testing.assert_allclose(got, scale * x)
        bad = [("/predict/a%2Fb", FASTWIRE, frame),
               ("/predict", {**FASTWIRE, "X-Zoo-Model": "x\x01"}, frame),
               ("/predict", {}, json.dumps(
                   {"model": 7, "inputs": {"x": x.tolist()}}).encode())]
        for path, headers, body in bad:
            try:
                conn.request("POST", path, body, headers)
            except ValueError:      # http.client refuses the header
                continue
            resp = conn.getresponse()
            resp.read()
            assert resp.status == 400, path
        conn.request("POST", "/predict/nope", frame, FASTWIRE)
        resp = conn.getresponse()
        assert resp.status == 500 and b"unknown model" in resp.read()
        # the keep-alive connection still serves
        conn.request("POST", "/predict/a", frame, FASTWIRE)
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 200
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        assert 'zoo_model_records_total{model="b"}' in text
    finally:
        conn.close()
        fe.stop()
        serving.stop()
        reg.stop()
