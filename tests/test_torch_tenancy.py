"""Tenancy in the port: per-tenant credit pools, the weighted scheduler
and the wire ``tenant`` field, on the CPU.

The scheduler and the policies are held to the JAX package's under the
same call sequences.  The engine runs a small fake model behind the
in-memory broker (and the HTTP frontend on port 0): a tenant flooding
past its credits is shed at its own gate with ``scope=tenant`` while the
other tenant is served in full, and the per-tenant books account every
request.  No test measures a rate or a time.
"""

import threading
import time

import numpy as np
import pytest

from analytics_zoo_tpu.serving import tenancy as J
from analytics_zoo_tpu_torch.common.config import ServingConfig
from analytics_zoo_tpu_torch.serving import tenancy as T
from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
from analytics_zoo_tpu_torch.serving.client import (
    FastWireHttpClient, InputQueue, OutputQueue, ServingError,
    ServingShedError)
from analytics_zoo_tpu_torch.serving.engine import ClusterServing
from analytics_zoo_tpu_torch.serving.http_frontend import ServingFrontend
from analytics_zoo_tpu_torch.serving.model_zoo import ModelRegistry
from analytics_zoo_tpu_torch.testing import chaos


class _FakeModel:
    concurrency = 2

    def __init__(self, gate=None):
        self.gate = gate

    def predict_async(self, x):
        if self.gate is not None:
            assert self.gate.wait(10.0)
        arr = x if isinstance(x, np.ndarray) else next(iter(x.values()))
        return np.asarray(arr, np.float32) * 2.0

    def fetch(self, pending):
        return pending


def _cfg(tenants, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("linger_ms", 1.0)
    kw.setdefault("decode_workers", 1)
    return ServingConfig(tenants=tenants, **kw)


def _sequence(mod):
    ws = mod.WeightedScheduler()
    out = [ws.order(["b", "a"])]
    for name, n, w in (("a", 3, 3.0), ("b", 1, 1.0), ("b", 1, 1.0),
                       ("a", 6, 3.0), ("c", 2, 0.5)):
        ws.charge(name, n, w)
        out.append(ws.order(["a", "b", "c"]))
    return out


def test_scheduler_and_policies_equal_jax():
    assert _sequence(T) == _sequence(J)
    for mod in (T, J):
        for bad in (lambda: mod.TenantPolicy("bad\x1fname"),
                    lambda: mod.TenantPolicy("a", credits=0),
                    lambda: mod.TenantPolicy("a", weight=0.0),
                    lambda: mod.TenancyController(
                        [mod.TenantPolicy("a"), mod.TenantPolicy("a")])):
            with pytest.raises(ValueError):
                bad()
    rows = (("gold", 64, 2.0), ("free", 8))
    t = T.TenancyController.from_config(rows)
    j = J.TenancyController.from_config(rows)
    assert t.tenants() == j.tenants()
    assert t.usage() == j.usage()
    assert T.TenancyController.from_config(None) is None


def test_flooding_tenant_is_shed_at_its_own_gate():
    # the model holds every dispatch until the flood has met the gate, so
    # what is admitted and what is shed does not depend on timing
    gate = threading.Event()
    model = _FakeModel(gate)
    broker = InMemoryBroker()
    s = ClusterServing(model, _cfg((("noisy", 2, 1.0), ("quiet", 8, 1.0))),
                       broker=broker).start()
    iq, oq = InputQueue(broker=broker), OutputQueue(broker=broker)
    try:
        x = np.ones((2,), np.float32)
        for i in range(20):
            iq.enqueue_items(f"n-{i}", {"x": x}, tenant="noisy")
        for i in range(6):
            iq.enqueue_items(f"q-{i}", {"x": x}, tenant="quiet")
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            u = s.tenancy.usage()
            if u["noisy"]["shed"] == 18 and u["quiet"]["admitted"] == 6:
                break
            time.sleep(0.01)
        gate.set()
        served, scopes = 0, set()
        for i in range(20):
            try:
                served += oq.query_blocking(f"n-{i}", timeout=10.0) \
                    is not None
            except ServingShedError as exc:
                scopes.add(exc.scope)
        for i in range(6):
            np.testing.assert_allclose(
                oq.query_blocking(f"q-{i}", timeout=10.0), 2.0 * x)
    finally:
        gate.set()
        s.stop()
    assert served == 2 and scopes == {"tenant"}
    u = s.tenancy.usage()
    assert u["noisy"]["admitted"] == u["noisy"]["served"] == 2
    assert u["noisy"]["shed"] == 18
    assert u["quiet"]["served"] == u["quiet"]["admitted"] == 6
    assert u["quiet"]["shed"] == u["quiet"]["errors"] == 0
    assert u["noisy"]["in_flight"] == u["quiet"]["in_flight"] == 0
    assert s.metrics()["tenants"] == u


def test_unknown_and_default_tenants_and_admit_fault():
    broker = InMemoryBroker()
    s = ClusterServing(_FakeModel(), _cfg((("default", 32, 1.0),
                                           ("vip", 32, 4.0))),
                       broker=broker)
    inj = chaos.ChaosInjector()
    inj.plan("tenant_admit", fault="raise", at=[1])
    iq, oq = InputQueue(broker=broker), OutputQueue(broker=broker)
    with chaos.installed(inj):
        s.start()
        try:
            iq.enqueue_batch_items([f"d-{i}" for i in range(4)],
                                   {"x": np.ones((4, 2), np.float32)})
            iq.enqueue_items("faulted", {"x": np.ones(2, np.float32)},
                             tenant="vip")
            iq.enqueue_batch_items([f"v-{i}" for i in range(4)],
                                   {"x": np.ones((4, 2), np.float32)},
                                   tenant="vip")
            iq.enqueue_items("x-1", {"x": np.ones(2, np.float32)},
                             tenant="nobody")
            for i in range(4):
                assert oq.query_blocking(f"d-{i}", timeout=10.0) is not None
                assert oq.query_blocking(f"v-{i}", timeout=10.0) is not None
            with pytest.raises(ServingError, match="tenant admission"):
                oq.query_blocking("faulted", timeout=10.0)
            with pytest.raises(ServingError, match="unknown tenant"):
                oq.query_blocking("x-1", timeout=10.0)
        finally:
            s.stop()
    assert inj.injected("tenant_admit") == 1
    u = s.tenancy.usage()
    assert sorted(u) == ["default", "vip"]
    assert u["default"]["served"] == u["default"]["admitted"] == 4
    assert u["vip"]["served"] == u["vip"]["admitted"] == 4
    assert u["vip"]["in_flight"] == 0


def test_tenant_rides_the_http_wire_and_config_rules():
    broker = InMemoryBroker()
    s = ClusterServing(_FakeModel(), _cfg((("alpha", 16, 1.0),)),
                       broker=broker).start()
    fe = ServingFrontend(s, port=0).start()
    cli = FastWireHttpClient(port=fe.port, timeout=20)
    try:
        out = cli.predict(uri="h-1", tenant="alpha",
                          x=np.ones((3,), np.float32))
        assert np.allclose(out, 2.0)
        with pytest.raises(ServingError, match="unknown tenant"):
            cli.predict(uri="h-2", tenant="ghost",
                        x=np.ones((3,), np.float32))
    finally:
        fe.stop()
        s.stop()
    assert s.tenancy.usage()["alpha"]["served"] == 1
    ctl = T.TenancyController([T.TenantPolicy("a")])
    assert ClusterServing(_FakeModel(), ServingConfig(),
                          broker=InMemoryBroker(),
                          tenancy=ctl).tenancy is ctl
    with pytest.raises(ValueError, match="pipelined"):
        ClusterServing(_FakeModel(), ServingConfig(pipeline=False),
                       broker=InMemoryBroker(), tenancy=ctl)
    reg = ModelRegistry()
    try:
        with pytest.raises(ValueError, match="registry"):
            ClusterServing(reg, ServingConfig(), broker=InMemoryBroker(),
                           tenancy=ctl)
    finally:
        reg.stop()
