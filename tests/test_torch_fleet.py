"""The multi-process serving fleet against the JAX package's.

- ``partition_for`` / ``partition_stream``: the same partition for 10,000
  seeded uris at every partition count.
- The bridge wire: bytes verbatim, ``wait_hgetall`` in one round trip, the
  snapshot and control channels, and a port ``RemoteBroker`` talking to a
  JAX ``BrokerBridge`` and the reverse, in one process.
- ``merge_snapshots`` and ``fleet_queue_signal`` equal the JAX functions'
  on the same snapshots; ``FleetRouter`` and ``ReplicaAutoscaler`` make
  the same decisions under one injected clock and one signal trace.
- One fleet worker in this process: a ``ServingFrontend`` with a
  ``FleetRouter`` over a bridge and two engines on the partition streams
  answers JSON and fast-wire requests identically, inside a
  ``fleet.route`` span.
- ``FleetSupervisor.start`` refuses to fork once CUDA is initialised.

Marked ``slow`` (several processes each): the supervisor end to end with
numpy models, ``kill_replica`` and the durable fleet's
``kill_broker_owner``.
"""

import dataclasses
import http.client
import json
import pickle
import threading
import time

import numpy as np
import pytest

from analytics_zoo_tpu import observability as jobs
from analytics_zoo_tpu.serving import broker as jbroker
from analytics_zoo_tpu.serving import fleet as jfleet
from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common.config import FleetConfig, ServingConfig
from analytics_zoo_tpu_torch.serving import broker as tbroker
from analytics_zoo_tpu_torch.serving import fleet as tfleet
from analytics_zoo_tpu_torch.serving.client import (
    FastWireHttpClient, InputQueue, OutputQueue, ServingError,
    ServingShedError)
from analytics_zoo_tpu_torch.serving.codec import encode_items_bytes
from analytics_zoo_tpu_torch.serving.engine import ClusterServing
from analytics_zoo_tpu_torch.serving.fleet import (
    BrokerBridge, FleetContext, FleetRouter, FleetSupervisor, RemoteBroker,
    partition_for, partition_stream)
from analytics_zoo_tpu_torch.serving.http_frontend import ServingFrontend


class Twice:
    """numpy-only ``predict_async`` / ``fetch`` model: fork-safe (no
    torch op runs in a forked replica)."""

    concurrency = 2

    def __init__(self, delay_s: float = 0.0):
        self.delay_s = delay_s

    def predict_async(self, x):
        if self.delay_s:
            time.sleep(self.delay_s)
        arr = x if isinstance(x, np.ndarray) else next(iter(x.values()))
        return np.asarray(arr, np.float32) * 2.0

    def fetch(self, pending):
        return pending


def _scfg(**kw):
    return ServingConfig(redis_url="memory://", max_batch=16, linger_ms=1.0,
                         decode_workers=1, **kw)


# ---- partitioning ------------------------------------------------------------

def test_partition_for_matches_jax_on_seeded_uris():
    rng = np.random.default_rng(0)
    uris = [f"req-{int(v):x}" for v in rng.integers(0, 2 ** 62, 10_000)]
    for n in (1, 2, 3, 4, 7, 16):
        got = [partition_for(u, n) for u in uris]
        assert got == [jfleet.partition_for(u, n) for u in uris]
        assert set(got) == set(range(n))
    assert partition_stream("serving_stream", 3) == \
        jfleet.partition_stream("serving_stream", 3) == "serving_stream.p3"


# ---- the bridge wire ---------------------------------------------------------

def _wire_script(bridge_mod, broker_mod, client_mod):
    """One script through ``client_mod.RemoteBroker`` against
    ``bridge_mod.BrokerBridge`` over ``broker_mod.InMemoryBroker``."""
    bridge = bridge_mod.BrokerBridge(broker_mod.InMemoryBroker(),
                                     port=0).start()
    rb = client_mod.RemoteBroker(bridge.address)
    out = []
    try:
        frame = b"\x00\xffraw-frame\x1f"
        rb.xgroup_create("s", "g")
        rb.xadd("s", {"uri": "u1", "data": frame, "deadline_ts": "123.5",
                      "trace_ctx": "7-9", "dedup_id": "d-1"})
        out.append([f for _, f in rb.xreadgroup("s", "g", "c",
                                                block_ms=50)])
        rb.set_results({"result:u1": {"value": frame, "code": "ok"}})
        out.append(rb.wait_result("result:u1", 1.0))
        out.append(rb.wait_hgetall("result:u1", 1.0))
        out.append(rb.wait_hgetall("result:miss", 0.02))
        out.append(rb.keys("result:*"))
        rb.hset("result:u1", {"scope": "tenant"})
        out.append(rb.hgetall("result:u1"))
        rb.delete("result:u1")
        out.append(rb.hgetall("result:u1"))
        rb.ctl_set("active_partitions", 3)
        out.append(rb.ctl_get("active_partitions"))
        out.append(rb.ctl_all())
        rb.snap_put("replica-0", b"blob")
        out.append(rb.snap_all()["replica-0"][0])
        with pytest.raises(RuntimeError, match="does not proxy"):
            rb._call("shutdown")
        out.append(rb.ping())                 # the connection survives
        out.append(rb.pending("s", "g"))      # None: no ledger here
    finally:
        rb.close()
        bridge.stop()
    return out


@pytest.mark.parametrize("bridge_mod,broker_mod,client_mod", [
    (tfleet, tbroker, tfleet), (jfleet, jbroker, tfleet),
    (tfleet, tbroker, jfleet)],
    ids=["port", "port-client-jax-bridge", "jax-client-port-bridge"])
def test_bridge_wire_matches_jax(bridge_mod, broker_mod, client_mod):
    got = _wire_script(bridge_mod, broker_mod, client_mod)
    assert got == _wire_script(jfleet, jbroker, jfleet)
    assert got[0] == [{"uri": "u1", "data": b"\x00\xffraw-frame\x1f",
                       "deadline_ts": "123.5", "trace_ctx": "7-9",
                       "dedup_id": "d-1"}]
    assert got[2] == {"value": b"\x00\xffraw-frame\x1f", "code": "ok"}
    assert got[3] == {} and got[7] == 3


def test_wait_hgetall_is_one_round_trip():
    bridge = BrokerBridge(tbroker.InMemoryBroker(), port=0).start()
    calls = []
    inner = bridge._dispatch
    bridge._dispatch = lambda m, a: (calls.append(m), inner(m, a))[1]
    rb = RemoteBroker(bridge.address)
    try:
        def later():
            time.sleep(0.05)
            bridge.broker.set_results(
                {"result:x": {"error": "boom", "code": "error"}})
        threading.Thread(target=later, daemon=True).start()
        oq = OutputQueue(broker=rb)
        rb.ping()                       # connect before counting
        calls.clear()
        with pytest.raises(ServingError, match="boom"):
            oq.query_blocking("x", timeout=2.0)
        assert calls == ["wait_hgetall"]      # the wait and the read
    finally:
        rb.close()
        bridge.stop()


def test_wait_hgetall_polls_a_broker_without_wait_result():
    class PollOnly:
        def __init__(self):
            self.h = {}

        def hgetall(self, key):
            return dict(self.h.get(key, {}))
    broker = PollOnly()
    bridge = BrokerBridge(broker, port=0).start()
    rb = RemoteBroker(bridge.address)
    try:
        t0 = time.monotonic()
        assert rb.wait_hgetall("result:miss", 0.2) == {}
        assert time.monotonic() - t0 >= 0.15
        threading.Timer(0.05, lambda: broker.h.update(
            {"result:x": {"value": b"v"}})).start()
        assert rb.wait_hgetall("result:x", 2.0) == {"value": b"v"}
    finally:
        rb.close()
        bridge.stop()


def test_concurrent_clients_use_their_own_sockets():
    bridge = BrokerBridge(tbroker.InMemoryBroker(), port=0).start()
    rb = RemoteBroker(bridge.address)
    errs = []

    def worker(tid):
        try:
            for i in range(50):
                rb.xadd("s", {"uri": f"{tid}-{i}"})
        except Exception as exc:           # pragma: no cover
            errs.append(exc)
    try:
        ts = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
        [t.start() for t in ts]
        [t.join(timeout=30) for t in ts]
        assert not errs
        got = rb.xreadgroup("s", "g", "c", count=1024, block_ms=50)
        assert len(got) == 400
    finally:
        rb.close()
        bridge.stop()


# ---- snapshot merge and the queue signal -------------------------------------

def _snapshots():
    """Registries of three processes, the same in both packages' hands
    (the snapshot is plain data)."""
    rng = np.random.default_rng(3)
    snaps = []
    for k in range(3):
        reg = obs.MetricsRegistry()
        reg.counter("zoo_serving_records_total", "h").inc(
            float(rng.integers(1, 50)))
        reg.counter("zoo_fleet_routed_total", "h", ["partition"]).labels(
            partition=str(k % 2)).inc(float(rng.integers(1, 9)))
        reg.gauge("zoo_serving_queue_depth", "h", ["queue"]).labels(
            queue="raw").set(float(rng.integers(0, 20)))
        reg.gauge("zoo_serving_queue_high_water", "h", ["queue"]).labels(
            queue="raw").set(float(rng.integers(0, 40)))
        reg.gauge("zoo_resilience_admission_in_flight", "h",
                  ["controller"]).labels(controller="serving").set(
            float(rng.integers(0, 30)))
        reg.gauge("zoo_fleet_active_replicas", "h").set(2.0 + (k == 1))
        reg.gauge("zoo_fleet_workers", "h").set(2.0)
        h = reg.histogram("zoo_t_lat", "h", buckets=(0.01, 0.1, 1.0))
        for v in rng.exponential(0.1, 20):
            h.observe(float(v))
        if k == 2:
            reg.histogram("zoo_t_lat2", "h", buckets=(0.5,)).observe(0.2)
        snaps.append(reg.snapshot())
    return snaps


def test_merge_snapshots_matches_jax():
    snaps = _snapshots()
    got = tfleet.merge_snapshots(pickle.loads(pickle.dumps(snaps)))
    assert got == jfleet.merge_snapshots(pickle.loads(pickle.dumps(snaps)))
    assert got["zoo_fleet_active_replicas"]["series"][()] == 3.0   # max
    assert got["zoo_fleet_workers"]["series"][()] == 2.0
    assert got["zoo_serving_records_total"]["series"][()] == sum(
        s["zoo_serving_records_total"]["series"][()] for s in snaps)
    assert obs.render_snapshot(got) == jobs.render_snapshot(got)


def test_fleet_queue_signal_matches_jax():
    snaps = _snapshots()
    for prev in (0.0, 10.0, 500.0):
        assert tfleet.fleet_queue_signal(snaps, prev) == \
            jfleet.fleet_queue_signal(snaps, prev)


# ---- router and autoscaler decisions -----------------------------------------

def _router_trace(fleet_mod, broker_mod, client_mod):
    """One scripted trace of routes and outcomes under an injected clock;
    each step's decision (partition, probe) or refusal, in order."""
    now = [0.0]
    r = fleet_mod.FleetRouter(broker_mod.InMemoryBroker(), stream="s",
                              partitions=3, refresh_s=3600.0, latch_s=0.5,
                              breaker_failure_threshold=2,
                              breaker_recovery_s=2.0,
                              clock=lambda: now[0])
    rng = np.random.default_rng(4)
    out = []
    for step in range(400):
        now[0] += float(rng.exponential(0.05))
        op = rng.integers(0, 10)
        p = int(rng.integers(0, 3))
        if op < 6:
            uri = f"u{int(rng.integers(0, 64))}"
            try:
                part, q, probe = r.route(uri)
                out.append(("route", part, probe, q.stream))
            except client_mod.ServingShedError:
                out.append(("shed",))
            except RuntimeError as exc:
                out.append(("dead", str(exc)[:20]))
        elif op < 8:
            r.note_result(p, timed_out=True)
        elif op < 9:
            r.note_shed(p)
        else:
            r.note_result(p, timed_out=False)
        if step == 200:
            r.set_active(2)
    return out


def test_router_decisions_match_jax():
    from analytics_zoo_tpu.serving import client as jclient
    from analytics_zoo_tpu_torch.serving import client as tclient
    got = _router_trace(tfleet, tbroker, tclient)
    assert got == _router_trace(jfleet, jbroker, jclient)
    kinds = {o[0] for o in got}
    assert {"route", "shed"} <= kinds
    assert any(o[0] == "route" and o[2] for o in got)      # probes
    assert any(o[0] == "route" and o[1] != partition_for(
        "u0", 3) for o in got)


def _autoscaler_trace(fleet_mod):
    now = [0.0]
    a = fleet_mod.ReplicaAutoscaler(min_replicas=1, max_replicas=4,
                                    high=10.0, low=1.0, up_sustain_s=2.0,
                                    down_sustain_s=4.0, cooldown_s=3.0,
                                    clock=lambda: now[0])
    rng = np.random.default_rng(5)
    replicas, out = 1, []
    for t in range(300):
        now[0] = t * 0.25
        phase = (t // 60) % 3
        signal = float(rng.uniform(*((12, 40), (0, 0.5), (2, 9))[phase]))
        replicas = a.tick(signal, replicas)
        out.append(replicas)
    return out


def test_autoscaler_decisions_match_jax():
    got = _autoscaler_trace(tfleet)
    assert got == _autoscaler_trace(jfleet)
    assert max(got) > 1 and min(got[120:]) == 1


# ---- one fleet worker in this process ----------------------------------------

def test_a_fleet_worker_answers_json_and_fastwire_identically():
    broker = tbroker.InMemoryBroker()
    bridge = BrokerBridge(broker, port=0).start()
    bridge.ctl_set("active_partitions", 2)
    cfg = _scfg()
    engines, fe = [], None
    try:
        for k in range(2):
            engines.append(ClusterServing(
                Twice(), dataclasses.replace(
                    cfg, input_stream=partition_stream(cfg.input_stream, k)),
                broker=RemoteBroker(bridge.address)).start())
        wb = RemoteBroker(bridge.address)
        router = FleetRouter(wb, stream=cfg.input_stream, partitions=2,
                             refresh_s=0.05)
        fe = ServingFrontend(
            broker=wb, config=cfg, stream=cfg.input_stream, router=router,
            fleet=FleetContext(wb, self_name="frontend-0"),
            worker_id="frontend-0", port=0).start()
        obs.get_tracer().clear()
        fw = FastWireHttpClient(port=fe.port, timeout=30)
        conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=30)
        rng = np.random.default_rng(6)
        xs = {f"w-{i}": rng.standard_normal(4).astype(np.float32)
              for i in range(16)}
        for uri, x in xs.items():
            want = x * 2.0
            np.testing.assert_array_equal(fw.predict(uri=uri, x=x), want)
            conn.request("POST", "/predict", json.dumps(
                {"uri": "json-" + uri, "inputs": {"x": x.tolist()}}),
                {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            assert resp.status == 200
            assert resp.headers["X-Zoo-Fleet-Worker"] == "frontend-0"
            np.testing.assert_array_equal(
                np.asarray(body["prediction"], np.float32), want)
        routed = obs.get_tracer().export(name="fleet.route")
        assert len(routed) == 32
        parts = {s["attrs"]["partition"] for s in routed}
        assert parts == {0, 1}
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        assert "zoo_fleet_routed_total" in text
        conn.close()
        fw.close()
    finally:
        if fe is not None:
            fe.stop()
        for e in engines:
            e.stop()
        bridge.stop()


def test_supervisor_refuses_to_fork_after_cuda_init(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    sup = FleetSupervisor(Twice, _scfg(), FleetConfig(), http_port=0)
    with pytest.raises(RuntimeError, match="before anything initialises "
                                           "CUDA"):
        sup.start()
    assert sup.bridge is None and not sup._replicas


# ---- process fleets (slow) ---------------------------------------------------

def _fleet(workers=2, replicas=2, fcfg=None):
    fcfg = fcfg or FleetConfig(snapshot_interval_s=0.15)
    fcfg.frontend_workers, fcfg.replicas = workers, replicas
    return FleetSupervisor(lambda: Twice(), _scfg(), fcfg, http_port=0,
                           autoscale=False).start()


@pytest.mark.slow
def test_supervisor_serves_over_one_port_with_the_fleet_trace():
    sup = _fleet()
    try:
        port = sup.http_port
        assert port != 0
        fw = FastWireHttpClient(port=port, timeout=30)
        for i in range(24):
            out = fw.predict(uri=f"e2e-{i}",
                             x=np.full((3,), float(i), np.float32))
            np.testing.assert_array_equal(out, np.full((3,), 2.0 * i))
        ctx = obs.new_trace_context()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=15)
        conn.request("POST", "/predict",
                     encode_items_bytes({"x": np.ones((4,), np.float32)}),
                     {"Content-Type": "application/x-zoo-fastwire",
                      "X-Zoo-Uri": "traced-1",
                      "X-Zoo-Trace": obs.encode_trace_context(ctx)})
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 200
        assert resp.headers["X-Zoo-Fleet-Worker"].startswith("frontend-")
        want = {"http.predict", "fleet.route", "serving.decode",
                "serving.dispatch", "serving.sink"}
        names, deadline = set(), time.monotonic() + 15
        while time.monotonic() < deadline and not want <= names:
            conn.request("GET", f"/spans?trace_id={ctx[0]}")
            spans = json.loads(conn.getresponse().read())["spans"]
            names = {s["name"] for s in spans}
            time.sleep(0.2)
        assert names == want
        served, deadline = 0.0, time.monotonic() + 10
        while time.monotonic() < deadline and served < 25:
            conn.request("GET", "/metrics")
            body = conn.getresponse().read().decode()
            served = sum(float(line.rsplit(" ", 1)[1])
                         for line in body.splitlines()
                         if line.startswith("zoo_serving_records_total"))
            time.sleep(0.2)
        assert served == 25 and "zoo_fleet_workers" in body
        conn.close()
    finally:
        sup.stop()


@pytest.mark.slow
def test_kill_replica_opens_its_breaker_and_diverts():
    fcfg = FleetConfig(snapshot_interval_s=0.15, breaker_failure_threshold=2,
                       breaker_recovery_s=60.0)
    sup = _fleet(workers=1, replicas=2, fcfg=fcfg)
    try:
        fw = FastWireHttpClient(port=sup.http_port, timeout=30)
        homed1 = [f"u{i}" for i in range(200)
                  if partition_for(f"u{i}", 2) == 1][:12]
        sup.kill_replica(1)
        ok = fail = 0
        for u in homed1:
            try:
                out = fw.predict(uri=u, deadline_ms=800,
                                 x=np.ones((2,), np.float32))
                np.testing.assert_array_equal(out, [2.0, 2.0])
                ok += 1
            except ServingError:
                fail += 1
        assert fail <= 2 and ok == len(homed1) - fail, (ok, fail)
    finally:
        sup.stop()


@pytest.mark.slow
def test_durable_fleet_survives_kill_broker_owner(tmp_path):
    fcfg = FleetConfig(frontend_workers=1, replicas=2,
                       snapshot_interval_s=0.2, durable=True,
                       wal_dir=str(tmp_path), failover_poll_s=0.2,
                       redeliver_idle_s=1.5)
    sup = FleetSupervisor(lambda: Twice(), _scfg(), fcfg, http_port=0,
                          autoscale=False).start()
    try:
        rb = RemoteBroker(sup.bridge.address)
        oq = OutputQueue(broker=rb)
        acked = {}

        def enqueue(uri, val):
            for _attempt in range(160):
                try:
                    InputQueue(broker=rb, stream=partition_stream(
                        "serving_stream", partition_for(uri, 2))
                    ).enqueue_items(uri, {"x": np.full((2,), val,
                                                       np.float32)})
                    acked[uri] = val
                    return True
                except Exception:
                    time.sleep(0.25)
            return False
        for i in range(12):
            assert enqueue(f"pre-{i}", float(i))
        sup.kill_broker_owner()
        for i in range(12):
            enqueue(f"mid-{i}", 100.0 + i)
        wrong = []
        for uri, val in sorted(acked.items()):
            got = None
            for _attempt in range(120):
                try:
                    got = oq.query_blocking(uri, timeout=5.0)
                except Exception:
                    got = None
                if got is not None:
                    break
                time.sleep(0.25)
            if got is None or not np.allclose(got, 2.0 * val):
                wrong.append((uri, val, got))
        assert len(acked) >= 18 and not wrong, wrong[:5]
        assert sup.last_failover_ms is not None
        deadline = time.monotonic() + 45
        while time.monotonic() < deadline:
            left = sum(len(rb.pending(partition_stream(
                "serving_stream", k), "serving") or {}) for k in range(2))
            if left == 0:
                break
            time.sleep(0.25)
        assert left == 0
    finally:
        sup.stop()


def test_shed_error_class_is_the_clients():
    # the router's front-door shed is the client's typed 429 error
    now = [0.0]
    r = FleetRouter(tbroker.InMemoryBroker(), stream="s", partitions=1,
                    refresh_s=3600.0, latch_s=1.0, clock=lambda: now[0])
    r.note_shed(0)
    with pytest.raises(ServingShedError, match="fleet overloaded"):
        r.route("u")
