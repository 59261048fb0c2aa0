"""The native-queue and Redis brokers and ``get_broker`` against the JAX
package's.

``NativeQueueBroker`` runs one command script through both packages (each
over its own copy of the C++ queue) and must observe the same results:
bytes carried verbatim, the read cache, ``keys`` and the singleton reset
on ``close``.  ``RedisBroker`` runs against a stub ``redis`` module (an
in-memory ``Redis.from_url`` with the commands the broker sends), which
the tests install in ``sys.modules``: the port must write the same wire
values as the JAX broker, and read back what it was given.
"""

import sys
import types

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from analytics_zoo_tpu.serving import broker as jbroker
from analytics_zoo_tpu_torch.serving import broker as tbroker


# ---- NativeQueueBroker -----------------------------------------------------

def _native_script(mod):
    b = mod.NativeQueueBroker()
    out = []
    try:
        b.xgroup_create("s", "g")
        sids = [b.xadd("s", {"uri": f"u{i}", "data": bytes([i]) * 3,
                             "deadline_ts": "1.5"}) for i in range(3)]
        b.xadd("other", {"uri": "o1"})
        out.append(sids)
        out.append(b.xreadgroup("s", "g", "c", count=2, block_ms=20))
        out.append(b.xreadgroup("s", "g", "c", count=8, block_ms=20))
        out.append(b.xreadgroup("s", "g", "c", count=8, block_ms=20))
        out.append(b.xack("s", "g", *sids))
        b.delete_stream("other")
        out.append(b.xreadgroup("other", "g", "c", block_ms=20))
        b.set_results({"result:u0": {"value": b"\x00\xff"},
                       "result:u1": {"error": "boom", "code": "shed"}})
        out.append(b.wait_result("result:u0", 1.0))
        out.append(b.wait_result("result:none", 0.02))
        out.append(b.hgetall("result:u0"))
        out.append(b.hgetall("result:u0"))          # the read cache
        b.hset("result:u1", {"scope": "tenant"})
        out.append(b.hgetall("result:u1"))
        out.append(sorted(b.keys("result:*")))
        b.delete("result:u0")
        out.append(b.hgetall("result:u0"))
        out.append(sorted(b.keys("result:*")))
    finally:
        b.close()
    return out


def test_native_broker_script_matches_jax():
    got = _native_script(tbroker)
    assert got == _native_script(jbroker)
    assert [f["data"] for _, f in got[1] + got[2]] == [
        b"\x00" * 3, b"\x01" * 3, b"\x02" * 3]
    assert got[3] == [] and got[5] == []
    assert got[8] == got[9] == {"value": b"\x00\xff"}
    assert got[10] == {"error": "boom", "code": "shed", "scope": "tenant"}
    assert got[12] == {} and got[13] == ["result:u1"]


def test_native_read_cache_is_bounded_and_unread_results_survive(
        monkeypatch):
    monkeypatch.setattr(tbroker.NativeQueueBroker, "READ_CACHE_MAX", 2)
    b = tbroker.NativeQueueBroker()
    try:
        b.set_results({f"result:{i}": {"v": i} for i in range(5)})
        for i in range(3):
            assert b.hgetall(f"result:{i}") == {"v": i}
        # result:0 fell out of the read cache: taken once, gone
        assert b.hgetall("result:0") == {}
        assert b.hgetall("result:2") == {"v": 2}
        # the unread ones are still in the C++ table
        assert b.hgetall("result:4") == {"v": 4}
        assert "result:0" not in b.keys()
    finally:
        b.close()


def test_native_singleton_resets_on_close():
    first = tbroker.get_broker("native://")
    assert tbroker.get_broker("native://") is first
    first.close()
    second = tbroker.get_broker("native://")
    try:
        assert second is not first
        with pytest.raises(RuntimeError, match="closed"):
            first.xadd("s", {"uri": "x"})
        second.xadd("s", {"uri": "y"})
        assert [f["uri"] for _, f in
                second.xreadgroup("s", "g", "c", block_ms=20)] == ["y"]
    finally:
        second.close()


# ---- the Redis wire values -------------------------------------------------

_values = st.one_of(
    st.binary(max_size=64), st.text(max_size=64),
    st.text(max_size=32).map(lambda t: "=b64=" + t),
    st.text(max_size=32).map(lambda t: "=str=" + t),
    st.integers(), st.floats(allow_nan=False))


@settings(max_examples=300, deadline=None, database=None)
@given(_values)
def test_wire_values_match_jax_and_round_trip(v):
    wire = tbroker.redis_wire_value(v)
    assert wire == jbroker.redis_wire_value(v)
    assert type(wire) is type(jbroker.redis_wire_value(v))
    back = tbroker.redis_unwire_value(wire)
    assert back == jbroker.redis_unwire_value(wire)
    assert back == (bytes(v) if isinstance(v, (bytes, bytearray)) else v)
    assert type(back) is (bytes if isinstance(v, (bytes, bytearray))
                          else type(v))


def test_unwire_leaves_foreign_sentinel_strings_alone():
    for v in ("=b64=not base64!", "=b64=", "plain"):
        assert tbroker.redis_unwire_value(v) == \
            jbroker.redis_unwire_value(v)
    assert tbroker.redis_unwire_value("=b64=not base64!") == \
        "=b64=not base64!"


# ---- RedisBroker over a stub redis module ----------------------------------

def _enc(v) -> bytes:
    return v if isinstance(v, bytes) else str(v).encode()


class _StubRedis:
    """The redis-py calls ``RedisBroker`` makes, over dicts, answering in
    bytes as redis-py does."""

    def __init__(self, url):
        self.url = url
        self.streams, self.groups, self.hashes = {}, {}, {}
        self.seq = 0

    @classmethod
    def from_url(cls, url):
        inst = cls(url)
        _StubRedis.last = inst
        return inst

    def xadd(self, stream, fields):
        self.seq += 1
        sid = f"{self.seq}-0".encode()
        self.streams.setdefault(stream, []).append(
            (sid, {_enc(k): _enc(v) for k, v in fields.items()}))
        return sid

    def xgroup_create(self, stream, group, id="0", mkstream=False):
        if (stream, group) in self.groups:
            raise RuntimeError("BUSYGROUP Consumer Group name already "
                               "exists")
        self.streams.setdefault(stream, [])
        self.groups[(stream, group)] = 0

    def xreadgroup(self, group, consumer, streams, count=None, block=None):
        out = []
        for stream in streams:
            cur = self.groups.setdefault((stream, group), 0)
            entries = self.streams.get(stream, [])[cur:cur + count]
            self.groups[(stream, group)] = cur + len(entries)
            if entries:
                out.append((stream.encode(), entries))
        return out

    def xack(self, stream, group, *ids):
        return len(ids)

    def hset(self, key, mapping):
        self.hashes.setdefault(key, {}).update(
            {_enc(k): _enc(v) for k, v in mapping.items()})

    def hgetall(self, key):
        return dict(self.hashes.get(key, {}))

    def delete(self, key):
        self.hashes.pop(key, None)

    def keys(self, pattern="*"):
        prefix = pattern.rstrip("*")
        return [k.encode() for k in self.hashes if k.startswith(prefix)]

    def pipeline(self, transaction=True):
        stub, ops = self, []

        class _Pipe:
            def delete(self, key):
                ops.append(lambda: stub.delete(key))

            def hset(self, key, mapping):
                ops.append(lambda: stub.hset(key, mapping))

            def execute(self):
                return [op() for op in ops]
        return _Pipe()


@pytest.fixture
def stub_redis(monkeypatch):
    mod = types.ModuleType("redis")
    mod.Redis = _StubRedis
    monkeypatch.setitem(sys.modules, "redis", mod)
    return mod


def _redis_script(mod):
    b = mod.RedisBroker("redis://stub:1")
    stub = _StubRedis.last
    out = []
    b.xgroup_create("s", "g")
    b.xgroup_create("s", "g")                  # BUSYGROUP is swallowed
    out.append(b.xadd("s", {"uri": "u1", "data": b"\x00\x01frame",
                            "trace_ctx": "=str=hostile"}))
    out.append(b.xadd("s", {"uri": "u2", "data": "legacy-b64-string"}))
    out.append(b.xreadgroup("s", "g", "c", count=8, block_ms=10))
    out.append(b.xack("s", "g", "1-0", "2-0"))
    b.hset("result:u1", {"value": b"\x07\x08"})
    b.set_results({"result:u2": {"error": "x", "code": "expired"},
                   "result:u3": {"value": b"=b64=raw"}})
    out.append([b.hgetall(f"result:u{i}") for i in (1, 2, 3, 4)])
    out.append(sorted(b.keys("result:*")))
    b.delete("result:u3")
    out.append(sorted(b.keys("result:*")))
    return out, stub.streams, stub.hashes


def test_redis_broker_writes_the_jax_wire_values(stub_redis):
    got, streams, hashes = _redis_script(tbroker)
    want, jstreams, jhashes = _redis_script(jbroker)
    assert got == want
    assert streams == jstreams and hashes == jhashes
    read = got[2]
    assert read[0][1] == {"uri": "u1", "data": b"\x00\x01frame",
                          "trace_ctx": "=str=hostile"}
    assert read[1][1]["data"] == "legacy-b64-string"
    # on the wire: strings only, bytes wrapped, a hostile string escaped
    assert streams["s"][0][1][b"data"].startswith(b"=b64=")
    assert streams["s"][0][1][b"trace_ctx"] == b"=str==str=hostile"
    assert got[4] == [{"value": b"\x07\x08"},
                      {"error": "x", "code": "expired"},
                      {"value": b"=b64=raw"}, {}]


def test_get_broker_routes_each_scheme(stub_redis):
    assert isinstance(tbroker.get_broker(None), tbroker.InMemoryBroker)
    assert tbroker.get_broker("memory://") is tbroker.get_broker(None)
    r = tbroker.get_broker("redis://cache:6379/0")
    assert isinstance(r, tbroker.RedisBroker)
    assert _StubRedis.last.url == "redis://cache:6379/0"
    n = tbroker.get_broker("native://")
    try:
        assert isinstance(n, tbroker.NativeQueueBroker)
    finally:
        n.close()
    from analytics_zoo_tpu_torch.serving.fleet import RemoteBroker
    f = tbroker.get_broker("fleet://10.1.2.3:4567")
    assert isinstance(f, RemoteBroker) and f.address == ("10.1.2.3", 4567)
    host, number = tbroker.get_broker("fleet://:4567").address
    assert host == "127.0.0.1" and number == 4567     # nothing binds it


def test_the_serving_stack_runs_over_the_native_broker():
    """``InputQueue`` -> pipelined ``ClusterServing`` -> ``OutputQueue``
    over ``native://``: frames verbatim, every answer back."""
    from analytics_zoo_tpu_torch.common.config import ServingConfig
    from analytics_zoo_tpu_torch.serving.client import (
        InputQueue, OutputQueue)
    from analytics_zoo_tpu_torch.serving.engine import ClusterServing

    class Twice:
        concurrency = 1

        def predict_async(self, x):
            # a single-input record reaches the model as its array
            return np.asarray(x, np.float32) * 2

        def fetch(self, pending):
            return pending
    broker = tbroker.get_broker("native://")
    serving = ClusterServing(Twice(), ServingConfig(
        redis_url="native://", max_batch=8, linger_ms=1.0,
        decode_workers=1)).start()
    try:
        assert serving.broker is broker
        iq, oq = InputQueue(broker=broker), OutputQueue(broker=broker)
        xs = {f"n{i}": np.full((3,), i, np.float32) for i in range(12)}
        for uri, x in xs.items():
            iq.enqueue(uri, x=x)
        for uri, x in xs.items():
            np.testing.assert_array_equal(
                oq.query_blocking(uri, timeout=10), x * 2)
    finally:
        serving.stop()
        broker.close()
