"""The port's device-memory ledger against the JAX package's, on the CPU.

The same pool books (a dict-backed ``Books`` the tests mutate) go to both
packages' ``MemoryLedger``: snapshots, top-K attribution, pressure
watermark transitions, the confirm-on-second-read leak sentinel (one
``mem_leak`` dump per divergence episode), sampler rings and
``merge_memory_snapshots`` must agree (the merge byte for byte as JSON).
``device_memory_stats`` reads ``torch.cuda`` only where this process has
initialised CUDA: on the CPU it returns ``[]`` and initialises nothing.
Then the port's real pools: the paged KV cache's ``kv_blocks`` books
equal the JAX cache's under the same churn, a seeded block leak is found
in one sweep, an ``LLMServing`` run over ``DecoderLM.tiny`` leaves exact
books, and the estimator's ``train_state`` pool counts its parameter and
optimizer bytes from the tensors.  Tests call ``sample_once`` /
``reconcile_once`` and never wait on a sampler's period; every ledger is
stopped in a ``finally``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu import observability as jobs
from analytics_zoo_tpu.llm.kv_cache import PagedKVCache as JKV
from analytics_zoo_tpu_torch import observability as tobs
from analytics_zoo_tpu_torch.llm.kv_cache import PagedKVCache as TKV

BOTH = (jobs, tobs)


class Books:
    """A dict-backed pool whose figures the tests mutate directly."""

    def __init__(self, capacity=1000, used=0, pinned=0, blocks=0,
                 owners=None):
        self.d = {"capacity_bytes": capacity, "used_bytes": used,
                  "pinned_bytes": pinned, "blocks": blocks,
                  "owners": dict(owners if owners is not None
                                 else ({"a": used} if used else {}))}
        self.lines = []

    def set_used(self, used, owner="a"):
        self.d["used_bytes"] = used
        self.d["owners"] = {owner: used} if used else {}

    def snapshot(self):
        return dict(self.d)

    def reconcile(self):
        return list(self.lines)


@pytest.fixture
def leds(tmp_path):
    """Fresh default ledgers (threads not armed), recorders in their own
    directories and fresh registries, in both packages."""
    prev = [O.set_registry(O.MetricsRegistry()) for O in BOTH]
    ledgers = [O.configure_memory_ledger(
        sample_interval_s=0.01, reconcile_interval_s=0.02,
        confirm_delay_s=0.0, leak_dump_interval_s=0.0) for O in BOTH]
    recs = [O.configure_flight_recorder(dir=str(tmp_path / name))
            for O, name in zip(BOTH, ("jax", "torch"))]
    for O in BOTH:
        O.get_tracer().clear()
    try:
        yield ledgers, recs
    finally:
        for O, led, p in zip(BOTH, ledgers, prev):
            led.stop()
            O.configure_memory_ledger()
            O.configure_flight_recorder()
            O.set_registry(p)


def _pools(snap):
    return json.dumps(snap["pools"], sort_keys=True)


class _Owner:
    pass


def _contract(led):
    """One fixed sequence of registrations and books; the pool views."""
    out = []
    a = Books(capacity=1000, used=300, pinned=100, blocks=3,
              owners={"x": 200, "y": 60, "z": 40})
    pa = led.register("a", a.snapshot)
    out.append(_pools(led.snapshot()))
    out.append(_pools(led.snapshot(top_k=1)))
    # a raw float and a missing key sanitise to the uniform contract
    led.register("b", lambda: {"used_bytes": 12.7, "owners": {"q": 12}})
    out.append(_pools(led.snapshot()))
    # latest registration wins; closing the stale handle is a no-op
    a2 = Books(capacity=10, used=5, owners={"w": 5})
    led.register("a", a2.snapshot)
    pa.close()
    out.append(_pools(led.snapshot()))
    # a dead owner's pool is reaped; a broken callback costs its pool only
    owner = _Owner()
    led.register("c", Books(used=1).snapshot, owner=owner)
    del owner
    led.register("d", lambda: 1 / 0)
    out.append(_pools(led.snapshot()))
    out.append(sorted(p.name for p in led.pools()))
    return out


def test_pool_contract_matches_jax(leds):
    (jled, tled), _ = leds
    assert _contract(tled) == _contract(jled)
    snap = tled.snapshot()
    assert set(snap) == {"host", "pid", "ts", "pools", "devices"}


def _pressure(O, led):
    books = Books(capacity=100, used=10)
    seen = []
    led.on_pressure(lambda name, level, snap: seen.append((name, level)))
    led.register("p", books.snapshot)
    levels = []
    for used in (10, 75, 86, 99, 50, 96, 0):
        books.set_used(used)
        led.sample_once()
        levels.append(led.pressure_level("p"))
    led.register("u", Books(capacity=0, used=10**9).snapshot)
    custom = led.register("c", Books(capacity=10, used=6).snapshot,
                          watermarks=[("hot", 0.9), ("warm", 0.5)])
    led.sample_once()
    return (seen, levels, led.pressure_level("u"),
            custom.level_name(), [w for w, _ in custom.watermarks],
            O.render().count("zoo_mem_pressure_state"))


def test_pressure_watermarks_transition_as_jax(leds):
    (jled, tled), _ = leds
    got = [_pressure(O, led) for O, led in zip(BOTH, (jled, tled))]
    assert got[0] == got[1]
    assert got[1][0][0] == ("p", got[1][0][0][1]) and got[1][2] == 0


def _sentinel(O, led, rec):
    books = Books(capacity=1000, used=10, owners={"a": 10})
    pool = led.register("p", books.snapshot, reconcile_fn=books.reconcile)
    out = [led.reconcile_once()]
    # a first-read divergence that heals before the confirming read is
    # not a leak
    books.lines = ["blip"]
    orig = books.reconcile

    def one_shot():
        lines = orig()
        books.lines = []
        return lines
    pool.reconcile_fn = one_shot
    out.append(led.reconcile_once())
    pool.reconcile_fn = books.reconcile
    # a confirmed divergence: counted every sweep, dumped once an episode
    books.d["used_bytes"] = 74
    out += [led.reconcile_once() for _ in range(3)]
    books.d["used_bytes"] = 10
    out.append(led.reconcile_once())
    books.d["used_bytes"] = 74
    out.append(led.reconcile_once())
    books.d.update(used_bytes=150, owners={"a": 150}, blocks=-1)
    books.d["capacity_bytes"] = 100
    out.append(led.reconcile_once())
    dumps = [d for d in rec.list_dumps() if d["reason"] == "mem_leak"]
    last = rec.read_dump(dumps[-1]["file"])["memory"]
    fails = O.get_registry().snapshot()[
        "zoo_mem_reconcile_failures_total"]["series"]
    events = [e["attrs"] for e in O.get_tracer().export_events()
              if e["kind"] == "mem_leak"]
    return out, len(dumps), last["diverged"], fails, events


def test_leak_sentinel_confirms_and_dumps_once_an_episode_as_jax(leds):
    (jled, tled), (jrec, trec) = leds
    got = [_sentinel(O, led, rec) for O, led, rec in
           zip(BOTH, (jled, tled), (jrec, trec))]
    assert got[0] == got[1]
    out, n_dumps, diverged, fails, events = got[1]
    assert out[0] == out[1] == {}
    assert "owner attribution sums to 10B, books say 74B used" in \
        out[2]["p"]
    assert n_dumps == 2 and diverged == ["p"]
    assert fails[(("pool", "p"),)] == 5
    assert events == [{"pool": "p", "lines": 1}] * 2


def test_sampler_rings_and_counter_tracks_match(leds):
    (jled, tled), _ = leds
    views = []
    for O, led in zip(BOTH, (jled, tled)):
        books = Books(capacity=100, used=10, pinned=4)
        led.register("p", books.snapshot)
        for used in (10, 20, 30):
            books.set_used(used)
            assert led.sample_once() == 1
        ev = led.counter_events()
        views.append(([(c["name"], c["values"]) for c in ev],
                      [(s[1], s[2]) for s in led.dump_section()["rings"][
                          "p"]],
                      sorted(led.dump_section())))
        trace = O.chrome_trace([], counters=ev)
        assert [e["ph"] for e in trace["traceEvents"]].count("C") == 3
    assert views[0] == views[1]


def test_background_threads_start_and_stop_clean(leds):
    (_, tled), _ = leds
    try:
        tled.start()
        assert tled.running
    finally:
        tled.stop()
    assert not tled.running


SNAPS = [
    {"host": "h1", "pid": 1, "ts": 0.0, "pools": {
        "kv_blocks": {"capacity_bytes": 100, "used_bytes": 40,
                      "pinned_bytes": 10, "blocks": 4,
                      "owners": {"seq:a": 30, "prefix_cache": 10}},
        "train_state": {"capacity_bytes": 50, "used_bytes": 50,
                        "pinned_bytes": 50, "blocks": 2,
                        "owners": {"zoo/weights": 30, "zoo/opt_state": 20}}},
     "devices": []},
    {"host": "h1", "pid": 2, "ts": 0.0, "pools": {
        "kv_blocks": {"capacity_bytes": 120, "used_bytes": 25,
                      "pinned_bytes": 5, "blocks": 2,
                      "owners": {"seq:b": 25}}}, "devices": []},
    {"host": "h2", "pid": 3, "ts": 0.0, "pools": {
        "kv_blocks": {"capacity_bytes": 100, "used_bytes": 7,
                      "pinned_bytes": 7, "blocks": 1,
                      "owners": {"seq:a": 7}}}, "devices": []},
]


@pytest.mark.parametrize("top_k", [None, 1, 2])
def test_merge_memory_snapshots_is_the_jax_merge(top_k):
    outs = [json.dumps(O.merge_memory_snapshots(SNAPS, top_k=top_k),
                       sort_keys=True) for O in BOTH]
    assert outs[0] == outs[1]
    merged = json.loads(outs[1])
    assert merged["pools"]["kv_blocks"]["capacity_bytes"] == 220
    assert merged["pools"]["kv_blocks"]["used_bytes"] == 72


def test_device_memory_stats_is_empty_on_the_cpu():
    assert tobs.device_memory_stats() == []
    assert not torch.cuda.is_initialized()
    snap = tobs.get_memory_ledger().snapshot()
    assert snap["devices"] == []
    assert not torch.cuda.is_initialized()


def _churn(kv, snap):
    """The JAX test's churn: adopt a shared prefix, append, insert, fork
    and free; the ``kv_blocks`` view after every round."""
    views = []
    shared = list(range(8))
    for i in range(10):
        sid = f"s{i}"
        kv.adopt_prefix(sid, shared)
        kv.append_tokens(sid, 6)
        kv.insert_prefix(sid, shared)
        if i % 3 == 0:
            kv.fork(sid, sid + "f")
            views.append(snap()["pools"]["kv_blocks"])
            kv.free(sid + "f")
        views.append(snap()["pools"]["kv_blocks"])
        kv.free(sid)
    views.append(snap()["pools"]["kv_blocks"])
    return views


def test_kv_books_under_churn_equal_the_jax_cache(leds):
    (jled, tled), _ = leds
    shape = dict(n_layers=1, num_blocks=32, block_size=4, n_kv_heads=2,
                 head_dim=4, prefix_cache=True)
    jkv, tkv = JKV(**shape), TKV(**shape, device="cpu")
    assert tkv.block_bytes == jkv.block_bytes
    jv, tv = _churn(jkv, jled.snapshot), _churn(tkv, tled.snapshot)
    assert tv == jv
    for p in tv:
        assert sum(p["owners"].values()) == p["used_bytes"]
        assert p["used_bytes"] == p["blocks"] * tkv.block_bytes
    assert tled.reconcile_once() == jled.reconcile_once() == {}


def test_a_seeded_block_leak_is_found_in_one_sweep(leds):
    (_, tled), (_, trec) = leds
    kv = TKV(n_layers=1, num_blocks=32, block_size=4, n_kv_heads=2,
             head_dim=4, prefix_cache=True, device="cpu")
    kv.adopt_prefix("s", list(range(8)))
    kv.insert_prefix("s", list(range(8)))
    kv.free("s")
    assert tled.reconcile_once() == {}
    leaked = kv.pool.alloc_n(1)             # a block no table books
    failures = tled.reconcile_once()
    assert list(failures) == ["kv_blocks"]
    assert failures["kv_blocks"] == [
        f"block {leaked[0]}: expected 0 refs, pool says 1"]
    assert [d["reason"] for d in trec.list_dumps()] == ["mem_leak"]
    for b in leaked:
        kv.pool.decref(b)
    assert tled.reconcile_once() == {}


def test_llm_engine_books_are_exact_after_a_run(leds):
    from analytics_zoo_tpu_torch.common.config import LLMServingConfig
    from analytics_zoo_tpu_torch.llm import GenerationClient, LLMServing
    from analytics_zoo_tpu_torch.models.generation import DecoderLM
    from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
    (_, tled), _ = leds
    model = DecoderLM.tiny(generator=torch.Generator().manual_seed(0),
                           device="cpu")
    eng = LLMServing(model, LLMServingConfig(
        num_blocks=64, block_size=8, max_active=4, max_model_len=256,
        prefill_chunk_tokens=16, prefix_cache=True),
        broker=InMemoryBroker(), device="cpu").start()
    try:
        cli = GenerationClient(broker=eng.broker)
        shared = list(range(1, 33))
        for i in range(4):
            out = cli.generate(f"r{i}", shared + [40 + i, 41 + i], 6,
                               timeout=5.0)
            assert len(out) == 6
    finally:
        eng.stop()
    pool = tled.snapshot()["pools"]["kv_blocks"]
    assert pool["blocks"] == eng.cache.pool.blocks_in_use > 0
    assert pool["used_bytes"] == pool["blocks"] * eng.cache.block_bytes
    assert pool["owners"] == {"prefix_cache": pool["used_bytes"]}
    assert pool["pinned_bytes"] == 0
    assert tled.reconcile_once() == {}
    assert eng.cache.leak_check()["tables"] == 0


def test_train_state_pool_counts_parameter_and_optimizer_bytes(leds):
    from analytics_zoo_tpu.tfpark.text_estimators import (
        BERTClassifier as JBERT)
    from analytics_zoo_tpu_torch.data.featureset import FeatureSet
    from analytics_zoo_tpu_torch.estimator.estimator import Estimator
    from analytics_zoo_tpu_torch.keras.optimizers import AdamWeightDecay
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier
    (_, tled), _ = leds
    cfg = dict(vocab=50, hidden_size=32, n_block=2, n_head=2, seq_len=16,
               intermediate_size=64)
    net = BERTClassifier(2, bert_config=cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0)).net
    est = Estimator(net, AdamWeightDecay(lr=1e-3), "sparse_categorical_"
                    "crossentropy", device="cpu", app_name="job")
    rs = np.random.default_rng(0)
    T = cfg["seq_len"]
    x = [rs.integers(1, 50, (8, T)).astype(np.int32),
         np.zeros((8, T), np.int32), np.ones((8, T), np.int32)]
    est.train(FeatureSet.from_ndarrays(x, (x[0][:, 0] % 2)
                                       .astype(np.int32)),
              batch_size=8, epochs=1)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    opt = [t for v in est.opt_state.values()
           for t in (v.values() if isinstance(v, dict) else [v])
           if isinstance(t, torch.Tensor)]
    pool = tled.snapshot()["pools"]["train_state"]
    weights = nbytes(net.parameters())
    assert pool["owners"] == {"job/weights": weights,
                              "job/opt_state": nbytes(opt)}
    assert pool["used_bytes"] == pool["pinned_bytes"] == \
        weights + nbytes(opt)
    assert pool["blocks"] == len(list(net.parameters())) + len(opt)
    assert pool["capacity_bytes"] == 0           # no card: no limit read
    # the parameter bytes are the JAX tree's
    jnet = JBERT(num_classes=2, bert_config=cfg).net
    jparams, _ = jax.eval_shape(lambda: jnet.build(jax.random.PRNGKey(0)))
    assert weights == sum(a.size * a.dtype.itemsize for a in
                          jax.tree_util.tree_leaves(jparams))
    text = tobs.render()
    assert f"zoo_estimator_weight_bytes_per_device {weights}" in text
    assert tled.reconcile_once() == {}
