"""The port's LLM serving path against the JAX package's, on the CPU.

The block pool, tables, copy-on-write, leak accounting and scheduler cases
of the JAX package's own serving tests, run on the port's classes; then
``LLMServing`` (in-memory broker, ``device="cpu"``) serves a tiny
``DecoderLM`` whose weights come from the JAX model, and every token read
back through ``GenerationClient`` must EQUAL the JAX package's
``greedy_reference`` — for concurrent prompts, a shared prefix served from
the radix cache, and preemption with recompute on resume.  ``leak_check``
reads zero live tables after every scenario.
"""

import time

import jax
import numpy as np
import pytest

from analytics_zoo_tpu.models.generation import (
    greedy_reference, init_decoder_params)
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.common.config import LLMServingConfig
from analytics_zoo_tpu_torch.common.resilience import Deadline
from analytics_zoo_tpu_torch.llm import (
    BlockPool, BlockPoolExhausted, BlockTable, GenerationClient,
    LLMServing, PagedKVCache)
from analytics_zoo_tpu_torch.llm.scheduler import (
    ContinuousBatchingScheduler, GenSequence)
from analytics_zoo_tpu_torch.models.generation import DecoderLM
from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
from analytics_zoo_tpu_torch.serving.client import (
    OutputQueue, ServingDeadlineError, ServingError, ServingShedError)

N_HEAD = 2


@pytest.fixture(scope="module")
def jparams():
    return init_decoder_params(jax.random.PRNGKey(0), 96, 32, N_HEAD, 2, 64,
                               512)


@pytest.fixture(scope="module")
def model(jparams):
    m = DecoderLM.tiny(device="cpu")
    return interop.load_jax_params(m, jax.tree_util.tree_map(np.asarray,
                                                             jparams))


def _cache(blocks=16, bs=4, **kw):
    return PagedKVCache(1, blocks, bs, 2, 4, device="cpu", **kw)


def _engine(model, broker=None, **kw):
    kw.setdefault("num_blocks", 64)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_active", 4)
    kw.setdefault("max_model_len", 256)
    return LLMServing(model, LLMServingConfig(**kw),
                      broker=broker or InMemoryBroker(), device="cpu")


def _drain(cli, uri, timeout=60.0):
    return [t for _, t in cli.stream_tokens(uri, timeout=timeout)]


def _assert_no_leaks(eng):
    """No live sequence holds anything: every allocated block is held
    EXACTLY once, by the radix prefix cache, and the per-block refcount
    books balance to the unit (tables + cache nodes)."""
    lk = eng.cache.leak_check()
    assert lk["held_blocks"] == 0 and lk["tables"] == 0, lk
    assert lk["in_use"] == lk["cached_blocks"], lk
    assert eng.cache.refcount_balance() == {}
    assert not eng.scheduler.has_work()
    if eng.admission is not None:
        assert eng.admission.in_flight == 0


def _wait_idle(eng, timeout=10.0):
    deadline = time.monotonic() + timeout
    while eng.scheduler.has_work() and time.monotonic() < deadline:
        time.sleep(0.02)


# ---------------------------------------------------------------------------
class TestBlockPool:
    def test_alloc_free_refcount_roundtrip(self):
        pool = BlockPool(4, 8)
        a, b = pool.alloc(), pool.alloc()
        assert pool.blocks_in_use == 2
        pool.incref(a)
        assert not pool.decref(a)          # still referenced
        assert pool.decref(a)              # now free
        assert pool.decref(b)
        assert pool.free_blocks == 4
        with pytest.raises(ValueError):
            pool.decref(a)                 # double free is loud

    def test_alloc_n_is_atomic_on_exhaustion(self):
        pool = BlockPool(3, 8)
        pool.alloc()
        with pytest.raises(BlockPoolExhausted):
            pool.alloc_n(3)
        assert pool.free_blocks == 2       # nothing half-allocated
        assert pool.exhaustion_events == 1

    def test_table_append_atomic_and_lazy(self):
        pool = BlockPool(2, 4)
        t = BlockTable(pool)
        slots = t.append_tokens(5)         # 2 blocks: 4 + 1
        assert len(t.blocks) == 2 and t.num_tokens == 5
        assert slots.tolist() == [t.blocks[0] * 4 + i for i in range(4)] \
            + [t.blocks[1] * 4]
        with pytest.raises(BlockPoolExhausted):
            t.append_tokens(4)             # needs a 3rd block
        assert t.num_tokens == 5           # untouched
        t.truncate()
        assert pool.free_blocks == 2

    def test_fork_cow_copies_page_content(self):
        """A forked table appending into a SHARED partial tail block
        copies on write, in place: the parent's cached K/V stays intact
        and the two tails diverge physically."""
        cache = PagedKVCache(1, 8, 4, 2, 4, device="cpu")
        base = cache.table("a")
        slots = cache.append_tokens("a", 6)   # blocks: [full, half]
        k = np.arange(6 * 2 * 4, dtype=np.float32).reshape(6, 2, 4)
        cache.write(0, slots, k, k + 100)
        pages = cache.k_pages
        cache.fork("a", "b")
        shared_tail = base.blocks[-1]
        assert cache.pool.refcount(shared_tail) == 2
        cache.append_tokens("b", 1)           # diverge into the tail
        forked = cache.table("b")
        assert forked.blocks[-1] != shared_tail
        assert cache.pool.refcount(shared_tail) == 1
        assert cache.k_pages is pages         # the same tensor, updated
        kp = cache.k_pages.numpy()
        np.testing.assert_array_equal(
            kp[0, shared_tail + 1, :2], kp[0, forked.blocks[-1] + 1, :2])
        np.testing.assert_array_equal(
            cache.v_pages.numpy()[0, forked.blocks[-1] + 1, :2],
            k[4:6] + 100)
        cache.free("a")
        cache.free("b")
        assert cache.pool.free_blocks == 8

    def test_leak_check_accounting(self):
        cache = PagedKVCache(1, 8, 4, 2, 4, device="cpu")
        cache.append_tokens("x", 9)
        lk = cache.leak_check()
        assert lk == {"tables": 1, "held_blocks": 3, "cached_blocks": 0,
                      "free_blocks": 5, "in_use": 3}
        assert cache.refcount_balance() == {}
        cache.free("x")
        assert cache.leak_check()["in_use"] == 0

    def test_kv_bytes_per_token_from_the_element_size(self):
        import torch
        assert _cache().kv_bytes_per_token == 2 * 1 * 2 * 4 * 4
        half = PagedKVCache(3, 4, 4, 2, 8, dtype=torch.bfloat16,
                            device="cpu")
        assert half.kv_bytes_per_token == 2 * 3 * 2 * 8 * 2
        assert half.k_pages.shape == (3, 5, 4, 2, 8)   # + scratch page


class TestRadixPrefixCache:
    def test_adopt_insert_evict_keeps_the_books(self):
        cache = _cache(blocks=8, bs=4, prefix_cache=True)
        toks = list(range(10))
        cache.append_tokens("a", 10)              # 3 blocks
        assert cache.insert_prefix("a", toks) == 2  # the 2 full blocks
        cache.free("a")
        assert cache.leak_check()["in_use"] == 2  # held by the cache only
        assert cache.adoptable_tokens(toks) == 8
        assert cache.adopt_prefix("b", toks) == 8
        assert cache.prefix_cache.hits == 1
        assert cache.refcount_balance() == {}
        assert cache.reclaim(8) == 0              # shared with b: pinned
        cache.free("b")
        assert cache.reclaim(8) == 2              # now cache-only
        assert cache.leak_check()["in_use"] == 0


# ---------------------------------------------------------------------------
class TestScheduler:
    def test_continuous_refills_mid_batch(self):
        s = ContinuousBatchingScheduler(_cache(), 2)
        a, b, c = (GenSequence(u, [1, 2], 4) for u in "abc")
        for x in (a, b, c):
            s.add(x)
        assert {x.uri for x in s.schedule_admissions()} == {"a", "b"}
        s.remove(a)
        assert [x.uri for x in s.schedule_admissions()] == ["c"]

    def test_static_admits_only_into_empty_batch(self):
        s = ContinuousBatchingScheduler(_cache(), 2, mode="static")
        a, b, c = (GenSequence(u, [1, 2], 4) for u in "abc")
        for x in (a, b, c):
            s.add(x)
        assert len(s.schedule_admissions()) == 2
        s.remove(a)
        assert s.schedule_admissions() == []     # b still resident
        s.remove(b)
        assert [x.uri for x in s.schedule_admissions()] == ["c"]

    def test_victim_is_lowest_priority_then_youngest(self):
        cache = _cache()
        s = ContinuousBatchingScheduler(cache, 3)
        hi = GenSequence("hi", [1], 4, priority=5)
        lo_old = GenSequence("lo_old", [1], 4, priority=0)
        lo_new = GenSequence("lo_new", [1], 4, priority=0)
        for x in (hi, lo_old, lo_new):
            s.add(x)
        s.schedule_admissions()
        for x in (hi, lo_old, lo_new):     # each holds private blocks
            cache.append_tokens(x.uri, 2)
        assert s._victim() is lo_new             # youngest of the lowest
        s.preempt(lo_new)
        assert lo_new.state == "waiting" and lo_new.preemptions == 1
        assert s._victim(below_priority=5) is lo_old
        assert s._victim(below_priority=0) is None

    def test_victim_accounting_skips_sharing_sequences(self):
        cache = _cache(blocks=4, bs=4)
        s = ContinuousBatchingScheduler(cache, 3)
        a = GenSequence("a", [1, 2, 3, 4], 4)
        s.add(a)
        s.schedule_admissions()
        cache.append_tokens("a", 8)              # 2 blocks, exactly full
        cache.fork("a", "b")                     # b shares BOTH blocks
        b = GenSequence("b", [1, 2, 3, 4], 4)
        s.add(b)
        s.schedule_admissions()
        c = GenSequence("c", [1] * 9, 4, priority=9)
        s.add(c)
        assert s.schedule_admissions() == []
        assert s.preemptions == 0
        assert a.state != "waiting" and b.state != "waiting"
        assert s._freeable_blocks(a) == 0 and s._freeable_blocks(b) == 0
        cache.append_tokens("b", 1)
        assert s._freeable_blocks(b) == 1
        assert s._victim() is b

    def test_admission_preempts_only_lower_priority(self):
        cache = _cache(blocks=2, bs=4)           # room for ONE sequence
        s = ContinuousBatchingScheduler(cache, 2)
        lo = GenSequence("lo", [1, 2, 3], 4, priority=0)
        s.add(lo)
        s.schedule_admissions()
        cache.append_tokens("lo", 5)             # lo holds both blocks
        peer = GenSequence("peer", [1, 2, 3], 4, priority=0)
        s.add(peer)
        assert s.schedule_admissions() == []     # equal priority waits
        assert lo.state != "waiting"
        s.waiting.remove(peer)
        hi = GenSequence("hi", [1, 2, 3], 4, priority=9)
        s.add(hi)
        assert [x.uri for x in s.schedule_admissions()] == ["hi"]
        assert lo.state == "waiting"             # evicted, blocks freed


# ---------------------------------------------------------------------------
class TestEngineEndToEnd:
    def test_greedy_equals_jax_reference_concurrently(self, jparams, model):
        prompts = ([5, 9, 2, 7], [1, 2, 3], [4] * 6, list(range(20, 39)))
        refs = [greedy_reference(jparams, p, 12, N_HEAD) for p in prompts]
        eng = _engine(model).start()
        cli = GenerationClient(broker=eng.broker)
        try:
            for i, p in enumerate(prompts):
                cli.submit(f"g{i}", p, 12)
            for i, ref in enumerate(refs):
                assert _drain(cli, f"g{i}") == ref
            # the aggregate result rides the ordinary result plane too
            out = OutputQueue(broker=eng.broker).query("g0")
            assert out.tolist() == refs[0]
            _wait_idle(eng)
            _assert_no_leaks(eng)
        finally:
            eng.stop()
        _assert_no_leaks(eng)

    def test_shared_prefix_is_adopted_and_exact(self, jparams, model):
        """Prompts sharing a 2-block prefix: after the first finishes,
        the others adopt its cached blocks (hits counted, tokens saved)
        and still decode exactly the reference."""
        prefix = list(range(40, 56))                # 2 blocks of 8
        prompts = [prefix + [3, 1, 4], prefix + [1, 5], prefix + [9] * 7]
        refs = [greedy_reference(jparams, p, 8, N_HEAD) for p in prompts]
        eng = _engine(model, prefill_chunk_tokens=16).start()
        cli = GenerationClient(broker=eng.broker)
        try:
            assert _drain(cli, cli.submit("s0", prompts[0], 8)) == refs[0]
            for i in (1, 2):
                cli.submit(f"s{i}", prompts[i], 8)
            for i in (1, 2):
                assert _drain(cli, f"s{i}") == refs[i]
            pc = eng.metrics()["prefix_cache"]
            assert pc["hits"] >= 2 and pc["tokens_saved"] >= 32, pc
            _wait_idle(eng)
            _assert_no_leaks(eng)
        finally:
            eng.stop()

    def test_preemption_recompute_on_resume_is_exact(self, jparams, model):
        """A pool sized below the working set forces preemption; the
        evicted sequences re-prefill prompt + generated and must still
        produce EXACTLY the reference decode."""
        prompts = [[1 + i, 2, 3] for i in range(4)]
        refs = [greedy_reference(jparams, p, 16, N_HEAD) for p in prompts]
        eng = _engine(model, num_blocks=8, block_size=4, max_active=4,
                      max_model_len=64).start()
        cli = GenerationClient(broker=eng.broker)
        try:
            for i, p in enumerate(prompts):
                cli.submit(f"p{i}", p, 16)
            for i, ref in enumerate(refs):
                assert _drain(cli, f"p{i}") == ref
            assert eng.scheduler.preemptions > 0
            assert eng.metrics()["preemptions"] > 0
            _wait_idle(eng)
            _assert_no_leaks(eng)
        finally:
            eng.stop()

    def test_eos_stops_generation_early(self, jparams, model):
        ref = greedy_reference(jparams, [3, 1, 4], 8, N_HEAD)
        eng = _engine(model, eos_id=ref[0]).start()
        cli = GenerationClient(broker=eng.broker)
        try:
            out = _drain(cli, cli.submit("e", [3, 1, 4], 8))
            assert out == ref[:1]          # stops AT the eos token
            _wait_idle(eng)
            _assert_no_leaks(eng)
        finally:
            eng.stop()

    def test_per_token_deadline_expires_mid_generation(self, model):
        eng = _engine(model, max_model_len=512).start()
        cli = GenerationClient(broker=eng.broker)
        try:
            cli.generate("warmup", [1, 2], 2, timeout=60)
            cli.submit("d", [1, 2, 3], 480, deadline_s=0.1)
            got = []
            with pytest.raises(ServingDeadlineError):
                for _, t in cli.stream_tokens("d", timeout=30):
                    got.append(t)
            assert 0 < len(got) < 480        # expired MID-generation
            assert eng.metrics()["sequences_expired"] == 1
            _wait_idle(eng)
            _assert_no_leaks(eng)
        finally:
            eng.stop()

    def test_explicit_deadline_rides_the_wire(self, model):
        """An explicit ``Deadline`` (already spent) is stamped on the
        entry and refused before admission, with the typed error."""
        eng = _engine(model).start()
        cli = GenerationClient(broker=eng.broker)
        try:
            cli.submit("late", [1, 2, 3], 8, deadline=Deadline(-1.0))
            with pytest.raises(ServingDeadlineError):
                _drain(cli, "late", timeout=10)
            assert eng.metrics()["sequences_expired"] == 1
            _assert_no_leaks(eng)
        finally:
            eng.stop()

    def test_admission_shed_is_immediate_and_typed(self, model):
        eng = _engine(model, admission_max_inflight=1,
                      max_model_len=512).start()
        cli = GenerationClient(broker=eng.broker)
        try:
            cli.submit("long", [1, 2, 3], 480)   # holds the only credit
            cli.submit("shed-me", [4, 5], 8)
            with pytest.raises(ServingShedError):
                _drain(cli, "shed-me", timeout=10)
            assert eng.metrics()["sequences_shed"] == 1
            assert len(_drain(cli, "long")) == 480
            _wait_idle(eng)
            _assert_no_leaks(eng)
        finally:
            eng.stop()

    def test_cancel_mid_generation_frees_blocks(self, model):
        eng = _engine(model, max_model_len=512).start()
        cli = GenerationClient(broker=eng.broker)
        try:
            cli.submit("c", [1, 2, 3], 480)
            it = cli.stream_tokens("c", timeout=30)
            next(it)                       # generation is live
            eng.cancel("c")
            with pytest.raises(ServingError):
                list(it)
            _wait_idle(eng)
            _assert_no_leaks(eng)
            assert eng.metrics()["sequences_finished"] == 1
        finally:
            eng.stop()

    def test_finished_token_streams_are_collected(self, model):
        eng = _engine(model, token_stream_retention=1).start()
        cli = GenerationClient(broker=eng.broker)
        try:
            for i in range(3):
                assert len(cli.generate(f"r{i}", [1, 2, i], 2)) == 2
            streams = set(eng.broker._streams)
            assert "llmtok:r2" in streams
            assert not {"llmtok:r0", "llmtok:r1"} & streams
        finally:
            eng.stop()


def test_config_fields_match_jax_and_model_parallel_raises():
    import dataclasses
    from analytics_zoo_tpu.common.config import LLMServingConfig as J
    assert [(f.name, f.default) for f in dataclasses.fields(
        LLMServingConfig)] == [(f.name, f.default)
                               for f in dataclasses.fields(J)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LLMServingConfig(model_parallel=2)
    # the Redis broker is ported: redis:// reaches RedisBroker, whose lazy
    # import of redis-py raises where redis-py is missing
    import sys
    saved = sys.modules.get("redis")
    sys.modules["redis"] = None
    try:
        with pytest.raises(ImportError, match="redis"):
            LLMServing(DecoderLM.tiny(device="cpu"),
                       LLMServingConfig(redis_url="redis://x:1"),
                       device="cpu")
    finally:
        if saved is None:
            del sys.modules["redis"]
        else:
            sys.modules["redis"] = saved


def test_engine_refuses_a_model_on_another_device(model):
    import torch
    with pytest.raises(ValueError, match="serving device"):
        LLMServing(model, LLMServingConfig(), broker=InMemoryBroker(),
                   device=torch.device("meta"))
