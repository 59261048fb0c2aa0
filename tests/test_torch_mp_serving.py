"""Model-parallel LLM serving against the JAX package's, on the CPU.

The sharded paged ops split q along heads and the page pools along KV
heads over a mesh's "model" axis; the port's run on ``["cpu"] * mp``
shards (the plain versions the CUDA kernels are held to), the JAX ones
under ``shard_map`` on ``mp`` devices of the 8-device CPU mesh.  Inputs
come from a numpy seed.  Tolerances (f32): the ops 1e-5 against JAX (the same
gather reference on the same data) and 1e-6 against the unsharded op
(batched products over fewer heads may sum in another order); greedy
tokens exactly equal, to the JAX
sharded model and to the port's unsharded one, at mp 2 and 4, through the
model's entry points and through ``LLMServing(model_parallel=2)`` with a
pre-sharded mesh.  Every test runs in a few seconds at most.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.llm.kv_cache import PagedKVCache as JCache
from analytics_zoo_tpu.models.generation import (
    DecoderLM as JDecoderLM, init_decoder_params)
from analytics_zoo_tpu.ops import paged_attention as JPA
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.common.config import LLMServingConfig
from analytics_zoo_tpu_torch.llm import (
    GenerationClient, LLMServing, PagedKVCache)
from analytics_zoo_tpu_torch.models.generation import DecoderLM
from analytics_zoo_tpu_torch.ops import paged_attention as TPA
from analytics_zoo_tpu_torch.parallel import (
    Mesh, NamedSharding, PartitionSpec as P, ShardedTensor, device_put)
from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker

N_HEAD, HIDDEN = 4, 32
PROMPTS = ([5, 17, 3, 88, 41, 9, 23, 70, 2, 14, 61],
           [7, 7, 12],
           list(range(30, 51)))


def _jmesh(mp):
    return jax.sharding.Mesh(np.asarray(jax.devices("cpu")[:mp]),
                             ("model",))


def _mesh(mp):
    return Mesh(["cpu"] * mp, ("model",))


def _pools(P_, bs, Hkv, D, seed):
    rs = np.random.default_rng(seed)
    return [rs.standard_normal((P_, bs, Hkv, D)).astype(np.float32)
            for _ in range(2)]


def _placed(pool, mesh):
    return device_put(pool, NamedSharding(mesh, P(None, None, "model",
                                                  None)))


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("H,Hkv", [(8, 8), (8, 4)], ids=["mha", "gqa"])
def test_sharded_paged_decode_matches_jax(mp, H, Hkv):
    rs = np.random.default_rng(mp * 10 + Hkv)
    B, D, P_, bs, nb = 3, 16, 9, 4, 4
    q = rs.standard_normal((B, H, D)).astype(np.float32)
    kp, vp = _pools(P_, bs, Hkv, D, seed=mp)
    lengths = np.array([5, 16, 0], np.int32)
    tables = rs.integers(1, P_, (B, nb)).astype(np.int32)
    want = np.asarray(JPA.sharded_paged_decode_attention(
        _jmesh(mp), *map(jnp.asarray, (q, kp, vp, lengths, tables))))
    mesh = _mesh(mp)
    tq, tk, tv = map(torch.from_numpy, (q, kp, vp))
    args = (torch.from_numpy(lengths), torch.from_numpy(tables))
    for pools in ((tk, tv), (_placed(tk, mesh), _placed(tv, mesh))):
        got = TPA.sharded_paged_decode_attention(mesh, tq, *pools, *args)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # and the unsharded op's (on a card bit for bit: the kernel per head;
    # the plain version's batched products here may sum in another order)
    whole = TPA.paged_decode_attention(tq, tk, tv, *args)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("H,Hkv", [(8, 8), (8, 4)], ids=["mha", "gqa"])
def test_sharded_paged_chunk_matches_jax(mp, H, Hkv):
    rs = np.random.default_rng(mp * 7 + Hkv)
    Tc, D, P_, bs, nb, start = 6, 16, 9, 4, 4, 5
    q = rs.standard_normal((Tc, H, D)).astype(np.float32)
    kp, vp = _pools(P_, bs, Hkv, D, seed=mp + 1)
    table = rs.integers(1, P_, (nb,)).astype(np.int32)
    want = np.asarray(JPA.sharded_paged_chunk_attention(
        _jmesh(mp), *map(jnp.asarray, (q, kp, vp, table)), start))
    mesh = _mesh(mp)
    tq, tk, tv = map(torch.from_numpy, (q, kp, vp))
    for pools in ((tk, tv), (_placed(tk, mesh), _placed(tv, mesh))):
        got = TPA.sharded_paged_chunk_attention(
            mesh, tq, *pools, torch.from_numpy(table), start)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    whole = TPA.paged_chunk_attention(tq, tk, tv, torch.from_numpy(table),
                                      start)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-6,
                               rtol=0)


def test_sharded_paged_ops_refuse_what_jax_refuses():
    q = torch.zeros(2, 6, 8)
    pool = torch.zeros(4, 2, 3, 8)
    lens = torch.ones(2, dtype=torch.int32)
    tables = torch.ones(2, 1, dtype=torch.int32)
    for mp in (4, 2):            # H % 4, then Hkv % 2
        with pytest.raises(ValueError, match="heads must divide the model "
                                             "axis") as got:
            TPA.sharded_paged_decode_attention(_mesh(mp), q, pool, pool,
                                               lens, tables)
        with pytest.raises(ValueError) as want:
            JPA.sharded_paged_decode_attention(
                _jmesh(mp), jnp.zeros((2, 6, 8)), jnp.zeros((4, 2, 3, 8)),
                jnp.zeros((4, 2, 3, 8)), jnp.ones(2, jnp.int32),
                jnp.ones((2, 1), jnp.int32))
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError, match="heads must divide"):
            TPA.sharded_paged_chunk_attention(_mesh(mp), q, pool, pool,
                                              tables[0], 0)
    wrong = device_put(torch.zeros(4, 2, 4, 8),
                       NamedSharding(_mesh(2), P("model")))
    with pytest.raises(ValueError, match="split along KV heads"):
        TPA.sharded_paged_decode_attention(_mesh(2), torch.zeros(2, 4, 8),
                                           wrong, wrong, lens, tables)


# --- the sharded model --------------------------------------------------

@pytest.fixture(scope="module")
def jparams():
    return init_decoder_params(jax.random.PRNGKey(3), 96, HIDDEN, N_HEAD, 2,
                               64, 512)


def _port_model(jparams, mesh=None):
    m = DecoderLM.tiny(device="cpu", n_head=N_HEAD, hidden=HIDDEN)
    interop.load_jax_params(m, jax.tree_util.tree_map(np.asarray, jparams))
    return m.shard(mesh) if mesh is not None else m


def _greedy(model, cache, uri, prompt, n_new, chunk=4, width=16):
    """Greedy decode of one sequence through the model's entry points:
    chunked prefill, then one decode step a token (the engine's calls)."""
    pos = 0
    while pos < len(prompt):
        n = min(chunk, len(prompt) - pos)
        slots = cache.append_tokens(uri, n)
        toks = np.zeros((chunk,), np.int32)
        toks[:n] = prompt[pos:pos + n]
        pslots = np.arange(chunk, dtype=np.int32) % cache.block_size
        pslots[:n] = slots
        logits, cache.k_pages, cache.v_pages = model.prefill_chunk(
            toks, pos, n, cache.page_table(uri, width), cache.k_pages,
            cache.v_pages, pslots)
        pos += n
    out = [int(np.argmax(np.asarray(logits)))]
    for _ in range(n_new - 1):
        slot = cache.append_tokens(uri, 1)
        length = cache.table(uri).num_tokens
        logits, cache.k_pages, cache.v_pages = model.decode(
            np.array([out[-1]], np.int32), np.array([length - 1], np.int32),
            np.array([length], np.int32),
            cache.page_table(uri, width)[None], cache.k_pages,
            cache.v_pages, slot)
        out.append(int(np.argmax(np.asarray(logits)[0])))
    return out


@pytest.mark.parametrize("mp", [2, 4])
def test_sharded_decoder_tokens_equal_jax_and_unsharded(jparams, mp):
    jm = JDecoderLM(jparams, 96, 512, N_HEAD, mesh=_jmesh(mp))
    jcache = JCache(2, 32, 4, N_HEAD, HIDDEN // N_HEAD,
                    page_sharding=jm.page_sharding)
    mesh = _mesh(mp)
    sharded = _port_model(jparams, mesh)
    cache = PagedKVCache(2, 32, 4, N_HEAD, HIDDEN // N_HEAD, device="cpu",
                         page_sharding=sharded.page_sharding)
    assert isinstance(cache.k_pages, ShardedTensor)
    assert [tuple(t.shape) for _, t in cache.k_pages.unique_shards()] == [
        (2, 33, 4, N_HEAD // mp, HIDDEN // N_HEAD)] * mp
    assert cache.kv_bytes_per_token == jcache.kv_bytes_per_token
    assert cache.kv_bytes_per_token_per_device * mp == \
        cache.kv_bytes_per_token
    plain = _port_model(jparams)
    pcache = PagedKVCache(2, 32, 4, N_HEAD, HIDDEN // N_HEAD, device="cpu")
    for i, prompt in enumerate(PROMPTS):
        want = _greedy(jm, jcache, f"s{i}", prompt, 8)
        assert _greedy(sharded, cache, f"s{i}", prompt, 8) == want
        assert _greedy(plain, pcache, f"s{i}", prompt, 8) == want
    # the shards hold the unsharded pool's heads
    np.testing.assert_allclose(cache.k_pages.gather().numpy(),
                               pcache.k_pages.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(cache.v_pages.gather().numpy(),
                               pcache.v_pages.numpy(), atol=1e-6, rtol=0)


def test_cache_copy_page_and_write_reach_every_shard():
    mesh = _mesh(2)
    sharding = NamedSharding(mesh, P(None, None, None, "model", None))
    cache = PagedKVCache(2, 4, 2, 4, 3, device="cpu", page_sharding=sharding)
    whole = PagedKVCache(2, 4, 2, 4, 3, device="cpu")
    rs = np.random.default_rng(0)
    k, v = (rs.standard_normal((3, 4, 3)).astype(np.float32)
            for _ in range(2))
    for c in (cache, whole):
        c.write(1, [2, 3, 5], k, v)
        c.copy_page(0, 2)            # pages 1 -> 3, every layer
    np.testing.assert_array_equal(cache.k_pages.gather().numpy(),
                                  whole.k_pages.numpy())
    np.testing.assert_array_equal(cache.v_pages.gather().numpy(),
                                  whole.v_pages.numpy())
    assert whole.k_pages[1, 3].abs().sum() > 0


def test_llm_serving_model_parallel_over_a_presharded_mesh(jparams):
    def serve(model, mp):
        eng = LLMServing(model, LLMServingConfig(
            max_active=4, num_blocks=48, block_size=4, max_model_len=64,
            prefill_chunk_tokens=8, model_parallel=mp),
            broker=InMemoryBroker(), device="cpu")
        cli = GenerationClient(broker=eng.broker)
        eng.start()
        try:
            for i, p in enumerate(PROMPTS):
                cli.submit(f"r{i}", p, 6)
            out = [[t for _, t in cli.stream_tokens(f"r{i}", timeout=60)]
                   for i in range(len(PROMPTS))]
        finally:
            eng.stop()
        return out, eng

    got, eng = serve(_port_model(jparams, _mesh(2)), 2)
    assert isinstance(eng.cache.k_pages, ShardedTensor)
    assert eng.cache.leak_check()["tables"] == 0
    want, _ = serve(_port_model(jparams), 1)
    assert got == want
    jm = JDecoderLM(jparams, 96, 512, N_HEAD, mesh=_jmesh(2))
    jcache = JCache(2, 48, 4, N_HEAD, HIDDEN // N_HEAD,
                    page_sharding=jm.page_sharding)
    assert got == [_greedy(jm, jcache, f"r{i}", p, 6)
                   for i, p in enumerate(PROMPTS)]


def test_model_parallel_refusals_match_jax(jparams):
    with pytest.raises(ValueError, match="must divide the model axis") as g:
        _port_model(jparams, _mesh(8))
    with pytest.raises(ValueError) as w:
        JDecoderLM(jparams, 96, 512, N_HEAD, mesh=_jmesh(8))
    assert str(g.value) == str(w.value)
    with pytest.raises(ValueError, match="already sharded over a 2-way"):
        LLMServing(_port_model(jparams, _mesh(2)),
                   LLMServingConfig(model_parallel=4),
                   broker=InMemoryBroker(), device="cpu")
    with pytest.raises(ValueError, match="model_parallel=2 needs 2 devices, "
                                         "have 1"):
        LLMServing(_port_model(jparams), LLMServingConfig(model_parallel=2),
                   broker=InMemoryBroker(), device="cpu")
