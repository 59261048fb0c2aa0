"""The port's decoder LM against the JAX package's, on the CPU.

The JAX parameter tree of a tiny ``DecoderLM`` (vocab 96, hidden 32, 2
heads, 2 layers) goes through ``interop.load_jax_params`` into the port's
module; the same tokens, page tables and pages then go through the JAX
functions and the port's entry points.  f32 throughout: logits and pages
to 1e-5, greedy tokens exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models import generation as jgen
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.models import generation as tgen
from analytics_zoo_tpu_torch.models.generation import DecoderLM

ATOL = 1e-5
N_HEAD = 2
L, BS, NB = 2, 8, 6           # layers, block size, table width
P = 16                        # pages, page 0 the scratch page


@pytest.fixture(scope="module")
def jparams():
    return jgen.init_decoder_params(jax.random.PRNGKey(0), 96, 32, N_HEAD,
                                    L, 64, 512)


@pytest.fixture(scope="module")
def model(jparams):
    m = DecoderLM.tiny(device="cpu")
    return interop.load_jax_params(m, jax.tree_util.tree_map(np.asarray,
                                                             jparams))


def _pages(rng):
    kp = rng.standard_normal((L, P, BS, N_HEAD, 16)).astype(np.float32)
    vp = rng.standard_normal((L, P, BS, N_HEAD, 16)).astype(np.float32)
    return kp, vp


def test_dense_logits_match_jax(jparams, model):
    tokens = np.random.default_rng(0).integers(0, 96, (3, 11)).astype(
        np.int32)
    want = np.asarray(jgen.dense_logits(jparams, jnp.asarray(tokens),
                                        N_HEAD))
    got = tgen.dense_logits(model, torch.from_numpy(tokens), N_HEAD)
    assert got.shape == (3, 11, 96)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=0)


def test_chunked_prefill_then_decode_match_jax_step_by_step(jparams, model):
    """A 20-token prompt prefilled in 3 chunks of 8 (the last padded onto
    the scratch page), then 6 decode steps beside a dead lane: logits and
    both page tensors against the JAX functions at every step."""
    rng = np.random.default_rng(1)
    kp, vp = _pages(rng)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    prompt = rng.integers(0, 96, 20).astype(np.int32)
    blocks = [7, 3, 12, 5, 9]                  # pool pages of the sequence
    table = np.zeros((NB,), np.int32)
    table[:len(blocks)] = blocks
    slot_of = lambda t: blocks[t // BS] * BS + t % BS

    def check(got, want):
        logits, k_pages, v_pages = got
        np.testing.assert_allclose(logits.numpy(), np.asarray(want[0]),
                                   atol=ATOL, rtol=0)
        assert k_pages is tk and v_pages is tv   # updated in place
        np.testing.assert_allclose(tk.numpy(), np.asarray(want[1]),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(want[2]),
                                   atol=ATOL, rtol=0)

    chunk = 8
    for start in range(0, 20, chunk):
        n = min(chunk, 20 - start)
        toks = np.zeros((chunk,), np.int32)
        toks[:n] = prompt[start:start + n]
        slots = np.arange(chunk, dtype=np.int32) % BS    # pad -> scratch
        slots[:n] = [slot_of(start + i) for i in range(n)]
        want = jgen.prefill_chunk(jparams, jnp.asarray(toks), start, n,
                                  jnp.asarray(table), jk, jv,
                                  jnp.asarray(slots), N_HEAD)
        jk, jv = want[1], want[2]
        check(model.prefill_chunk(toks, start, n, table, tk, tv, slots),
              want)
    nxt = int(np.argmax(np.asarray(want[0])))
    ctx = 20
    for _ in range(6):
        # lane 0 live, lane 1 dead (length 0, scratch slot)
        tokens = np.array([nxt, 0], np.int32)
        positions = np.array([ctx, 0], np.int32)
        lengths = np.array([ctx + 1, 0], np.int32)
        tables = np.stack([table, np.zeros_like(table)])
        slots = np.array([slot_of(ctx), 1], np.int32)
        want = jgen.decode_step(jparams, *(jnp.asarray(a) for a in (
            tokens, positions, lengths, tables)), jk, jv,
            jnp.asarray(slots), N_HEAD)
        jk, jv = want[1], want[2]
        check(model.decode(tokens, positions, lengths, tables, tk, tv,
                           slots), want)
        nxt = int(np.argmax(np.asarray(want[0])[0]))
        ctx += 1


def test_whole_prompt_prefill_matches_jax(jparams, model):
    rng = np.random.default_rng(2)
    kp, vp = _pages(rng)
    toks = np.zeros((16,), np.int32)
    toks[:11] = rng.integers(0, 96, 11)
    slots = np.arange(16, dtype=np.int32) % BS
    slots[:11] = np.arange(11) + 2 * BS          # pages 2 and 3
    want = jgen.prefill(jparams, jnp.asarray(toks), 11, jnp.asarray(kp),
                        jnp.asarray(vp), jnp.asarray(slots), N_HEAD)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    logits, _, _ = model.prefill(toks, 11, tk, tv, slots)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want[0]),
                               atol=ATOL, rtol=0)
    # positions 2..3 pages hold the prompt's K/V exactly as JAX wrote them
    np.testing.assert_allclose(tk.numpy()[:, 2:4], np.asarray(want[1])[
        :, 2:4], atol=ATOL, rtol=0)


def test_live_lane_ignores_garbage_in_the_scratch_page(model):
    """Dead lanes and chunk padding write to page 0 in any order (duplicate
    slots): a live sequence never reads it, so its logits do not move when
    page 0 holds anything finite."""
    rng = np.random.default_rng(3)
    kp, vp = _pages(rng)
    table = np.array([[4, 6, 0, 0, 0, 0], [0] * NB], np.int32)
    args = (np.array([5, 9], np.int32), np.array([10, 0], np.int32),
            np.array([11, 0], np.int32), table)
    slots = np.array([6 * BS + 2, 1], np.int32)
    outs = []
    for fill in (0.0, 1e4):
        tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
        tk[:, 0], tv[:, 0] = fill, -fill
        outs.append(model.decode(*args, tk, tv, slots)[0][0])
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)


def test_greedy_reference_equals_jax(jparams, model):
    for prompt in ([5, 9, 2, 7], [1, 2, 3], [4] * 6):
        want = jgen.greedy_reference(jparams, prompt, 10, N_HEAD)
        assert tgen.greedy_reference(model, prompt, 10, N_HEAD) == want


def test_load_jax_params_is_strict(jparams):
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    m = DecoderLM.tiny(device="cpu")
    missing = dict(tree, blocks=[dict(b) for b in tree["blocks"]])
    del missing["blocks"][1]["fc2"]
    with pytest.raises(KeyError, match="blocks.1.fc2"):
        interop.load_jax_params(m, missing)
    extra = dict(tree, blocks=tree["blocks"] + [tree["blocks"][0]])
    with pytest.raises(KeyError, match="blocks.2"):
        interop.load_jax_params(m, extra)
    back = interop.params_tree(interop.load_jax_params(m, tree))
    assert isinstance(back["blocks"], list) and len(back["blocks"]) == L
    np.testing.assert_array_equal(back["blocks"][1]["qkv"]["W"],
                                  tree["blocks"][1]["qkv"]["W"])


def test_model_parallel_is_not_ported():
    # ported since: shard() and mesh= shard the paged attention, and what
    # is refused is what the JAX model refuses, a model axis that does not
    # divide the KV heads (tests/test_torch_mp_serving.py holds the
    # sharded model to the JAX one)
    from analytics_zoo_tpu_torch.parallel import Mesh
    mesh = Mesh(["cpu"] * 2, ("model",))
    m = DecoderLM(96, 32, 2, 2, 64, 512, device="cpu", mesh=mesh)
    assert m.mesh is mesh and tuple(m.page_sharding.spec) == (
        None, None, None, "model", None)
    assert DecoderLM.tiny(device="cpu").shard(mesh).mesh is mesh
    with pytest.raises(ValueError, match="must divide the model axis"):
        DecoderLM.tiny(device="cpu").shard(Mesh(["cpu"] * 4, ("model",)))
