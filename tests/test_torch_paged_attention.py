"""The port's paged attention ops against the JAX package's, on the CPU.

The same numpy inputs go through ``analytics_zoo_tpu.ops.paged_attention``
(``backend="jnp"``: its gather reference, the semantics oracle of the TPU
kernel) and the port's ops, whose CPU path is the plain version the CUDA
kernels are held to.  Tolerances: f32 1e-5 absolute; bf16 2e-2 absolute
(inputs rounded to bf16 the same way on both sides, f32 math, one output
rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import paged_attention as jpa
from analytics_zoo_tpu_torch.llm import BlockTable
from analytics_zoo_tpu_torch.llm.kv_cache import BlockPool
from analytics_zoo_tpu_torch.ops import paged_attention as tpa

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _pair(x: np.ndarray, dtype: str):
    """One numpy array as a JAX array and a torch tensor of ``dtype``."""
    if dtype == "float32":
        return jnp.asarray(x), torch.from_numpy(x.copy())
    return (jnp.asarray(x, jnp.bfloat16),
            torch.from_numpy(x.copy()).to(torch.bfloat16))


def _pools(rng, P, bs, Hkv, D, dtype):
    kp = rng.standard_normal((P, bs, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, bs, Hkv, D)).astype(np.float32)
    return _pair(kp, dtype), _pair(vp, dtype)


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_decode_matches_jax(heads, dtype):
    H, Hkv = heads
    B, D, P, bs, nb = 5, 16, 12, 8, 4
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    (jk, tk), (jv, tv) = _pools(rng, P, bs, Hkv, D, dtype)
    # lengths: dead lane, inside the first block, not a block multiple,
    # exactly full, a full block
    lengths = np.array([0, 3, 13, nb * bs, bs], np.int32)
    tables = rng.integers(0, P, (B, nb)).astype(np.int32)
    jq, tq = _pair(q, dtype)
    want = jpa.paged_decode_attention(jq, jk, jv, jnp.asarray(lengths),
                                      jnp.asarray(tables), backend="jnp")
    got = tpa.paged_decode_attention(tq, tk, tv, torch.from_numpy(lengths),
                                     torch.from_numpy(tables))
    assert got.dtype == tq.dtype and got.shape == (B, H, D)
    _close(got, want, dtype)
    assert torch.all(got[0] == 0)               # lengths == 0 -> zeros


def test_decode_reads_shared_prefix_blocks_through_a_ref_counted_pool():
    """Two sequences share their first blocks (a fork of one block
    table); the second diverges into a copied tail.  Both read their K/V
    through tables the real pool built."""
    bs, D, H = 4, 8, 2
    pool = BlockPool(10, bs)
    a = BlockTable(pool)
    a.append_tokens(6)                      # blocks [full, half]
    b = a.fork()
    copied = []
    b.append_tokens(3, cow_copy=lambda s, d: copied.append((s, d)))
    assert copied and pool.refcount(a.blocks[0]) == 2
    rng = np.random.default_rng(1)
    P = pool.num_blocks + 1                 # page 0 is scratch
    kp = rng.standard_normal((P, bs, H, D)).astype(np.float32)
    vp = rng.standard_normal((P, bs, H, D)).astype(np.float32)
    for src, dst in copied:                 # what PagedKVCache.copy_page does
        kp[dst + 1], vp[dst + 1] = kp[src + 1], vp[src + 1]
    nb = 4
    tables = np.zeros((2, nb), np.int32)
    for i, t in enumerate((a, b)):
        tables[i, :len(t.blocks)] = np.asarray(t.blocks) + 1
    lengths = np.array([a.num_tokens, b.num_tokens], np.int32)
    q = rng.standard_normal((2, H, D)).astype(np.float32)
    want = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(lengths), jnp.asarray(tables), backend="jnp")
    got = tpa.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(lengths), torch.from_numpy(tables))
    _close(got, want, "float32")
    assert tables[0, 0] == tables[1, 0]     # the shared prefix block
    assert tables[0, 1] != tables[1, 1]     # the copied-on-write tail


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    dict(H=4, Hkv=4, Tc=8, start=0, n=8),
    dict(H=4, Hkv=4, Tc=8, start=13, n=5),      # padded tail past start
    dict(H=8, Hkv=2, Tc=16, start=5, n=11),     # GQA
], ids=["start0", "start_padded_tail", "gqa"])
def test_chunk_matches_jax(case, dtype):
    H, Hkv, Tc, start = case["H"], case["Hkv"], case["Tc"], case["start"]
    D, P, bs, nb = 16, 12, 8, 5
    rng = np.random.default_rng(2)
    q = rng.standard_normal((Tc, H, D)).astype(np.float32)
    (jk, tk), (jv, tv) = _pools(rng, P, bs, Hkv, D, dtype)
    table = rng.permutation(np.arange(1, P))[:nb].astype(np.int32)
    jq, tq = _pair(q, dtype)
    want = jpa.paged_chunk_attention(jq, jk, jv, jnp.asarray(table),
                                     jnp.asarray(start, jnp.int32))
    got = tpa.paged_chunk_attention(tq, tk, tv, torch.from_numpy(table),
                                    start)
    assert got.dtype == tq.dtype and got.shape == (Tc, H, D)
    _close(got, want, dtype)


def test_cpu_tensors_with_cuda_backend_raise():
    q = torch.zeros(1, 2, 32)
    pages = torch.zeros(3, 4, 2, 32)
    lens = torch.ones(1, dtype=torch.int32)
    table = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_decode_attention(q, pages, pages, lens, table,
                                   backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_chunk_attention(q, pages, pages, table[0], 0,
                                  backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_decode_attention(q, pages, pages, lens, table,
                                   backend="pallas")


def test_gqa_head_ratio_must_divide():
    q = torch.zeros(1, 3, 8)
    pages = torch.zeros(3, 4, 2, 8)
    table = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="H % Hkv"):
        tpa.paged_decode_attention(q, pages, pages,
                                   torch.ones(1, dtype=torch.int32), table)
    with pytest.raises(ValueError, match="H % Hkv"):
        tpa.paged_chunk_attention(q, pages, pages, table[0], 0)
