"""(data × model)-sharded flash attention against the JAX package's, on
the CPU.

``sharded_flash_attention`` splits the batch over "data" and the heads
over "model"; the port runs each block's ``flash_attention`` (its plain
version here) on ``["cpu"] * 4``, the JAX package under ``shard_map`` on 4
devices of the 8-device CPU mesh.  Inputs come from a numpy seed.
Tolerances (f32): outputs 1e-5; dropout keep-masks bit for bit (each
block re-derives its seed from its coordinates, as JAX does); gradients
against ``jax.grad`` 1e-5.  A tiny BERT served under a 2D context
(``context_scope``) routes every attention through the sharded op and
equals itself without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.common.config import (
    MeshConfig as JMeshConfig, ZooConfig as JZooConfig)
from analytics_zoo_tpu.ops import attention as JA
from analytics_zoo_tpu.tfpark.text_estimators import BERTClassifier as JBERT
from analytics_zoo_tpu_torch.common import context as tctx
from analytics_zoo_tpu_torch.common.config import MeshConfig, ZooConfig
from analytics_zoo_tpu_torch.keras.layers import self_attention
from analytics_zoo_tpu_torch.ops import attention as TA
from analytics_zoo_tpu_torch.parallel import Mesh
from analytics_zoo_tpu_torch.tfpark.text_estimators import (
    BERTClassifier as TBERT)

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_port_context():
    tctx.reset_context()
    yield
    tctx.reset_context()


def _meshes(dp=2, mp=2):
    jm = jax.sharding.Mesh(
        np.asarray(jax.devices("cpu")[:dp * mp]).reshape(dp, mp),
        ("data", "model"))
    return jm, Mesh(np.full((dp, mp), "cpu", dtype=object),
                    ("data", "model"))


def _qkv(B=4, H=4, T=8, D=8, seed=0):
    rs = np.random.default_rng(seed)
    return [rs.standard_normal((B, H, T, D)).astype(np.float32)
            for _ in range(3)]


def _mask(B, T, seed=1):
    rs = np.random.default_rng(seed)
    lens = rs.integers(1, T + 1, B)
    return (np.arange(T)[None] < lens[:, None]).astype(np.int32)


@pytest.mark.parametrize("masked,causal", [(False, False), (True, False),
                                           (False, True)],
                         ids=["full", "padding", "causal"])
def test_sharded_flash_attention_matches_jax(masked, causal):
    jm, mesh = _meshes()
    q, k, v = _qkv()
    mask = _mask(4, 8) if masked else None
    want = JA.sharded_flash_attention(
        jm, *map(jnp.asarray, (q, k, v)),
        padding_mask=None if mask is None else jnp.asarray(mask),
        causal=causal)
    got = TA.sharded_flash_attention(
        mesh, *map(torch.from_numpy, (q, k, v)),
        padding_mask=None if mask is None else torch.from_numpy(mask),
        causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    # head- and batch-independent: the unsharded op gives the same rows
    # (bit for bit on a card, where each block is the kernel's)
    whole = TA.flash_attention(
        *map(torch.from_numpy, (q, k, v)),
        padding_mask=None if mask is None else torch.from_numpy(mask),
        causal=causal)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("seed", [7, -123456789, 2 ** 31 - 1])
def test_sharded_dropout_masks_equal_jax_bit_for_bit(seed):
    """With q = k = 0 every probability is 1/T, and with V's row j the
    one-hot e_j, output column j is keep[j] / (T (1 - rate)): the mask."""
    jm, mesh = _meshes()
    B, H, T = 4, 4, 8
    q = np.zeros((B, H, T, T), np.float32)
    v = np.broadcast_to(np.eye(T, dtype=np.float32), (B, H, T, T)).copy()
    jfn = jax.jit(lambda q_, k_, v_, s_: JA.sharded_flash_attention(
        jm, q_, k_, v_, dropout_rate=0.3, dropout_seed=s_))
    want = np.asarray(jfn(jnp.asarray(q), jnp.asarray(q), jnp.asarray(v),
                          jnp.int32(seed))) > 0
    for s in (seed, torch.tensor(seed, dtype=torch.int32)):
        got = TA.sharded_flash_attention(
            mesh, torch.from_numpy(q), torch.from_numpy(q),
            torch.from_numpy(v), dropout_rate=0.3, dropout_seed=s)
        np.testing.assert_array_equal(got.numpy() > 0, want)
    assert 0.5 < want.mean() < 0.9
    # each block draws its own mask (not the unsharded one)
    whole = TA.flash_attention(torch.from_numpy(q), torch.from_numpy(q),
                               torch.from_numpy(v), dropout_rate=0.3,
                               dropout_seed=seed)
    assert not np.array_equal(whole.numpy() > 0, want)
    # with random inputs the outputs agree too
    q, k, v = _qkv(seed=4)
    want = jfn(*map(jnp.asarray, (q, k, v)), jnp.int32(seed))
    got = TA.sharded_flash_attention(mesh, *map(torch.from_numpy, (q, k, v)),
                                     dropout_rate=0.3, dropout_seed=seed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("drop", [0.0, 0.2], ids=["plain", "dropout"])
def test_sharded_flash_gradients_match_jax_grad(drop):
    jm, mesh = _meshes()
    q, k, v = _qkv(seed=5)
    g = _qkv(seed=6)[0]
    mask = _mask(4, 8, seed=2)

    def jloss(q_, k_, v_):
        o = JA.sharded_flash_attention(jm, q_, k_, v_,
                                       padding_mask=jnp.asarray(mask),
                                       dropout_rate=drop, dropout_seed=11)
        return jnp.sum(o * g)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = TA.sharded_flash_attention(mesh, tq, tk, tv,
                                   padding_mask=torch.from_numpy(mask),
                                   dropout_rate=drop, dropout_seed=11)
    (o * torch.from_numpy(g)).sum().backward()
    for name, t, w in zip("qkv", (tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=ATOL, rtol=0, err_msg=f"d{name}")


def test_sharded_flash_refuses_what_jax_refuses():
    jm, mesh = _meshes()
    q = np.zeros((3, 4, 8, 8), np.float32)
    with pytest.raises(ValueError, match="batch % dp == 0") as got:
        TA.sharded_flash_attention(mesh, *[torch.from_numpy(q)] * 3)
    with pytest.raises(ValueError) as want:
        JA.sharded_flash_attention(jm, *[jnp.asarray(q)] * 3)
    assert str(got.value) == str(want.value)
    q = torch.zeros(2, 3, 8, 8)
    with pytest.raises(ValueError, match="heads % mp == 0"):
        TA.sharded_flash_attention(mesh, q, q, q)


CFG = dict(vocab=50, hidden_size=32, n_block=2, n_head=2, seq_len=16,
           intermediate_size=64)


def _bert():
    jb = JBERT(num_classes=3, bert_config=CFG)
    params, state = jb.net.build(jax.random.PRNGKey(0))
    tb = TBERT(num_classes=3, bert_config=CFG, device="cpu")
    tb.load_weights(jax.tree_util.tree_map(np.asarray, params))
    return jb, params, state, tb


def _inputs(B=4, seed=0):
    rs = np.random.default_rng(seed)
    T = CFG["seq_len"]
    ids = rs.integers(0, CFG["vocab"], (B, T)).astype(np.int32)
    seg = rs.integers(0, 2, (B, T)).astype(np.int32)
    lens = np.array([16, 9, 3, 12][:B])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    return [ids, seg, mask]


def test_bert_under_a_2d_context_equals_itself_without_one(monkeypatch):
    jb, params, state, tb = _bert()
    x = _inputs()
    alone = tb.predict(x, batch_size=4)
    calls = []
    inner = self_attention.sharded_flash_attention

    def spy(mesh, *args, **kw):
        calls.append(dict(mesh.shape))
        return inner(mesh, *args, **kw)

    monkeypatch.setattr(self_attention, "sharded_flash_attention", spy)
    ctx = tctx.ZooContext(ZooConfig(), tctx._build_mesh(
        [torch.device("cpu")] * 4, MeshConfig(data=2, model=2)))
    with tctx.context_scope(ctx):
        sharded = tb.predict(x, batch_size=4)
        odd = tb.predict([a[:3] for a in x], batch_size=3)
    assert calls == [{"data": 2, "model": 2, "sequence": 1, "expert": 1,
                      "pipeline": 1}] * CFG["n_block"]
    np.testing.assert_allclose(sharded, alone, atol=1e-6, rtol=0)
    # a batch the data axis does not divide runs unsharded
    np.testing.assert_allclose(odd, alone[:3], atol=1e-6, rtol=0)
    # ... and the JAX model under its own 2D context answers the same
    jm = jctx.ZooContext(JZooConfig(), jctx._build_mesh(
        jax.devices("cpu")[:4], JMeshConfig(data=2, model=2)))
    with jctx.context_scope(jm):
        want = np.asarray(jb.net.apply(params, state, x)[0])
    np.testing.assert_allclose(sharded, want, atol=1e-5, rtol=0)


def test_a_global_2d_context_routes_until_reset(monkeypatch):
    _, _, _, tb = _bert()
    x = _inputs()
    calls = []
    inner = self_attention.sharded_flash_attention
    monkeypatch.setattr(self_attention, "sharded_flash_attention",
                        lambda *a, **kw: calls.append(1) or inner(*a, **kw))
    try:
        tctx.init_zoo_context(ZooConfig(mesh=MeshConfig(data=2, model=2)),
                              devices=["cpu"] * 4)
        tb.predict(x, batch_size=4)
        assert len(calls) == CFG["n_block"]
    finally:
        tctx.reset_context()
    tb.predict(x, batch_size=4)
    assert len(calls) == CFG["n_block"]      # no context: unsharded
