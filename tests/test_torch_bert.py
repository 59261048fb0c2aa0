"""The port's BERT classifier against the JAX package's, on the CPU.

A tiny BERTClassifier (2 blocks, hidden 32, 2 heads, seq 16, vocab 50) is
built in JAX, its parameter tree goes through ``interop.load_jax_params``
into the port, and both predict on the same numpy inputs.  f32 tolerance
1e-5 absolute on the class probabilities.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.keras import activations as JAct
from analytics_zoo_tpu.keras.layers import TransformerLayer as JTransformer
from analytics_zoo_tpu.keras.layers.normalization import LayerNorm as JLN
from analytics_zoo_tpu.tfpark.text_estimators import BERTClassifier as JBERT
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.keras import activations as TAct
from analytics_zoo_tpu_torch.keras.layers import (
    LayerNorm as TLN, TransformerLayer as TTransformer)
from analytics_zoo_tpu_torch.keras.layers.self_attention import (
    MultiHeadAttention, set_attention_backend)
from analytics_zoo_tpu_torch.tfpark import TFDataset
from analytics_zoo_tpu_torch.tfpark.text_estimators import (
    BERTClassifier as TBERT)

CFG = dict(vocab=50, hidden_size=32, n_block=2, n_head=2, seq_len=16,
           intermediate_size=64)
ATOL = 1e-5


def _jax_model(num_classes=3, seed=0):
    jb = JBERT(num_classes=num_classes, bert_config=CFG)
    params, state = jb.net.build(jax.random.PRNGKey(seed))
    return jb, params, state


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _inputs(lens, seed=0):
    rs = np.random.default_rng(seed)
    B, T = len(lens), CFG["seq_len"]
    ids = rs.integers(0, CFG["vocab"], (B, T)).astype(np.int32)
    seg = rs.integers(0, 2, (B, T)).astype(np.int32)
    mask = (np.arange(T)[None] < np.array(lens)[:, None]).astype(np.int32)
    return [ids, seg, mask]


@pytest.mark.parametrize("lens", [[16, 16, 16], [16, 9, 3, 1, 12],
                                  [0, 5, 16]], ids=["full", "ragged",
                                                    "empty_row"])
def test_classifier_probs_match_jax(lens):
    jb, params, state = _jax_model()
    x = _inputs(lens)
    want = np.asarray(jb.net.apply(params, state, x)[0])
    tb = TBERT(num_classes=3, bert_config=CFG, device="cpu")
    tb.load_weights(_tree(params))
    got = tb.predict(x, batch_size=2)
    assert got.shape == (len(lens), 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)


def test_param_tree_is_the_jax_tree():
    _, params, _ = _jax_model()
    tb = TBERT(num_classes=3, bert_config=CFG, device="cpu")
    tb.load_weights(_tree(params))
    got, state = tb.net.get_weights()
    assert state == {}
    want = _tree(params)
    jl = jax.tree_util.tree_leaves_with_path(want)
    tl = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(jl) == len(tl)
    for path, leaf in jl:
        np.testing.assert_array_equal(tl[path], leaf)
    assert "bert_classifier_bert_block1" in got["bert"]
    assert set(got["bert"]["bert_classifier_bert_block0"]) == {
        "attn", "ffn", "ln1", "ln2"}


def test_missing_extra_and_misshapen_keys_raise():
    _, params, _ = _jax_model()
    tb = TBERT(num_classes=3, bert_config=CFG, device="cpu")
    tree = _tree(params)
    missing = {"bert": dict(tree["bert"]), "head": tree["head"]}
    del missing["bert"]["pooler"]
    with pytest.raises(KeyError, match="bert.pooler.W"):
        tb.load_weights(missing)
    extra = {"bert": tree["bert"], "head": {**tree["head"], "c": 1.0}}
    with pytest.raises(KeyError, match="head.c"):
        tb.load_weights(extra)
    bad = {"bert": tree["bert"],
           "head": {"W": np.zeros((32, 4), np.float32),
                    "b": tree["head"]["b"]}}
    before = tb.net.head.W.detach().clone()
    with pytest.raises(ValueError, match="head.W"):
        tb.load_weights(bad)
    assert torch.equal(tb.net.head.W, before)   # nothing was written


def test_one_attention_layer_per_block_and_backend_switch():
    tb = TBERT(num_classes=2, bert_config=dict(CFG, n_block=3),
               device="cpu")
    mhas = [m for m in tb.net.modules() if isinstance(m, MultiHeadAttention)]
    assert len(mhas) == 3 and all(m.backend is None for m in mhas)
    set_attention_backend(tb.net, "plain")
    assert all(m.backend == "plain" for m in mhas)
    set_attention_backend(tb.net, "jnp")        # the JAX name of "plain"
    assert all(m.backend == "plain" for m in mhas)
    with pytest.raises(ValueError):
        set_attention_backend(tb.net, "xla")


def test_training_is_not_ported_yet(tmp_path):
    # the JAX estimator's knobs train now (multi-step dispatch, model_dir
    # checkpoints, LAMB); the training forward runs, and without a seed
    # it drops nothing
    x = _inputs([16, 9])
    ds = TFDataset.from_ndarrays((tuple(x), np.array([0, 1], np.int32)),
                                 batch_size=2)
    for kw in (dict(steps_per_dispatch=4), dict(model_dir=str(tmp_path)),
               dict(optimizer="lamb")):
        tb = TBERT(num_classes=2, bert_config=CFG, device="cpu", **kw)
        tb.train(ds, epochs=2)
        assert tb._train_est.global_step == 2
    assert sorted(os.listdir(tmp_path)) == ["ckpt-0", "ckpt-1", "ckpt-2"]
    tb.net.train()
    xt = [torch.from_numpy(a) for a in x]
    train_out = tb.net(xt)
    tb.net.eval()
    torch.testing.assert_close(train_out, tb.net(xt), atol=0, rtol=0)


def test_transformer_layer_matches_jax():
    jl = JTransformer(vocab=50, seq_len=16, n_block=2, hidden_size=32,
                      n_head=2)
    params, state = jl.build(jax.random.PRNGKey(1), (None, 16))
    ids = np.random.default_rng(1).integers(0, 50, (3, 16)).astype(np.int32)
    want = np.asarray(jl.call(params, state, jnp.asarray(ids), False,
                              None)[0])
    tl = TTransformer(vocab=50, seq_len=16, n_block=2, hidden_size=32,
                      n_head=2, name=jl.name)
    interop.load_jax_params(tl, _tree(params))
    got = tl(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_layer_norm_and_gelu_match_jax():
    x = np.random.default_rng(2).standard_normal((4, 7, 32)) \
        .astype(np.float32) * 3 + 1
    jln = JLN()
    p, _ = jln.build(None, (None, 7, 32))
    p = {"gamma": np.linspace(0.5, 2, 32).astype(np.float32),
         "beta": np.linspace(-1, 1, 32).astype(np.float32)}
    want = np.asarray(jln.call(p, {}, jnp.asarray(x), False, None)[0])
    tln = TLN(32)
    interop.load_jax_params(tln, p)
    np.testing.assert_allclose(tln(torch.from_numpy(x)).detach().numpy(),
                               want, atol=ATOL, rtol=0)
    for name in ("gelu", "gelu_exact", "tanh", "softmax"):
        np.testing.assert_allclose(
            TAct.get(name)(torch.from_numpy(x)).numpy(),
            np.asarray(JAct.get(name)(jnp.asarray(x))), atol=ATOL, rtol=0)


def test_params_tree_round_trips_dicts_and_lists():
    """BERT trees (dicts only) come back unchanged; a tree holding a list
    of blocks maps onto ``blocks.<i>`` keys and comes back as a list."""
    _, params, _ = _jax_model()
    tree = _tree(params)
    tb = TBERT(num_classes=3, bert_config=CFG, device="cpu")
    back = interop.params_tree(interop.load_jax_params(tb.net, tree))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)

    net = torch.nn.Module()
    net.head = torch.nn.Module()
    net.head.W = torch.nn.Parameter(torch.zeros(2, 3))
    net.blocks = torch.nn.ModuleList(torch.nn.Module() for _ in range(11))
    for blk in net.blocks:
        blk.b = torch.nn.Parameter(torch.zeros(4))
    listed = {"head": {"W": np.ones((2, 3), np.float32)},
              "blocks": [{"b": np.full(4, i, np.float32)}
                         for i in range(11)]}
    back = interop.params_tree(interop.load_jax_params(net, listed))
    assert isinstance(back["blocks"], list) and len(back["blocks"]) == 11
    assert [float(b["b"][0]) for b in back["blocks"]] == list(range(11))
    np.testing.assert_array_equal(back["head"]["W"], listed["head"]["W"])
