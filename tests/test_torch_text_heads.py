"""The port's BERT NER and SQuAD heads against the JAX package's, on the CPU.

A tiny BERT (2 blocks, hidden 32, 2 heads, seq 16, vocab 50) is built in
JAX under each head and its parameter tree loaded into the port
(``{"bert": ..., "head": {"W", "b"}}``, strict paths).  f32 tolerances:
forwards 1e-5; ``_squad_loss`` and its gradient 1e-6; the training
forward with dropout on from the same int seed 1e-5 (outputs and
gradients); ``train`` with dropout off step for step 1e-5 (losses,
relative) and 1e-5 on the weights after 3 AdamWeightDecay steps, but
1e-4 on the elements whose gradient is 0 in exact arithmetic
(``_noise_driven``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.estimator import estimator as JE
from analytics_zoo_tpu.keras.optimizers import AdamWeightDecay as JAdamW
from analytics_zoo_tpu.tfpark import TFDataset as JTFDataset
from analytics_zoo_tpu.tfpark import text_estimators as JT
from analytics_zoo_tpu_torch.estimator import estimator as TE
from analytics_zoo_tpu_torch.keras.optimizers import (
    AdamWeightDecay as TAdamW)
from analytics_zoo_tpu_torch.tfpark import TFDataset as TTFDataset
from analytics_zoo_tpu_torch.tfpark import text_estimators as TT

CFG = dict(vocab=50, hidden_size=32, n_block=2, n_head=2, seq_len=16,
           intermediate_size=64)
TAGS = 9                       # the CoNLL-2003 BIO set: O + B-/I- x 4
ATOL = 1e-5


def _tree(params):
    return jax.tree_util.tree_map(np.array, params)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _inputs(n, seed=0):
    rs = np.random.default_rng(seed)
    T = CFG["seq_len"]
    ids = rs.integers(1, CFG["vocab"], (n, T)).astype(np.int32)
    lens = rs.integers(4, T + 1, n)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    seg = (np.arange(T)[None] >= (lens // 2)[:, None]).astype(np.int32)
    return [ids * mask, seg, mask], lens


def _ner_data(n, seed=0):
    x, _ = _inputs(n, seed)
    return x, (x[0] % TAGS).astype(np.int32)     # a tag per token id


def _squad_data(n, seed=0):
    x, lens = _inputs(n, seed)
    rs = np.random.default_rng(seed + 1)
    start = rs.integers(0, lens // 2 + 1).astype(np.int64)
    end = np.minimum(start + rs.integers(0, 3, n), lens - 1).astype(np.int64)
    return x, [start, end]


def _pair(head, cfg, seed=0):
    """The JAX estimator with built weights and the port's holding them."""
    if head == "ner":
        jest, test = JT.BERTNER(TAGS, bert_config=cfg), TT.BERTNER(
            TAGS, bert_config=cfg, device="cpu")
    else:
        jest, test = JT.BERTSQuAD(bert_config=cfg), TT.BERTSQuAD(
            bert_config=cfg, device="cpu")
    params, _ = jest.net.build(jax.random.PRNGKey(seed))
    test.load_weights(_tree(params))
    return jest, test, params


def _outs(y):
    return [np.asarray(a) for a in y] if isinstance(y, list) else [
        np.asarray(y)]


@pytest.mark.parametrize("head", ["ner", "squad"])
def test_forward_matches_jax(head):
    jest, test, params = _pair(head, CFG)
    x, _ = _inputs(5, seed=2)
    want, _ = jest.net.apply(params, {}, [jnp.asarray(a) for a in x])
    got = test.predict(x, batch_size=2)
    for g, w in zip(_outs(got), _outs(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    if head == "ner":
        assert got.shape == (5, CFG["seq_len"], TAGS)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    else:
        assert [a.shape for a in got] == [(5, CFG["seq_len"])] * 2
    assert set(_flat(test.net.get_weights()[0])) == set(_flat(_tree(params)))


def test_squad_loss_and_gradient_match_jax():
    rs = np.random.default_rng(3)
    logits = [rs.standard_normal((6, 16)).astype(np.float32)
              for _ in range(2)]
    labels = [rs.integers(0, 16, 6).astype(np.int32) for _ in range(2)]
    jl, jg = jax.value_and_grad(lambda p: JT._squad_loss(p, labels))(
        [jnp.asarray(a) for a in logits])
    tp = [torch.from_numpy(a).requires_grad_() for a in logits]
    tl = TT._squad_loss(tp, [torch.from_numpy(a) for a in labels])
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), abs=1e-6)
    for t, w in zip(tp, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
    # int64 positions (what a TFRecord file holds) give the same loss
    tl64 = TT._squad_loss([t.detach() for t in tp],
                          [torch.from_numpy(a.astype(np.int64))
                           for a in labels])
    assert float(tl64) == float(tl.detach())


def test_squad_loss_name_is_the_loss_on_class_and_instance():
    assert TT.BERTSQuAD.loss_name is TT._squad_loss
    assert TT.BERTSQuAD(bert_config=CFG, device="cpu").loss_name \
        is TT._squad_loss
    assert TT.BERTNER.loss_name == "sparse_categorical_crossentropy"


@pytest.mark.parametrize("head", ["ner", "squad"])
@pytest.mark.parametrize("seed", [7, -3])
def test_training_forward_with_dropout_matches_jax(head, seed):
    cfg = dict(CFG, hidden_drop=0.1, attn_drop=0.1)
    jest, test, params = _pair(head, cfg)
    x, _ = _inputs(4, seed=1)
    rs = np.random.default_rng(2)
    # a small projection: f32 sums over (B, T, C) stay near 1e-6 relative
    ws = [0.05 * rs.standard_normal(w.shape).astype(np.float32)
          for w in _outs(jest.net.apply(params, {}, x)[0])]

    def jloss(p):
        y, _ = jest.net.apply(p, {}, x, training=True, rng=seed)
        return sum(jnp.sum(a * w) for a, w in zip(
            y if isinstance(y, list) else [y], ws)), y
    (_, jy), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    test.net.train()
    y = test.net([torch.from_numpy(a) for a in x], seed=seed)
    ys = y if isinstance(y, list) else [y]
    sum((a * torch.from_numpy(w)).sum() for a, w in zip(ys, ws)).backward()
    test.net.eval()
    for g, w in zip(ys, _outs(jy)):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=ATOL, rtol=0)
    want = _flat(_tree(jgrads))
    # the pooler is unused by both heads: JAX's gradient there is zero
    got = {n: np.zeros(p.shape, np.float32) if p.grad is None
           else p.grad.numpy() for n, p in test.net.named_parameters()}
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g, atol=ATOL, rtol=0,
                                   err_msg=name)


# Elements whose gradient is 0 in exact arithmetic, so that both packages
# step them on rounding noise, which Adam scales up to a full step: the
# key bias (adding one vector to every key shifts a query's scores by one
# constant, which the softmax over keys cancels) and, under SQuAD's softmax
# over positions, the head's bias and the last block's LayerNorm shift.
# Read after 3 steps: key biases 2.5e-6 / 2.6e-6 (NER), 3.8e-6 / 9.0e-6
# (SQuAD), SQuAD's head.b 1.1e-5, its last ln2.beta 8.2e-6; every other
# element 6e-8 or less.
NOISE_ATOL = 1e-4


def _noise_driven(head, name, shape):
    noise = np.zeros(shape, bool)
    if name.endswith("attn.qkv.b"):
        d = shape[0] // 3
        noise[d:2 * d] = True
    if head == "squad" and (name == "head.b" or name.endswith(
            f"_block{CFG['n_block'] - 1}.ln2.beta")):
        noise[...] = True
    return noise


def _record(monkeypatch, cls, name, value_of):
    seen, orig = [], getattr(cls, name)

    def spy(self, *args, **kw):
        out = orig(self, *args, **kw)
        seen.extend(value_of(args, out))
        return out
    monkeypatch.setattr(cls, name, spy)
    return seen


@pytest.mark.parametrize("head", ["ner", "squad"])
def test_train_matches_jax_step_for_step(monkeypatch, head):
    cfg = dict(CFG, hidden_drop=0.0, attn_drop=0.0)
    opt = dict(lr=1e-3, warmup_portion=0.2, total=10, weight_decay=0.01)
    x, y = (_ner_data if head == "ner" else _squad_data)(16)
    if head == "ner":
        jest = JT.BERTNER(TAGS, bert_config=cfg, optimizer=JAdamW(**opt))
        test = TT.BERTNER(TAGS, bert_config=cfg, optimizer=TAdamW(**opt),
                          device="cpu")
    else:
        jest = JT.BERTSQuAD(bert_config=cfg, optimizer=JAdamW(**opt))
        test = TT.BERTSQuAD(bert_config=cfg, optimizer=TAdamW(**opt),
                            device="cpu")
    params, _ = jest.net.build(jax.random.PRNGKey(4))
    start = _tree(params)
    jest._variables = (params, {})
    test.load_weights(start)
    jlosses = _record(monkeypatch, JE.Estimator, "_post_dispatch",
                      lambda a, out: np.ravel(np.asarray(a[2])).tolist())
    tlosses = _record(monkeypatch, TE.Estimator, "_train_step",
                      lambda a, out: [float(out)])
    data = (tuple(x), y)
    jest.train(JTFDataset.from_ndarrays(data, batch_size=8), steps=3)
    test.train(TTFDataset.from_ndarrays(data, batch_size=8), steps=3)
    assert len(jlosses) == len(tlosses) == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=0)
    want = _flat(_tree(jest._variables[0]))
    got = _flat(test.net.get_weights()[0])
    for name, w in want.items():
        g, noise = got[name], _noise_driven(head, name, w.shape)
        np.testing.assert_allclose(g[~noise], w[~noise], atol=ATOL, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(g[noise], w[noise], atol=NOISE_ATOL,
                                   rtol=0, err_msg=name)
    # evaluate takes the list of labels (SQuAD) and gives JAX's loss
    jeval = jest.evaluate(JTFDataset.from_ndarrays(data, batch_size=8))
    teval = test.evaluate(TTFDataset.from_ndarrays(data, batch_size=8))
    assert teval["loss"] == pytest.approx(jeval["loss"], rel=1e-5)


def test_squad_on_the_device_tier_with_graph_groups_equals_eager():
    """A list label tree through the DEVICE tier and K-step dispatches
    (on the CPU the K steps run one after another) gives K = 1's steps."""
    x, y = _squad_data(32)
    runs = []
    for k in (4, 1):
        est = TT.BERTSQuAD(bert_config=CFG, optimizer=TAdamW(lr=1e-3),
                           steps_per_dispatch=k, device="cpu",
                           generator=torch.Generator().manual_seed(0))
        ds = TTFDataset.from_ndarrays((tuple(x), y), batch_size=4,
                                      memory_type="DEVICE")
        est.train(ds, epochs=1, seed=3)
        runs.append((est._train_est.history[0]["loss"],
                     _flat(est.net.get_weights()[0])))
    assert runs[0][0] == pytest.approx(runs[1][0], rel=1e-6)
    for name, w in runs[1][1].items():
        np.testing.assert_allclose(runs[0][1][name], w, atol=1e-6, rtol=0)


def test_ner_loss_covers_padding_tokens():
    """The JAX loss has no mask: padded tokens count."""
    from analytics_zoo_tpu_torch.keras import losses
    est = TT.BERTNER(TAGS, bert_config=CFG, device="cpu")
    x, y = _ner_data(4)
    probs = est.net([torch.from_numpy(a) for a in x])
    loss = losses.get(est.loss_name)(probs, torch.from_numpy(y))
    p = probs.detach().numpy().reshape(-1, TAGS)
    want = -np.mean(np.log(np.clip(p[np.arange(len(p)), y.reshape(-1)],
                                   1e-7, 1.0)))
    assert float(loss.detach()) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("cls", [TT.BERTNER, TT.BERTSQuAD])
def test_sharding_options_name_item_5(cls):
    # the options item 5 ported train under the global context: the ZeRO
    # update and Megatron-placed weights over data 2 x model 2 of the CPU
    from analytics_zoo_tpu_torch.common import context as tctx
    from analytics_zoo_tpu_torch.common.config import MeshConfig, ZooConfig
    from analytics_zoo_tpu_torch.parallel import bytes_per_device, tree_bytes
    args = (TAGS,) if cls is TT.BERTNER else ()
    x, y = (_ner_data if cls is TT.BERTNER else _squad_data)(8)
    tctx.reset_context()
    tctx.init_zoo_context(ZooConfig(mesh=MeshConfig(data=2, model=2)),
                          devices=["cpu"] * 4)
    try:
        for kw in (dict(shard_optimizer=True), dict(shard_model=True)):
            est = cls(*args, bert_config=CFG, device="cpu", **kw)
            est.train(TTFDataset.from_ndarrays((tuple(x), y), batch_size=4),
                      seed=1)
            inner = est._train_est
            assert inner.global_step == 2
            assert np.isfinite(inner.history[-1]["loss"])
            tree = inner.params if "shard_model" in kw else {
                k: v for k, v in inner.opt_state.items() if k != "decayed"}
            assert bytes_per_device(tree) < tree_bytes(tree)
    finally:
        tctx.reset_context()
