"""The port's training path against the JAX package's, on the CPU.

A tiny BERT classifier (2 blocks, hidden 32, 2 heads, seq 16, vocab 50) is
built in JAX and its parameter tree loaded into the port.  The training
forward with an int seed and dropout 0.1 must give the same outputs and
parameter gradients (hidden dropout masks and attention keep-masks are
bit-identical); ``BERTClassifier.train`` with dropout off must follow the
same per-step losses and end at the same weights, from the same data and
shuffle.  f32 tolerances: 1e-5 on outputs, gradients and per-step losses
(relative), 1e-4 on the weights after 5 AdamWeightDecay steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.estimator import estimator as JE
from analytics_zoo_tpu.keras.layers import TransformerLayer as JTransformer
from analytics_zoo_tpu.keras.optimizers import AdamWeightDecay as JAdamW
from analytics_zoo_tpu.tfpark import TFDataset as JTFDataset
from analytics_zoo_tpu.tfpark.text_estimators import BERTClassifier as JBERT
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.common.config import MeshConfig, ZooConfig
from analytics_zoo_tpu_torch.common.context import ZooContext, _build_mesh
from analytics_zoo_tpu_torch.parallel import bytes_per_device, tree_bytes
from analytics_zoo_tpu_torch.estimator import Estimator
from analytics_zoo_tpu_torch.estimator import estimator as TE
from analytics_zoo_tpu_torch.keras.layers import (
    TransformerLayer as TTransformer)
from analytics_zoo_tpu_torch.keras.optimizers import (
    Adam as TAdam, AdamWeightDecay as TAdamW)
from analytics_zoo_tpu_torch.tfpark import (
    BERTClassifier as TBERT, TFDataset as TTFDataset)

CFG = dict(vocab=50, hidden_size=32, n_block=2, n_head=2, seq_len=16,
           intermediate_size=64)
ATOL = 1e-5


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _data(n, seed=0, ragged=True):
    rs = np.random.default_rng(seed)
    T = CFG["seq_len"]
    ids = rs.integers(1, CFG["vocab"], (n, T)).astype(np.int32)
    lens = rs.integers(4, T + 1, n) if ragged else np.full(n, T)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    seg = (np.arange(T)[None] >= (lens // 2)[:, None]).astype(np.int32)
    labels = (ids[:, 0] % 2).astype(np.int32)    # learnable from the input
    return [ids * mask, seg, mask], labels


@pytest.mark.parametrize("seed", [7, -3])
def test_training_forward_and_gradients_match_jax(seed):
    cfg = dict(CFG, hidden_drop=0.1, attn_drop=0.1)
    jb = JBERT(num_classes=3, bert_config=cfg)
    params, state = jb.net.build(jax.random.PRNGKey(0))
    x, _ = _data(5, seed=1)
    w = np.random.default_rng(2).standard_normal((5, 3)).astype(np.float32)

    def jloss(p):
        probs, _ = jb.net.apply(p, state, x, training=True, rng=seed)
        return jnp.sum(probs * w), probs
    (jl, jprobs), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)

    tb = TBERT(num_classes=3, bert_config=cfg, device="cpu")
    tb.load_weights(_tree(params))
    tb.net.train()
    probs = tb.net([torch.from_numpy(a) for a in x], seed=seed)
    loss = (probs * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(probs.detach().numpy(), np.asarray(jprobs),
                               atol=ATOL, rtol=0)
    # dropout really ran: eval mode gives other outputs
    tb.net.eval()
    assert not np.allclose(tb.predict(x), probs.detach().numpy(), atol=1e-3)
    want = _flat(_tree(jgrads))
    got = {n: p.grad.numpy() for n, p in tb.net.named_parameters()}
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g, atol=ATOL, rtol=0,
                                   err_msg=name)


def test_transformer_layer_training_forward_matches_jax():
    jl = JTransformer(vocab=50, seq_len=16, n_block=2, hidden_size=32,
                      n_head=2, embedding_drop=0.2, hidden_drop=0.1,
                      attn_drop=0.1)
    params, state = jl.build(jax.random.PRNGKey(1), (None, 16))
    ids = np.random.default_rng(1).integers(0, 50, (3, 16)).astype(np.int32)
    want = np.asarray(jl.call(params, state, jnp.asarray(ids), True, 11)[0])
    tl = TTransformer(vocab=50, seq_len=16, n_block=2, hidden_size=32,
                      n_head=2, embedding_drop=0.2, name=jl.name)
    interop.load_jax_params(tl, _tree(params))
    tl.train()
    got = tl(torch.from_numpy(ids), seed=11).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _record(monkeypatch, cls, name, value_of):
    """Wrap ``cls.name`` to append ``value_of(result)`` per call."""
    seen, orig = [], getattr(cls, name)

    def spy(self, *args, **kw):
        out = orig(self, *args, **kw)
        seen.extend(value_of(args, out))
        return out
    monkeypatch.setattr(cls, name, spy)
    return seen


def test_classifier_train_matches_jax_step_for_step(monkeypatch):
    cfg = dict(CFG, hidden_drop=0.0, attn_drop=0.0)
    x, y = _data(24)
    opt = dict(lr=1e-3, warmup_portion=0.2, total=10, weight_decay=0.01)
    jclf = JBERT(num_classes=2, bert_config=cfg, optimizer=JAdamW(**opt))
    params, _ = jclf.net.build(jax.random.PRNGKey(3))
    start = jax.tree_util.tree_map(np.array, params)   # training donates
    jclf._variables = (params, {})
    tclf = TBERT(num_classes=2, bert_config=cfg, optimizer=TAdamW(**opt),
                 device="cpu")
    tclf.load_weights(start)

    jlosses = _record(monkeypatch, JE.Estimator, "_post_dispatch",
                      lambda a, out: np.ravel(np.asarray(a[2])).tolist())
    tlosses = _record(monkeypatch, TE.Estimator, "_train_step",
                      lambda a, out: [float(out)])
    data = (tuple(x), y)
    jclf.train(JTFDataset.from_ndarrays(data, batch_size=8), steps=5)
    tclf.train(TTFDataset.from_ndarrays(data, batch_size=8), steps=5)
    # 3 batches an epoch: the 5 steps span two shuffled epochs
    assert len(jlosses) == len(tlosses) == 5
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=0)
    assert tclf._train_est.global_step == 5

    want = _flat(_tree(jclf._variables[0]))
    got = _flat(tclf.net.get_weights()[0])
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=1e-4, rtol=0,
                                   err_msg=name)
    assert any(not np.array_equal(got[n], _flat(start)[n]) for n in got)

    jeval = jclf.evaluate(JTFDataset.from_ndarrays(data, batch_size=8))
    teval = tclf.evaluate(TTFDataset.from_ndarrays(data, batch_size=8))
    assert teval["accuracy"] == pytest.approx(jeval["accuracy"], abs=1e-12)
    assert teval["loss"] == pytest.approx(jeval["loss"], rel=1e-5)
    probs = tclf.predict(TTFDataset.from_ndarrays(data, batch_per_thread=5))
    assert probs.shape == (24, 2)
    np.testing.assert_allclose(probs, tclf.predict(x, batch_size=7),
                               atol=1e-6)


def test_same_seed_same_batches_as_jax():
    x, y = _data(20)
    jds = JTFDataset.from_ndarrays((tuple(x), y), batch_size=8)
    tds = TTFDataset.from_ndarrays((tuple(x), y), batch_size=8)
    for epoch in range(3):
        jb = list(jds.get_training_data().local_batches(8, epoch=epoch))
        tb = list(tds.get_training_data().local_batches(8, epoch=epoch))
        assert len(jb) == len(tb) == 2
        for (jx, jy), (tx, ty) in zip(jb, tb):
            np.testing.assert_array_equal(ty, jy)
            for a, b in zip(tx, jx):
                np.testing.assert_array_equal(a, b)


def test_loss_falls_in_f32_and_mixed_precision():
    x, y = _data(64, ragged=False)
    ds = TTFDataset.from_ndarrays((tuple(x), y), batch_size=16)
    for mixed in (False, True):
        clf = TBERT(num_classes=2, bert_config=CFG, optimizer=TAdam(1e-3),
                    mixed_precision=mixed, device="cpu",
                    generator=torch.Generator().manual_seed(0))
        clf.train(ds, epochs=4, seed=5)
        hist = clf._train_est.history
        assert [h["epoch"] for h in hist] == [1, 2, 3, 4]
        assert all(np.isfinite(h["loss"]) and h["seconds"] > 0 for h in hist)
        assert hist[-1]["loss"] < hist[0]["loss"]
        # masters stay f32; the evaluation runs in f32
        assert all(p.dtype == torch.float32 for p in clf.net.parameters())
        assert clf.evaluate(ds)["accuracy"] > 0.5


def test_validation_during_training_sets_the_score():
    from analytics_zoo_tpu_torch.common.triggers import MaxScore
    cfg = dict(CFG, hidden_drop=0.1, attn_drop=0.1)
    nets = [TBERT(num_classes=2, bert_config=cfg, device="cpu").net
            for _ in range(2)]
    nets[1].load_state_dict(nets[0].state_dict())
    ests = [Estimator(n, "adam", "sparse_categorical_crossentropy",
                      metrics=["accuracy"], device="cpu") for n in nets]
    x, y = _data(16)
    fs = TTFDataset.from_ndarrays((tuple(x), y), batch_size=8) \
        .get_training_data()
    # validation at every epoch end leaves the training as it was
    # (dropout on again in the next epoch)
    hist = ests[0].train(fs, 8, epochs=2, validation_data=fs, seed=4)
    plain = ests[1].train(fs, 8, epochs=2, seed=4)
    assert [h["loss"] for h in hist] == [h["loss"] for h in plain]
    assert all("val_accuracy" in h and "val_loss" in h for h in hist)
    # accuracy > -1 always: the end trigger fires on the first score,
    # which only the epoch end's validation can set
    hist = ests[0].train(fs, 8, epochs=3, validation_data=fs, seed=4,
                         end_trigger=MaxScore(-1.0))
    assert len(hist) == 3 and ests[0].global_step == 6
    want = ests[0].evaluate(fs, 8)
    assert {k: hist[-1][f"val_{k}"] for k in want} == want


def test_estimator_options_not_ported_raise():
    # every option of the JAX estimator trains now (each for two steps
    # here; their parity with JAX is test_torch_multistep.py, and the
    # sharded ones' test_torch_mesh_train.py): the ZeRO update and the
    # Megatron-placed weights on a data 2 x model 2 mesh of the CPU
    net = TBERT(num_classes=2, bert_config=CFG, device="cpu").net
    x, y = _data(8)
    fs = TTFDataset.from_ndarrays((tuple(x), y), batch_size=4) \
        .get_training_data()
    mc = MeshConfig(data=2, model=2)
    ctx = ZooContext(ZooConfig(mesh=mc),
                     _build_mesh([torch.device("cpu")] * 4, mc))
    for kw in (dict(shard_optimizer=True), dict(shard_model=True)):
        est = Estimator(net, "adam", "sparse_categorical_crossentropy",
                        ctx=ctx, **kw)
        hist = est.train(fs, 4, seed=1)
        assert est.global_step == 2 and np.isfinite(hist[-1]["loss"])
        tree = est.params if "shard_model" in kw else {
            k: v for k, v in est.opt_state.items() if k != "decayed"}
        assert bytes_per_device(tree) < tree_bytes(tree)
    for kw in (dict(steps_per_dispatch=2), dict(grad_accum_steps=2),
               dict(remat=True),
               dict(mixed_precision=True, grad_dtype="bfloat16")):
        est = Estimator(net, "adam", "sparse_categorical_crossentropy",
                        device="cpu", **kw)
        hist = est.train(fs, 4, seed=1)
        assert est.global_step == 2 and np.isfinite(hist[-1]["loss"])
    est = Estimator(net, "adam", "sparse_categorical_crossentropy",
                    device="cpu")
    est.train(fs, 4, resume=True)           # no checkpoint_dir: a fresh run
    assert est.global_step == 2
    dev = TTFDataset.from_ndarrays((tuple(x), y), batch_size=4,
                                   memory_type="DEVICE").get_training_data()
    assert [b[1].tolist() for b in dev.batches(4)] == \
        [y[i].tolist() for i in dev.base._epoch_indices(0).reshape(2, 4)[
            dev.stacked_epoch(4, 0)[3]]]