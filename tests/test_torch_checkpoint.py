"""Checkpoints, resume and retry: the port against the JAX package, on the
CPU.

The JAX Estimator writes a checkpoint (a tiny BERT classifier, an
AdamWeightDecay whose first moment is bf16); the port restores it (its
``treedef.pkl`` pickles a jax ``PyTreeDef``, read without jax) and
continues, and that continuation must equal the JAX package's own resumed
run: per-step losses to 1e-5 relative, weights to 1e-5 absolute (f32,
dropout off; the two packages' CPU matmuls sum in other orders).  A
checkpoint the port writes restores bit for bit and a resumed run equals
the uninterrupted one exactly; an incomplete ``ckpt-*`` is never
restored; ``keep_checkpoints`` keeps the newest; a failed epoch is retried
from the latest checkpoint as the JAX loop retries it.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common.triggers import (
    SeveralIteration as JSeveralIteration)
from analytics_zoo_tpu.data import FeatureSet as JFeatureSet
from analytics_zoo_tpu.estimator import estimator as JE
from analytics_zoo_tpu.keras.optimizers import AdamWeightDecay as JAdamW
from analytics_zoo_tpu.tfpark.text_estimators import BERTClassifier as JBERT
from analytics_zoo_tpu_torch.common.config import TrainConfig, ZooConfig
from analytics_zoo_tpu_torch.common.triggers import SeveralIteration
from analytics_zoo_tpu_torch.data.featureset import FeatureSet
from analytics_zoo_tpu_torch.estimator import checkpoint as TC
from analytics_zoo_tpu_torch.estimator import estimator as TE
from analytics_zoo_tpu_torch.keras.optimizers import AdamWeightDecay as TAdamW
from analytics_zoo_tpu_torch.tfpark import BERTClassifier as TBERT

CFG = dict(vocab=50, hidden_size=32, n_block=2, n_head=2, seq_len=16,
           intermediate_size=64, hidden_drop=0.0, attn_drop=0.0)
OPT = dict(lr=1e-3, warmup_portion=0.2, total=40, weight_decay=0.01,
           state_dtype="bfloat16")
LOSS = "sparse_categorical_crossentropy"


def _data(n=32, seed=0):
    rs = np.random.default_rng(seed)
    T = CFG["seq_len"]
    ids = rs.integers(1, CFG["vocab"], (n, T)).astype(np.int32)
    lens = rs.integers(4, T + 1, n)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    seg = (np.arange(T)[None] >= (lens // 2)[:, None]).astype(np.int32)
    return [ids * mask, seg, mask], (ids[:, 0] % 2).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _losses(monkeypatch, cls):
    seen, orig = [], cls._post_dispatch

    def spy(self, n, k, lv, *args, **kw):
        seen.extend(np.ravel(np.asarray(
            lv.float().cpu() if isinstance(lv, torch.Tensor) else lv))
            .tolist())
        return orig(self, n, k, lv, *args, **kw)
    monkeypatch.setattr(cls, "_post_dispatch", spy)
    return seen


def _jax_start():
    jclf = JBERT(num_classes=2, bert_config=CFG)
    params, _ = jclf.net.build(jax.random.PRNGKey(5))
    return jclf.net, jax.tree_util.tree_map(np.array, params)


def _port_net(start=None):
    clf = TBERT(num_classes=2, bert_config=CFG, device="cpu",
                generator=torch.Generator().manual_seed(0))
    if start is not None:
        clf.load_weights(start)
    return clf.net


def test_port_restores_a_jax_checkpoint_and_continues_as_jax(
        tmp_path, monkeypatch):
    x, y = _data()
    jnet, start = _jax_start()
    written = str(tmp_path / "written")
    jest = JE.Estimator(jnet, JAdamW(**OPT), LOSS, checkpoint_dir=written)
    jest.train(JFeatureSet.from_ndarrays(list(x), y), batch_size=8,
               epochs=1, variables=(start, {}))
    assert os.path.isdir(os.path.join(written, "ckpt-4"))
    for who in ("j", "t"):
        shutil.copytree(written, str(tmp_path / who))

    jl = _losses(monkeypatch, JE.Estimator)
    tl = _losses(monkeypatch, TE.Estimator)
    jnet2, _ = _jax_start()
    jres = JE.Estimator(jnet2, JAdamW(**OPT), LOSS,
                        checkpoint_dir=str(tmp_path / "j"))
    jres.train(JFeatureSet.from_ndarrays(list(x), y), batch_size=8,
               epochs=3, resume=True, variables=(start, {}))
    tnet = _port_net()
    tres = TE.Estimator(tnet, TAdamW(**OPT), LOSS,
                        checkpoint_dir=str(tmp_path / "t"), device="cpu")
    tres.train(FeatureSet.from_ndarrays(list(x), y), batch_size=8,
               epochs=3, resume=True)
    # resumed at epoch 1 of 3, step 4: two more epochs of 4 steps
    assert tres.global_step == jres.global_step == 12
    assert len(tl) == len(jl) == 8
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    want = _flat(jax.tree_util.tree_map(np.asarray, jres.params))
    got = _flat(tnet.get_weights()[0])
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=1e-5, rtol=0,
                                   err_msg=name)
    assert all(m.dtype == torch.bfloat16
               for m in tres.opt_state["mu"].values())
    assert int(tres.opt_state["count"]) == 12


def test_jax_checkpoint_reads_without_jax_classes(tmp_path):
    # the JAX bundle maps onto the port's names: dotted parameter names,
    # optax's ScaleByAdamState(count, mu, nu) onto the optimizer's slots,
    # the bf16 first moment kept bf16, meta's numbers as ints
    x, y = _data()
    jnet, start = _jax_start()
    jest = JE.Estimator(jnet, JAdamW(**OPT), LOSS,
                        checkpoint_dir=str(tmp_path))
    jest.train(JFeatureSet.from_ndarrays(list(x), y), batch_size=8,
               epochs=1, variables=(start, {}))
    (params, opt, state, meta), step = TC.restore_checkpoint(
        TC.latest_checkpoint(str(tmp_path)))
    assert step == 4 and meta == {"epoch": 1,
                                  "data_cursor": {"epoch": 1, "step": 0}}
    want = _flat(jax.tree_util.tree_map(np.asarray, jest.params))
    assert set(params) == set(want) and state == {}
    for name, w in want.items():
        np.testing.assert_array_equal(params[name].numpy(), w)
    assert int(opt["count"]) == 4
    jmu = _flat(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jest.opt_state[0].mu))
    for name, m in jmu.items():
        assert opt["mu"][name].dtype == torch.bfloat16
        np.testing.assert_array_equal(opt["mu"][name].float().numpy(), m)
    assert opt["nu"][next(iter(jmu))].dtype == torch.float32


def _port_est(net, ckdir, **kw):
    return TE.Estimator(net, TAdamW(**OPT), LOSS, checkpoint_dir=ckdir,
                        device="cpu", **kw)


def test_port_round_trip_is_exact(tmp_path):
    x, y = _data()
    fs = FeatureSet.from_ndarrays(list(x), y)
    whole = _port_est(_port_net(), None)
    whole.train(fs, batch_size=8, epochs=3, seed=2)
    first = _port_est(_port_net(), str(tmp_path))
    first.train(fs, batch_size=8, epochs=1, seed=2)
    (params, opt, state, meta), step = TC.restore_checkpoint(
        TC.latest_checkpoint(str(tmp_path)))
    assert step == 4 and meta["epoch"] == 1
    for name, p in first.model.named_parameters():
        assert torch.equal(params[name], p.detach())
    for name, m in first.opt_state["mu"].items():
        assert opt["mu"][name].dtype == torch.bfloat16
        assert torch.equal(opt["mu"][name], m)
    assert torch.equal(opt["count"], first.opt_state["count"])
    resumed = _port_est(_port_net(), str(tmp_path))
    resumed.train(fs, batch_size=8, epochs=3, seed=2, resume=True)
    assert resumed.global_step == whole.global_step == 12
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in whole.history[1:]]
    for (n, a), (_, b) in zip(whole.model.named_parameters(),
                              resumed.model.named_parameters()):
        assert torch.equal(a, b), n


def test_an_incomplete_checkpoint_is_never_restored(tmp_path):
    x, y = _data()
    est = _port_est(_port_net(), str(tmp_path))
    est.train(FeatureSet.from_ndarrays(list(x), y), batch_size=8, epochs=1)
    good = TC.latest_checkpoint(str(tmp_path))
    assert good.endswith("ckpt-4")
    # a later step whose marker never landed, and a write cut short
    torn = tmp_path / "ckpt-9"
    shutil.copytree(good, str(torn))
    os.remove(torn / "COMPLETE")
    shutil.copytree(good, str(tmp_path / "ckpt-12.tmp"))
    assert TC.latest_checkpoint(str(tmp_path)) == good
    assert TC.latest_checkpoint(str(tmp_path / "none")) is None
    resumed = _port_est(_port_net(), str(tmp_path))
    resumed.train(FeatureSet.from_ndarrays(list(x), y), batch_size=8,
                  epochs=2, resume=True)
    assert resumed.global_step == 8


def test_keep_retains_the_newest(tmp_path):
    x, y = _data()
    config = ZooConfig(train=TrainConfig(keep_checkpoints=2))
    est = TE.Estimator(_port_net(), TAdamW(**OPT), LOSS, config=config,
                       checkpoint_dir=str(tmp_path),
                       checkpoint_trigger=SeveralIteration(3), device="cpu")
    est.train(FeatureSet.from_ndarrays(list(x), y), batch_size=8, epochs=3)
    assert sorted(os.listdir(tmp_path)) == ["ckpt-12", "ckpt-9"]
    for keep in (1, 3):
        d = tmp_path / f"keep{keep}"
        for step in range(5):
            TC.save_checkpoint(str(d), step, ({"w": torch.ones(2) * step},),
                               keep=keep)
        assert sorted(os.listdir(d)) == [f"ckpt-{s}"
                                         for s in range(5 - keep, 5)]


def _flaky(monkeypatch, cls, est):
    """Make ``est``'s epoch fail once, after its second step."""
    done = {"failed": False}
    orig = cls._run_epoch

    def run_epoch(self, *args, **kw):
        if self is est and not done["failed"] and self.global_step >= 2:
            done["failed"] = True
            raise RuntimeError("simulated worker failure")
        return orig(self, *args, **kw)
    monkeypatch.setattr(cls, "_run_epoch", run_epoch)
    return done


def test_retry_restores_and_finishes_as_jax(tmp_path, monkeypatch):
    # checkpoints every step; the second epoch fails at its start, is
    # retried from the latest checkpoint (step 4, epoch 1) and both
    # packages finish the same three epochs on the same weights (an f32
    # first moment: the resumed bf16 one is the test above)
    x, y = _data()
    jnet, start = _jax_start()
    opt = dict(OPT, state_dtype=None)
    jest = JE.Estimator(jnet, JAdamW(**opt), LOSS,
                        checkpoint_dir=str(tmp_path / "j"),
                        checkpoint_trigger=JSeveralIteration(1))
    tnet = _port_net(start)
    test = TE.Estimator(tnet, TAdamW(**opt), LOSS,
                        checkpoint_dir=str(tmp_path / "t"),
                        checkpoint_trigger=SeveralIteration(1),
                        device="cpu")
    jdone = _flaky(monkeypatch, JE.Estimator, jest)
    tdone = _flaky(monkeypatch, TE.Estimator, test)
    jest.train(JFeatureSet.from_ndarrays(list(x), y), batch_size=8,
               epochs=3, variables=(start, {}))
    test.train(FeatureSet.from_ndarrays(list(x), y), batch_size=8, epochs=3)
    assert jdone["failed"] and tdone["failed"]
    assert test.global_step == jest.global_step == 12
    np.testing.assert_allclose([h["loss"] for h in test.history],
                               [h["loss"] for h in jest.history],
                               rtol=1e-5)
    want = _flat(jax.tree_util.tree_map(np.asarray, jest.params))
    got = _flat(tnet.get_weights()[0])
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=1e-5, rtol=0)


def test_no_retry_without_a_checkpoint_or_retries_left(tmp_path,
                                                       monkeypatch):
    x, y = _data()
    fs = FeatureSet.from_ndarrays(list(x), y)
    est = _port_est(_port_net(), None)
    _flaky(monkeypatch, TE.Estimator, est)
    with pytest.raises(RuntimeError, match="simulated"):
        est.train(fs, batch_size=8, epochs=2)
    config = ZooConfig(train=TrainConfig(failure_retry_times=0))
    est = TE.Estimator(_port_net(), TAdamW(**OPT), LOSS, config=config,
                       checkpoint_dir=str(tmp_path), device="cpu")
    _flaky(monkeypatch, TE.Estimator, est)
    with pytest.raises(RuntimeError, match="simulated"):
        est.train(fs, batch_size=8, epochs=2)
