"""Multi-step dispatch, gradient accumulation, remat and the bf16 gradient
tree: the port's Estimator against the JAX package's, on the CPU.

A tiny BERT classifier (2 blocks, hidden 32, seq 16, vocab 50) is built in
JAX and its weights loaded into the port; both train on the same numpy
data and shuffle.  On the CPU the port runs the K steps of a dispatch one
after another (on the card they are CUDA graph replays), with the same
device-tensor seeds and step count as one step at a time.

Tolerances: f32 runs with dropout off hold per-step losses to 1e-5
relative and every weight to 1e-5 absolute against JAX (XLA's and
PyTorch's CPU matmuls sum in other orders); the port's K = 4 against its
K = 1 with dropout on is exact.  The bf16 run (bf16 forward, bf16
gradients, bf16 first moment) is held to 2e-2 relative on the losses, the
weights' change over the run to 10 % of JAX's change in relative L2 over
all of them, and each tensor's change to 50 %: both packages round to
bf16 at every matmul and elementwise op, but XLA keeps f32 intermediates
inside its fusions where PyTorch rounds each op, so the gradients differ
at bf16's resolution (2**-8 relative), more where a batch's per-example
gradients nearly cancel (the pooler's, pulled opposite ways by the two
classes), and Adam turns a gradient difference of a small gradient into a
difference of its lr-sized step.  The key third of each attention bias is
left out: its true gradient is zero (a row's softmax does not change when
a constant is added to all its scores), so its steps are Adam-normalised
rounding noise in either package.  Readings on the 8-device CPU mesh the
tests run on: losses 1.16e-2 relative at worst, the weights' change 5.0 %
over all of them, 36 % in the worst tensor (the pooler's bias).  The
per-tensor reading depends on JAX's reduction order: on a one-device
mesh the same run reads 64 % there (losses 1.05e-2, all weights 6.4 %).
"""

import os

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common.triggers import MaxIteration as JMaxIteration
from analytics_zoo_tpu.common.triggers import (
    SeveralIteration as JSeveralIteration)
from analytics_zoo_tpu.data import FeatureSet as JFeatureSet
from analytics_zoo_tpu.estimator import estimator as JE
from analytics_zoo_tpu.keras.optimizers import AdamWeightDecay as JAdamW
from analytics_zoo_tpu.tfpark.text_estimators import BERTClassifier as JBERT
from analytics_zoo_tpu_torch.common.triggers import MaxIteration
from analytics_zoo_tpu_torch.common.triggers import SeveralIteration
from analytics_zoo_tpu_torch.data.featureset import FeatureSet
from analytics_zoo_tpu_torch.estimator import estimator as TE
from analytics_zoo_tpu_torch.keras.optimizers import AdamWeightDecay as TAdamW
from analytics_zoo_tpu_torch.tfpark import BERTClassifier as TBERT

CFG = dict(vocab=50, hidden_size=32, n_block=2, n_head=2, seq_len=16,
           intermediate_size=64)
OPT = dict(lr=1e-3, warmup_portion=0.2, total=40, weight_decay=0.01)
LOSS = "sparse_categorical_crossentropy"


def _data(n, seed=0):
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
    """Every step's loss, read from what each dispatch hands
    ``_post_dispatch``."""
    seen, orig = [], cls._post_dispatch

    def spy(self, n, k, lv, *args, **kw):
        seen.extend(np.ravel(np.asarray(
            lv.float().cpu() if isinstance(lv, torch.Tensor) else lv))
            .tolist())
        return orig(self, n, k, lv, *args, **kw)
    monkeypatch.setattr(cls, "_post_dispatch", spy)
    return seen


def _pair(drop=0.0):
    """The JAX net with its initial weights, and the port's classifier net
    holding the same weights."""
    cfg = dict(CFG, hidden_drop=drop, attn_drop=drop)
    jclf = JBERT(num_classes=2, bert_config=cfg)
    params, _ = jclf.net.build(jax.random.PRNGKey(3))
    start = jax.tree_util.tree_map(np.array, params)
    tclf = TBERT(num_classes=2, bert_config=cfg, device="cpu")
    tclf.load_weights(start)
    return jclf.net, start, tclf.net


def _featuresets(tier, x, y):
    j = JFeatureSet.from_ndarrays(list(x), y)
    t = FeatureSet.from_ndarrays(list(x), y)
    if tier == "DEVICE":
        return j.cache_device(), t.cache_device()
    return j, t


def _assert_weights(tnet, jparams, atol):
    want = _flat(jax.tree_util.tree_map(np.asarray, jparams))
    got = _flat(tnet.get_weights()[0])
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=atol, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("tier", ["DRAM", "DEVICE"])
def test_four_steps_a_dispatch_match_jax(tier, tmp_path, monkeypatch):
    # 64 rows, batch 8: 8 steps an epoch, two dispatches of K = 4 (the
    # DEVICE tier chains up to the next possible checkpoint); checkpoints
    # every 3 steps land at the ends of the groups covering 3, 6, 9 and
    # 12; the end trigger at 14 stops both at the end of its group, 16
    jnet, start, tnet = _pair()
    x, y = _data(64)
    jfs, tfs = _featuresets(tier, x, y)
    jl = _losses(monkeypatch, JE.Estimator)
    tl = _losses(monkeypatch, TE.Estimator)
    jest = JE.Estimator(jnet, JAdamW(**OPT), LOSS, steps_per_dispatch=4,
                        checkpoint_dir=str(tmp_path / "j"),
                        checkpoint_trigger=JSeveralIteration(3))
    test = TE.Estimator(tnet, TAdamW(**OPT), LOSS, steps_per_dispatch=4,
                        checkpoint_dir=str(tmp_path / "t"),
                        checkpoint_trigger=SeveralIteration(3),
                        device="cpu")
    jhist = jest.train(jfs, batch_size=8, epochs=3,
                       end_trigger=JMaxIteration(14),
                       variables=(start, {}))
    thist = test.train(tfs, batch_size=8, epochs=3,
                       end_trigger=MaxIteration(14), seed=0)
    assert test.global_step == jest.global_step == 16
    assert len(tl) == len(jl) == 16
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert [h["epoch"] for h in thist] == [h["epoch"] for h in jhist] == [1]
    assert thist[0]["loss"] == pytest.approx(jhist[0]["loss"], rel=1e-5)
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j")) == \
        ["ckpt-12", "ckpt-16", "ckpt-8"]
    _assert_weights(tnet, jest.params, 1e-5)


@pytest.mark.parametrize("tier", ["DRAM", "DEVICE"])
def test_chained_steps_equal_single_steps_with_dropout(tier):
    # dropout on: the step's seed derives on the device from the device
    # step counter, so K = 4 (and a ragged K = 3: 8 steps are two groups
    # and two single steps) drop exactly what K = 1 drops
    x, y = _data(64)
    runs = []
    for k in (1, 4, 3):
        _, start, tnet = _pair(drop=0.1)
        fs = _featuresets(tier, x, y)[1]
        est = TE.Estimator(tnet, TAdamW(**OPT), LOSS, steps_per_dispatch=k,
                           device="cpu")
        hist = est.train(fs, batch_size=8, epochs=2, seed=11)
        runs.append(([h["loss"] for h in hist], tnet.get_weights()[0]))
    for losses, weights in runs[1:]:
        assert losses == runs[0][0]
        for name, w in _flat(weights).items():
            np.testing.assert_array_equal(w, _flat(runs[0][1])[name])


@pytest.mark.parametrize("kw", [dict(grad_accum_steps=2), dict(remat=True)],
                         ids=["grad_accum_steps=2", "remat"])
def test_accumulation_and_remat_match_jax(kw, monkeypatch):
    # batch 16 (the JAX microbatches shard over the 8-device mesh)
    jnet, start, tnet = _pair()
    x, y = _data(64, seed=1)
    jl = _losses(monkeypatch, JE.Estimator)
    tl = _losses(monkeypatch, TE.Estimator)
    jest = JE.Estimator(jnet, JAdamW(**OPT), LOSS, **kw)
    test = TE.Estimator(tnet, TAdamW(**OPT), LOSS, device="cpu", **kw)
    jest.train(JFeatureSet.from_ndarrays(list(x), y), batch_size=16,
               epochs=2, variables=(start, {}))
    test.train(FeatureSet.from_ndarrays(list(x), y), batch_size=16,
               epochs=2)
    assert len(tl) == len(jl) == 8
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    _assert_weights(tnet, jest.params, 1e-5)


def test_bf16_gradients_and_moments_match_jax(monkeypatch):
    # the bench's configuration at a tiny size: mixed precision, the bf16
    # gradient tree, the bf16 first moment, K = 4 on the DEVICE tier
    jnet, start, tnet = _pair()
    x, y = _data(64, seed=2)
    jl = _losses(monkeypatch, JE.Estimator)
    tl = _losses(monkeypatch, TE.Estimator)
    kw = dict(mixed_precision=True, grad_dtype="bfloat16",
              steps_per_dispatch=4)
    jest = JE.Estimator(jnet, JAdamW(state_dtype="bfloat16", **OPT), LOSS,
                        **kw)
    test = TE.Estimator(tnet, TAdamW(state_dtype="bfloat16", **OPT), LOSS,
                        device="cpu", **kw)
    jfs, tfs = _featuresets("DEVICE", x, y)
    jest.train(jfs, batch_size=8, epochs=2, variables=(start, {}))
    test.train(tfs, batch_size=8, epochs=2)
    assert len(tl) == len(jl) == 16
    np.testing.assert_allclose(tl, jl, rtol=2e-2, atol=0)    # reads 1.16e-2
    want = _flat(jax.tree_util.tree_map(np.asarray, jest.params))
    got, init = _flat(tnet.get_weights()[0]), _flat(start)
    hidden = CFG["hidden_size"]
    total_moved = total_diff = 0.0
    for name, w in want.items():
        keep = np.ones(w.shape, bool)
        if name.endswith("attn.qkv.b"):
            keep[hidden:2 * hidden] = False          # the key bias
        moved = np.linalg.norm((w - init[name])[keep])
        diff = np.linalg.norm((got[name] - w)[keep])
        # reads 0.36 at worst (the pooler's bias)
        assert moved > 0 and diff <= 0.5 * moved, (name, diff, moved)
        total_moved += moved ** 2
        total_diff += diff ** 2
    assert total_diff ** 0.5 <= 0.1 * total_moved ** 0.5      # reads 0.050
    assert all(m.dtype == torch.bfloat16
               for m in test.opt_state["mu"].values())
    assert all(p.dtype == torch.float32 for p in tnet.parameters())


# the comparison above with f32 moments, and with SGD: bars (losses, all
# weights' change, each tensor's change) and the readings on the 8-device
# CPU mesh.  f32 moments read 8.9e-3 / 3.9 % / 34.5 % (the pooler's bias):
# the moment's dtype is not what moves the pooler's bias.  SGD reads
# 1.2e-2 / 1.9 % / 4.3 % (the head's bias; the pooler's 3.1 %): the bf16
# gradients agree, and Adam's normalised step on the pooler bias's small,
# nearly cancelling gradient is where the two packages part.
BF16_CASES = {
    "adam_f32_moments": (lambda J: J.AdamWeightDecay(**OPT),
                         (2e-2, 0.1, 0.5)),
    "sgd": (lambda J: J.SGD(lr=0.05), (2e-2, 0.05, 0.1)),
}


@pytest.mark.parametrize("case", list(BF16_CASES))
def test_bf16_gradients_match_jax_under_other_optimizers(case, monkeypatch):
    from analytics_zoo_tpu.keras import optimizers as jopt
    from analytics_zoo_tpu_torch.keras import optimizers as topt
    make, (loss_rtol, all_rtol, each_rtol) = BF16_CASES[case]
    jnet, start, tnet = _pair()
    x, y = _data(64, seed=2)
    jl = _losses(monkeypatch, JE.Estimator)
    tl = _losses(monkeypatch, TE.Estimator)
    kw = dict(mixed_precision=True, grad_dtype="bfloat16",
              steps_per_dispatch=4)
    jest = JE.Estimator(jnet, make(jopt), LOSS, **kw)
    test = TE.Estimator(tnet, make(topt), LOSS, device="cpu", **kw)
    jfs, tfs = _featuresets("DEVICE", x, y)
    jest.train(jfs, batch_size=8, epochs=2, variables=(start, {}))
    test.train(tfs, batch_size=8, epochs=2)
    assert len(tl) == len(jl) == 16
    np.testing.assert_allclose(tl, jl, rtol=loss_rtol, atol=0)
    want = _flat(jax.tree_util.tree_map(np.asarray, jest.params))
    got, init = _flat(tnet.get_weights()[0]), _flat(start)
    hidden = CFG["hidden_size"]
    total_moved = total_diff = 0.0
    for name, w in want.items():
        keep = np.ones(w.shape, bool)
        if name.endswith("attn.qkv.b"):
            keep[hidden:2 * hidden] = False          # the key bias
        moved = np.linalg.norm((w - init[name])[keep])
        diff = np.linalg.norm((got[name] - w)[keep])
        assert moved > 0 and diff <= each_rtol * moved, (name, diff, moved)
        total_moved += moved ** 2
        total_diff += diff ** 2
    assert total_diff ** 0.5 <= all_rtol * total_moved ** 0.5
    assert all(p.dtype == torch.float32 for p in tnet.parameters())



def test_a_second_device_dataset_is_captured_anew(monkeypatch):
    # one estimator trains on two DEVICE-tier datasets of one shape in
    # turn.  A stand-in for the CUDA graph replays the body it captured,
    # reading the source of its capture as a graph reads the addresses it
    # captured: the second dataset must be captured anew, and the losses
    # equal those of steps that read each dataset directly
    made = []

    class Capture:
        def __init__(self, body, state_tensors, src):
            self.body, self.src = body, src
            made.append(src)

        def replay(self, n):
            for _ in range(n):
                self.body()

    data = [_data(64, seed=4), _data(64, seed=5)]

    def train_both(est):
        return [est.train(FeatureSet.from_ndarrays(list(x), y)
                          .cache_device(), batch_size=8, epochs=1,
                          seed=2)[-1]["loss"] for x, y in data]
    runs = []
    for captured in (False, True):
        if captured:
            monkeypatch.setattr(TE, "_CapturedStep", Capture)
            monkeypatch.setattr(TE.Estimator, "_graphs_on",
                                property(lambda self: True))
        _, _, tnet = _pair(drop=0.1)
        est = TE.Estimator(tnet, TAdamW(**OPT), LOSS, steps_per_dispatch=4,
                           device="cpu")
        runs.append(train_both(est))
    assert len(made) == 2 and made[0] is not made[1]
    assert est._graph.src is made[1]
    assert runs[1] == runs[0]

class _HostGuard:
    """Makes any read of a tensor on the host, and any tensor made from
    host data, raise: what a CUDA graph's capture refuses."""

    NAMES = ("item", "__bool__", "__float__", "__int__", "tolist", "numpy")

    def __enter__(self):
        refuse = self._refuse
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}
        self.made = (torch.tensor, torch.from_numpy, torch.as_tensor)
        as_tensor = torch.as_tensor
        for n in self.NAMES:
            setattr(torch.Tensor, n, refuse)
        torch.tensor = torch.from_numpy = refuse
        torch.as_tensor = lambda x, *a, **k: (
            as_tensor(x, *a, **k) if isinstance(x, torch.Tensor)
            else refuse())

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(torch.Tensor, n, f)
        torch.tensor, torch.from_numpy, torch.as_tensor = self.made

    @staticmethod
    def _refuse(*args, **kw):
        raise AssertionError("the step touched the host")


@pytest.mark.parametrize("kw", [
    dict(), dict(mixed_precision=True, grad_dtype="bfloat16"),
    dict(grad_accum_steps=2, remat=True), dict(gradient_clip_norm=1.0)],
    ids=["f32", "bf16", "accum_remat", "clip_norm"])
def test_a_dispatch_reads_and_copies_nothing_from_the_host(kw, monkeypatch):
    # what the card captures as a CUDA graph must not read a tensor on
    # the host nor copy a host value in: checked here on the CPU around
    # the second epoch's dispatch (the first builds what is cached); the
    # DEVICE tier chains each epoch's 8 steps into one dispatch
    _, _, tnet = _pair(drop=0.1)
    x, y = _data(64)
    opt = TAdamW(state_dtype="bfloat16" if kw else None, **OPT)
    est = TE.Estimator(tnet, opt, LOSS, steps_per_dispatch=4, device="cpu",
                       **kw)
    orig, calls = TE.Estimator._run_steps, []

    def guarded(self, n, src):
        calls.append(n)
        if len(calls) == 1:
            return orig(self, n, src)
        with _HostGuard():
            return orig(self, n, src)
    monkeypatch.setattr(TE.Estimator, "_run_steps", guarded)
    hist = est.train(FeatureSet.from_ndarrays(list(x), y).cache_device(),
                     batch_size=8, epochs=2, seed=1)
    assert calls == [8, 8] and np.isfinite(hist[-1]["loss"])


def test_a_step_runs_cudnn_deterministic(monkeypatch):
    # the card's convolution backward repeats only under cuDNN's
    # deterministic algorithms: every step runs with them, and the
    # setting is restored after the step
    _, start, tnet = _pair()
    x, y = _data(16)
    seen = []
    orig = TE.Estimator._grads

    def spy(self, *args, **kw):
        seen.append(torch.backends.cudnn.deterministic)
        return orig(self, *args, **kw)
    monkeypatch.setattr(TE.Estimator, "_grads", spy)
    assert not torch.backends.cudnn.deterministic
    est = TE.Estimator(tnet, TAdamW(**OPT), LOSS, device="cpu")
    est.train(FeatureSet.from_ndarrays(list(x), y), batch_size=8, epochs=1)
    assert seen == [True, True]
    assert not torch.backends.cudnn.deterministic


def test_bf16_pooler_bias_gradient_and_normalised_step_match_jax():
    # one step of the bench's bf16 configuration from the same weights and
    # batch in both packages: the raw bf16 gradient of the pooler (its
    # bias and matrix) and Adam's normalised step m_hat / (sqrt(v_hat) +
    # eps) from each package's own optimizer state after the update.
    # Readings (the CPU, batch 8): the bias gradient differs by 1.25e-2 of
    # its largest element (a median 2.5 bf16 ulps of each element) and its
    # normalised step by 7.3e-3 of a unit step, so one step's bias agrees;
    # the matrix's normalised step differs by up to 2 (a flipped sign) in
    # 0.8 % of its elements, each with |g| within a few bf16 ulps of the
    # largest (below 2**-6 of it; reads 4.8e-3), where the bf16 sum's
    # rounding decides the sign
    from analytics_zoo_tpu.keras import losses as jlosses
    jnet, start, tnet = _pair()
    x, y = _data(64, seed=2)
    xb, yb = [a[:8] for a in x], y[:8]
    test = TE.Estimator(tnet, TAdamW(state_dtype="bfloat16", **OPT), LOSS,
                        device="cpu", mixed_precision=True,
                        grad_dtype="bfloat16")
    tgrads, update = {}, test.optimizer.update_blocks

    def spy(blocks, state):           # no mesh: one block a leaf
        tgrads.update({k: v.float().numpy().copy()
                       for k, v in zip(blocks.names, blocks.gs)})
        return update(blocks, state)
    test.optimizer.update_blocks = spy
    test.train(FeatureSet.from_ndarrays(xb, yb, shuffle=False),
               batch_size=8, epochs=1)

    bf16 = jax.numpy.bfloat16
    down = lambda t: jax.tree_util.tree_map(
        lambda a: a.astype(bf16) if jax.numpy.issubdtype(
            a.dtype, jax.numpy.floating) else a, t)
    params = jax.tree_util.tree_map(jax.numpy.asarray, start)

    def objective(p):
        preds, _ = jnet.apply(p, {}, down([jax.numpy.asarray(a)
                                           for a in xb]),
                              training=True, rng=jax.random.PRNGKey(0))
        return jlosses.get(LOSS)(preds.astype(jax.numpy.float32),
                                 jax.numpy.asarray(yb))
    jg = jax.jit(jax.grad(objective))(down(params))
    jopt = JAdamW(state_dtype="bfloat16", **OPT)
    _, jstate = jopt.tx.update(jg, jopt.tx.init(params), params)
    f32 = lambda t: _flat(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jax.numpy.float32)), t))
    jgrads, jmu, jnu = f32(jg), f32(jstate[0].mu), f32(jstate[0].nu)

    b1, b2, eps = 0.9, 0.999, 1e-6
    step = lambda mu, nu: (mu / (1 - b1)) / (np.sqrt(nu / (1 - b2)) + eps)
    assert float(test.opt_state["count"]) == 1.0
    norm = {}
    for name in ("bert.pooler.b", "bert.pooler.W"):
        g_t, g_j = tgrads[name], jgrads[name]
        top = np.abs(g_j).max()
        n_t = step(test.opt_state["mu"][name].float().numpy(),
                   test.opt_state["nu"][name].float().numpy())
        n_j = step(jmu[name], jnu[name])
        norm[name] = (np.abs(g_t - g_j).max() / top, np.abs(n_t - n_j),
                      np.abs(g_j) / top)
    g_rel, n_diff, _ = norm["bert.pooler.b"]
    assert g_rel <= 2e-2            # reads 1.25e-2
    assert n_diff.max() <= 2e-2     # reads 7.3e-3
    g_rel, n_diff, mag = norm["bert.pooler.W"]
    assert g_rel <= 2e-2            # reads 1.28e-2
    flipped = n_diff > 0.5
    assert 0 < flipped.mean() <= 0.02           # reads 0.8 %
    assert (mag[flipped] < 2.0 ** -6).all()     # reads 4.8e-3 at most


def test_bf16_pooler_bias_sign_split_over_the_16_steps():
    # the configuration of test_bf16_gradients_and_moments_match_jax
    # (bf16 gradients and first moment, K = 4, DEVICE tier, 16 steps of
    # 8), with the pooler bias's bf16 gradient and Adam's normalised step
    # m_hat / (sqrt(v_hat) + eps) read at every step in both packages: the
    # port's through its optimizer's update, the JAX package's through a
    # debug callback around its optimizer's update inside the jitted scan
    jnet, start, tnet = _pair()
    x, y = _data(64, seed=2)
    kw = dict(mixed_precision=True, grad_dtype="bfloat16",
              steps_per_dispatch=4)
    name = "bert.pooler.b"
    b1, b2, eps = 0.9, 0.999, 1e-6

    def normalised(mu, nu, t):
        return (mu / (1 - b1 ** t)) / (np.sqrt(nu / (1 - b2 ** t)) + eps)

    test = TE.Estimator(tnet, TAdamW(state_dtype="bfloat16", **OPT), LOSS,
                        device="cpu", **kw)
    tlog, update = [], test.optimizer.update_blocks

    def tspy(blocks, state):          # no mesh: one block a leaf
        g = blocks.gs[blocks.names.index(name)].float().numpy().copy()
        update(blocks, state)
        t = float(state["count"])
        tlog.append((g, normalised(state["mu"][name].float().numpy(),
                                   state["nu"][name].float().numpy(), t)))
    test.optimizer.update_blocks = tspy

    jopt = JAdamW(state_dtype="bfloat16", **OPT)
    jlog, jupdate = [], jopt.update
    f32 = lambda a: np.asarray(a, np.float32)

    def record(g, mu, nu, count):
        # unordered, and once per device of the CPU mesh: kept by count
        jlog.append((int(count), f32(g),
                     normalised(f32(mu), f32(nu), float(count))))

    def jspy(grads, opt_state, params):
        upd, new = jupdate(grads, opt_state, params)
        adam = new[0]
        jax.debug.callback(record,
                           grads["bert"]["pooler"]["b"],
                           adam.mu["bert"]["pooler"]["b"],
                           adam.nu["bert"]["pooler"]["b"], adam.count)
        return upd, new
    jopt.update = jspy
    jest = JE.Estimator(jnet, jopt, LOSS, **kw)
    jfs, tfs = _featuresets("DEVICE", x, y)
    jest.train(jfs, batch_size=8, epochs=2, variables=(start, {}))
    test.train(tfs, batch_size=8, epochs=2)
    jsteps = {}
    for count, g, n in jlog:
        jsteps.setdefault(count, (g, n))
    jlog = [jsteps[c] for c in sorted(jsteps)]
    assert len(tlog) == len(jlog) == 16
    rows = []
    for step, ((tg, tn), (jg, jn)) in enumerate(zip(tlog, jlog), start=1):
        top = np.abs(jg).max()
        g_flip = np.sign(tg) != np.sign(jg)
        n_flip = np.sign(tn) != np.sign(jn)
        rows.append((step, float(np.abs(tg - jg).max() / top),
                     int(g_flip.sum()), int(n_flip.sum()),
                     float(np.abs(tn - jn).max()),
                     float((np.abs(jg) / top)[g_flip].max())
                     if g_flip.any() else 0.0))
    # readings (the CPU): step 1, from the same weights, splits no sign
    # (|dg| 1.06e-2 of max|g|, the bf16 sums' rounding alone); the first
    # gradient split is at step 2, in 2 elements with |g| <= 3.97e-3 of
    # max|g| against |dg| 4.76e-2 there; the normalised step's signs
    # first split at step 8, in one element.  Every split element's |g|
    # lies below its step's |dg| (3.3e-2 against 9.4e-2 at worst, step
    # 6): the bias gradient nearly cancels over the batch, so the bf16
    # rounding of its terms decides those signs, and Adam's normalisation
    # turns each into a unit-sized step
    assert rows[0][2] == rows[0][3] == 0
    assert any(r[2] for r in rows)
    for step, dg, g_split, n_split, dn, split_mag in rows:
        assert split_mag <= dg, (step, split_mag, dg)
