"""The NER / SQuAD heads, autograd, the local estimator, KNRM and Seq2seq
on the card.

Marked ``cuda``: every test skips with a reason where no CUDA device is
visible.  On a machine with a card:
``python -m pytest --noconftest tests/test_torch_cuda_heads.py``.  f32
with TF32 off, small widths (hidden 64, 2 blocks, 2 heads, T 48 with a
ragged padding mask):
- NER probabilities and SQuAD logits through ``flash_fwd`` against plain
  attention on the card (1e-4), with 2 launches a forward;
- one SQuAD training step with the kernels against plain attention (loss
  1e-5, each gradient 1e-3 of its max|g|), and 8 f32 steps through a
  captured graph (``steps_per_dispatch=4``, DEVICE tier, the list label
  tree) equal to 8 eager steps (losses 1e-5 relative, weights 1e-5 of
  max|p|), 2 + 2 launches a step counted through the replays;
- KNRM and Seq2seq against the same models on the CPU (predictions 1e-5,
  3 SGD steps 1e-4 relative), KNRM and a ``CustomLoss`` inside a captured
  step equal to eager steps, ``LocalEstimator`` on the card against the
  CPU (losses 1e-4 relative); these launch no port kernel;
- one SQuAD training forward and backward repeated gives the same bits.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import autograd as A
from analytics_zoo_tpu_torch.data.featureset import FeatureSet
from analytics_zoo_tpu_torch.estimator import LocalEstimator
from analytics_zoo_tpu_torch.estimator import estimator as est_mod
from analytics_zoo_tpu_torch.keras import engine
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras.layers.self_attention import (
    set_attention_backend)
from analytics_zoo_tpu_torch.keras.optimizers import SGD, AdamWeightDecay
from analytics_zoo_tpu_torch.models import KNRM, Seq2seq
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.tfpark import BERTNER, BERTSQuAD, TFDataset

pytestmark = pytest.mark.cuda

CFG = dict(vocab=100, hidden_size=64, n_block=2, n_head=2, seq_len=48,
           intermediate_size=128)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card run of the BERT heads")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def losses(monkeypatch):
    seen = []
    orig = est_mod.Estimator._post_dispatch

    def spy(est, n, k, lv, *args, **kw):
        seen.append(lv.float().cpu().reshape(-1))
        return orig(est, n, k, lv, *args, **kw)
    monkeypatch.setattr(est_mod.Estimator, "_post_dispatch", spy)
    return seen


def _flat(seen):
    out = [float(v) for lv in seen for v in lv]
    seen.clear()
    return np.array(out)


def _squad_data(n, seed=0):
    rs = np.random.default_rng(seed)
    T = CFG["seq_len"]
    ids = rs.integers(1, CFG["vocab"], (n, T)).astype(np.int32)
    lens = rs.integers(16, T + 1, n)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    seg = (np.arange(T)[None] >= (lens // 2)[:, None]).astype(np.int32)
    start = rs.integers(0, lens // 2).astype(np.int64)
    end = np.minimum(start + 3, lens - 1).astype(np.int64)
    return (ids * mask, seg, mask), [start, end]


def _heads(dev, cls, **kw):
    args = (9,) if cls is BERTNER else ()
    return cls(*args, bert_config=CFG, device=dev,
               generator=torch.Generator().manual_seed(0), **kw)


@pytest.mark.parametrize("cls", [BERTNER, BERTSQuAD])
def test_heads_on_the_kernels_match_plain_attention(dev, cls):
    est = _heads(dev, cls)
    x, _ = _squad_data(8)
    _kernels.reset_launches()
    got = est.predict(list(x), batch_size=8)
    assert _kernels.flash_fwd.launches == CFG["n_block"]
    set_attention_backend(est.net, "plain")
    want = est.predict(list(x), batch_size=8)
    gots = got if isinstance(got, list) else [got]
    wants = want if isinstance(want, list) else [want]
    for g, w in zip(gots, wants):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=1e-4 * max(1.0, np.abs(
            w).max()), rtol=0)


def test_squad_step_kernels_vs_plain(dev):
    from analytics_zoo_tpu_torch.tfpark.text_estimators import _squad_loss
    x, y = _squad_data(8, seed=1)
    xs = [torch.from_numpy(a).to(dev) for a in x]
    ys = [torch.from_numpy(a).to(dev) for a in y]
    cfg = dict(CFG, hidden_drop=0.1, attn_drop=0.1)
    est = BERTSQuAD(bert_config=cfg, device=dev,
                    generator=torch.Generator().manual_seed(0))
    runs = []
    for backend in (None, "plain"):
        set_attention_backend(est.net, backend)
        est.net.train()
        loss = _squad_loss(est.net(xs, seed=5), ys)
        params = list(est.net.parameters())
        grads = est_mod.grads_of(loss, params)
        est.net.eval()
        runs.append((float(loss.detach()), grads))
    assert abs(runs[0][0] - runs[1][0]) <= 1e-5
    names = [n for n, _ in est.net.named_parameters()]
    top = max(float(g.abs().max()) for g in runs[1][1])
    for name, gk, gp in zip(names, runs[0][1], runs[1][1]):
        if name == "head.b" or name.endswith(
                f"_block{CFG['n_block'] - 1}.ln2.beta"):
            # the same vector added to every position's output (the head's
            # bias, the last LayerNorm's shift) cancels in the softmax over
            # positions: 0 in exact arithmetic, noise in both versions
            assert max(float(gk.abs().max()), float(gp.abs().max())) \
                <= 1e-5 * top
            continue
        scale = float(gp.abs().max()) or 1.0
        assert float((gk - gp).abs().max()) <= 1e-3 * scale, name


def test_squad_graph_steps_equal_eager_steps(dev, losses):
    x, y = _squad_data(32, seed=2)
    runs = {}
    for k in (4, 1):
        est = _heads(dev, BERTSQuAD, optimizer=AdamWeightDecay(lr=1e-3),
                     steps_per_dispatch=k)
        ds = TFDataset.from_ndarrays((x, y), batch_size=4,
                                     memory_type="DEVICE")
        _kernels.reset_launches()
        est.train(ds, epochs=1, seed=3)
        torch.cuda.synchronize()
        runs[k] = (_flat(losses), {n: p.detach().clone()
                                   for n, p in est.net.named_parameters()},
                   (_kernels.flash_fwd.launches,
                    _kernels.flash_bwd.launches))
    assert runs[4][2] == runs[1][2] == (8 * CFG["n_block"],) * 2
    np.testing.assert_allclose(runs[4][0], runs[1][0], rtol=1e-5)
    for n, p in runs[1][1].items():
        scale = float(p.abs().max()) or 1.0
        assert float((runs[4][1][n] - p).abs().max()) <= 1e-5 * scale, n


def test_a_squad_step_repeats_bit_identically(dev):
    """Two runs of one training forward and backward give the same bits:
    96 x 48 = 4,608 positions share BERT's two segment rows and 99 token
    rows (a gather's backward there added them in no fixed order)."""
    from analytics_zoo_tpu_torch.tfpark.text_estimators import _squad_loss
    x, y = _squad_data(96, seed=4)
    xs = [torch.from_numpy(a).to(dev) for a in x]
    ys = [torch.from_numpy(a).to(dev) for a in y]
    est = BERTSQuAD(bert_config=dict(CFG, hidden_drop=0.1, attn_drop=0.1),
                    device=dev, generator=torch.Generator().manual_seed(0))
    est.net.train()
    params = list(est.net.parameters())
    runs = [est_mod.grads_of(_squad_loss(est.net(xs, seed=5), ys), params)
            for _ in range(3)]
    names = [n for n, _ in est.net.named_parameters()]
    for later in runs[1:]:
        for name, a, b in zip(names, runs[0], later):
            assert torch.equal(a, b), name


def _knrm(d, target_mode="ranking"):
    engine.reset_uids()
    return KNRM(6, 12, vocab_size=500, embed_size=32, device=d,
                target_mode=target_mode)


def test_knrm_card_vs_cpu_and_in_a_graph(dev, losses):
    card, cpu = _knrm(dev), _knrm("cpu")
    cpu.load_state_dict(card.state_dict())
    rs = np.random.RandomState(0)
    x = {"text1": rs.randint(1, 500, (64, 6)).astype(np.int32),
         "text2": rs.randint(1, 500, (64, 12)).astype(np.int32)}
    y = rs.randint(0, 2, 64).astype(np.float32)
    np.testing.assert_allclose(card.predict(x, batch_size=32),
                               cpu.predict(x, batch_size=32), atol=1e-5)
    for m in (card, cpu):
        m.compile(SGD(lr=1e-3), "mse")
    fs = lambda: FeatureSet.from_ndarrays(x, y, shuffle=False)
    card.fit(fs(), batch_size=16, nb_epoch=1, steps_per_dispatch=1)
    on_card = _flat(losses)[:3]
    cpu.fit(fs(), batch_size=16, nb_epoch=1)
    np.testing.assert_allclose(on_card, _flat(losses)[:3], rtol=1e-4)
    graph, eager = _knrm(dev), _knrm(dev)
    eager.load_state_dict(graph.state_dict())
    runs = []
    _kernels.reset_launches()
    for m, k in ((graph, 4), (eager, 1)):
        m.compile(SGD(lr=1e-3), "mse")
        m.fit(fs().cache_device(), batch_size=8, nb_epoch=1,
              steps_per_dispatch=k)
        runs.append(_flat(losses))
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-5)
    assert not any(w.launches for w in _kernels.KERNELS.values())


def test_seq2seq_card_vs_cpu(dev, losses):
    card = Seq2seq(50, embed_dim=16, hidden=32, num_layers=2, device=dev)
    cpu = Seq2seq(50, embed_dim=16, hidden=32, num_layers=2, device="cpu")
    cpu.load_state_dict(card.state_dict())
    rs = np.random.RandomState(1)
    src = rs.randint(2, 50, (32, 7)).astype(np.int32)
    dec = np.concatenate([np.ones((32, 1), np.int32), src[:, :-1]], 1)
    x = {"enc": src, "dec": dec}
    np.testing.assert_allclose(card.predict(x, batch_size=16),
                               cpu.predict(x, batch_size=16), atol=1e-5)
    np.testing.assert_array_equal(card.infer(src[:4], 1, max_seq_len=6),
                                  cpu.infer(src[:4], 1, max_seq_len=6))
    for m in (card, cpu):
        m.compile("sgd", "sparse_categorical_crossentropy")
    card.fit(x, src, batch_size=8, nb_epoch=1)
    on_card = _flat(losses)
    cpu.fit(x, src, batch_size=8, nb_epoch=1)
    np.testing.assert_allclose(on_card, _flat(losses), rtol=1e-4)


def test_custom_loss_in_a_captured_step_and_local_estimator(dev, losses):
    def build(d):
        engine.reset_uids()
        return engine.Sequential([L.Dense(16, activation="tanh",
                                          input_shape=(8,)), L.Dense(3)],
                                 device=d)
    loss = lambda: A.CustomLoss(
        lambda yt, yp: A.mean(A.square(yt - yp) + 0.1 * A.abs(yp), axis=1),
        (3,))
    rs = np.random.RandomState(2)
    x = rs.randn(64, 8).astype(np.float32)
    y = np.tanh(x[:, :3]).astype(np.float32)
    nets = [build(dev) for _ in range(2)]
    nets[1].load_state_dict(nets[0].state_dict())
    runs = []
    for net, k in zip(nets, (4, 1)):
        net.compile(SGD(lr=0.1), loss())
        net.fit(FeatureSet.from_ndarrays(x, y, shuffle=False).cache_device(),
                batch_size=8, nb_epoch=1, steps_per_dispatch=k)
        runs.append(_flat(losses))
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-5)
    card, cpu = build(dev), build("cpu")
    cpu.load_state_dict(card.state_dict())
    hist = [LocalEstimator(m, loss(), "sgd").fit((x, y), batch_size=8,
                                                 epochs=3)
            for m in (card, cpu)]
    np.testing.assert_allclose([h["loss"] for h in hist[0]],
                               [h["loss"] for h in hist[1]], rtol=1e-4)
