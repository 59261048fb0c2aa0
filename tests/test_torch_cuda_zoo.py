"""The layer catalogue and the zoo models on the card against the CPU.

Marked ``cuda``: every test skips with a reason where no CUDA device is
visible.  On a machine with a card:
``python -m pytest --noconftest tests/test_torch_cuda_zoo.py``.  f32 with
TF32 off: one small model of each family (TextClassifier with each
encoder, SessionRecommender, AnomalyDetector, ImageClassifier with each
backbone) predicts within 1e-5 of the same model on the CPU and takes 3
SGD steps within 1e-4 relative of the CPU's losses; a Sequential
with ``BatchNormalization`` trained through a captured CUDA graph
(``steps_per_dispatch=4``) equals 8 eager steps (losses 1e-5 relative,
weights and moving statistics 1e-5 of their largest magnitude); a
recurrent layer and a pooled convolution with BatchNorm train in bf16
under mixed precision, graph and eager alike, with the statistics and the
master weights staying f32.  No kernel of the port launches on this path.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.data.featureset import FeatureSet
from analytics_zoo_tpu_torch.estimator import estimator as est_mod
from analytics_zoo_tpu_torch.keras import engine
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras import optimizers as O
from analytics_zoo_tpu_torch import models as M
from analytics_zoo_tpu_torch.ops import _kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card run of the zoo models")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def losses(monkeypatch):
    """Every training step's loss, as each dispatch hands it on."""
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


def _pair(build):
    engine.reset_uids()
    cpu = build("cpu")
    cpu.init(torch.Generator().manual_seed(0))
    engine.reset_uids()
    card = build("cuda")
    card.set_weights(cpu.get_weights())
    return cpu, card


def _no_dropout(*nets):
    for net in nets:
        for layer in net.layers:
            if isinstance(layer, L.Dropout):
                layer.p = 0.0


FAMILIES = {
    "text-cnn": (lambda d: M.TextClassifier(
        5, sequence_length=40, encoder="cnn", encoder_output_dim=32,
        token_length=16, vocab_size=300, device=d), "text"),
    "text-lstm": (lambda d: M.TextClassifier(
        5, sequence_length=40, encoder="lstm", encoder_output_dim=32,
        token_length=16, vocab_size=300, device=d), "text"),
    "text-gru": (lambda d: M.TextClassifier(
        5, sequence_length=40, encoder="gru", encoder_output_dim=32,
        token_length=16, vocab_size=300, device=d), "text"),
    "session": (lambda d: M.SessionRecommender(
        200, include_history=True, device=d), "session"),
    "anomaly": (lambda d: M.AnomalyDetector((24, 1), device=d), "anomaly"),
    "image-lenet": (lambda d: M.ImageClassifier(10, device=d), "lenet"),
    "image-vgg": (lambda d: M.ImageClassifier(
        10, (32, 32, 3), "vgg", device=d), "image"),
    "image-resnet": (lambda d: M.ImageClassifier(
        10, (32, 32, 3), "resnet", device=d), "image"),
}


def _data(kind, n, seed=0):
    rs = np.random.RandomState(seed)
    if kind == "text":
        return (rs.randint(0, 300, (n, 40)).astype(np.int32),
                rs.randint(0, 5, n).astype(np.int32))
    if kind == "session":
        return ([rs.randint(1, 201, (n, 10)).astype(np.int32),
                 rs.randint(1, 201, (n, 5)).astype(np.int32)],
                rs.randint(0, 201, n).astype(np.int32))
    if kind == "anomaly":
        return (rs.randn(n, 24, 1).astype(np.float32),
                rs.randn(n).astype(np.float32))
    shape = (28, 28, 1) if kind == "lenet" else (32, 32, 3)
    return (rs.randn(n, *shape).astype(np.float32),
            rs.randint(0, 10, n).astype(np.int32))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_zoo_model_on_the_card_matches_the_cpu(dev, losses, family):
    build, kind = FAMILIES[family]
    cpu, card = _pair(build)
    x, y = _data(kind, 96)
    _kernels.reset_launches()
    np.testing.assert_allclose(card.predict(x, batch_size=32),
                               cpu.predict(x, batch_size=32), atol=1e-5,
                               rtol=0)
    _no_dropout(cpu, card)
    loss = "mse" if kind == "anomaly" else "sparse_categorical_crossentropy"
    for m in (cpu, card):
        m.compile(O.SGD(lr=0.01), loss)
    card.fit(x, y, batch_size=32, nb_epoch=1)
    got = _flat(losses)
    cpu.fit(x, y, batch_size=32, nb_epoch=1)
    want = _flat(losses)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert not any(w.launches for w in _kernels.KERNELS.values())


def _bn_net(device):
    # no bias before the BatchNorm (it would cancel: its gradient is
    # rounding noise around 0)
    return engine.Sequential([
        L.Convolution2D(16, 3, 3, border_mode="same", bias=False,
                        input_shape=(32, 32, 3)),
        L.BatchNormalization(), L.Activation("relu"),
        L.GlobalAveragePooling2D(), L.Dense(10, activation="softmax")],
        device=device)


def _bn_run(spd, x, y, tree, losses, steps=8, **kw):
    engine.reset_uids()
    net = _bn_net("cuda")
    assert {t.device.type for t in net.state_dict().values()} == {"cuda"}
    net.set_weights(tree)
    net.compile(O.SGD(lr=0.1), "sparse_categorical_crossentropy")
    fs = FeatureSet.from_ndarrays(x, y, shuffle=False).cache_device()
    net.fit(fs, batch_size=32, nb_epoch=steps // (len(y) // 32),
            steps_per_dispatch=spd, **kw)
    return _flat(losses), net


def test_batchnorm_graph_replays_equal_eager_steps(dev, losses):
    rs = np.random.RandomState(0)
    x = (rs.randn(128, 32, 32, 3) * 2.0 + 0.5).astype(np.float32)
    y = rs.randint(0, 10, 128).astype(np.int32)
    engine.reset_uids()
    ref = _bn_net("cpu")
    ref.init(torch.Generator().manual_seed(0))
    tree = ref.get_weights()
    graph_losses, graph = _bn_run(4, x, y, tree, losses)
    eager_losses, eager = _bn_run(1, x, y, tree, losses)
    assert len(graph_losses) == len(eager_losses) == 8
    np.testing.assert_allclose(graph_losses, eager_losses, rtol=1e-5, atol=0)
    moved = False
    for (k, a), b in zip(graph.state_dict().items(),
                         eager.state_dict().values()):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * scale, k
        moved |= k.endswith("moving_mean") and bool(b.abs().max() > 0)
    assert moved                      # the replays updated the statistics


@pytest.mark.parametrize("spd", [1, 4])
def test_mixed_precision_keeps_statistics_and_masters_f32(dev, losses, spd):
    rs = np.random.RandomState(1)
    nets = {
        "lstm": (lambda: engine.Sequential([
            L.LSTM(32, input_shape=(20, 8)), L.Dense(1)], device="cuda"),
            rs.randn(128, 20, 8).astype(np.float32),
            rs.randn(128).astype(np.float32), "mse"),
        "conv": (lambda: engine.Sequential([
            L.Convolution2D(8, 3, 3, border_mode="same",
                            input_shape=(16, 16, 3)),
            L.BatchNormalization(), L.MaxPooling2D(), L.Flatten(),
            L.Dense(10, activation="softmax")], device="cuda"),
            rs.randn(128, 16, 16, 3).astype(np.float32),
            rs.randint(0, 10, 128).astype(np.int32),
            "sparse_categorical_crossentropy"),
    }
    for name, (build, x, y, loss) in nets.items():
        runs = {}
        for mixed in (False, True):
            engine.reset_uids()
            net = build()
            net.init(torch.Generator(device="cuda").manual_seed(0))
            net.compile(O.Adam(lr=1e-3), loss)
            fs = FeatureSet.from_ndarrays(x, y, shuffle=False).cache_device()
            net.fit(fs, batch_size=32, nb_epoch=2, steps_per_dispatch=spd,
                    mixed_precision=mixed)
            runs[mixed] = _flat(losses)
            assert all(t.dtype == torch.float32
                       for t in net.state_dict().values()), name
        f32, bf16 = runs[False], runs[True]
        assert np.isfinite(bf16).all() and len(bf16) == len(f32) == 8
        # bf16 activations: the first loss within bf16 rounding of f32's
        assert abs(bf16[0] - f32[0]) <= 2e-2 * abs(f32[0]), name
