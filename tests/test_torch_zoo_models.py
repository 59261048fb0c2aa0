"""The port's TextClassifier, SessionRecommender, AnomalyDetector and
ImageClassifier against the JAX package's, on the CPU.

Each model is built in both packages from fresh name counters, the JAX
``init`` weights go into the port through ``set_weights``, and the
forwards must agree within 1e-5 (f32) on the same numpy inputs.  A
3-step ``fit`` must follow JAX's ``fit`` step for step (losses 1e-5
relative, weights 1e-5 absolute), with the ``Dropout`` layers' rate set to
0 on both nets (the JAX ``Model`` derives its keys with ``fold_in`` and
takes no int seed, so no JAX mask exists to match).  The models' own
helpers (``recommend_for_session``, ``unroll``, ``detect_anomalies``,
``label_output``) give JAX's answers.  A Sequential with
``BatchNormalization`` trains as JAX's (its moving statistics too), and
the same run with ``steps_per_dispatch=4`` equals ``steps_per_dispatch=1``.
"""

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.estimator import estimator as JE
from analytics_zoo_tpu.keras import engine as jengine
from analytics_zoo_tpu.keras import layers as JL
from analytics_zoo_tpu import models as JM
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.estimator import estimator as TE
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.keras import engine as tengine
from analytics_zoo_tpu_torch.keras import layers as TL
from analytics_zoo_tpu_torch import models as TM

ATOL = 1e-5
TEXT = dict(class_num=3, sequence_length=12, encoder_output_dim=16,
            token_length=8, vocab_size=50)
SESSION = dict(item_count=30, item_embed=8, rnn_hidden_layers=(12, 8),
               session_length=6, mlp_hidden_layers=(8, 4), history_length=3)
IMAGE = {"lenet": (12, 12, 1), "vgg": (8, 8, 3), "resnet": (8, 8, 3)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(jbuild, tbuild):
    jengine.reset_uids()
    jm = jbuild()
    params, state = jm.init(jax.random.PRNGKey(0))
    tengine.reset_uids()
    tm = tbuild()
    tm.set_weights((_np(params), _np(state)))
    return jm, tm


def _models(kind, variant):
    if kind == "text":
        kw = dict(TEXT, encoder=variant)
        return _pair(lambda: JM.TextClassifier(**kw),
                     lambda: TM.TextClassifier(device="cpu", **kw))
    if kind == "session":
        kw = dict(SESSION, include_history=variant)
        return _pair(lambda: JM.SessionRecommender(**kw),
                     lambda: TM.SessionRecommender(device="cpu", **kw))
    if kind == "anomaly":
        return _pair(lambda: JM.AnomalyDetector((10, 1)),
                     lambda: TM.AnomalyDetector((10, 1), device="cpu"))
    shape = IMAGE[variant]
    return _pair(lambda: JM.ImageClassifier(5, shape, variant),
                 lambda: TM.ImageClassifier(5, shape, variant, device="cpu"))


def _data(kind, variant, n, seed=0):
    rs = np.random.RandomState(seed)
    if kind == "text":
        x = rs.randint(0, TEXT["vocab_size"], (n, 12)).astype(np.int32)
        return x, rs.randint(0, 3, n).astype(np.int32)
    if kind == "session":
        x = [rs.randint(1, 31, (n, 6)).astype(np.int32)]
        if variant:
            x.append(rs.randint(1, 31, (n, 3)).astype(np.int32))
        return x, rs.randint(0, 31, n).astype(np.int32)
    if kind == "anomaly":
        return (rs.randn(n, 10, 1).astype(np.float32),
                rs.randn(n).astype(np.float32))
    return (rs.randn(n, *IMAGE[variant]).astype(np.float32),
            rs.randint(0, 5, n).astype(np.int32))


MODELS = [("text", "cnn"), ("text", "lstm"), ("text", "gru"),
          ("session", False), ("session", True), ("anomaly", None),
          ("image", "lenet"), ("image", "vgg"), ("image", "resnet")]
IDS = [f"{k}-{v}" for k, v in MODELS]


def _forward(tm, x):
    with torch.no_grad():
        tx = ([torch.from_numpy(a) for a in x] if isinstance(x, list)
              else torch.from_numpy(x))
        return tm(tx).numpy()


@pytest.mark.parametrize("kind,variant", MODELS, ids=IDS)
def test_forward_matches_jax(kind, variant):
    jm, tm = _models(kind, variant)
    assert set(tm.state_dict()) == set(interop._flatten(
        _np(jm.get_weights()[0])))
    x, _ = _data(kind, variant, 6)
    want = np.asarray(jm.apply(*jm.get_weights(), x)[0])
    np.testing.assert_allclose(_forward(tm, x), want, atol=ATOL, rtol=0)
    assert tm.summary() == jm.summary()


def _no_dropout(*nets):
    for net in nets:
        for layer in net.layers:
            if isinstance(layer, (JL.Dropout, TL.Dropout)):
                layer.p = 0.0


def _spy(monkeypatch):
    jlosses, tlosses = [], []
    orig_j, orig_t = JE.Estimator._post_dispatch, TE.Estimator._train_step

    def jspy(self, *a, **k):
        jlosses.extend(np.ravel(np.asarray(a[2])).tolist())
        return orig_j(self, *a, **k)

    def tspy(self, *a, **k):
        out = orig_t(self, *a, **k)
        tlosses.append(float(out))
        return out
    monkeypatch.setattr(JE.Estimator, "_post_dispatch", jspy)
    monkeypatch.setattr(TE.Estimator, "_train_step", tspy)
    return jlosses, tlosses


def _same_weights(jm, tm, atol=1e-5):
    want = interop._flatten(_np(jm.get_weights()[0]))
    got = interop._flatten(tm.get_weights()[0])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0,
                                   err_msg=k)
    jstate = interop._flatten(_np(jm.get_weights()[1]))
    tstate = interop._flatten(tm.get_weights()[1])
    assert set(jstate) == set(tstate)
    for k in jstate:
        np.testing.assert_allclose(tstate[k], jstate[k], atol=atol, rtol=0,
                                   err_msg=k)


LOSS = {"text": "sparse_categorical_crossentropy",
        "session": "sparse_categorical_crossentropy", "anomaly": "mse",
        "image": "sparse_categorical_crossentropy"}


@pytest.mark.parametrize("kind,variant", MODELS, ids=IDS)
def test_three_fit_steps_follow_jax(kind, variant, monkeypatch):
    from analytics_zoo_tpu.keras import optimizers as JO
    from analytics_zoo_tpu_torch.keras import optimizers as TO
    jm, tm = _models(kind, variant)
    _no_dropout(jm, tm)
    x, y = _data(kind, variant, 24, seed=1)
    jlosses, tlosses = _spy(monkeypatch)
    jm.compile(JO.Adagrad(lr=0.05), LOSS[kind])
    tm.compile(TO.Adagrad(lr=0.05), LOSS[kind])
    jm.fit(x, y, batch_size=8, nb_epoch=1)
    tm.fit(x, y, batch_size=8, nb_epoch=1)
    assert len(tlosses) == len(jlosses) == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=0)
    _same_weights(jm, tm)


def test_recommend_for_session_matches_jax():
    jm, tm = _models("session", False)
    sessions = _data("session", False, 13, seed=2)[0][0]
    want = jm.recommend_for_session(sessions, 4, batch_size=8)
    got = tm.recommend_for_session(sessions, 4, batch_size=8)
    for g_row, w_row in zip(got, want):
        assert [i for i, _ in g_row] == [i for i, _ in w_row]
        np.testing.assert_allclose([p for _, p in g_row],
                                   [p for _, p in w_row], atol=ATOL)
    one = tm.recommend_for_session(sessions[:1], 2, zero_based_label=False)
    assert one == [[(i + 1, p) for i, p in got[0][:2]]]


def test_anomaly_detector_helpers_and_warm_start_match_jax(monkeypatch):
    series = np.sin(np.arange(60) / 4.0).astype(np.float32)
    for step in (1, 3):
        got = TM.AnomalyDetector.unroll(series, 10, step)
        want = JM.AnomalyDetector.unroll(series, 10, step)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    x, y = TM.AnomalyDetector.unroll(series, 10)
    jm, tm = _models("anomaly", None)
    _no_dropout(jm, tm)
    jlosses, tlosses = _spy(monkeypatch)
    for m in (jm, tm):
        m.compile("adam", "mse")
    jm.fit(x[:32], y[:32], batch_size=16, nb_epoch=1)
    tm.fit(x[:32], y[:32], batch_size=16, nb_epoch=1)
    jm.fit(x[:32], y[:32], batch_size=16, nb_epoch=1, warm_start=True)
    tm.fit(x[:32], y[:32], batch_size=16, nb_epoch=1, warm_start=True)
    assert tm._last_estimator.global_step == 4
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=0)
    _same_weights(jm, tm)
    pred = tm.predict(x, batch_size=16)
    jpred = np.asarray(jm.predict(x, batch_size=16))
    np.testing.assert_allclose(pred, jpred, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tm.detect_anomalies(y, pred, 4),
                                  jm.detect_anomalies(y, jpred, 4))


def test_label_output_matches_jax():
    labels = [f"c{i}" for i in range(5)]
    jengine.reset_uids()
    jm = JM.ImageClassifier(5, labels=labels)
    tengine.reset_uids()
    tm = TM.ImageClassifier(5, labels=labels, device="cpu")
    probs = np.random.RandomState(0).dirichlet(np.ones(5), 3)
    assert tm.label_output(probs, 3) == jm.label_output(probs, 3)
    tm.labels = jm.labels = None
    assert tm.label_output(probs[0], 2) == jm.label_output(probs[0], 2)
    with pytest.raises(ValueError, match="backbone"):
        TM.ImageClassifier(5, backbone="alexnet", device="cpu")


def test_text_classifier_with_pretrained_embedding_and_serving():
    w = np.random.RandomState(0).randn(40, 6).astype(np.float32)
    kw = dict(class_num=2, sequence_length=10, encoder="cnn",
              encoder_output_dim=8, embedding_weights=w)
    jm, tm = _pair(lambda: JM.TextClassifier(**kw),
                   lambda: TM.TextClassifier(device="cpu", **kw))
    np.testing.assert_array_equal(tm.embed.embeddings.detach().numpy(), w)
    x = np.random.RandomState(1).randint(0, 40, (5, 10)).astype(np.int32)
    want = np.asarray(jm.apply(*jm.get_weights(), x)[0])
    got = InferenceModel(device="cpu").load_keras(tm).predict(x)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="encoder"):
        TM.TextClassifier(2, encoder="rnn", device="cpu")


def _bn_net(L):
    return [L.Convolution2D(4, 3, 3, border_mode="same",
                            input_shape=(6, 6, 3)),
            L.BatchNormalization(), L.Activation("relu"),
            L.GlobalAveragePooling2D(), L.Dense(3, activation="softmax")]


def test_batchnorm_sequential_trains_as_jax(monkeypatch):
    jengine.reset_uids()
    jm = jengine.Sequential(_bn_net(JL))
    params, state = jm.init(jax.random.PRNGKey(0))
    tengine.reset_uids()
    tm = tengine.Sequential(_bn_net(TL), device="cpu")
    tm.set_weights((_np(params), _np(state)))
    rs = np.random.RandomState(0)
    x = rs.randn(24, 6, 6, 3).astype(np.float32) * 2.0 + 1.0
    y = rs.randint(0, 3, 24).astype(np.int32)
    jlosses, tlosses = _spy(monkeypatch)
    for m in (jm, tm):
        m.compile("sgd", "sparse_categorical_crossentropy")
        m.fit(x, y, batch_size=8, nb_epoch=1)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=0)
    _same_weights(jm, tm)
    assert set(interop._flatten(tm.get_weights()[1])) == {
        "batchnormalization_1.moving_mean", "batchnormalization_1.moving_var"}
    # eval mode reads the moving statistics
    np.testing.assert_allclose(
        tm.predict(x, batch_size=8),
        np.asarray(jm.predict(x, batch_size=8)), atol=ATOL, rtol=0)


def test_batchnorm_dispatch_of_four_steps_equals_four_eager_steps():
    rs = np.random.RandomState(0)
    x = rs.randn(32, 6, 6, 3).astype(np.float32)
    y = rs.randint(0, 3, 32).astype(np.int32)
    nets = []
    for spd in (1, 4):
        tengine.reset_uids()
        net = tengine.Sequential(_bn_net(TL), device="cpu")
        net.init(torch.Generator().manual_seed(0))
        net.compile("sgd", "sparse_categorical_crossentropy")
        net.fit(x, y, batch_size=8, nb_epoch=1, steps_per_dispatch=spd)
        nets.append(net)
    for a, b in zip(nets[0].state_dict().values(),
                    nets[1].state_dict().values()):
        assert torch.equal(a, b)


def test_batchnorm_statistics_move_once_a_step_under_remat():
    # the rematerialised forward recomputes the step in the backward; the
    # moving statistics must take one update a step, as without remat
    rs = np.random.RandomState(1)
    x = rs.randn(16, 6, 6, 3).astype(np.float32)
    y = rs.randint(0, 3, 16).astype(np.int32)
    nets = []
    for remat in (False, True):
        tengine.reset_uids()
        net = tengine.Sequential(_bn_net(TL), device="cpu")
        net.init(torch.Generator().manual_seed(0))
        net.compile("sgd", "sparse_categorical_crossentropy")
        net.fit(x, y, batch_size=8, nb_epoch=1, remat=remat)
        nets.append(net)
    for (k, a), b in zip(nets[0].state_dict().items(),
                         nets[1].state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=k)


def test_text_classifier_served_by_the_pipelined_engine_equals_jax():
    from analytics_zoo_tpu_torch.common.config import ServingConfig
    from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
    from analytics_zoo_tpu_torch.serving.client import (InputQueue,
                                                        OutputQueue)
    from analytics_zoo_tpu_torch.serving.engine import ClusterServing
    jm, tm = _models("text", "gru")
    x = _data("text", "gru", 7, seed=5)[0]
    broker = InMemoryBroker()
    serving = ClusterServing(InferenceModel(device="cpu").load_keras(tm),
                             ServingConfig(), broker=broker).start()
    try:
        iq, oq = InputQueue(broker=broker), OutputQueue(broker=broker)
        for i, row in enumerate(x):
            iq.enqueue(f"r{i}", tokens=row)
        got = np.stack([oq.query_blocking(f"r{i}", timeout=30)
                        for i in range(len(x))])
    finally:
        serving.stop()
    want = np.asarray(jm.apply(*jm.get_weights(), x)[0])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("how", ["input_shape", "init"])
def test_sequential_holds_every_weight_on_its_device(how):
    # "meta" stands in for the card: layers built on the host, at
    # construction or by init, must join the device the net was asked for
    if how == "input_shape":
        net = tengine.Sequential([TL.LSTM(4, input_shape=(3, 2)),
                                  TL.BatchNormalization(), TL.Dense(1)],
                                 device="meta")
    else:
        net = tengine.Sequential([TL.Dense(4), TL.Scale(), TL.Dense(1)],
                                 device="meta").init(input_shape=(None, 3))
    assert {t.device.type for t in net.state_dict().values()} == {"meta"}
    assert net.device.type == "meta"
