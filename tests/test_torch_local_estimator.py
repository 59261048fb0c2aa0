"""The port's LocalEstimator against the JAX package's, on the CPU.

A small Keras ``Sequential`` (and a two-input ``Model``) built in both
packages from the same JAX weights: ``fit`` for 3 epochs gives the JAX
epoch losses (1e-5 relative) and weights (1e-5), over the JAX batch
order (``np.random.RandomState(epoch)``, checked batch for batch);
``evaluate`` and ``predict`` agree (1e-5); validation adds ``val_*``
entries; the weights already on the model are adopted and written back;
``batch_size > n`` and the optimizer objects of ``net/`` raise.
"""

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.estimator import LocalEstimator as JLocal
from analytics_zoo_tpu.estimator import local_estimator as JL
from analytics_zoo_tpu.keras import engine as JEng
from analytics_zoo_tpu.keras import layers as JLayers
from analytics_zoo_tpu_torch.estimator import LocalEstimator as TLocal
from analytics_zoo_tpu_torch.estimator import local_estimator as TL
from analytics_zoo_tpu_torch.keras import engine as TEng
from analytics_zoo_tpu_torch.keras import layers as TLayers
from analytics_zoo_tpu_torch.keras.optimizers import Adam as TAdam

ATOL = 1e-5


def _data(n=40, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 6).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.int32)
    return x, y


def _seq(eng, L):
    eng.reset_uids()
    kw = {} if eng is JEng else {"device": "cpu"}
    return eng.Sequential([L.Dense(8, activation="relu", input_shape=(6,)),
                           L.Dense(2, activation="softmax")], **kw)


def _pair(build=_seq):
    jm, tm = build(JEng, JLayers), build(TEng, TLayers)
    params, state = jm.init(jax.random.PRNGKey(1))
    tm.set_weights((jax.tree_util.tree_map(np.asarray, params),
                    jax.tree_util.tree_map(np.asarray, state)))
    return jm, tm


def _close_trees(got, want, atol=ATOL):
    for layer in want:
        for k in want[layer]:
            np.testing.assert_allclose(got[layer][k], np.asarray(
                want[layer][k]), atol=atol, rtol=0, err_msg=f"{layer}.{k}")


def test_batch_order_is_the_jax_one():
    x, y = _data(23)
    for shuffle, epoch, drop in ((True, 0, True), (True, 2, True),
                                 (False, 0, False)):
        jb = list(JL._as_batches(x, y, 5, shuffle, epoch, drop))
        tb = list(TL._as_batches(x, y, 5, shuffle, epoch, drop))
        assert len(jb) == len(tb) == (4 if drop else 5)
        for (jx, jy), (tx, ty) in zip(jb, tb):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_fit_evaluate_predict_match_jax(opt):
    x, y = _data()
    jm, tm = _pair()
    jest = JLocal(jm, "sparse_categorical_crossentropy", opt,
                  metrics=["accuracy"])
    test = TLocal(tm, "sparse_categorical_crossentropy", opt,
                  metrics=["accuracy"])
    jh = jest.fit((x, y), batch_size=8, epochs=3)
    th = test.fit((x, y), batch_size=8, epochs=3)
    assert [h["epoch"] for h in th] == [h["epoch"] for h in jh] == [0, 1, 2]
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], rtol=1e-5)
    # trained in place and read back in the JAX layout
    _close_trees(test.params, jest.params)
    _close_trees(tm.get_weights()[0], jm._variables[0])
    assert test.state == {}
    je, te = jest.evaluate((x, y), batch_size=16), test.evaluate((x, y), 16)
    assert te["loss"] == pytest.approx(je["loss"], rel=1e-5)
    assert te["accuracy"] == pytest.approx(je["accuracy"], abs=1e-12)
    np.testing.assert_allclose(test.predict(x, batch_size=16),
                               jest.predict(x, batch_size=16), atol=ATOL)
    # a second fit continues the optimizer state, epochs counted anew
    jh = jest.fit((x, y), batch_size=8, epochs=1)
    th = test.fit((x, y), batch_size=8, epochs=1)
    assert th[-1]["loss"] == pytest.approx(jh[-1]["loss"], rel=1e-5)
    assert th[-1]["epoch"] == 0 and len(th) == 4


def test_list_inputs_and_validation_match_jax():
    def build(eng, L):
        eng.reset_uids()
        a, b = eng.Input((3,)), eng.Input((4,))
        h = L.Dense(5, activation="tanh")(L.Merge(mode="concat")([a, b]))
        kw = {} if eng is JEng else {"device": "cpu"}
        return eng.Model([a, b], L.Dense(1)(h), **kw)
    rs = np.random.RandomState(3)
    x = [rs.randn(30, 3).astype(np.float32),
         rs.randn(30, 4).astype(np.float32)]
    y = (x[0].sum(1, keepdims=True) - x[1].mean(1, keepdims=True)).astype(
        np.float32)
    jm, tm = _pair(build)
    jest, test = JLocal(jm, "mse", "sgd"), TLocal(tm, "mse", "sgd")
    jh = jest.fit((x, y), batch_size=7, epochs=3, validation_data=(x, y))
    th = test.fit((x, y), batch_size=7, epochs=3, validation_data=(x, y))
    for t, j in zip(th, jh):
        assert set(t) == set(j) == {"epoch", "loss", "val_loss"}
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-5)
        assert t["val_loss"] == pytest.approx(j["val_loss"], rel=1e-5)
    np.testing.assert_allclose(test.predict(x, batch_size=4),
                               jest.predict(x, batch_size=4), atol=ATOL)


def test_unbuilt_model_is_built_from_a_sample_batch():
    TEng.reset_uids()
    net = TEng.Sequential([TLayers.Dense(3), TLayers.Dense(1)], device="cpu")
    assert not net.built
    x = np.random.RandomState(0).randn(16, 5).astype(np.float32)
    est = TLocal(net, "mse", TAdam(lr=0.01))
    hist = est.fit((x, x[:, :1]), batch_size=4, epochs=2)
    assert net.built and len(hist) == 2 and np.isfinite(hist[-1]["loss"])
    assert est.params["dense_1"]["W"].shape == (5, 3)


def test_errors():
    x, y = _data(10)
    jm, tm = _pair()
    with pytest.raises(ValueError, match="exceeds dataset size 10"):
        TLocal(tm).fit((x, y), batch_size=11)
    with pytest.raises(ValueError, match="unknown optimizer"):
        TLocal(tm, optmethod="nope")
    for opt in ({"dense_1": "sgd"}, torch.optim.SGD(tm.parameters(), 0.1)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            TLocal(tm, optmethod=opt)
    with pytest.raises(ValueError, match="support"):
        TLocal(tm, optmethod=3.0)
