"""The port's validation metrics against the JAX package's, on the CPU.

Every metric streams the same batches of numpy-seeded predictions and
labels through ``update`` in both packages, and ``result`` must agree
within 1e-6; ``get`` takes every name of the JAX registry.
``Top5Accuracy`` breaks ties as ``lax.top_k`` does (the lower class
index first), checked on scores with ties across the fifth place.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.keras import losses as JLoss
from analytics_zoo_tpu.keras import metrics as JM
from analytics_zoo_tpu_torch.keras import losses as TLoss
from analytics_zoo_tpu_torch.keras import metrics as TM


def _stream(jm, tm, batches):
    jacc, tacc = jm.init(), tm.init()
    for pred, true in batches:
        jacc = jm.update(jacc, jnp.asarray(pred), jnp.asarray(true))
        tacc = tm.update(tacc, torch.from_numpy(pred), torch.from_numpy(true))
    return jm.result(jacc), tm.result(tacc)


def _probs(rs, b, c):
    p = rs.rand(b, c).astype(np.float32)
    return p / p.sum(axis=1, keepdims=True)


def _batches(kind, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for b in (16, 7, 32):
        if kind == "classes":
            out.append((_probs(rs, b, 10),
                        rs.randint(0, 10, b).astype(np.int32)))
        elif kind == "one_hot":
            out.append((_probs(rs, b, 10),
                        np.eye(10, dtype=np.float32)[rs.randint(0, 10, b)]))
        elif kind == "binary":
            out.append((rs.rand(b).astype(np.float32),
                        rs.randint(0, 2, b).astype(np.float32)))
        elif kind == "binary_col":
            out.append((rs.rand(b, 1).astype(np.float32),
                        rs.randint(0, 2, (b, 1)).astype(np.float32)))
        elif kind == "two_class":
            out.append((_probs(rs, b, 2), rs.randint(0, 2, b)
                        .astype(np.float32)))
        elif kind == "two_class_one_hot":
            out.append((_probs(rs, b, 2), np.eye(2, dtype=np.float32)[
                rs.randint(0, 2, b)]))
        elif kind == "regression":
            out.append((rs.randn(b, 3).astype(np.float32),
                        rs.randn(b, 3).astype(np.float32)))
    return out


CASES = [
    ("Accuracy", "classes"), ("Accuracy", "one_hot"),
    ("Accuracy", "binary"), ("Accuracy", "binary_col"),
    ("SparseCategoricalAccuracy", "classes"),
    ("Top5Accuracy", "classes"), ("Top5Accuracy", "one_hot"),
    ("MAE", "regression"), ("MSE", "regression"),
    ("AUC", "binary"), ("AUC", "binary_col"), ("AUC", "two_class"),
    ("AUC", "two_class_one_hot"),
]


@pytest.mark.parametrize("name,kind", CASES,
                         ids=[f"{n}-{k}" for n, k in CASES])
def test_metric_matches_jax(name, kind):
    want, got = _stream(getattr(JM, name)(), getattr(TM, name)(),
                        _batches(kind))
    assert got == pytest.approx(want, abs=1e-6)
    assert getattr(TM, name).name == getattr(JM, name).name


def test_auc_with_fewer_bins_matches_jax():
    want, got = _stream(JM.AUC(20), TM.AUC(20), _batches("binary", seed=3))
    assert got == pytest.approx(want, abs=1e-6)


def test_auc_refuses_more_than_two_classes():
    with pytest.raises(ValueError, match="binary"):
        TM.AUC().update(TM.AUC().init(), torch.rand(4, 3), torch.zeros(4))


def test_top5_breaks_ties_as_lax_top_k():
    # scores tied across the fifth place: the lower indices rank first
    pred = np.zeros((6, 8), np.float32)
    pred[:, 0] = 1.0
    pred[:, 3] = 0.5          # classes 1, 2, 4-7 tie at 0 for places 3..
    true = np.array([1, 2, 4, 5, 6, 7], np.int32)
    want, got = _stream(JM.Top5Accuracy(), TM.Top5Accuracy(),
                        [(pred, true)])
    assert got == want == pytest.approx(3 / 6)


@pytest.mark.parametrize("loss", ["mse", "sparse_categorical_crossentropy"])
def test_loss_metric_matches_jax(loss):
    if loss == "mse":
        batches = _batches("regression")
    else:
        batches = _batches("classes")
    want, got = _stream(JM.Loss(JLoss.get(loss)), TM.Loss(TLoss.get(loss)),
                        batches)
    assert got == pytest.approx(want, rel=1e-6)


def test_registry_names_are_the_jax_ones():
    assert set(TM._REGISTRY) == set(JM._REGISTRY)
    for name in JM._REGISTRY:
        assert type(TM.get(name)).__name__ == type(JM.get(name)).__name__
        assert type(TM.get(name.upper())).__name__ == \
            type(JM.get(name)).__name__
    assert isinstance(TM.get(TM.MAE), TM.MAE)
    with pytest.raises(ValueError, match="unknown metric"):
        TM.get("f1")


def test_metrics_evaluate_through_the_estimator():
    from analytics_zoo_tpu_torch.keras import layers as TL
    from analytics_zoo_tpu_torch.keras.engine import Sequential
    rs = np.random.RandomState(0)
    x = rs.randn(40, 5).astype(np.float32)
    y = rs.randint(0, 2, 40).astype(np.int32)
    m = Sequential([TL.Dense(2, activation="softmax", input_shape=(5,))],
                   device="cpu")
    m.compile("sgd", "sparse_categorical_crossentropy",
              ["accuracy", "top5", "auc", "sparse_categorical_accuracy"])
    out = m.evaluate(x, y, batch_size=16)
    probs = m.predict(x, batch_size=16)
    acc = float(np.mean(probs.argmax(1) == y))
    assert out["accuracy"] == pytest.approx(acc)
    assert out["sparse_categorical_accuracy"] == pytest.approx(acc)
    assert out["top5_accuracy"] == 1.0
    jm = JM.AUC()
    want = jm.result(jm.update(jm.init(), jnp.asarray(probs),
                               jnp.asarray(y)))
    assert out["auc"] == pytest.approx(want, abs=1e-6)
