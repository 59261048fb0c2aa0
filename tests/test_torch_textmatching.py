"""The port's KNRM and Ranker against the JAX package's, on the CPU.

KNRM (both ``target_mode``s, 21 kernels, a trainable and a frozen
``embedding_weights`` table) built in both packages from the same JAX
weights: predictions 1e-5; 3 SGD ``fit`` steps with the same shuffle,
losses 1e-5 relative and weights 1e-5; the frozen table a buffer that no
step moves; ``evaluate_ndcg`` / ``evaluate_map`` exactly JAX's on the JAX
test's ranked ``TextSet`` (``tests/test_models.py``), and 1.0 for a
perfect ranker; a saved KNRM pickles and loads.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.keras.engine import reset_uids as j_reset
from analytics_zoo_tpu.keras.optimizers import SGD as JSGD
from analytics_zoo_tpu.models import KNRM as JKNRM
from analytics_zoo_tpu.models import textmatching as JTM
from analytics_zoo_tpu_torch.keras.engine import KerasNet
from analytics_zoo_tpu_torch.keras.engine import reset_uids as t_reset
from analytics_zoo_tpu_torch.keras.optimizers import SGD as TSGD
from analytics_zoo_tpu_torch.models import KNRM as TKNRM
from analytics_zoo_tpu_torch.models import Ranker
from analytics_zoo_tpu_torch.models import textmatching as TTM

ATOL = 1e-5
L1, L2, V, E = 5, 10, 40, 16


def _ids(n, seed=0):
    """Query / document ids, relevant iff the first tokens are equal
    (planted in half the rows)."""
    rs = np.random.RandomState(seed)
    q = rs.randint(1, V, (n, L1)).astype(np.int32)
    d = rs.randint(1, V, (n, L2)).astype(np.int32)
    d[: n // 2, 0] = q[: n // 2, 0]
    return q, d, (q[:, 0] == d[:, 0]).astype(np.float32)


def _pair(**kw):
    j_reset()
    jm = JKNRM(L1, L2, vocab_size=V, embed_size=E, **kw)
    t_reset()
    tm = TKNRM(L1, L2, vocab_size=V, embed_size=E, device="cpu", **kw)
    params, state = jm.init(jax.random.PRNGKey(0))
    tm.set_weights((jax.tree_util.tree_map(np.asarray, params),
                    jax.tree_util.tree_map(np.asarray, state)))
    return jm, tm


def test_kernel_pool_matches_jax():
    rs = np.random.RandomState(1)
    qe = rs.randn(3, L1, E).astype(np.float32)
    de = rs.randn(3, L2, E).astype(np.float32)
    de[:, 0] = qe[:, 0]                       # exact matches: the last kernel
    want = np.asarray(JTM._kernel_pool([qe, de], 21, 0.1, 0.001))
    got = TTM._kernel_pool([torch.from_numpy(qe), torch.from_numpy(de)], 21,
                           0.1, 0.001).numpy()
    assert got.shape == (3, 21)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("kernel_num", [1, 2, 3, 11, 21, 51])
def test_pool_constants_are_numpys_f32_values(kernel_num):
    """Made on the device (no host copy), the centres and widths equal the
    JAX package's f32 values bit for bit."""
    K = kernel_num
    mus = np.asarray(np.linspace(-1.0 + 1.0 / K, 1.0 - 1.0 / K,
                                 K - 1).tolist() + [1.0], np.float32)
    sig = np.asarray([0.1] * (K - 1) + [0.001], np.float32)
    got_mus, got_denom = TTM._pool_consts("cpu", K, 0.1, 0.001)
    assert got_mus.dtype == got_denom.dtype == torch.float32
    np.testing.assert_array_equal(got_mus.numpy(), mus)
    np.testing.assert_array_equal(got_denom.numpy(), 2 * np.square(sig))


@pytest.mark.parametrize("mode", ["ranking", "classification"])
def test_forward_and_three_sgd_steps_match_jax(mode):
    q, d, y = _ids(48)
    loss = "binary_crossentropy" if mode == "classification" else "mse"
    jm, tm = _pair(target_mode=mode)
    x = {"text1": q, "text2": d}
    want = np.asarray(jm.predict(x, batch_size=16))
    got = tm.predict(x, batch_size=16)
    assert got.shape == (48, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # lr 1e-3: the default 0.01 diverges on the unbounded ranking score
    # (an epoch's mean MSE ~2e4), which no summation order survives
    jm.compile(JSGD(lr=1e-3), loss)
    tm.compile(TSGD(lr=1e-3), loss)
    jh = jm.fit(x, y, batch_size=16, nb_epoch=1)
    th = tm.fit(x, y, batch_size=16, nb_epoch=1)
    assert th[0]["loss"] == pytest.approx(jh[0]["loss"], rel=1e-5)
    jw = jax.tree_util.tree_map(np.asarray, jm.get_weights()[0])
    tw = tm.get_weights()[0]
    for layer in jw:
        for k in jw[layer]:
            np.testing.assert_allclose(tw[layer][k], jw[layer][k],
                                       atol=ATOL, rtol=0)


def test_predict_first_then_fit():
    """A predict (under inference_mode) and then a training step on the
    same model: the step's pooling constants are its own tensors."""
    _, tm = _pair(target_mode="classification")
    q, d, y = _ids(16)
    tm.predict({"text1": q, "text2": d}, batch_size=8)
    tm.compile("sgd", "binary_crossentropy")
    hist = tm.fit({"text1": q, "text2": d}, y, batch_size=8, nb_epoch=1)
    assert np.isfinite(hist[0]["loss"])


def test_frozen_embedding_is_a_buffer_no_step_moves():
    w = np.random.RandomState(2).randn(V, E).astype(np.float32)
    jm, tm = _pair(embedding_weights=w, train_embed=False,
                   target_mode="classification")
    assert "embed.embeddings" in dict(tm.named_buffers())
    assert "embeddings" not in tm.get_weights()[0].get("embed", {})
    q, d, y = _ids(32)
    tm.compile("adam", "binary_crossentropy")
    tm.fit({"text1": q, "text2": d}, y, batch_size=16, nb_epoch=1)
    np.testing.assert_array_equal(
        tm.get_weights()[1]["embed"]["embeddings"], w)


def test_bad_target_mode_raises():
    with pytest.raises(ValueError, match="target_mode"):
        TKNRM(4, 6, vocab_size=10, embed_size=4, target_mode="rank",
              device="cpu")


def _ranked_textset():
    """The JAX test's listwise TextSet: two queries, a negative then a
    positive candidate each (``tests/test_models.py`` TestRanker)."""
    from analytics_zoo_tpu.feature.common import Relation
    from analytics_zoo_tpu.feature.text import TextSet
    q = TextSet.from_texts(["alpha beta", "gamma delta"])
    for i, f in enumerate(q.features):
        f["uri"] = f"q{i}"
    a = TextSet.from_texts(["alpha beta match", "noise words here",
                            "gamma delta match", "other noise text"])
    for i, f in enumerate(a.features):
        f["uri"] = f"a{i}"
    joint = TextSet.from_texts([f["text"] for f in q.features + a.features])
    joint.tokenize().normalize().word2idx()
    for ts, ln in ((q, 4), (a, 5)):
        (ts.tokenize().normalize().word2idx(existing_map=joint.word_index)
         .shape_sequence(len=ln))
    rels = [Relation("q0", "a1", 0), Relation("q0", "a0", 1),
            Relation("q1", "a3", 0), Relation("q1", "a2", 1)]
    return TextSet.from_relation_lists(rels, q, a).generate_sample()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ranker_metrics_equal_jax_on_the_jax_textset(seed):
    j_reset()
    jm = JKNRM(text1_length=4, text2_length=5, vocab_size=30, embed_size=8)
    t_reset()
    tm = TKNRM(text1_length=4, text2_length=5, vocab_size=30, embed_size=8,
               device="cpu")
    params, state = jm.init(jax.random.PRNGKey(seed))
    tm.set_weights((jax.tree_util.tree_map(np.asarray, params), {}))
    ts = _ranked_textset()
    for k in (1, 2, 3):
        assert tm.evaluate_ndcg(ts, k=k) == jm.evaluate_ndcg(ts, k=k)
    assert tm.evaluate_map(ts) == jm.evaluate_map(ts)
    assert tm.evaluate_map(ts, threshold=0.5) == jm.evaluate_map(
        ts, threshold=0.5)
    with pytest.raises(ValueError, match="positive"):
        tm.evaluate_ndcg(ts, k=0)


class _Oracle(Ranker, KerasNet):
    """Scores a candidate by its token overlap with the query."""

    text1_length = 4

    def forward(self, x):
        q_tok, a_tok = x
        good = (q_tok[:, :, None] == a_tok[:, None, :]) & (
            q_tok[:, :, None] != 0)
        return good.sum(dim=(1, 2)).float()


def test_perfect_ranker_scores_one_and_unbuilt_raises():
    oracle = _Oracle(name="oracle")
    oracle._device = torch.device("cpu")
    ts = _ranked_textset()
    assert oracle.evaluate_ndcg(ts, k=2) == 1.0
    assert oracle.evaluate_map(ts) == 1.0
    from analytics_zoo_tpu_torch.keras.layers import Dense
    oracle.add_module("late", Dense(3))          # waits for its shape
    with pytest.raises(RuntimeError, match="not initialized"):
        oracle.evaluate_map(ts)


def test_saved_knrm_loads_and_predicts(tmp_path):
    _, tm = _pair(target_mode="classification")
    q, d, _ = _ids(8)
    path = str(tmp_path / "knrm.zoo")
    tm.save(path)
    loaded = KerasNet.load(path, device="cpu")
    pool = dict(loaded.named_children())["kernel_pooling"].fn
    assert isinstance(pool, functools.partial)
    assert pool.func is TTM._kernel_pool
    np.testing.assert_array_equal(
        loaded.predict({"text1": q, "text2": d}, batch_size=4),
        tm.predict({"text1": q, "text2": d}, batch_size=4))
