"""The port's recommendation models against the JAX package's, on the CPU.

NeuralCF (fused tables, separate tables, no MF tower) and WideAndDeep
(wide, deep, wide_n_deep) are built in both packages with the same layer
names; the JAX model's ``init`` weights go into the port through
``set_weights``, and the forwards must agree within 1e-6 (f32) on the
same numpy-seeded ids, out-of-range and negative ids included (NaN rows
where ``jnp.take`` gives them).  ``fit`` must follow JAX's ``fit`` step
for step (losses 1e-5 relative, weights 1e-5 absolute after 5 Adam steps
on the same shuffled batches), and ``evaluate`` / ``predict`` / the
Recommender API must give JAX's answers.  Classic ``ClusterServing``
serves NCF's dict inputs with JAX's answers.
"""

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.estimator import estimator as JE
from analytics_zoo_tpu.keras import engine as jengine
from analytics_zoo_tpu.models import recommendation as JR
from analytics_zoo_tpu_torch.common.config import ServingConfig
from analytics_zoo_tpu_torch.estimator import estimator as TE
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.keras import engine as tengine
from analytics_zoo_tpu_torch.models import recommendation as TR
from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
from analytics_zoo_tpu_torch.serving.client import InputQueue, OutputQueue
from analytics_zoo_tpu_torch.serving.engine import ClusterServing

ATOL = 1e-6
USERS, ITEMS = 30, 20
SMALL = dict(user_count=USERS, item_count=ITEMS, user_embed=8, item_embed=6,
             mf_embed=4, hidden_layers=(16, 8))
LAYOUTS = {"fused": {}, "separate": dict(fused_tables=False),
           "no_mf": dict(include_mf=False)}
CI = dict(wide_base_cols=["occupation", "gender"], wide_base_dims=[21, 3],
          wide_cross_cols=["age-gender"], wide_cross_dims=[100],
          indicator_cols=["occupation", "gender"], indicator_dims=[21, 3],
          embed_cols=["userId", "itemId"], embed_in_dims=[60, 40],
          embed_out_dims=[8, 8], continuous_cols=["age"])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(jbuild, tbuild):
    """The JAX model (initialised) and the port's with its weights; both
    built from fresh name counters."""
    jengine.reset_uids()
    jm = jbuild()
    params, state = jm.init(jax.random.PRNGKey(0))
    tengine.reset_uids()
    tm = tbuild()
    tm.set_weights((_np(params), _np(state)))
    return jm, tm


def _ncf(**kw):
    kw = dict(SMALL, **kw)
    return _pair(lambda: JR.NeuralCF(**kw),
                 lambda: TR.NeuralCF(device="cpu", **kw))


def _ids(n, seed=0, users=USERS, items=ITEMS):
    rs = np.random.RandomState(seed)
    return (rs.randint(1, users + 1, (n, 1)).astype(np.int32),
            rs.randint(1, items + 1, (n, 1)).astype(np.int32))


def _jforward(jm, x):
    return np.asarray(jm.apply(*jm.get_weights(), x)[0])


def _tforward(tm, x):
    with torch.no_grad():
        return tm(x if isinstance(x, dict) else [torch.from_numpy(a)
                                                 for a in x]).numpy()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ncf_forward_matches_jax(layout):
    jm, tm = _ncf(**LAYOUTS[layout])
    assert set(tm.state_dict()) == {
        f"{k}.{leaf}" for k, v in _np(jm.get_weights()[0]).items()
        for leaf in v}
    x = _ids(64)
    np.testing.assert_allclose(_tforward(tm, x), _jforward(jm, x),
                               atol=ATOL, rtol=0)
    # dict inputs by input name, as the serving engine sends them
    got = _tforward(tm, {"user": torch.from_numpy(x[0]),
                         "item": torch.from_numpy(x[1])})
    np.testing.assert_allclose(got, _jforward(jm, x), atol=ATOL, rtol=0)
    assert tm.summary() == jm.summary()


@pytest.mark.parametrize("layout", ["fused", "separate"])
def test_out_of_range_and_negative_ids_match_jax(layout):
    jm, tm = _ncf(**LAYOUTS[layout])
    # the table has USERS + 1 rows: USERS + 1 and -(USERS + 2) are out of
    # range, -1 and -(USERS + 1) wrap to the last and the first row
    users = np.array([[1], [USERS + 1], [-1], [-(USERS + 1)],
                      [-(USERS + 2)], [10 ** 6], [0]], np.int32)
    items = np.array([[2], [3], [ITEMS + 1], [-2], [4], [5], [-(ITEMS + 1)]],
                     np.int32)
    want = _jforward(jm, (users, items))
    got = _tforward(tm, (users, items))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).any(axis=1).tolist() == [False, True, True, False,
                                                   True, True, False]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_out_of_range_rows_get_no_gradient():
    _, tm = _ncf()
    tm.train()
    users = torch.tensor([[USERS + 1], [3]], dtype=torch.int32)
    items = torch.tensor([[2], [2]], dtype=torch.int32)
    out = tm([users, items])
    out[1, 0].backward()            # a row sums to 1: its sum has no grad
    table = tm.user_embed.embeddings
    assert torch.isfinite(table.grad).all()
    # only row 3 is reached by the valid id; row 0 (the clamped stand-in of
    # the out-of-range id) gets nothing
    nonzero = table.grad.abs().sum(dim=1).nonzero().ravel().tolist()
    assert nonzero == [3]


def test_graft_entry_configuration_at_batch_1024():
    cfg = dict(user_count=6040, item_count=3706, class_num=2, user_embed=32,
               item_embed=32, hidden_layers=(64, 32, 16), mf_embed=16)
    jm, tm = _pair(lambda: JR.NeuralCF(**cfg),
                   lambda: TR.NeuralCF(device="cpu", **cfg))
    x = _ids(1024, seed=3, users=6040, items=3706)
    np.testing.assert_allclose(_tforward(tm, x), _jforward(jm, x),
                               atol=ATOL, rtol=0)


def _columns(n, seed=0):
    rs = np.random.RandomState(seed)
    return {"occupation": rs.randint(0, 21, n), "gender": rs.randint(0, 3, n),
            "age-gender": rs.randint(0, 100, n),
            "userId": rs.randint(1, 61, n), "itemId": rs.randint(1, 41, n),
            "age": rs.randint(18, 60, n).astype(np.float32)}


@pytest.mark.parametrize("model_type", ["wide", "deep", "wide_n_deep"])
def test_wide_and_deep_matches_jax(model_type):
    ci_j, ci_t = JR.ColumnFeatureInfo(**CI), TR.ColumnFeatureInfo(**CI)
    jm, tm = _pair(
        lambda: JR.WideAndDeep(model_type, column_info=ci_j,
                               hidden_layers=(16, 8)),
        lambda: TR.WideAndDeep(model_type, column_info=ci_t,
                               hidden_layers=(16, 8), device="cpu"))
    cols = _columns(48)
    want_x = JR.assemble_feature_dict(cols, ci_j, model_type)
    x = TR.assemble_feature_dict(cols, ci_t, model_type)
    assert list(x) == list(want_x)
    for k in x:
        assert x[k].dtype == want_x[k].dtype
        assert x[k].tobytes() == want_x[k].tobytes(), k
    got = _tforward(tm, {k: torch.from_numpy(v) for k, v in x.items()})
    np.testing.assert_allclose(got, _jforward(jm, want_x), atol=ATOL, rtol=0)
    assert [l.name for l in tm.layers] == [l.name for l in jm.layers]


def test_feature_assembly_is_byte_equal():
    ci_j, ci_t = JR.ColumnFeatureInfo(**CI), TR.ColumnFeatureInfo(**CI)
    cols = _columns(33, seed=5)
    cols["userId"] = np.concatenate([cols["userId"][:-2], [-3, 999]])
    np.testing.assert_array_equal(TR.get_wide_tensor(cols, ci_t),
                                  JR.get_wide_tensor(cols, ci_j))
    got, want = (TR.get_deep_tensors(cols, ci_t),
                 JR.get_deep_tensors(cols, ci_j))
    assert {k: v.tobytes() for k, v in got.items()} == {
        k: v.tobytes() for k, v in want.items()}
    for bad in ("cross", None):
        with pytest.raises(ValueError, match="model_type"):
            TR.assemble_feature_dict(cols, ci_t, bad)
    with pytest.raises(ValueError, match="column_info"):
        TR.WideAndDeep("wide", device="cpu")


def test_recommender_api_matches_jax():
    jm, tm = _ncf()
    jm.compile("adam", "sparse_categorical_crossentropy")
    tm.compile("adam", "sparse_categorical_crossentropy")
    pairs = [JR.UserItemFeature(u, i) for u, i in ((1, 2), (3, 4), (30, 20))]
    np.testing.assert_allclose(
        tm.predict_user_item_pair(
            [TR.UserItemFeature(p.user_id, p.item_id) for p in pairs]),
        jm.predict_user_item_pair(pairs), atol=ATOL, rtol=0)
    for got, want in ((tm.recommend_for_user(7, 5),
                       jm.recommend_for_user(7, 5)),
                      (tm.recommend_for_item(4, 6, batch_size=8),
                       jm.recommend_for_item(4, 6, batch_size=8)),
                      (tm.recommend_for_user(2, 3, candidate_items=[5, 9, 1]),
                       jm.recommend_for_user(2, 3,
                                             candidate_items=[5, 9, 1]))):
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                                   atol=ATOL, rtol=0)
        scores = dict(want)
        # the same order, but for ids whose scores tie within tolerance
        for (a, sa), (b, _) in zip(got, want):
            assert a == b or abs(scores.get(a, np.inf) - sa) <= ATOL


def _record(monkeypatch, cls, name, value_of):
    seen, orig = [], getattr(cls, name)

    def spy(self, *args, **kw):
        out = orig(self, *args, **kw)
        seen.extend(value_of(args, out))
        return out
    monkeypatch.setattr(cls, name, spy)
    return seen


def test_fit_matches_jax_step_for_step(monkeypatch):
    jm, tm = _ncf()
    x = list(_ids(80, seed=1))
    y = np.random.RandomState(2).randint(0, 2, 80).astype(np.int32)
    for m in (jm, tm):
        m.compile("adam", "sparse_categorical_crossentropy", ["accuracy"])
    jlosses = _record(monkeypatch, JE.Estimator, "_post_dispatch",
                      lambda a, out: np.ravel(np.asarray(a[2])).tolist())
    tlosses = _record(monkeypatch, TE.Estimator, "_train_step",
                      lambda a, out: [float(out)])
    jhist = jm.fit(x, y, batch_size=16, nb_epoch=1)
    thist = tm.fit(x, y, batch_size=16, nb_epoch=1)
    assert len(jlosses) == len(tlosses) == 5
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=0)
    assert len(thist) == len(jhist) == 1
    # a warm start continues the optimizer state: 5 more steps
    jm.fit(x, y, batch_size=16, nb_epoch=1, warm_start=True)
    tm.fit(x, y, batch_size=16, nb_epoch=1, warm_start=True)
    assert tm._last_estimator.global_step == 10
    np.testing.assert_allclose(tlosses[5:], jlosses[5:], rtol=1e-5, atol=0)
    want, got = _np(jm.get_weights()[0]), tm.get_weights()[0]
    assert set(got) == set(want)
    for layer, leaves in want.items():
        for leaf, w in leaves.items():
            np.testing.assert_allclose(got[layer][leaf], w, atol=1e-5,
                                       rtol=0, err_msg=f"{layer}.{leaf}")
    # evaluate and predict on a ragged tail
    xe, ye = [a[:37] for a in x], y[:37]
    jev, tev = jm.evaluate(xe, ye, batch_size=16), tm.evaluate(xe, ye,
                                                               batch_size=16)
    assert set(tev) == set(jev)
    for k in jev:
        np.testing.assert_allclose(tev[k], jev[k], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm.predict(xe, batch_size=16),
                               np.asarray(jm.predict(xe, batch_size=16)),
                               atol=ATOL, rtol=0)


def test_served_ncf_equals_jax_forward():
    jm, tm = _ncf()
    im = InferenceModel(device="cpu").load_keras(tm)
    broker = InMemoryBroker()
    serving = ClusterServing(im, ServingConfig(
        pipeline=False, batch_size=4, redis_url="memory://"),
        broker=broker).start()
    sizes = (1, 5, 2, 9)
    x = _ids(sum(sizes), seed=4)
    x[0][3, 0] = USERS + 1                    # a NaN row, then more answers
    uris = [f"r-{i}" for i in range(len(x[0]))]
    try:
        iq, start = InputQueue(broker=broker), 0
        for n in sizes:
            sl = slice(start, start + n)
            iq.enqueue_batch(uris[sl], user=x[0][sl], item=x[1][sl])
            start += n
        oq = OutputQueue(broker=broker)
        got = np.stack([oq.query_blocking(u, timeout=60) for u in uris])
    finally:
        serving.stop()
    want = _jforward(jm, x)
    assert np.isnan(want[3]).all() and not np.isnan(np.delete(want, 3,
                                                              0)).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
