"""The port's Keras graph and layers against the JAX package's, on the CPU.

Each layer runs in both packages on the same numpy-seeded inputs with the
same weights (JAX ``init`` -> ``set_weights`` / ``load_jax_params``); the
forwards must agree within 1e-6 in f32.  Also: every ``Merge`` mode (max
and min share the gradient among ties as ``jnp.max`` does), ``Variable``
arithmetic, ``Model`` with list, tuple, single and dict inputs,
``Sequential``, the JAX auto-names of unnamed layers, the activation,
initializer and loss registries, and a frozen embedding table that lives
in state.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.keras import activations as JAct
from analytics_zoo_tpu.keras import engine as JEng
from analytics_zoo_tpu.keras import initializers as JInit
from analytics_zoo_tpu.keras import layers as JL
from analytics_zoo_tpu.keras import losses as JLoss
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch import tensorboard as TTB
from analytics_zoo_tpu_torch.keras import activations as TAct
from analytics_zoo_tpu_torch.keras import engine as TEng
from analytics_zoo_tpu_torch.keras import initializers as TInit
from analytics_zoo_tpu_torch.keras import layers as TL
from analytics_zoo_tpu_torch.keras import losses as TLoss

ATOL = 1e-6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _both(jlayer, tlayer, x, shape=None):
    """(JAX output, port output) of one layer on ``x`` (an array or a list
    of arrays), the port layer loaded with the JAX layer's weights."""
    shape = shape or ([(None,) + a.shape[1:] for a in x]
                      if isinstance(x, list) else (None,) + x.shape[1:])
    params, state = jlayer.build(jax.random.PRNGKey(1), shape)
    want = np.asarray(jlayer.call(params, state, x, False, None)[0])
    tlayer.ensure_built(shape)
    interop.load_jax_params(tlayer, _np(params), _np(state))
    tx = ([torch.from_numpy(a) for a in x] if isinstance(x, list)
          else torch.from_numpy(x))
    with torch.no_grad():
        got = tlayer(tx).numpy()
    return want, got


@pytest.mark.parametrize("kw", [
    dict(activation="relu"), dict(activation="tanh", bias=False),
    dict(activation="softmax", init="he_uniform"), dict()])
def test_dense_matches_jax(kw):
    x = _x(5, 3, 7)
    want, got = _both(JL.Dense(4, **kw), TL.Dense(4, **kw), x)
    assert got.shape == (5, 3, 4)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["sum", "mul", "ave", "max", "min",
                                  "concat", "dot", "cosine"])
def test_merge_modes_match_jax_with_their_gradients(mode):
    xs = [_x(4, 6, seed=s) for s in range(3 if mode not in ("dot", "cosine")
                                          else 2)]
    if mode in ("max", "min"):
        xs[1][:, :3] = xs[0][:, :3]          # ties share the gradient
    jl, tl = JL.Merge(mode=mode), TL.Merge(mode=mode)
    want, got = _both(jl, tl, xs)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert tuple(want.shape[1:]) == tl.compute_output_shape(
        [(None, 6)] * len(xs))[1:]
    w = _x(*want.shape, seed=9)
    jg = jax.grad(lambda a: jnp.sum(jl.call({}, {}, a, False, None)[0] * w))(
        [jnp.asarray(a) for a in xs])
    ts = [torch.from_numpy(a).requires_grad_() for a in xs]
    (tl(ts) * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=ATOL,
                                   rtol=0)


SHAPE_LAYERS = {
    "flatten": lambda L: L.Flatten(), "narrow1": lambda L: L.Narrow(1, 1, 2),
    "narrow2": lambda L: L.Narrow(2, 3, 2),
    "select": lambda L: L.Select(1, 2), "squeeze": lambda L: L.Squeeze(2),
    "expand": lambda L: L.ExpandDim(1),
    "reshape": lambda L: L.Reshape((-1, 5)),
    "softplus": lambda L: L.Activation("softplus"),
    "hard_sigmoid": lambda L: L.Activation("hard_sigmoid")}


@pytest.mark.parametrize("name", list(SHAPE_LAYERS))
def test_shape_and_activation_layers_match_jax(name):
    x = _x(3, 4, 1, 5) if name == "squeeze" else _x(3, 4, 5)
    jl, tl = SHAPE_LAYERS[name](JL), SHAPE_LAYERS[name](TL)
    want, got = _both(jl, tl, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    shape = (None,) + x.shape[1:]
    assert tl.compute_output_shape(shape) == tuple(
        jl.compute_output_shape(shape))


@pytest.mark.parametrize("trainable", [True, False])
def test_embedding_matches_jax_and_freezes_into_state(trainable):
    ids = np.array([[0, 5, 9], [-1, -10, 10], [-11, 3, 200]], np.int32)
    table = _x(10, 4, seed=3)
    jl = JL.Embedding(10, 4, trainable=trainable, weights=table)
    tl = TL.Embedding(10, 4, trainable=trainable, weights=table)
    want, got = _both(jl, tl, ids)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want[1, 2]).all() and np.isnan(want[2, :1]).all()
    np.testing.assert_allclose(got, want, atol=0, rtol=0)
    assert [n for n, _ in tl.named_parameters()] == (
        ["embeddings"] if trainable else [])
    assert [n for n, _ in tl.named_buffers()] == (
        [] if trainable else ["embeddings"])
    with pytest.raises(ValueError, match="shape"):
        TL.Embedding(3, 4, weights=table)


def test_frozen_table_round_trips_as_state():
    JEng.reset_uids()
    ji = JL.Input((2,), name="ids")
    jout = JL.Dense(3, name="d")(JL.Flatten()(JL.Embedding(
        7, 4, trainable=False, name="e")(ji)))
    jm = JEng.Model(ji, jout)
    params, state = jm.init(jax.random.PRNGKey(0))
    TEng.reset_uids()
    ti = TL.Input((2,), name="ids")
    tout = TL.Dense(3, name="d")(TL.Flatten()(TL.Embedding(
        7, 4, trainable=False, name="e")(ti)))
    tm = TEng.Model(ti, tout, device="cpu")
    tm.set_weights((_np(params), _np(state)))
    p, s = tm.get_weights()
    assert set(p) == {"d"} and set(s) == {"e"}
    np.testing.assert_array_equal(s["e"]["embeddings"],
                                  np.asarray(state["e"]["embeddings"]))
    ids = np.array([[1, 6], [0, 3]], np.int32)
    want = np.asarray(jm.apply(params, state, ids)[0])
    np.testing.assert_allclose(tm(torch.from_numpy(ids)).detach().numpy(),
                               want, atol=ATOL, rtol=0)
    with pytest.raises(KeyError, match="e.embeddings"):
        tm.set_weights(_np(params))              # state missing


def _graph(E, L, **kw):
    """One graph built through ``E`` (an engine) and ``L`` (a layers
    module): Variable arithmetic and unnamed layers over two inputs."""
    E.reset_uids()
    a, b = L.Input((4,), name="a"), L.Input((4,))
    h = L.Dense(6)(a)
    y = (3.0 - h * 2.0) / 4.0 + (-h) ** 2
    z = L.Merge(mode="concat")([y, a * b, 1.0 / (b * b + 1.0), a - b,
                                L.Dense(2)(a)])
    z = (z.slice(1, 1, 9) - L.ExpandDim(1)(b.index_select(1, 3)) * 0.5
         + L.ExpandDim(1)(a.slice(1, 0, 1).squeeze(1)))
    return (E.Model([a, b], L.Dense(3, activation="softmax")(z), **kw),
            b.name)


def test_variable_graph_matches_jax_with_its_auto_names():
    jm, jb = _graph(JEng, JL)
    params, state = jm.init(jax.random.PRNGKey(0))
    tm, tb = _graph(TEng, TL, device="cpu")
    assert tb == jb == "input_1"
    assert [l.name for l in tm.layers] == [l.name for l in jm.layers]
    tm.set_weights((_np(params), _np(state)))
    a, b = _x(5, 4, seed=1), _x(5, 4, seed=2)
    want = np.asarray(jm.apply(params, state, [a, b])[0])
    ta, tb_ = torch.from_numpy(a), torch.from_numpy(b)
    with torch.no_grad():
        for x in ([ta, tb_], (ta, tb_), {"a": ta, jb: tb_}):
            np.testing.assert_allclose(tm(x).numpy(), want, atol=ATOL,
                                       rtol=0)
    with pytest.raises(ValueError, match="expects 2 inputs"):
        tm(ta)


def test_single_input_model_and_sequential_match_jax():
    JEng.reset_uids()
    jseq = JEng.Sequential([JL.Dense(5, activation="relu", input_shape=(3,)),
                            JL.Dense(4), JL.Activation("elu")])
    x = JL.Input((3,))
    jmodel = JEng.Model(x, JL.Dense(2)(jseq(x)))
    params, state = jmodel.init(jax.random.PRNGKey(2))
    TEng.reset_uids()
    tseq = TEng.Sequential([TL.Dense(5, activation="relu", input_shape=(3,)),
                            TL.Dense(4)], device="cpu")
    tseq.add(TL.Activation("elu"))
    tx = TL.Input((3,))
    tmodel = TEng.Model(tx, TL.Dense(2)(tseq(tx)), device="cpu")
    assert ([l.name for l in tmodel.layers]
            == [l.name for l in jmodel.layers]
            == ["sequential_1", "dense_3"])
    assert [l.name for l in tseq.layers] == ["dense_1", "dense_2",
                                             "activation_1"]
    tmodel.set_weights((_np(params), _np(state)))
    xs = _x(6, 3)
    want = np.asarray(jmodel.apply(params, state, xs)[0])
    with torch.no_grad():
        np.testing.assert_allclose(tmodel(torch.from_numpy(xs)).numpy(),
                                   want, atol=ATOL, rtol=0)
        # the inner Sequential alone, on its slice of the tree
        inner = np.asarray(jseq.apply(params["sequential_1"], {}, xs)[0])
        np.testing.assert_allclose(tseq(torch.from_numpy(xs)).numpy(), inner,
                                   atol=ATOL, rtol=0)


def test_sequential_without_a_shape_builds_at_init():
    seq = TEng.Sequential([TL.Dense(3), TL.Dense(2)], device="cpu")
    with pytest.raises(ValueError, match="input_shape unknown"):
        seq.init()
    with pytest.raises(RuntimeError, match="input_shape unknown"):
        seq(torch.zeros(1, 4))
    seq.init(torch.Generator().manual_seed(0), input_shape=(None, 4))
    assert seq(torch.zeros(1, 4)).shape == (1, 2)
    assert seq.param_count() == 4 * 3 + 3 + 3 * 2 + 2


def test_duplicate_layer_names_are_refused():
    a = TL.Input((2,))
    with pytest.raises(ValueError, match="named 'd'"):
        TEng.Model(a, TL.Merge()([TL.Dense(2, name="d")(a),
                                  TL.Dense(2, name="d")(a)]), device="cpu")
    # one layer called twice is one set of weights
    d = TL.Dense(2, name="d")
    m = TEng.Model(a, TL.Merge()([d(a), d(a)]), device="cpu")
    assert [n for n, _ in m.named_parameters()] == ["d.W", "d.b"]


def test_registries_match_jax():
    assert set(TAct._REGISTRY) == set(JAct._REGISTRY)
    assert set(TInit._REGISTRY) == set(JInit._REGISTRY)
    assert set(TLoss._REGISTRY) == set(JLoss._REGISTRY)


@pytest.mark.parametrize("name", sorted(n for n in JAct._REGISTRY if n))
def test_activation_matches_jax(name):
    x = _x(4, 7) * 3
    np.testing.assert_allclose(TAct.get(name)(torch.from_numpy(x)).numpy(),
                               np.asarray(JAct.get(name)(jnp.asarray(x))),
                               atol=2e-6, rtol=1e-6)


def _loss_inputs(name):
    rs = np.random.RandomState(0)
    probs = rs.dirichlet(np.ones(5), 6).astype(np.float32)
    if name.startswith("sparse"):
        return (_x(6, 5) if "logits" in name else probs,
                rs.randint(0, 5, 6).astype(np.int32))
    if name in ("categorical_crossentropy", "kld",
                "kullback_leibler_divergence"):
        return probs, rs.dirichlet(np.ones(5), 6).astype(np.float32)
    if name.startswith("binary"):
        return (_x(6, 1) if "logits" in name else probs[:, :1],
                rs.randint(0, 2, (6, 1)).astype(np.float32))
    if name in ("hinge", "squared_hinge"):
        return _x(6, 1), np.sign(_x(6, 1, seed=4))
    return np.abs(_x(6, 3)) + 0.1, np.abs(_x(6, 3, seed=5)) + 0.1


@pytest.mark.parametrize("name", sorted(JLoss._REGISTRY))
def test_loss_matches_jax(name):
    y_pred, y_true = _loss_inputs(name)
    want = float(JLoss.get(name)(jnp.asarray(y_pred), jnp.asarray(y_true)))
    got = float(TLoss.get(name)(torch.from_numpy(y_pred),
                                torch.from_numpy(y_true)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", sorted(JInit._REGISTRY))
def test_initializer_scale_matches_jax(name):
    shape = (64, 32)
    want = np.asarray(JInit.get(name)(jax.random.PRNGKey(0), shape))
    got = TInit.get(name)(torch.empty(shape),
                          torch.Generator().manual_seed(0)).numpy()
    # different generators: the same law, not the same numbers
    np.testing.assert_allclose(got.std(), want.std(), rtol=0.1, atol=1e-6)
    np.testing.assert_allclose(np.abs(got).max(), np.abs(want).max(),
                               rtol=0.35, atol=1e-6)
    assert TL.Embedding(3, 2).kernel_init is TInit.uniform


def test_compile_fit_need_a_compile_and_save_names_item_2(tmp_path):
    # compile is still needed first; save / load, set_checkpoint,
    # set_tensorboard and fit's checkpoint_dir / steps_per_dispatch are
    # ported now; loading a JAX-written file names item 2
    x = TL.Input((2,))
    m = TEng.Model(x, TL.Dense(2, activation="softmax")(x), device="cpu")
    with pytest.raises(RuntimeError, match="compile"):
        m.fit(np.zeros((4, 2), np.float32), np.zeros(4, np.int32))
    with pytest.raises(RuntimeError, match="compile"):
        m.evaluate(np.zeros((4, 2), np.float32), np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="per-name optimizer"):
        m.compile({"a": "adam"}, "mse")
    m.compile("sgd", "sparse_categorical_crossentropy")
    xs = np.random.default_rng(0).standard_normal((4, 2)).astype(np.float32)
    ys = np.array([0, 1, 1, 0], np.int32)
    m.set_checkpoint(str(tmp_path / "ck"))
    m.set_tensorboard(str(tmp_path / "tb"), "app")
    m.fit(xs, ys, batch_size=2, steps_per_dispatch=2)
    assert sorted(os.listdir(tmp_path / "ck")) == ["ckpt-0", "ckpt-2"]
    assert TTB.read_scalar(str(tmp_path / "tb" / "app" / "train"),
                           "Loss").shape == (1, 3)
    m.fit(xs, ys, batch_size=2, checkpoint_dir=str(tmp_path / "ck2"))
    assert os.path.isdir(tmp_path / "ck2" / "ckpt-2")
    m.save(str(tmp_path / "m.pkl"))
    back = TEng.KerasNet.load(str(tmp_path / "m.pkl"), device="cpu")
    np.testing.assert_array_equal(back.predict(xs), m.predict(xs))
    jx = JL.Input((2,))
    jm = JEng.Model(jx, JL.Dense(2)(jx))
    jm.init(jax.random.PRNGKey(0))
    jm.save(str(tmp_path / "j.pkl"))
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        TEng.KerasNet.load(str(tmp_path / "j.pkl"), device="cpu")
