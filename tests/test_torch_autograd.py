"""The port's autograd against the JAX package's, on the CPU.

Every function of ``autograd.__all__`` symbolic (a ``Model`` over
``Input`` nodes, the same auto-names) and eager, on the same numpy
inputs; ``batch_dot`` over its axes, ``normalize`` and the 2-D squeeze
rule; ``mm`` with and without ``axes``; ``Parameter`` (``init_weight``,
``init_method``, the default draw's range, the ``+ - *`` sugar) and
``Constant`` (a buffer: the JAX ``state``) as graph nodes with no input;
``CustomLoss`` (its value, ``forward`` and ``backward``) and 3 ``fit``
steps of a ``Model`` compiled with it, against JAX's with the same
weights.  f32 tolerance 1e-5 (forwards, losses relative, weights).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu import autograd as JA
from analytics_zoo_tpu.keras import engine as JEng
from analytics_zoo_tpu.keras.layers import Dense as JDense
from analytics_zoo_tpu.keras.optimizers import SGD as JSGD
from analytics_zoo_tpu_torch import autograd as TA
from analytics_zoo_tpu_torch.keras import engine as TEng
from analytics_zoo_tpu_torch.keras.layers import Dense as TDense
from analytics_zoo_tpu_torch.keras.optimizers import SGD as TSGD

ATOL = 1e-5


def _x(*shape, seed=0, positive=False):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.abs(a) + 0.5 if positive else a


def _both(build, in_shapes, xs):
    """``build(A, inputs)`` in both packages (auto-names reset), the JAX
    weights loaded into the port; returns (port out, JAX out, models)."""
    outs, models = [], []
    for A, eng in ((JA, JEng), (TA, TEng)):
        eng.reset_uids()
        ins = [eng.Input(s) for s in in_shapes]
        out = build(A, ins)
        kw = {} if eng is JEng else {"device": "cpu"}
        models.append(eng.Model(ins if len(ins) > 1 else ins[0], out, **kw))
    jm, tm = models
    params, state = jm.init(jax.random.PRNGKey(0))
    tm.set_weights((jax.tree_util.tree_map(np.asarray, params),
                    jax.tree_util.tree_map(np.asarray, state)))
    jarg = [jnp.asarray(a) for a in xs] if len(xs) > 1 else jnp.asarray(
        xs[0])
    targ = [torch.from_numpy(a) for a in xs] if len(xs) > 1 else \
        torch.from_numpy(xs[0])
    want = np.asarray(jm.apply(params, state, jarg)[0])
    got = tm(targ).detach().numpy()
    assert [l.name for l in tm.layers] == [l.name for l in jm.layers]
    return got, want, models


UNARY = {
    "square": lambda A, v: A.square(v), "sqrt": lambda A, v: A.sqrt(v),
    "exp": lambda A, v: A.exp(v), "log": lambda A, v: A.log(v),
    "abs": lambda A, v: A.abs(v), "neg": lambda A, v: A.neg(v),
    "softsign": lambda A, v: A.softsign(v),
    "softplus": lambda A, v: A.softplus(v), "erf": lambda A, v: A.erf(v),
    "contiguous": lambda A, v: A.contiguous(v),
    "mean": lambda A, v: A.mean(v, axis=1),
    "mean_keep": lambda A, v: A.mean(v, axis=2, keepDims=True),
    "sum": lambda A, v: A.sum(v, axis=1, keepDims=True),
    "sum_batch": lambda A, v: A.sum(v),
    "clip": lambda A, v: A.clip(v, 0.7, 1.4),
    "pow": lambda A, v: A.pow(v, 2.5),
    "maximum_scalar": lambda A, v: A.maximum(v, 1.0),
    "expand_dims": lambda A, v: A.expand_dims(v, 1),
    "expand_dims_last": lambda A, v: A.expand_dims(v, -1),
    "l2_normalize": lambda A, v: A.l2_normalize(v, axis=2),
    "operators": lambda A, v: (1.0 - v) * 2.0 + v / 2.0 - v ** 2.0,
    "slice_select": lambda A, v: v.slice(1, 1, 2).index_select(2, 3),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_ops_match_jax_symbolic_and_eager(name):
    a = _x(3, 4, 5, positive=True)
    got, want, _ = _both(lambda A, ins: UNARY[name](A, ins[0]), [(4, 5)],
                         [a])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-6)
    if name in ("operators", "slice_select"):
        return
    eager = UNARY[name](TA, a)
    assert isinstance(eager, torch.Tensor)
    np.testing.assert_allclose(eager.numpy(), want, atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(UNARY[name](TA, torch.from_numpy(a)).numpy(),
                               want, atol=ATOL, rtol=1e-6)


BINARY = {
    "maximum": lambda A, x, y: A.maximum(x, y),
    "stack": lambda A, x, y: A.stack([x, y], axis=1),
    "stack_last": lambda A, x, y: A.stack([x, y], axis=-1),
    "mm": lambda A, x, y: A.mm(x, A.expand_dims(y, 2)),
    "batch_dot_3d": lambda A, x, y: A.batch_dot(x, y, axes=(2, 2)),
    "batch_dot_norm": lambda A, x, y: A.batch_dot(x, y, axes=2,
                                                  normalize=True),
    "arith": lambda A, x, y: A.maximum(x, y) - x * y + y / (x + 3.0),
}


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_ops_match_jax(name):
    a, b = _x(2, 4, 6, seed=1), _x(2, 4, 6, seed=2)
    if name == "mm":
        b = _x(2, 6, seed=2)
    shapes = [(4, 6), b.shape[1:]]
    got, want, _ = _both(lambda A, ins: BINARY[name](A, *ins), shapes, [a, b])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("case", [
    ((2, 3, 4), (2, 4, 5), (2, 1), False),
    ((2, 3, 4), (2, 5, 4), 2, False),
    ((2, 4, 3), (2, 4, 5), 1, True),
    ((6, 8), (6, 8), 1, False),
    ((6, 8), (6, 8), 1, True),
    ((6, 8), (6, 8, 3), (1, 1), False),
], ids=["ik-kj", "last-last", "first-first-normalized", "2d-squeeze",
        "2d-cosine", "2d-3d"])
def test_batch_dot_eager_matches_jax(case):
    sa, sb, axes, normalize = case
    a, b = _x(*sa, seed=3), _x(*sb, seed=4)
    want = np.asarray(JA.batch_dot(a, b, axes=axes, normalize=normalize))
    got = TA.batch_dot(a, b, axes=axes, normalize=normalize).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("axes", [None, (1, 0), (0, 1)])
def test_mm_eager_matches_jax(axes):
    a, b = _x(4, 5, seed=5), _x(5, 4, seed=6)
    want = np.asarray(JA.mm(a, b, axes=axes))
    got = TA.mm(a, b, axes=axes).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-6)


def test_eager_stack_maximum_and_epsilon():
    a, b = _x(2, 3, seed=7), _x(2, 3, seed=8)
    np.testing.assert_allclose(TA.stack([a, b]).numpy(),
                               np.asarray(JA.stack([a, b])), atol=0)
    np.testing.assert_allclose(TA.maximum(a, b).numpy(),
                               np.asarray(JA.maximum(a, b)), atol=0)
    np.testing.assert_allclose(TA.maximum(a, 0.25).numpy(),
                               np.asarray(JA.maximum(a, 0.25)), atol=0)
    assert TA.epsilon() == JA.epsilon() == 1e-7
    # numpy f64 is taken as f32, as jnp.asarray takes it
    assert TA.square(np.ones(3)).dtype == torch.float32


def test_parameter_node_matches_jax_and_trains_as_jax():
    x = _x(16, 4, seed=9)
    y = 3.0 * x + 1.0
    runs = []
    for A, eng, dense, sgd in ((JA, JEng, JDense, JSGD),
                               (TA, TEng, TDense, TSGD)):
        eng.reset_uids()
        p = A.Parameter((4,), init_weight=np.full(4, 0.5, np.float32))
        inp = eng.Input((4,))
        out = dense(4)(inp * p.to_variable()) + A.Constant(
            np.arange(4, dtype=np.float32)).to_variable()
        out = 1.0 - (p - out)           # the + - * sugar on a Parameter
        kw = {} if eng is JEng else {"device": "cpu"}
        runs.append((p, eng.Model(inp, out, **kw), sgd))
    (jp, jm, _), (tp, tm, _) = runs
    params, state = jm.init(jax.random.PRNGKey(2))
    assert set(params) == {jp.name, "dense_1"} and set(state) == {
        "constant_1"}
    tm.set_weights((jax.tree_util.tree_map(np.asarray, params),
                    jax.tree_util.tree_map(np.asarray, state)))
    assert dict(tm.named_buffers()).keys() == {"constant_1.value"}
    assert "constant_1.value" not in dict(tm.named_parameters())
    want = np.asarray(jm.apply(params, state, jnp.asarray(x))[0])
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               want, atol=ATOL, rtol=0)
    jm.compile(JSGD(lr=0.05), "mse")
    tm.compile(TSGD(lr=0.05), "mse")
    jh = jm.fit(x, y, batch_size=8, nb_epoch=3, distributed=False)
    th = tm.fit(x, y, batch_size=8, nb_epoch=3)
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], rtol=1e-5)
    jw = np.asarray(jm.get_weights()[0][jp.name]["weight"])
    np.testing.assert_allclose(tp.weight.detach().numpy(), jw, atol=ATOL)
    np.testing.assert_allclose(tm.get_weights()[1]["constant_1"]["value"],
                               np.arange(4))


def test_parameter_initialisers():
    p = TA.Parameter((3, 5))
    limit = np.sqrt(6.0 / 15)
    w = p.weight.detach().numpy()
    assert w.shape == (3, 5) and np.all(np.abs(w) <= limit) and w.std() > 0
    p.reset_parameters(torch.Generator().manual_seed(1))
    again = TA.Parameter((3, 5))
    again.reset_parameters(torch.Generator().manual_seed(1))
    assert torch.equal(p.weight, again.weight)
    z = TA.Parameter((2, 2), init_method="zero")
    assert not z.weight.detach().any()
    ones = TA.Parameter((2,), init_weight=[1.0, 2.0])
    np.testing.assert_array_equal(ones.weight.detach().numpy(), [1.0, 2.0])
    assert ones.to_variable() is ones.to_variable()
    assert ones.to_variable().shape == (2,)


def _mse_like(A):
    return lambda yt, yp: A.mean(A.square(yt - yp) + 0.1 * A.abs(yp),
                                 axis=1)


def test_custom_loss_value_forward_backward_match_jax():
    yp, yt = _x(5, 3, seed=10), _x(5, 3, seed=11)
    jl = JA.CustomLoss(_mse_like(JA), (3,))
    tl = TA.CustomLoss(_mse_like(TA), (3,))
    assert float(tl(torch.from_numpy(yp), torch.from_numpy(yt))) == \
        pytest.approx(float(jl(jnp.asarray(yp), jnp.asarray(yt))), rel=1e-6)
    assert tl.forward(yt, yp) == pytest.approx(jl.forward(yt, yp), rel=1e-6)
    np.testing.assert_allclose(tl.backward(yt, yp), jl.backward(yt, yp),
                               atol=1e-6, rtol=0)
    with pytest.raises(TypeError, match="Variable"):
        TA.CustomLoss(lambda yt, yp: 1.0, (3,))


def test_custom_loss_in_keras_fit_matches_jax():
    x = _x(24, 6, seed=12)
    y = np.tanh(x[:, :3] - x[:, 3:]).astype(np.float32)
    models = []
    for A, eng, dense in ((JA, JEng, JDense), (TA, TEng, TDense)):
        eng.reset_uids()
        kw = {} if eng is JEng else {"device": "cpu"}
        models.append(eng.Sequential([dense(8, activation="tanh",
                                            input_shape=(6,)), dense(3)],
                                     **kw))
        models[-1].compile(JSGD(lr=0.1) if eng is JEng else TSGD(lr=0.1),
                           A.CustomLoss(_mse_like(A), (3,)))
    jm, tm = models
    params, state = jm.init(jax.random.PRNGKey(5))
    tm.set_weights((jax.tree_util.tree_map(np.asarray, params),
                    jax.tree_util.tree_map(np.asarray, state)))
    jh = jm.fit(x, y, batch_size=8, nb_epoch=1, distributed=False)
    th = tm.fit(x, y, batch_size=8, nb_epoch=1)
    assert th[0]["loss"] == pytest.approx(jh[0]["loss"], rel=1e-5)
    jw = jax.tree_util.tree_map(np.asarray, jm.get_weights()[0])
    tw = tm.get_weights()[0]
    for layer in jw:
        for k in jw[layer]:
            np.testing.assert_allclose(tw[layer][k], jw[layer][k],
                                       atol=ATOL, rtol=0)
