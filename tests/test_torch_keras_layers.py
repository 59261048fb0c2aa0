"""The port's core, advanced-activation, normalisation and embedding
layers against the JAX package's, on the CPU.

Each layer is built in both packages; the JAX layer's weights (moved off
their constant initial values by a seeded perturbation) go into the port
layer through ``interop.load_jax_params``, and the forward and the
gradients of a random projection of the output (with respect to the input
and every weight) must agree within 1e-5 (f32) on the same numpy input.
``Dropout`` must give the JAX layer's mask bit for bit for an int seed.
The layers whose JAX draws come from ``jax.random`` draw from the port's
counter hash instead, so they are held to the distribution: the identity
in eval mode, the same draw for the same seed (an int or a 0-d int32
tensor), keep-rates, means and variances within 4 standard errors at
2^16 elements, and spatial masks constant along the broadcast axes.
``BatchNormalization``'s running statistics must follow the JAX state
over 3 training forwards within 1e-5; ``WordEmbedding`` reads a tiny
GloVe file as the JAX layer does.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.keras import layers as JL
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.keras import layers as TL

from torch_parity import ATOL, _np, _perturb, _x, check_layer

N = 1 << 16                      # elements of a distributional check
SE = 4.0                         # standard errors allowed


# (layer, constructor kwargs, input shape, input options)
CASES = [
    ("Permute", dict(dims=(2, 1)), (4, 3, 5), {}),
    ("Permute", dict(dims=(3, 1, 2)), (2, 3, 4, 5), {}),
    ("RepeatVector", dict(n=3), (4, 5), {}),
    ("Masking", dict(mask_value=0.0), (4, 6, 3), dict(zero_rows=True)),
    ("Highway", dict(), (4, 6), {}),
    ("Highway", dict(activation="relu", bias=False), (4, 3, 6), {}),
    ("MaxoutDense", dict(output_dim=5, nb_feature=3), (4, 6), {}),
    ("MaxoutDense", dict(output_dim=5, bias=False), (4, 6), {}),
    ("Scale", dict(), (4, 3, 6), {}),
    ("CAdd", dict(), (4, 6), {}),
    ("CAdd", dict(size=(3, 6)), (4, 3, 6), {}),
    ("CMul", dict(), (4, 6), {}),
    ("CMul", dict(size=(3, 1)), (4, 3, 6), {}),
    ("Mul", dict(), (4, 6), {}),
    ("SparseDense", dict(output_dim=3, activation="relu"), (4, 6), {}),
    ("Exp", dict(), (4, 6), {}),
    ("Log", dict(), (4, 6), dict(positive=True)),
    ("Sqrt", dict(), (4, 6), dict(positive=True)),
    ("Square", dict(), (4, 6), {}),
    ("Negative", dict(), (4, 6), {}),
    ("Identity", dict(), (4, 6), {}),
    ("AddConstant", dict(constant=1.5), (4, 6), {}),
    ("MulConstant", dict(constant=-2.5), (4, 6), {}),
    ("Power", dict(power=2.0, scale=0.5, shift=0.3), (4, 6), {}),
    ("Power", dict(power=0.5, scale=2.0, shift=0.1), (4, 6),
     dict(positive=True)),
    ("Threshold", dict(th=0.2, v=-1.0), (4, 6), {}),
    ("BinaryThreshold", dict(value=0.1), (4, 6), dict(grad=False)),
    ("HardShrink", dict(value=0.4), (4, 6), {}),
    ("SoftShrink", dict(value=0.4), (4, 6), {}),
    ("HardTanh", dict(min_value=-0.5, max_value=0.8), (4, 6), {}),
    ("LRN2D", dict(), (2, 3, 3, 7), {}),
    ("LRN2D", dict(alpha=0.1, k=2.0, beta=0.5, n=4), (2, 3, 3, 6), {}),
    ("WithinChannelLRN2D", dict(), (2, 6, 5, 3), {}),
    ("WithinChannelLRN2D", dict(size=4, alpha=0.5, beta=0.6), (2, 5, 6, 2),
     {}),
    ("SplitTensor", dict(dim=2, num_split=3), (4, 2, 6), {}),
    ("Max", dict(dim=1), (4, 5, 3), {}),
    ("Expand", dict(tgt_sizes=(-1, 3, 4)), (2, 1, 4), {}),
    ("Squeeze", dict(dim=1), (4, 1, 3), {}),
    ("ELU", dict(alpha=0.7), (4, 6), {}),
    ("LeakyReLU", dict(), (4, 6), {}),
    ("PReLU", dict(), (4, 3, 6), {}),
    ("SReLU", dict(), (4, 6), dict(scale=2.0)),
    ("ThresholdedReLU", dict(theta=0.3), (4, 6), {}),
    ("Softmax", dict(), (4, 6), {}),
    ("Softmax", dict(axis=1), (4, 3, 6), {}),
    ("RReLU", dict(), (4, 6), {}),
    ("Dropout", dict(p=0.3), (4, 6), {}),
    ("SpatialDropout1D", dict(p=0.3), (4, 3, 6), {}),
    ("SpatialDropout2D", dict(p=0.3), (2, 3, 4, 5), {}),
    ("SpatialDropout3D", dict(p=0.3, dim_ordering="tf"), (2, 3, 2, 2, 3),
     {}),
    ("GaussianDropout", dict(p=0.3), (4, 6), {}),
    ("GaussianNoise", dict(sigma=0.5), (4, 6), {}),
]


def _input(shape, opts):
    x = _x(*shape, positive=opts.get("positive", False))
    x = x * opts.get("scale", 1.0)
    if opts.get("zero_rows"):
        x[:, ::2, :] = 0.0
    return x


@pytest.mark.parametrize(
    "name,kw,shape,opts", CASES,
    ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_layer_matches_jax_in_eval_mode(name, kw, shape, opts):
    x = _input(shape, opts)
    check_layer(getattr(JL, name)(**kw), getattr(TL, name)(**kw), x,
                grad=opts.get("grad", True))


def test_get_shape_select_table_and_the_sampler_in_eval_mode():
    x = _x(4, 3, 5)
    got = TL.GetShape()(torch.from_numpy(x))
    want = JL.GetShape().call({}, {}, jnp.asarray(x), False, None)[0]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pair = [_x(4, 3), _x(4, 3, seed=1)]
    check_layer(JL.SelectTable(1), TL.SelectTable(1), pair)
    check_layer(JL.GaussianSampler(), TL.GaussianSampler(), pair)


@pytest.mark.parametrize("wrapped", ["layer", "function"])
def test_keras_layer_wrapper_matches_jax(wrapped):
    x = _x(4, 6)
    if wrapped == "layer":
        jl = JL.KerasLayerWrapper(JL.Dense(3, activation="tanh"))
        tl = TL.KerasLayerWrapper(TL.Dense(3, activation="tanh"))
    else:
        jl = JL.KerasLayerWrapper(lambda t: jnp.tanh(t) * 2.0)
        tl = TL.KerasLayerWrapper(lambda t: torch.tanh(t) * 2.0)
    check_layer(jl, tl, x)
    # the wrapped layer's tree is the wrapper's own (not nested)
    assert set(tl.state_dict()) == ({"W", "b"} if wrapped == "layer"
                                    else set())
    assert tl.compute_output_shape((None, 6)) == jl.compute_output_shape(
        (None, 6))


def test_a_layer_in_a_sequential_carries_its_tree():
    from analytics_zoo_tpu.keras.engine import Sequential as JSeq
    from analytics_zoo_tpu.keras.engine import reset_uids as jreset
    from analytics_zoo_tpu_torch.keras.engine import Sequential as TSeq
    from analytics_zoo_tpu_torch.keras.engine import reset_uids as treset
    build = lambda L: [L.Highway(input_shape=(6,)), L.PReLU(),
                       L.MaxoutDense(4, nb_feature=2), L.Scale(),
                       L.CMul(), L.Mul(), L.Dense(2)]
    jreset()
    jm = JSeq(build(JL))
    params, state = jm.init(jax.random.PRNGKey(0))
    params = _perturb(params)
    treset()
    tm = TSeq(build(TL), device="cpu")
    tm.set_weights((_np(params), _np(state)))
    x = _x(5, 6)
    want = np.asarray(jm.apply(params, state, jnp.asarray(x))[0])
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# --- randomness -------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 12345, -7])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_is_the_jax_mask_bit_for_bit(seed, p):
    x = _x(8, 33, 5)
    want = JL.Dropout(p).call({}, {}, jnp.asarray(x), True,
                              jnp.int32(seed))[0]
    layer = TL.Dropout(p)
    layer.train()
    got = layer(torch.from_numpy(x), seed=seed)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a 0-d int32 tensor seed (as the captured step holds it) is the same
    got_t = layer(torch.from_numpy(x),
                  seed=torch.tensor(seed, dtype=torch.int32))
    assert torch.equal(got, got_t)


DRAWN = {
    "Dropout": lambda: TL.Dropout(0.3),
    "SpatialDropout1D": lambda: TL.SpatialDropout1D(0.3),
    "SpatialDropout2D": lambda: TL.SpatialDropout2D(0.3),
    "SpatialDropout3D": lambda: TL.SpatialDropout3D(0.3),
    "GaussianDropout": lambda: TL.GaussianDropout(0.3),
    "GaussianNoise": lambda: TL.GaussianNoise(0.5),
    "RReLU": lambda: TL.RReLU(),
}
SHAPES = {"SpatialDropout2D": (4, 3, 5, 6), "SpatialDropout3D": (2, 3, 2, 4,
                                                                 5)}


@pytest.mark.parametrize("name", list(DRAWN))
def test_drawn_layers_are_identities_in_eval_and_repeat_per_seed(name):
    x = torch.from_numpy(_x(*SHAPES.get(name, (4, 6, 5))))
    layer = DRAWN[name]()
    if name == "RReLU":           # eval: the mean slope, not the identity
        want = torch.where(x >= 0, x, (1 / 8 + 1 / 3) / 2 * x)
    else:
        want = x
    assert torch.equal(layer(x, seed=3), want)
    layer.train()
    assert torch.equal(layer(x), want)          # no seed: no draw
    a, b = layer(x, seed=3), layer(x, seed=3)
    assert torch.equal(a, b)
    assert torch.equal(a, layer(x, seed=torch.tensor(3, dtype=torch.int32)))
    assert not torch.equal(a, layer(x, seed=4))


def _within(value, mean, var, n):
    return abs(value - mean) <= SE * math.sqrt(var / n)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_spatial_dropout_keeps_whole_channels_at_the_rate(p):
    cases = [(TL.SpatialDropout1D(p), (N // 8, 4, 8), (0, 2)),
             (TL.SpatialDropout2D(p), (N // 8, 8, 2, 2), (0, 1)),
             (TL.SpatialDropout2D(p, dim_ordering="tf"), (N // 8, 2, 2, 8),
              (0, 3)),
             (TL.SpatialDropout3D(p), (N // 8, 8, 1, 2, 1), (0, 1)),
             (TL.SpatialDropout3D(p, dim_ordering="tf"), (N // 8, 1, 2, 1,
                                                          8), (0, 4))]
    keep = 1.0 - p
    for layer, shape, kept_axes in cases:
        layer.train()
        y = layer(torch.ones(shape), seed=11)
        # one draw per (batch, channel): constant along the other axes
        other = tuple(i for i in range(len(shape)) if i not in kept_axes)
        first = y.narrow(other[0], 0, 1)
        assert torch.equal(y, first.expand_as(y))
        mask = first.amax(dim=other) > 0
        assert mask.numel() == N
        assert _within(float(mask.float().mean()), keep, keep * p, N)
        # survivors scale by 1 / keep
        assert torch.allclose(y[y > 0], torch.tensor(1.0 / keep))


def test_gaussian_draws_have_their_moments():
    x = torch.ones(N)
    for layer, mean, var in ((TL.GaussianDropout(0.3), 1.0, 0.3 / 0.7),
                             (TL.GaussianNoise(0.5), 1.0, 0.25)):
        layer.train()
        y = layer(x, seed=5)
        assert _within(float(y.mean()), mean, var, N)
        # the variance of a sample variance is 2 var^2 / n for a normal
        assert _within(float(y.var()), var, 2 * var * var, N)
    mean, log_var = torch.zeros(N), torch.full((N,), math.log(4.0))
    sampler = TL.GaussianSampler()
    assert torch.equal(sampler([mean, log_var], seed=2), mean)
    sampler.train()
    y = sampler([mean, log_var], seed=2)
    assert _within(float(y.mean()), 0.0, 4.0, N)
    assert _within(float(y.var()), 4.0, 32.0, N)
    assert torch.equal(y, sampler([mean, log_var], seed=2))


def test_rrelu_slopes_are_uniform_in_their_range():
    layer = TL.RReLU(lower=0.1, upper=0.3)
    layer.train()
    slopes = layer(-torch.ones(N), seed=9).neg()
    assert float(slopes.min()) >= 0.1 and float(slopes.max()) < 0.3
    width = 0.2
    assert _within(float(slopes.mean()), 0.2, width ** 2 / 12, N)
    assert torch.equal(layer(torch.ones(8), seed=9), torch.ones(8))


def test_hash_draws_are_the_same_on_a_tensor_seed_in_a_model():
    from analytics_zoo_tpu_torch.keras.engine import Sequential
    m = Sequential([TL.GaussianNoise(0.5, input_shape=(3, 6)),
                    TL.SpatialDropout1D(0.3), TL.Dropout(0.2)],
                   device="cpu")
    m.train()
    x = torch.ones(4, 3, 6)
    assert torch.equal(m(x, seed=1),
                       m(x, seed=torch.tensor(1, dtype=torch.int32)))


# --- BatchNormalization -----------------------------------------------------

@pytest.mark.parametrize("axis,shape", [(-1, (6, 4, 5, 3)), (1, (6, 3, 4)),
                                        (-1, (8, 5))])
def test_batchnorm_matches_jax_and_its_running_statistics(axis, shape):
    jl, tl = JL.BatchNormalization(axis=axis), TL.BatchNormalization(
        axis=axis)
    x0 = _x(*shape) * 2.0 + 0.5
    # eval mode: the moving statistics (moved off 0 / 1)
    params, state = jl.build(jax.random.PRNGKey(1), (None,) + shape[1:])
    params, state = _perturb(params), _perturb(state)
    state = jax.tree_util.tree_map(jnp.abs, state)
    tl.ensure_built((None,) + shape[1:])
    interop.load_jax_params(tl, _np(params), _np(state))
    np.testing.assert_allclose(
        tl(torch.from_numpy(x0)).detach().numpy(),
        np.asarray(jl.call(params, state, jnp.asarray(x0), False, None)[0]),
        atol=ATOL, rtol=0)
    # three training forwards: outputs and the state they leave
    tl.train()
    for step in range(3):
        x = _x(*shape, seed=step) * 2.0 + 0.5
        want, state = jl.call(params, state, jnp.asarray(x), True, None)
        got = tl(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)
        for key in ("moving_mean", "moving_var"):
            np.testing.assert_allclose(getattr(tl, key).numpy(),
                                       np.asarray(state[key]), atol=ATOL,
                                       rtol=0, err_msg=f"{key} step {step}")
    assert set(interop.state_tree(tl)) == {"moving_mean", "moving_var"}
    assert set(interop.params_tree(tl)) == {"gamma", "beta"}


def test_batchnorm_training_gradients_match_jax():
    shape = (6, 4, 3)
    jl, tl = JL.BatchNormalization(), TL.BatchNormalization()
    params, state = jl.build(jax.random.PRNGKey(1), (None,) + shape[1:])
    params = _perturb(params)
    tl.ensure_built((None,) + shape[1:])
    interop.load_jax_params(tl, _np(params), _np(state))
    tl.train()
    x = _x(*shape)
    r = _x(*shape, seed=4)
    loss = lambda p, xx: jnp.sum(jl.call(p, state, xx, True, None)[0] * r)
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    (tl(tx) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=ATOL,
                               rtol=0)
    for key in ("gamma", "beta"):
        np.testing.assert_allclose(getattr(tl, key).grad.numpy(),
                                   np.asarray(gp[key]), atol=ATOL, rtol=0)


# --- word and sparse embeddings ---------------------------------------------

GLOVE = ["the 0.1 0.2 -0.3", "cat -1.5 0.25 2.0", "sat 3.0 -0.5 0.125",
         "mat 0.0 1.0 -1.0"]


@pytest.mark.parametrize("word_index", [None, {"cat": 1, "mat": 2, "dog": 3,
                                               "the": 5}])
def test_word_embedding_reads_glove_as_jax(tmp_path, word_index):
    path = tmp_path / "glove.txt"
    path.write_text("\n".join(GLOVE) + "\n", encoding="utf-8")
    jl = JL.WordEmbedding(str(path), word_index)
    tl = TL.WordEmbedding(str(path), word_index)
    assert (tl.input_dim, tl.output_dim) == (jl.input_dim, jl.output_dim)
    params, state = jl.build(jax.random.PRNGKey(0), (None, 4))
    assert not params                           # frozen: state, a buffer
    np.testing.assert_array_equal(tl.embeddings.numpy(),
                                  np.asarray(state["embeddings"]))
    assert not list(tl.parameters())
    ids = np.array([[0, 1, 2, tl.input_dim - 1]], np.int32)
    np.testing.assert_array_equal(
        tl(torch.from_numpy(ids)).numpy(),
        np.asarray(jl.call(params, state, jnp.asarray(ids), False,
                           None)[0]))


def test_word_embedding_from_weights_and_trainable():
    w = _x(7, 3)
    for trainable in (False, True):
        jl = JL.WordEmbedding(weights=w, input_dim=7, output_dim=3,
                              trainable=trainable)
        tl = TL.WordEmbedding(weights=w, input_dim=7, output_dim=3,
                              trainable=trainable)
        ids = np.array([[1, 6, 0], [2, 2, 5]], np.int32)
        check_layer(jl, tl, ids, grad=False)
        assert bool(list(tl.parameters())) is trainable


def test_sparse_embedding_matches_jax():
    ids = np.random.RandomState(0).randint(0, 9, (4, 5)).astype(np.int32)
    check_layer(JL.SparseEmbedding(9, 4), TL.SparseEmbedding(9, 4), ids,
                grad=False)


@pytest.mark.parametrize("rows", [2, 50])
@pytest.mark.parametrize("how", ["gather_rows", "ordered"])
def test_gather_rows_is_jnp_take(rows, how):
    """``gather_rows`` (the embedding lookup: ``F.embedding`` here, its
    ordered-backward form on the card, run here as ``ordered``) gives
    ``jnp.take``'s rows and gradient, ids repeated many times over."""
    from analytics_zoo_tpu_torch.keras.layers import embedding
    gather = (embedding.gather_rows if how == "gather_rows"
              else embedding._OrderedGather.apply)
    rs = np.random.RandomState(rows)
    table = rs.randn(rows, 5).astype(np.float32)
    ids = rs.randint(0, rows, (6, 40)).astype(np.int32)
    r = rs.randn(6, 40, 5).astype(np.float32)
    take = lambda t: jnp.take(t, jnp.asarray(ids), axis=0)
    want = np.asarray(take(jnp.asarray(table)))
    gwant = np.asarray(jax.grad(lambda t: jnp.sum(take(t) * r))(
        jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    got = gather(t, torch.from_numpy(ids).long())
    np.testing.assert_array_equal(got.detach().numpy(), want)
    torch.sum(got * torch.from_numpy(r)).backward()
    np.testing.assert_allclose(t.grad.numpy(), gwant, rtol=1e-6, atol=1e-6)
