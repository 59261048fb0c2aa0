"""The port's recurrent layers against the JAX package's, on the CPU.

SimpleRNN, LSTM and GRU (forwards and backwards in time, last step and
whole sequences, Keras-1 and other activations), ``LSTM.scan_with_state``
from given states, ``Bidirectional`` in every merge mode,
``TimeDistributed`` over a dense and a convolution layer, and
``ConvLSTM2D`` / ``ConvLSTM3D``: the JAX weights (perturbed) go into the
port through ``interop.load_jax_params`` (``W`` / ``U`` / ``b``, the
``forward`` / ``backward`` subtrees, ``TimeDistributed``'s unnested
inner tree), and forwards and gradients must agree within 1e-5 (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.keras import layers as JL
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.keras import layers as TL

from torch_parity import ATOL, _np, _perturb, _x, check_layer

RNN = [
    ("SimpleRNN", dict()),
    ("SimpleRNN", dict(return_sequences=True, go_backwards=True)),
    ("LSTM", dict()),
    ("LSTM", dict(return_sequences=True)),
    ("LSTM", dict(go_backwards=True)),
    ("LSTM", dict(return_sequences=True, go_backwards=True,
                  inner_activation="sigmoid", activation="relu")),
    ("GRU", dict()),
    ("GRU", dict(return_sequences=True)),
    ("GRU", dict(go_backwards=True, inner_activation="sigmoid")),
    ("GRU", dict(return_sequences=True, go_backwards=True)),
]


@pytest.mark.parametrize("name,kw", RNN,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(RNN)])
def test_recurrent_layer_matches_jax(name, kw):
    jl, tl = getattr(JL, name)(6, **kw), getattr(TL, name)(6, **kw)
    x = _x(3, 7, 4)
    got = check_layer(jl, tl, x)
    assert tuple(got.shape) == ((3, 7, 6) if kw.get("return_sequences")
                                else (3, 6))
    assert tl.compute_output_shape((None, 7, 4)) == \
        jl.compute_output_shape((None, 7, 4))
    assert set(tl.state_dict()) == {"W", "U", "b"}


def test_initial_biases_are_the_jax_ones():
    for name in ("SimpleRNN", "LSTM", "GRU"):
        jp, _ = getattr(JL, name)(5).build(jax.random.PRNGKey(0), (None, 3, 2))
        tl = getattr(TL, name)(5, input_shape=(3, 2))
        np.testing.assert_array_equal(tl.b.detach().numpy(),
                                      np.asarray(jp["b"]))
        for key in ("W", "U"):
            assert tuple(getattr(tl, key).shape) == jp[key].shape


@pytest.mark.parametrize("with_state", [False, True])
def test_lstm_scan_with_state_matches_jax(with_state):
    jl, tl = JL.LSTM(5), TL.LSTM(5)
    params, _ = jl.build(jax.random.PRNGKey(1), (None, 6, 3))
    params = _perturb(params)
    tl.ensure_built((None, 6, 3))
    interop.load_jax_params(tl, _np(params))
    x = _x(2, 6, 3)
    h0 = _x(2, 5, seed=1) if with_state else None
    c0 = _x(2, 5, seed=2) if with_state else None
    want = jl.scan_with_state(params, jnp.asarray(x),
                              None if h0 is None else jnp.asarray(h0),
                              None if c0 is None else jnp.asarray(c0))
    got = tl.scan_with_state(torch.from_numpy(x),
                             None if h0 is None else torch.from_numpy(h0),
                             None if c0 is None else torch.from_numpy(c0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("merge_mode", ["concat", "sum", "mul", "ave"])
@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_bidirectional_matches_jax(cell, merge_mode):
    seq = merge_mode in ("concat", "mul")
    jl = JL.Bidirectional(getattr(JL, cell)(4, return_sequences=seq),
                          merge_mode=merge_mode)
    tl = TL.Bidirectional(getattr(TL, cell)(4, return_sequences=seq),
                          merge_mode=merge_mode)
    check_layer(jl, tl, _x(2, 5, 3))
    assert {k.split(".")[0] for k in tl.state_dict()} == {"forward",
                                                          "backward"}
    assert tl.compute_output_shape((None, 5, 3)) == \
        jl.compute_output_shape((None, 5, 3))


@pytest.mark.parametrize("inner", ["dense", "conv"])
def test_time_distributed_matches_jax(inner):
    if inner == "dense":
        jl = JL.TimeDistributed(JL.Dense(3, activation="tanh"))
        tl = TL.TimeDistributed(TL.Dense(3, activation="tanh"))
        x = _x(2, 5, 4)
    else:
        jl = JL.TimeDistributed(JL.Convolution2D(3, 2, 2))
        tl = TL.TimeDistributed(TL.Convolution2D(3, 2, 2))
        x = _x(2, 3, 4, 5, 2)
    check_layer(jl, tl, x)
    # the inner tree is the wrapper's own, as in the JAX package
    assert set(tl.state_dict()) == {"W", "b"}
    assert tl.compute_output_shape((None,) + x.shape[1:]) == \
        jl.compute_output_shape((None,) + x.shape[1:])


@pytest.mark.parametrize("return_sequences", [False, True])
def test_conv_lstm_2d_matches_jax(return_sequences):
    jl = JL.ConvLSTM2D(3, 3, return_sequences=return_sequences)
    tl = TL.ConvLSTM2D(3, 3, return_sequences=return_sequences)
    check_layer(jl, tl, _x(1, 3, 4, 5, 2))
    assert tl.compute_output_shape((None, 3, 4, 5, 2)) == \
        jl.compute_output_shape((None, 3, 4, 5, 2))


def test_conv_lstm_3d_matches_jax():
    check_layer(JL.ConvLSTM3D(2, 3, return_sequences=True),
                TL.ConvLSTM3D(2, 3, return_sequences=True),
                _x(1, 2, 3, 3, 3, 1))


def test_recurrent_layers_in_a_model_train_as_jax(monkeypatch):
    """A Sequential of Bidirectional(LSTM) -> TimeDistributed(Dense) ->
    GRU -> Dense: 3 SGD steps within 1e-5 of JAX's fit."""
    from analytics_zoo_tpu.estimator import estimator as JE
    from analytics_zoo_tpu.keras.engine import Sequential as JSeq
    from analytics_zoo_tpu.keras.engine import reset_uids as jreset
    from analytics_zoo_tpu_torch.estimator import estimator as TE
    from analytics_zoo_tpu_torch.keras.engine import Sequential as TSeq
    from analytics_zoo_tpu_torch.keras.engine import reset_uids as treset

    def build(L):
        return [L.Bidirectional(L.LSTM(4, return_sequences=True),
                                input_shape=(6, 3)),
                L.TimeDistributed(L.Dense(5, activation="relu")),
                L.GRU(4), L.Dense(1)]
    jreset()
    jm = JSeq(build(JL))
    params, state = jm.init(jax.random.PRNGKey(0))
    treset()
    tm = TSeq(build(TL), device="cpu")
    tm.set_weights((_np(params), _np(state)))
    x, y = _x(24, 6, 3), _x(24, seed=1)
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
    for m in (jm, tm):
        m.compile("sgd", "mse")
        m.fit(x, y, batch_size=8, nb_epoch=1)
    assert len(tlosses) == len(jlosses) == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=0)
    want = interop._flatten(_np(jm.get_weights()[0]))
    got = interop._flatten(tm.get_weights()[0])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0,
                                   err_msg=k)
