"""The port's convolution, padding, cropping, up-sampling, resizing and
pooling layers against the JAX package's, on the CPU.

Every layer is built in both packages on the same numpy input, the JAX
kernels (perturbed off their initial values) go into the port through
``interop.load_jax_params`` with no transpose, and the forward and the
gradients of a random projection of the output must agree within 1e-5
(f32), for every border mode, stride and dilation case: ``same`` with odd
and even kernels at strides 1, 2 and 3 (XLA's low-side rule), the
transposed convolution with kernels below, at and above its stride, and
bilinear resizing up and down (antialiased).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.keras import layers as JL
from analytics_zoo_tpu_torch.keras import layers as TL

from torch_parity import _x, check_layer

CONV = [
    ("Convolution1D", (4, 3), dict(border_mode="valid"), (2, 9, 3)),
    ("Convolution1D", (4, 4), dict(border_mode="same", subsample=2),
     (2, 9, 3)),
    ("Convolution1D", (4, 5), dict(border_mode="same", activation="relu"),
     (2, 8, 3)),
    ("Convolution1D", (3, 2), dict(border_mode="same", subsample=3,
                                   bias=False), (2, 10, 2)),
    ("Convolution2D", (4, 3, 3), dict(), (2, 7, 6, 3)),
    ("Convolution2D", (4, 2, 4), dict(border_mode="same", subsample=(2, 2)),
     (2, 7, 6, 3)),
    ("Convolution2D", (4, 4, 4), dict(border_mode="same", subsample=(2, 1)),
     (2, 8, 7, 2)),
    ("Convolution2D", (3, 3, 2), dict(border_mode="valid", subsample=(1, 2),
                                      activation="tanh"), (2, 7, 8, 2)),
    ("Convolution2D", (3, 3, 3), dict(border_mode="same", dilation=(2, 1)),
     (2, 9, 7, 2)),
    ("Convolution2D", (3, 5), dict(border_mode="same"), (1, 6, 6, 2)),
    ("Convolution3D", (3, 2, 3, 2), dict(border_mode="same", subsample=2),
     (2, 5, 6, 4, 2)),
    ("Convolution3D", (3, 3), dict(), (1, 5, 4, 4, 2)),
    ("AtrousConvolution1D", (3, 3), dict(atrous_rate=2, border_mode="same"),
     (2, 11, 2)),
    ("AtrousConvolution2D", (3, 3, 3), dict(atrous_rate=(2, 3)),
     (2, 9, 10, 2)),
    ("AtrousConvolution2D", (3, 2, 2), dict(atrous_rate=2,
                                            border_mode="same"),
     (2, 7, 6, 2)),
    ("Deconvolution2D", (2, 3, 3), dict(), (2, 4, 5, 2)),
    ("Deconvolution2D", (3, 3, 3), dict(subsample=(2, 2)), (2, 4, 5, 3)),
    ("Deconvolution2D", (2, 2, 4), dict(subsample=(3, 2)), (2, 3, 4, 2)),
    ("Deconvolution2D", (3, 4, 3), dict(subsample=(2, 2),
                                        border_mode="same"), (2, 3, 4, 3)),
    ("Deconvolution2D", (2, 3, 2), dict(subsample=(1, 3), border_mode="same",
                                        activation="relu"), (2, 3, 3, 2)),
    ("Deconvolution2D", (2, 5, 5), dict(subsample=(2, 2),
                                        border_mode="same"), (1, 3, 3, 2)),
    ("SeparableConvolution2D", (4, 3, 3), dict(), (2, 6, 7, 3)),
    ("SeparableConvolution2D", (4, 3), dict(depth_multiplier=2,
                                            border_mode="same",
                                            subsample=(2, 2)), (2, 7, 6, 3)),
    ("LocallyConnected1D", (3, 3), dict(), (2, 8, 2)),
    ("LocallyConnected1D", (3, 2), dict(subsample_length=2,
                                        activation="relu"), (2, 9, 2)),
    ("LocallyConnected2D", (3, 2, 3), dict(), (2, 5, 6, 2)),
    ("LocallyConnected2D", (2, 3, 2), dict(subsample=(2, 2), bias=False),
     (2, 7, 6, 2)),
    ("ShareConvolution2D", (3, 3, 3), dict(pad_h=1, pad_w=2), (2, 2, 6, 5)),
    ("ShareConvolution2D", (3, 2, 2), dict(subsample=(2, 1),
                                           activation="softmax"),
     (2, 2, 6, 5)),
    ("ShareConv2D", (2, 3, 3), dict(), (1, 2, 5, 5)),
]


def _id(case):
    name, args, kw, shape = case
    return f"{name}-{'x'.join(map(str, args))}-" + "-".join(
        f"{k}{v}" for k, v in kw.items())


@pytest.mark.parametrize("name,args,kw,shape", CONV,
                         ids=[_id(c) for c in CONV])
def test_convolution_matches_jax(name, args, kw, shape):
    jl, tl = getattr(JL, name)(*args, **kw), getattr(TL, name)(*args, **kw)
    got = check_layer(jl, tl, _x(*shape))
    assert tuple(got.shape[1:]) == tuple(tl.compute_output_shape(
        (None,) + shape[1:])[1:])
    assert tl.compute_output_shape((None,) + shape[1:]) == \
        jl.compute_output_shape((None,) + shape[1:])


SHAPE_OPS = [
    ("ZeroPadding1D", (), dict(), (2, 5, 3)),
    ("ZeroPadding1D", ((1, 3),), dict(), (2, 5, 3)),
    ("ZeroPadding2D", ((1, 2),), dict(), (2, 4, 3, 2)),
    ("ZeroPadding2D", ((1, 0, 2, 3),), dict(), (2, 4, 3, 2)),
    ("ZeroPadding3D", ((1, 0, 2),), dict(), (1, 3, 2, 2, 2)),
    ("Cropping1D", ((1, 2),), dict(), (2, 7, 3)),
    ("Cropping1D", ((2, 0),), dict(), (2, 7, 3)),
    ("Cropping2D", (((1, 0), (2, 1)),), dict(), (2, 5, 6, 2)),
    ("Cropping3D", (((1, 1), (0, 1), (1, 0)),), dict(), (1, 4, 3, 3, 2)),
    ("UpSampling1D", (3,), dict(), (2, 4, 3)),
    ("UpSampling2D", ((2, 3),), dict(), (2, 3, 2, 2)),
    ("UpSampling3D", ((2, 1, 3),), dict(), (1, 2, 3, 2, 2)),
    ("ResizeBilinear", (7, 9), dict(), (2, 4, 5, 3)),
    ("ResizeBilinear", (3, 2), dict(), (2, 8, 7, 3)),
    ("ResizeBilinear", (5, 10), dict(), (1, 9, 4, 2)),
    ("ResizeBilinear", (6, 6), dict(), (1, 6, 6, 2)),
]


@pytest.mark.parametrize("name,args,kw,shape", SHAPE_OPS,
                         ids=[_id(c) for c in SHAPE_OPS])
def test_padding_cropping_and_resizing_match_jax(name, args, kw, shape):
    jl, tl = getattr(JL, name)(*args, **kw), getattr(TL, name)(*args, **kw)
    got = check_layer(jl, tl, _x(*shape))
    assert tl.compute_output_shape((None,) + shape[1:]) == \
        jl.compute_output_shape((None,) + shape[1:])
    assert tuple(got.shape[1:]) == tuple(jl.compute_output_shape(
        (None,) + shape[1:])[1:])


POOL = [
    ("MaxPooling1D", (), dict(), (2, 9, 3)),
    ("MaxPooling1D", (3, 2), dict(border_mode="same"), (2, 8, 3)),
    ("AveragePooling1D", (2,), dict(), (2, 9, 3)),
    ("AveragePooling1D", (4, 3), dict(border_mode="same"), (2, 10, 3)),
    ("MaxPooling2D", (), dict(), (2, 7, 6, 2)),
    ("MaxPooling2D", ((2, 2), (1, 1)), dict(border_mode="same"),
     (2, 5, 6, 2)),
    ("MaxPooling2D", ((3, 2), (2, 3)), dict(border_mode="same"),
     (2, 7, 8, 2)),
    ("AveragePooling2D", ((3, 3),), dict(), (2, 7, 6, 2)),
    ("AveragePooling2D", ((2, 2), (1, 1)), dict(border_mode="same"),
     (2, 5, 6, 2)),
    ("AveragePooling2D", ((3, 4), (2, 3)), dict(border_mode="same"),
     (2, 7, 8, 2)),
    ("MaxPooling3D", (), dict(), (1, 4, 5, 4, 2)),
    ("MaxPooling3D", ((2, 3, 2), (1, 2, 2)), dict(border_mode="same"),
     (1, 4, 5, 3, 2)),
    ("AveragePooling3D", (), dict(border_mode="same"), (1, 3, 5, 4, 2)),
    ("Pooling1D", (), dict(), (2, 6, 3)),
    ("Pooling2D", (), dict(border_mode="same"), (2, 5, 5, 2)),
    ("GlobalMaxPooling1D", (), dict(), (2, 7, 3)),
    ("GlobalAveragePooling1D", (), dict(), (2, 7, 3)),
    ("GlobalMaxPooling2D", (), dict(), (2, 4, 5, 3)),
    ("GlobalAveragePooling2D", (), dict(), (2, 4, 5, 3)),
    ("GlobalMaxPooling3D", (), dict(), (1, 3, 4, 2, 3)),
    ("GlobalAveragePooling3D", (), dict(), (1, 3, 4, 2, 3)),
]


@pytest.mark.parametrize("name,args,kw,shape", POOL,
                         ids=[_id(c) for c in POOL])
def test_pooling_matches_jax(name, args, kw, shape):
    jl, tl = getattr(JL, name)(*args, **kw), getattr(TL, name)(*args, **kw)
    got = check_layer(jl, tl, _x(*shape))
    assert tl.compute_output_shape((None,) + shape[1:]) == \
        jl.compute_output_shape((None,) + shape[1:])
    assert tuple(got.shape[1:]) == tuple(jl.compute_output_shape(
        (None,) + shape[1:])[1:])


def test_max_pooling_same_pads_with_minus_infinity():
    # every value negative: a zero pad would win the border windows
    x = -np.abs(_x(2, 5, 5, 2)) - 1.0
    check_layer(JL.MaxPooling2D((3, 3), (2, 2), border_mode="same"),
                TL.MaxPooling2D((3, 3), (2, 2), border_mode="same"), x)


def test_deconvolution_needs_as_many_filters_as_input_channels():
    # the JAX kernel (kh, kw, nb_filter, in) is read with its third axis as
    # the input's channels: the JAX layer raises unless they agree, and so
    # does the port
    x = _x(1, 3, 3, 2)
    jl = JL.Deconvolution2D(3, 2, 2)
    params, state = jl.build(jax.random.PRNGKey(0), (None, 3, 3, 2))
    with pytest.raises(ValueError):
        jl.call(params, state, jnp.asarray(x), False, None)
    tl = TL.Deconvolution2D(3, 2, 2, input_shape=(3, 3, 2))
    with pytest.raises(ValueError, match="nb_filter 3 must equal"):
        tl(torch.from_numpy(x))


def test_keras1_aliases():
    assert TL.Conv1D is TL.Convolution1D
    assert TL.Conv2D is TL.Convolution2D
    assert TL.Conv3D is TL.Convolution3D
    assert TL.ShareConv2D is TL.ShareConvolution2D
