"""Core layers: Dense, Dropout and its kinds, Activation, the shape ops,
Merge, the learned and stateless elementwise layers.

Port of ``analytics_zoo_tpu/keras/layers/core.py``.  Shapes follow
Keras-1: ``input_shape`` excludes the batch entry, and a shape passed
between layers carries it as ``None``.

Randomness.  A layer that draws takes ``seed=`` (an int, or a 0-d int32
tensor on the card) in training mode and is the identity without one, as
the JAX layers are without a key.  ``Dropout`` is the JAX layer's
``hash_dropout`` bit for bit.  The JAX package draws the spatial and
Gaussian kinds and ``GaussianSampler`` from ``jax.random``, which no port
can reproduce: here they draw from the counter hash of ``ops/dropout.py``
(``hash_bernoulli``, ``hash_normal``), so a seed held on the card draws
anew at every replay of a captured step.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras import activations, initializers
from analytics_zoo_tpu_torch.keras.engine import Layer, _seeded
from analytics_zoo_tpu_torch.ops.dropout import (
    hash_bernoulli, hash_dropout, hash_normal, process_offset)


class Dense(Layer):
    """``{"W": (d_in, d_out), "b": (d_out,)}`` applied as ``x @ W + b``
    over the last dim, then the activation.  ``W_regularizer`` and
    ``b_regularizer`` are accepted and unused, as in the JAX package."""

    def __init__(self, output_dim: int, activation=None,
                 init="glorot_uniform", bias: bool = True, W_regularizer=None,
                 b_regularizer=None, **kw):
        super().__init__(**kw)
        self.output_dim = output_dim
        self.activation = activations.get(activation)
        self.kernel_init = initializers.get(init)
        self.bias = bias
        self.built = False
        if self.input_shape is not None:
            self.ensure_built(self.input_shape)

    def build(self, input_shape):
        self.W = nn.Parameter(torch.empty(input_shape[-1], self.output_dim))
        if self.bias:
            self.b = nn.Parameter(torch.zeros(self.output_dim))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        if not self.built:
            return
        self.kernel_init(self.W, generator)
        if self.bias:
            self.b.zero_()

    def forward(self, x):
        return self.activation(F.linear(x, self.W.t(),
                                        self.b if self.bias else None))

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)


class Activation(Layer):
    def __init__(self, activation, **kw):
        super().__init__(**kw)
        self.activation = activations.get(activation)

    def forward(self, x):
        return self.activation(x)


class Flatten(Layer):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], math.prod(input_shape[1:]))


class Reshape(Layer):
    def __init__(self, target_shape: Sequence[int], **kw):
        super().__init__(**kw)
        self.target_shape = tuple(target_shape)

    def _resolve(self, dims):
        if -1 not in self.target_shape:
            return self.target_shape
        known = math.prod(d for d in self.target_shape if d != -1)
        return tuple(math.prod(dims) // known if d == -1 else d
                     for d in self.target_shape)

    def forward(self, x):
        return x.reshape((x.shape[0],) + self._resolve(x.shape[1:]))

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + self._resolve(input_shape[1:])


class Merge(Layer):
    """Merge a list of inputs: sum / mul / ave / max / min / concat / dot /
    cosine.  max and min share the gradient among ties, as ``jnp.max``
    does."""

    def __init__(self, mode: str = "sum", concat_axis: int = -1, **kw):
        super().__init__(**kw)
        self.mode = mode
        self.concat_axis = concat_axis

    def forward(self, xs):
        if self.mode == "sum":
            return sum(xs[1:], xs[0])
        if self.mode == "mul":
            y = xs[0]
            for x in xs[1:]:
                y = y * x
            return y
        if self.mode == "ave":
            return sum(xs[1:], xs[0]) / float(len(xs))
        if self.mode == "max":
            return torch.stack(xs).amax(dim=0)
        if self.mode == "min":
            return torch.stack(xs).amin(dim=0)
        if self.mode == "concat":
            return torch.cat(xs, dim=self.concat_axis)
        if self.mode == "dot":
            return torch.sum(xs[0] * xs[1], dim=-1, keepdim=True)
        if self.mode == "cosine":
            a, b = (x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True)
                         + 1e-8) for x in xs[:2])
            return torch.sum(a * b, dim=-1, keepdim=True)
        raise ValueError(f"unknown merge mode {self.mode}")

    def compute_output_shape(self, input_shapes):
        s0 = list(input_shapes[0])
        if self.mode == "concat":
            ax = self.concat_axis % len(s0)
            s0[ax] = sum(s[ax] for s in input_shapes)
            return tuple(s0)
        if self.mode in ("dot", "cosine"):
            return (s0[0], 1)
        return tuple(s0)


class Select(Layer):
    """Select index ``index`` along dim ``dim`` (batch dim included)."""

    def __init__(self, dim: int, index: int, **kw):
        super().__init__(**kw)
        self.dim, self.index = dim, index

    def forward(self, x):
        return torch.select(x, self.dim, self.index)

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        s.pop(self.dim % len(s))
        return tuple(s)


class Narrow(Layer):
    def __init__(self, dim: int, offset: int, length: int = 1, **kw):
        super().__init__(**kw)
        self.dim, self.offset, self.length = dim, offset, length

    def forward(self, x):
        return x.narrow(self.dim, self.offset, self.length)

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        s[self.dim % len(s)] = self.length
        return tuple(s)


class Squeeze(Layer):
    def __init__(self, dim: int, **kw):
        super().__init__(**kw)
        self.dim = dim

    def forward(self, x):
        return torch.squeeze(x, self.dim)

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        s.pop(self.dim % len(s))
        return tuple(s)


class ExpandDim(Layer):
    def __init__(self, dim: int, **kw):
        super().__init__(**kw)
        self.dim = dim

    def forward(self, x):
        return torch.unsqueeze(x, self.dim)

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        s.insert(self.dim % (len(s) + 1), 1)
        return tuple(s)


class _Built(Layer):
    """A layer whose parameters depend on its input's shape: built when
    the shape is known (at construction with ``input_shape``, when called
    on a ``Variable``, or by ``init``)."""

    def _defer(self) -> None:
        self.built = False
        if self.input_shape is not None:
            self.ensure_built(self.input_shape)


class Dropout(Layer):
    """The JAX ``Dropout``: in training mode with a seed, the counter-hash
    mask of ``hash_dropout`` (bit-identical to the JAX layer's for an int
    seed); otherwise the identity."""

    def __init__(self, p: float, **kw):
        super().__init__(**kw)
        self.p = p

    def _active(self, seed) -> bool:
        return self.training and self.p > 0.0 and seed is not None

    def forward(self, x, seed=None):
        if not self._active(seed):
            return x
        return hash_dropout(x, self.p, seed=seed,
                            offset=process_offset(x.shape))


class _SpatialDropout(Dropout):
    """Drops whole channels: one draw per (batch, channel), the same along
    every other axis."""

    _channel_axis = 2

    def forward(self, x, seed=None):
        if not self._active(seed):
            return x
        keep = 1.0 - self.p
        shape = [1] * x.dim()
        shape[0] = x.shape[0]
        shape[self._channel_axis] = x.shape[self._channel_axis]
        mask = hash_bernoulli(tuple(shape), seed, keep, x.device,
                              offset=process_offset(shape))
        return torch.where(mask, x / keep, 0.0)


class SpatialDropout1D(_SpatialDropout):
    """(B, T, C): a draw per (B, C)."""


class SpatialDropout2D(_SpatialDropout):
    def __init__(self, p: float, dim_ordering: str = "th", **kw):
        super().__init__(p, **kw)
        self._channel_axis = 1 if dim_ordering == "th" else 3


class SpatialDropout3D(_SpatialDropout):
    def __init__(self, p: float, dim_ordering: str = "th", **kw):
        super().__init__(p, **kw)
        self._channel_axis = 1 if dim_ordering == "th" else 4


class GaussianDropout(Layer):
    """``x * (1 + sqrt(p / (1 - p)) * N(0, 1))`` in training mode."""

    def __init__(self, p: float, **kw):
        super().__init__(**kw)
        self.p = p

    def forward(self, x, seed=None):
        if not self.training or seed is None:
            return x
        std = math.sqrt(self.p / (1.0 - self.p))
        return x * (1.0 + std * hash_normal(
            x.shape, seed, x.device, x.dtype, offset=process_offset(x.shape)))


class GaussianNoise(Layer):
    """``x + sigma * N(0, 1)`` in training mode."""

    def __init__(self, sigma: float, **kw):
        super().__init__(**kw)
        self.sigma = sigma

    def forward(self, x, seed=None):
        if not self.training or seed is None:
            return x
        return x + self.sigma * hash_normal(
            x.shape, seed, x.device, x.dtype, offset=process_offset(x.shape))


class Permute(Layer):
    """Permute the non-batch dims by ``dims`` (1-based, Keras-1)."""

    def __init__(self, dims: Sequence[int], **kw):
        super().__init__(**kw)
        self.dims = tuple(dims)

    def forward(self, x):
        return x.permute((0,) + self.dims)

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + tuple(input_shape[d] for d in self.dims)


class RepeatVector(Layer):
    def __init__(self, n: int, **kw):
        super().__init__(**kw)
        self.n = n

    def forward(self, x):
        return x.unsqueeze(1).expand(-1, self.n, -1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self.n, input_shape[1])


class Masking(Layer):
    """Zero the timesteps whose every feature equals ``mask_value``."""

    def __init__(self, mask_value: float = 0.0, **kw):
        super().__init__(**kw)
        self.mask_value = mask_value

    def forward(self, x):
        keep = torch.any(x != self.mask_value, dim=-1, keepdim=True)
        return x * keep.to(x.dtype)


class Highway(_Built):
    """``y = t * h(x W + b) + (1 - t) * x`` with ``t = sigmoid(x W_t +
    b_t)``; ``b_t`` starts at -2 (carry open), as in Keras 1."""

    def __init__(self, activation="tanh", init="glorot_uniform",
                 bias: bool = True, **kw):
        super().__init__(**kw)
        self.activation = activations.get(activation)
        self.kernel_init = initializers.get(init)
        self.use_bias = bias
        self._defer()

    def build(self, input_shape):
        d = input_shape[-1]
        self.W = nn.Parameter(torch.empty(d, d))
        self.W_t = nn.Parameter(torch.empty(d, d))
        if self.use_bias:
            self.b = nn.Parameter(torch.zeros(d))
            self.b_t = nn.Parameter(torch.full((d,), -2.0))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        if not self.built:
            return
        self.kernel_init(self.W, generator)
        self.kernel_init(self.W_t, generator)
        if self.use_bias:
            self.b.zero_()
            self.b_t.fill_(-2.0)

    def forward(self, x):
        h = torch.matmul(x, self.W)
        t = torch.matmul(x, self.W_t)
        if self.use_bias:
            h = h + self.b
            t = t + self.b_t
        t = torch.sigmoid(t)
        return t * self.activation(h) + (1.0 - t) * x


class MaxoutDense(_Built):
    """``max_k (x W_k + b_k)`` over ``nb_feature`` dense maps of (B, d)."""

    def __init__(self, output_dim: int, nb_feature: int = 4,
                 init="glorot_uniform", bias: bool = True, **kw):
        super().__init__(**kw)
        self.output_dim = output_dim
        self.nb_feature = nb_feature
        self.kernel_init = initializers.get(init)
        self.use_bias = bias
        self._defer()

    def build(self, input_shape):
        d = input_shape[-1]
        self.W = nn.Parameter(torch.empty(self.nb_feature, d,
                                          self.output_dim))
        if self.use_bias:
            self.b = nn.Parameter(torch.zeros(self.nb_feature,
                                              self.output_dim))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        if not self.built:
            return
        self.kernel_init(self.W, generator)
        if self.use_bias:
            self.b.zero_()

    def forward(self, x):
        y = torch.einsum("bd,kdo->bko", x, self.W)
        if self.use_bias:
            y = y + self.b
        return y.amax(dim=1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self.output_dim)


# ---- learned elementwise ---------------------------------------------------

class Scale(_Built):
    """Per-channel affine ``x * alpha + beta``."""

    def __init__(self, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self._defer()

    def build(self, input_shape):
        d = input_shape[-1]
        self.alpha = nn.Parameter(torch.ones(d))
        self.beta = nn.Parameter(torch.zeros(d))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        if self.built:
            self.alpha.fill_(1.0)
            self.beta.zero_()

    def forward(self, x):
        return x * self.alpha + self.beta


class _Elementwise(_Built):
    """``CAdd`` / ``CMul``: one learned tensor of ``size`` (default the
    last dim), added or multiplied."""

    _key, _fill = "", 0.0

    def __init__(self, size: Optional[Sequence[int]] = None, **kw):
        super().__init__(**kw)
        self.size = size
        self._defer()

    def build(self, input_shape):
        shape = tuple(self.size) if self.size else (input_shape[-1],)
        self.register_parameter(self._key, nn.Parameter(
            torch.full(shape, self._fill)))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        if self.built:
            getattr(self, self._key).fill_(self._fill)


class CAdd(_Elementwise):
    _key, _fill = "bias", 0.0

    def forward(self, x):
        return x + self.bias


class CMul(_Elementwise):
    _key, _fill = "weight", 1.0

    def forward(self, x):
        return x * self.weight


class Mul(Layer):
    """One learned scalar multiplier."""

    def __init__(self, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.weight = nn.Parameter(torch.ones(()))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        self.weight.fill_(1.0)

    def forward(self, x):
        return x * self.weight


class SparseDense(Dense):
    """Dense over one-hot or sparse-coded inputs: the compute is Dense's,
    as in the JAX package."""


# ---- stateless elementwise -------------------------------------------------

class Exp(Layer):
    def forward(self, x):
        return torch.exp(x)


class Log(Layer):
    def forward(self, x):
        return torch.log(x)


class Sqrt(Layer):
    def forward(self, x):
        return torch.sqrt(x)


class Square(Layer):
    def forward(self, x):
        return torch.square(x)


class Negative(Layer):
    def forward(self, x):
        return torch.neg(x)


class Identity(Layer):
    def forward(self, x):
        return x


class AddConstant(Layer):
    def __init__(self, constant: float, **kw):
        super().__init__(**kw)
        self.constant = constant

    def forward(self, x):
        return x + self.constant


class MulConstant(Layer):
    def __init__(self, constant: float, **kw):
        super().__init__(**kw)
        self.constant = constant

    def forward(self, x):
        return x * self.constant


class Power(Layer):
    """``(scale * x + shift) ** power``."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0,
                 **kw):
        super().__init__(**kw)
        self.power, self.scale, self.shift = power, scale, shift

    def forward(self, x):
        return torch.pow(self.scale * x + self.shift, self.power)


class Threshold(Layer):
    def __init__(self, th: float = 1e-6, v: float = 0.0, **kw):
        super().__init__(**kw)
        self.th, self.v = th, v

    def forward(self, x):
        return torch.where(x > self.th, x, self.v)


class BinaryThreshold(Layer):
    """``1.0`` where ``x > value``, else ``0.0`` (float32)."""

    def __init__(self, value: float = 1e-6, **kw):
        super().__init__(**kw)
        self.value = value

    def forward(self, x):
        return (x > self.value).to(torch.float32)


class HardShrink(Layer):
    def __init__(self, value: float = 0.5, **kw):
        super().__init__(**kw)
        self.value = value

    def forward(self, x):
        return torch.where(torch.abs(x) > self.value, x, 0.0)


class SoftShrink(Layer):
    def __init__(self, value: float = 0.5, **kw):
        super().__init__(**kw)
        self.value = value

    def forward(self, x):
        return torch.sign(x) * torch.clamp(torch.abs(x) - self.value,
                                           min=0.0)


class HardTanh(Layer):
    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 **kw):
        super().__init__(**kw)
        self.min_value, self.max_value = min_value, max_value

    def forward(self, x):
        return torch.clamp(x, self.min_value, self.max_value)


class LRN2D(Layer):
    """Cross-channel local response normalisation (channels-last):
    ``x_c / (k + alpha * sum_{c' in window} x_{c'}^2) ** beta`` over a
    window of ``n`` channels centred on ``c``."""

    def __init__(self, alpha: float = 1e-4, k: float = 1.0,
                 beta: float = 0.75, n: int = 5, **kw):
        super().__init__(**kw)
        self.alpha, self.k, self.beta, self.n = alpha, k, beta, n

    def forward(self, x):
        sq = torch.square(x)
        half = self.n // 2
        padded = F.pad(sq, (half, half))
        c = x.shape[-1]
        window = sum(padded[..., i:i + c] for i in range(self.n))
        return x / (self.k + self.alpha * window) ** self.beta


class WithinChannelLRN2D(Layer):
    """(B, H, W, C): ``x / (1 + alpha * mean of x^2 over a size x size
    window) ** beta``, the window zero-padded as XLA's ``SAME``."""

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75,
                 **kw):
        super().__init__(**kw)
        self.size, self.alpha, self.beta = size, alpha, beta

    def forward(self, x):
        k = self.size
        lo = (k - 1) // 2
        sq = torch.square(x).permute(0, 3, 1, 2)
        sq = F.pad(sq, (lo, k - 1 - lo, lo, k - 1 - lo))
        window = F.avg_pool2d(sq, k, stride=1, divisor_override=1)
        norm = (1.0 + self.alpha * window.permute(0, 2, 3, 1)
                / (k ** 2)) ** self.beta
        return x / norm


# ---- structural ops --------------------------------------------------------

class SplitTensor(Layer):
    """Split into ``num_split`` equal parts along ``dim`` (a list)."""

    def __init__(self, dim: int, num_split: int, **kw):
        super().__init__(**kw)
        self.dim, self.num_split = dim, num_split

    def forward(self, x):
        n = x.shape[self.dim]
        if n % self.num_split:
            raise ValueError(f"SplitTensor: dim {self.dim} of size {n} does "
                             f"not split into {self.num_split} equal parts")
        return list(torch.split(x, n // self.num_split, dim=self.dim))


class Max(Layer):
    """Max along ``dim`` (ties share the gradient, as ``jnp.max``)."""

    def __init__(self, dim: int, return_value: bool = True, **kw):
        super().__init__(**kw)
        self.dim = dim

    def forward(self, x):
        return torch.amax(x, dim=self.dim)

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        s.pop(self.dim % len(s))
        return tuple(s)


class GetShape(Layer):
    """The input's shape as an int32 tensor."""

    def forward(self, x):
        return torch.tensor(tuple(x.shape), dtype=torch.int32,
                            device=x.device)

    def compute_output_shape(self, input_shape):
        return (len(input_shape),)


class Expand(Layer):
    """Broadcast size-1 dims up to ``tgt_sizes``; -1 keeps a dim."""

    def __init__(self, tgt_sizes: Sequence[int], **kw):
        super().__init__(**kw)
        self.tgt_sizes = tuple(tgt_sizes)

    def _target(self, in_shape):
        if len(self.tgt_sizes) != len(in_shape):
            raise ValueError(
                f"Expand tgt_sizes rank {len(self.tgt_sizes)} != input rank "
                f"{len(in_shape)} (shape {tuple(in_shape)})")
        return tuple(s if t == -1 else t
                     for s, t in zip(in_shape, self.tgt_sizes))

    def forward(self, x):
        return x.expand(self._target(tuple(x.shape)))

    def compute_output_shape(self, input_shape):
        return self._target(input_shape)


class SelectTable(Layer):
    """Element ``index`` of a list input."""

    def __init__(self, index: int, **kw):
        super().__init__(**kw)
        self.index = index

    def forward(self, x):
        return x[self.index]

    def compute_output_shape(self, input_shape):
        return input_shape[self.index]


class GaussianSampler(Layer):
    """``[mean, log_var] -> mean + exp(log_var / 2) * N(0, 1)`` in training
    mode with a seed; the mean otherwise."""

    def forward(self, x, seed=None):
        mean, log_var = x
        if self.training and seed is not None:
            eps = hash_normal(mean.shape, seed, mean.device, mean.dtype,
                              offset=process_offset(mean.shape))
            return mean + torch.exp(0.5 * log_var) * eps
        return mean

    def compute_output_shape(self, input_shape):
        return input_shape[0]


def _adopt(holder: nn.Module, inner: nn.Module) -> None:
    """Make ``holder``'s parameters, buffers and children those of
    ``inner`` (the same dicts), so that its ``state_dict`` is the inner
    tree itself (the JAX wrappers return the inner layer's tree
    unnested) and ``.to`` / optimizers reach the inner weights once.
    ``inner`` is held outside the module tree."""
    holder._parameters = inner._parameters
    holder._buffers = inner._buffers
    holder._non_persistent_buffers_set = inner._non_persistent_buffers_set
    holder._modules = inner._modules
    object.__setattr__(holder, "inner", inner)


def _call_inner(inner: nn.Module, training: bool, x, seed):
    if inner.training != training:
        inner.train(training)
    if seed is not None and _seeded(inner):
        return inner(x, seed=seed)
    return inner(x)


class KerasLayerWrapper(Layer):
    """Any ``nn.Module`` (or a bare tensor function, through ``Lambda``)
    as a Keras layer; its parameter tree is the module's own."""

    def __init__(self, module, output_shape_fn=None, **kw):
        super().__init__(**kw)
        if not isinstance(module, nn.Module):
            from analytics_zoo_tpu_torch.keras.engine import Lambda
            module = Lambda(module, output_shape_fn=output_shape_fn)
        self.output_shape_fn = output_shape_fn
        _adopt(self, module)
        if getattr(module, "input_shape", None) is not None \
                and self.input_shape is None:
            self.input_shape = module.input_shape
        self.built = getattr(module, "built", True)

    def build(self, input_shape):
        if isinstance(self.inner, Layer):
            self.inner.ensure_built(input_shape)

    def reset_parameters(self, generator=None) -> None:
        if isinstance(self.inner, Layer):
            self.inner.reset_parameters(generator)

    def forward(self, x, seed=None):
        return _call_inner(self.inner, self.training, x, seed)

    def compute_output_shape(self, input_shape):
        if isinstance(self.inner, Layer):
            return self.inner.compute_output_shape(input_shape)
        if self.output_shape_fn:
            return self.output_shape_fn(input_shape)
        dev = next(iter(self.inner.parameters()), torch.zeros(())).device
        with torch.no_grad():
            out = self.inner(torch.zeros(
                (1,) + tuple(s or 1 for s in input_shape[1:]), device=dev))
        return (None,) + tuple(out.shape[1:])
