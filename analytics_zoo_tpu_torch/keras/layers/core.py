"""Core layers: Dense, Activation, the shape ops and Merge.

Port of the part of ``analytics_zoo_tpu/keras/layers/core.py`` that the
recommendation models use, with the shape ops that come with it.  Shapes
follow Keras-1: ``input_shape`` excludes the batch entry, and a shape
passed between layers carries it as ``None``.  ``Dropout`` and the rest of
``core.py`` are not ported yet (ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras import activations, initializers
from analytics_zoo_tpu_torch.keras.engine import Layer


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
