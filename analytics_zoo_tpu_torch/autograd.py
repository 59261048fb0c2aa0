"""Autograd: symbolic ``Variable`` math, ``Parameter`` / ``Constant`` and
``CustomLoss``.

Port of ``analytics_zoo_tpu/autograd.py``.  Every op is a thin ``Lambda``
node over a PyTorch function, so a ``Variable`` expression graph runs as a
``keras.engine.Model``.  Every function is polymorphic, as in the JAX
package: given a symbolic ``Variable`` it extends the graph; given a
tensor or an array it evaluates eagerly with the same expression (numpy
floats are taken as f32, as JAX takes them).  Node names come from the
engine's auto-name counters (``mean_1``, ``batch_dot_2``, ...), so the
same construction order gives the JAX package's names.

``Parameter`` is a free trainable weight and ``Constant`` a fixed value
(a buffer, the JAX ``state``) used as graph nodes with no input; their
output has no batch dimension and broadcasts.  ``Parameter``'s default
draw is uniform in ``+-sqrt(6 / size)`` from a ``torch.Generator`` (the
JAX draw is ``jax.random``, which no port can reproduce: parity goes
through ``interop.load_jax_params``).  ``init_method`` is an initializer
of ``keras.initializers`` (a name, or ``fn(tensor, generator)``).

``CustomLoss`` builds a loss from a ``Variable`` expression over
``(y_true, y_pred)`` once; it is called as ``(y_pred, y_true)`` and returns
the mean, so it drops into ``KerasNet.compile(loss=...)``.  Its graph
makes no host read and keeps Python scalars as scalars, so a training step
that calls it can be captured as a CUDA graph.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.keras import initializers
from analytics_zoo_tpu_torch.keras.engine import (Input, Lambda, Layer, Model,
                                                  Variable, _auto_name)

__all__ = [
    "mean", "abs", "sum", "batch_dot", "l2_normalize", "stack",
    "expand_dims", "clip", "contiguous", "square", "sqrt", "exp", "maximum",
    "log", "pow", "epsilon", "neg", "softsign", "softplus", "mm", "erf",
    "Parameter", "Constant", "CustomLoss", "Variable", "Lambda", "Input",
]

_EPSILON = 1e-7


def epsilon() -> float:
    """Fuzz factor."""
    return _EPSILON


def _tensor(x) -> torch.Tensor:
    """A tensor as is; an array or a number as a tensor, floats as f32 (as
    ``jnp.asarray`` takes them without x64)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _apply(x, fn: Callable, opname: str):
    """Symbolic: a new Lambda node; eager: evaluate."""
    if isinstance(x, Variable):
        return Variable._from_layer(Lambda(fn, name=_auto_name(opname)), x)
    return fn(_tensor(x))


def _apply2(x, y, fn: Callable, opname: str):
    xs, ys = isinstance(x, Variable), isinstance(y, Variable)
    if xs and ys:
        lam = Lambda(lambda xs_: fn(xs_[0], xs_[1]), name=_auto_name(opname))
        return Variable._from_layer(lam, [x, y])
    if xs:
        return Variable._from_layer(
            Lambda(lambda a: fn(a, y), name=_auto_name(opname)), x)
    if ys:
        return Variable._from_layer(
            Lambda(lambda b: fn(x, b), name=_auto_name(opname)), y)
    return fn(_tensor(x), _tensor(y))


def _like(v, t: torch.Tensor) -> torch.Tensor:
    """``v`` beside ``t``: a tensor as is, a Python number as a 0-d tensor
    made on ``t``'s device by a fill (no host copy, so a captured step can
    hold it), an array copied there."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, (int, float)):
        keep = t.is_floating_point() or isinstance(v, int)
        return torch.full((), v, dtype=t.dtype if keep else torch.float32,
                          device=t.device)
    return _tensor(v).to(t.device)


# ---- elementwise / reduction surface --------------------------------------

def mean(x, axis: int = 0, keepDims: bool = False):
    """Mean over ``axis`` (counted from the batch dimension)."""
    return _apply(x, lambda a: torch.mean(a, dim=axis, keepdim=keepDims),
                  "mean")


def abs(x):  # noqa: A001 - the JAX surface's name
    return _apply(x, torch.abs, "abs")


def sum(x, axis: int = 0, keepDims: bool = False):  # noqa: A001
    return _apply(x, lambda a: torch.sum(a, dim=axis, keepdim=keepDims),
                  "sum")


def clip(x, min: float, max: float):  # noqa: A002 - keras arg names
    return _apply(x, lambda a: torch.clamp(a, min, max), "clip")


def square(x):
    return _apply(x, torch.square, "square")


def sqrt(x):
    return _apply(x, torch.sqrt, "sqrt")


def exp(x):
    return _apply(x, torch.exp, "exp")


def log(x):
    return _apply(x, torch.log, "log")


def pow(x, a: float):  # noqa: A001
    return _apply(x, lambda t: torch.pow(t, a), "pow")


def neg(x):
    return _apply(x, torch.neg, "neg")


def maximum(x, y):
    def fn(a, b):
        if not isinstance(a, torch.Tensor):
            a, b = b, a
        return torch.maximum(a, _like(b, a))
    return _apply2(x, y, fn, "maximum")


def softsign(x):
    return _apply(x, lambda a: a / (torch.abs(a) + 1.0), "softsign")


def softplus(x):
    # jax.nn.softplus is logaddexp(x, 0) (no threshold)
    return _apply(x, lambda a: torch.logaddexp(a, torch.zeros_like(a)),
                  "softplus")


def erf(x):
    return _apply(x, torch.erf, "erf")


def contiguous(x):
    """A layout no-op: the values are unchanged."""
    return _apply(x, lambda a: a.contiguous(), "contiguous")


def expand_dims(x, axis: int):
    return _apply(x, lambda a: torch.unsqueeze(a, axis), "expand_dims")


def _l2n(a: torch.Tensor, axis: int) -> torch.Tensor:
    return a / torch.sqrt(torch.clamp(
        torch.sum(torch.square(a), dim=axis, keepdim=True), min=_EPSILON))


def l2_normalize(x, axis: int):
    return _apply(x, lambda a: _l2n(a, axis), "l2_normalize")


def stack(inputs: Sequence, axis: int = 1):
    """Stack along a new axis (default 1: after the batch)."""
    if inputs and isinstance(inputs[0], Variable):
        lam = Lambda(lambda xs: torch.stack(list(xs), dim=axis),
                     name=_auto_name("stack"))
        return Variable._from_layer(lam, list(inputs))
    return torch.stack([_tensor(i) for i in inputs], dim=axis)


def _batch_dot(a, b, axes, normalize: bool):
    if isinstance(axes, int):
        axes = (axes, axes)
    a_ax, b_ax = axes
    if normalize:
        a, b = _l2n(a, a_ax), _l2n(b, b_ax)
    if a.dim() == 2:
        a, a_ax = a[:, :, None], (2 if a_ax == 0 else a_ax)
    if b.dim() == 2:
        b, b_ax = b[:, :, None], (2 if b_ax == 0 else b_ax)
    squeeze_2d = (a.dim() == 3 and a.shape[2] == 1 and b.dim() == 3
                  and b.shape[2] == 1)
    a = torch.movedim(a, a_ax, 2)       # contracted dim last
    b = torch.movedim(b, b_ax, 1)       # contracted dim first
    out = torch.einsum("bik,bkj->bij", a, b)
    return out[:, :, 0] if squeeze_2d else out


def batch_dot(x, y, axes: Union[int, Sequence[int]] = 1,
              normalize: bool = False):
    """Batchwise dot product (Keras ``batch_dot``): ``axes`` are the
    contracted dims (batch dim = 0); ``normalize`` L2-normalises along them
    first, giving cosine similarity."""
    return _apply2(x, y, lambda a, b: _batch_dot(a, b, axes, normalize),
                   "batch_dot")


def mm(x, y, axes: Optional[Sequence[int]] = None):
    """Matrix product contracting ``axes`` (default: last of ``x`` with
    first of ``y``, ``matmul``)."""
    if axes is None:
        return _apply2(x, y, torch.matmul, "mm")
    ax = (axes[0], axes[1])
    return _apply2(x, y, lambda a, b: torch.tensordot(
        a, b, dims=([ax[0]], [ax[1]])), "mm")


# ---- graph-weight nodes ---------------------------------------------------

class Parameter(Layer):
    """A free trainable weight usable as a graph node.  ``shape`` has no
    batch dimension; the node broadcasts over the batch."""

    def __init__(self, shape: Sequence[int],
                 init_method: Optional[Union[str, Callable]] = None,
                 init_weight: Optional[np.ndarray] = None, **kw):
        super().__init__(**kw)
        self.weight_shape = tuple(shape)
        self.init_method = (initializers.get(init_method)
                            if init_method is not None else None)
        self.init_weight = (np.asarray(init_weight, np.float32)
                            if init_weight is not None else None)
        self.weight = nn.Parameter(torch.empty(self.weight_shape))
        self._var: Optional[Variable] = None
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        if self.init_weight is not None:
            self.weight.copy_(torch.from_numpy(self.init_weight))
        elif self.init_method is not None:
            self.init_method(self.weight, generator)
        else:
            n = int(np.prod(self.weight_shape)) or 1
            limit = float(np.sqrt(6.0 / n))
            self.weight.uniform_(-limit, limit, generator=generator)

    def forward(self, x=None):
        return self.weight

    def compute_output_shape(self, input_shape):
        return self.weight_shape

    def to_variable(self) -> Variable:
        """The symbolic node of this parameter (a layer with no input)."""
        if self._var is None:
            self._var = Variable(self.weight_shape, layer=self, inputs=[])
        return self._var

    # operator sugar: p + x etc. go through the Variable node
    def __add__(self, other):
        return self.to_variable() + other

    __radd__ = __add__

    def __mul__(self, other):
        return self.to_variable() * other

    __rmul__ = __mul__

    def __sub__(self, other):
        return self.to_variable() - other

    def __rsub__(self, other):
        return other - self.to_variable()


class Constant(Layer):
    """A non-trainable graph constant: a buffer (the JAX ``state``)."""

    def __init__(self, data, **kw):
        super().__init__(**kw)
        self.data = np.asarray(data, np.float32)
        self.register_buffer("value", torch.from_numpy(self.data.copy()))
        self._var: Optional[Variable] = None

    def forward(self, x=None):
        return self.value

    def compute_output_shape(self, input_shape):
        return tuple(self.data.shape)

    def to_variable(self) -> Variable:
        if self._var is None:
            self._var = Variable(tuple(self.data.shape), layer=self,
                                 inputs=[])
        return self._var


# ---- custom loss ----------------------------------------------------------

class CustomLoss:
    """A loss built from a ``Variable`` expression over ``(y_true,
    y_pred)``: ``loss_func(y_true, y_pred) -> Variable`` is traced once
    into a ``Model``; a call runs that graph on the predictions' device
    and returns the mean.  Callable as ``(y_pred, y_true)``, the engine's
    convention, so ``KerasNet.compile(loss=CustomLoss(...))`` takes it."""

    def __init__(self, loss_func: Callable, y_pred_shape: Sequence[int],
                 y_true_shape: Optional[Sequence[int]] = None):
        self.y_pred_shape = tuple(y_pred_shape)
        self.y_true_shape = tuple(y_true_shape or y_pred_shape)
        y_true = Input(self.y_true_shape, name="y_true")
        y_pred = Input(self.y_pred_shape, name="y_pred")
        out = loss_func(y_true, y_pred)
        if not isinstance(out, Variable):
            raise TypeError("loss_func must return a Variable")
        # the graph's own weights (a Parameter or Constant node, if any)
        # follow the predictions to their device at the first call
        self._model = Model([y_true, y_pred], out, device="cpu")
        self._model.train()

    def _on(self, device: torch.device) -> Model:
        held = next(iter(self._model.state_dict().values()), None)
        if held is not None and held.device != device:
            self._model.to(device)
        return self._model

    def __call__(self, y_pred, y_true):
        y_pred, y_true = _tensor(y_pred), _tensor(y_true)
        return torch.mean(self._on(y_pred.device)([y_true, y_pred]))

    # eager parity helpers
    def forward(self, y_true, y_pred) -> float:
        with torch.no_grad():
            return float(self(y_pred, y_true))

    def backward(self, y_true, y_pred) -> np.ndarray:
        """The gradient of the loss with respect to ``y_pred``, as numpy."""
        p = _tensor(np.asarray(y_pred, np.float32)).clone().requires_grad_()
        g, = torch.autograd.grad(self(p, _tensor(y_true)), p)
        return g.detach().cpu().numpy()
