"""Advanced activation layers: ELU, LeakyReLU, PReLU, SReLU,
ThresholdedReLU, Softmax, RReLU.

Port of ``analytics_zoo_tpu/keras/layers/advanced_activations.py``.
``RReLU`` draws its training slopes from the counter hash of
``ops/dropout.py`` (``hash_uniform``) where the JAX layer draws from
``jax.random``, which no port can reproduce; in eval mode, or without a
seed, it uses the mean slope, as the JAX layer does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.layers.core import _Built
from analytics_zoo_tpu_torch.keras.engine import Layer
from analytics_zoo_tpu_torch.ops.dropout import hash_uniform


class ELU(Layer):
    def __init__(self, alpha: float = 1.0, **kw):
        super().__init__(**kw)
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class LeakyReLU(Layer):
    def __init__(self, alpha: float = 0.3, **kw):
        super().__init__(**kw)
        self.alpha = alpha

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha * x)


class PReLU(_Built):
    """A learned slope per channel, starting at 0.25."""

    def __init__(self, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self._defer()

    def build(self, input_shape):
        self.alpha = nn.Parameter(torch.full((input_shape[-1],), 0.25))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        if self.built:
            self.alpha.fill_(0.25)

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha * x)


class SReLU(_Built):
    """S-shaped ReLU with learned thresholds and slopes per channel."""

    _INIT = {"t_left": 0.0, "a_left": 0.2, "t_right": 1.0, "a_right": 1.0}

    def __init__(self, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self._defer()

    def build(self, input_shape):
        d = input_shape[-1]
        for key, v in self._INIT.items():
            self.register_parameter(key, nn.Parameter(torch.full((d,), v)))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        if self.built:
            for key, v in self._INIT.items():
                getattr(self, key).fill_(v)

    def forward(self, x):
        tl, al, tr, ar = self.t_left, self.a_left, self.t_right, self.a_right
        return torch.where(x < tl, tl + al * (x - tl),
                           torch.where(x > tr, tr + ar * (x - tr), x))


class ThresholdedReLU(Layer):
    def __init__(self, theta: float = 1.0, **kw):
        super().__init__(**kw)
        self.theta = theta

    def forward(self, x):
        return torch.where(x > self.theta, x, 0.0)


class Softmax(Layer):
    def __init__(self, axis: int = -1, **kw):
        super().__init__(**kw)
        self.axis = axis

    def forward(self, x):
        return torch.softmax(x, dim=self.axis)


class RReLU(Layer):
    """Randomised leaky ReLU: slopes uniform in ``[lower, upper)`` in
    training mode with a seed, the mean slope otherwise."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 **kw):
        super().__init__(**kw)
        self.lower, self.upper = lower, upper

    def forward(self, x, seed=None):
        if self.training and seed is not None:
            u = hash_uniform(x.shape, seed, x.device, x.dtype)
            a = self.lower + (self.upper - self.lower) * u
        else:
            a = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, a * x)
