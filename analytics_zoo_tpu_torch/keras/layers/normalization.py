"""Batch and layer normalisation.

Port of ``analytics_zoo_tpu/keras/layers/normalization.py``.
``LayerNorm``: eps 1e-5 inside the square root of the population
variance, parameters ``gamma`` and ``beta``.  ``BatchNormalization``:
channels-last (``axis``), eps 1e-3, momentum 0.99, the biased variance;
``moving_mean`` / ``moving_var`` are buffers (the JAX layer's ``state``),
updated in place by each training forward, so that a training step
captured as a CUDA graph updates them at every replay.  Under mixed
precision the statistics of a bf16 batch fold into the f32 buffers, which
stay f32, as the JAX estimator casts the new state back to its incoming
dtype.  When a training step recomputes its forward in the backward
(``Estimator(remat=True)``), the recomputation runs under
``recomputing()`` and leaves the statistics alone, so each step updates
them once, as the JAX layer's functional state does.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.engine import Layer


_recompute_depth = 0


@contextlib.contextmanager
def recomputing():
    """The context of a forward recomputed for its backward: training
    layers keep their running statistics as they are."""
    global _recompute_depth
    _recompute_depth += 1
    try:
        yield
    finally:
        _recompute_depth -= 1


class BatchNormalization(Layer):
    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99,
                 axis: int = -1, **kw):
        super().__init__(**kw)
        self.epsilon = epsilon
        self.momentum = momentum
        self.axis = axis
        self.built = False
        if self.input_shape is not None:
            self.ensure_built(self.input_shape)

    def build(self, input_shape):
        d = input_shape[self.axis]
        self.gamma = nn.Parameter(torch.ones(d))
        self.beta = nn.Parameter(torch.zeros(d))
        self.register_buffer("moving_mean", torch.zeros(d))
        self.register_buffer("moving_var", torch.ones(d))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        if not self.built:
            return
        self.gamma.fill_(1.0)
        self.beta.zero_()
        self.moving_mean.zero_()
        self.moving_var.fill_(1.0)

    def forward(self, x):
        ax = self.axis % x.dim()
        shape = [1] * x.dim()
        shape[ax] = -1
        if self.training:
            axes = tuple(i for i in range(x.dim()) if i != ax)
            var, mean = torch.var_mean(x, dim=axes, correction=0)
            if not _recompute_depth:
                self._update_statistics(mean.detach(), var.detach())
        else:
            mean, var = self.moving_mean, self.moving_var
        return self._normalise(x, mean, var, shape)

    @torch.no_grad()
    def _update_statistics(self, mean, var) -> None:
        """``m * old + (1 - m) * new``, the JAX arithmetic, into the
        buffers in place (in their own dtype)."""
        m = self.momentum
        self.moving_mean.copy_(m * self.moving_mean + (1 - m) * mean)
        self.moving_var.copy_(m * self.moving_var + (1 - m) * var)

    def _normalise(self, x, mean, var, shape):
        mean = mean.reshape(shape)
        var = var.reshape(shape)
        gamma = self.gamma.reshape(shape)
        beta = self.beta.reshape(shape)
        return gamma * (x - mean) / torch.sqrt(var + self.epsilon) + beta


class LayerNorm(Layer):
    def __init__(self, hidden_size: int, epsilon: float = 1e-5,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.epsilon = epsilon
        self.gamma = nn.Parameter(torch.ones(hidden_size))
        self.beta = nn.Parameter(torch.zeros(hidden_size))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        self.gamma.fill_(1.0)
        self.beta.zero_()

    def forward(self, x):
        # F.layer_norm normalises with the biased (population) variance,
        # the same statistic as jnp.var
        return F.layer_norm(x, (x.shape[-1],), self.gamma, self.beta,
                            self.epsilon)
