"""Layer normalisation.

Port of ``LayerNorm`` in ``analytics_zoo_tpu/keras/layers/normalization.py``:
eps 1e-5 inside the square root of the population variance, parameters
``gamma`` and ``beta``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.engine import Layer


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
