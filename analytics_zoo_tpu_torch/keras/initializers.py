"""Weight initializers (Keras-1 ``init=`` strings) the BERT slice uses.

Port of ``analytics_zoo_tpu/keras/initializers.py`` as in-place fills of a
tensor from an explicit ``torch.Generator``.  Torch's generators and JAX's
keys give different numbers from one seed, so weights cross between the
packages through ``interop.load_jax_params``, never through a shared seed.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _fans(shape):
    if len(shape) == 2:
        return shape[0], shape[1]
    if len(shape) in (3, 4, 5):
        receptive = math.prod(shape[:-2])
        return shape[-2] * receptive, shape[-1] * receptive
    fan = int(math.sqrt(math.prod(shape)))
    return fan, fan


@torch.no_grad()
def glorot_uniform(t: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
    fan_in, fan_out = _fans(tuple(t.shape))
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return t.uniform_(-limit, limit, generator=generator)


@torch.no_grad()
def normal(t: torch.Tensor, generator: Optional[torch.Generator] = None,
           scale: float = 0.05):
    return t.normal_(0.0, scale, generator=generator)


_REGISTRY = {"glorot_uniform": glorot_uniform, "xavier": glorot_uniform,
             "normal": normal, "gaussian": normal}


def get(init):
    if callable(init):
        return init
    try:
        return _REGISTRY[init]
    except KeyError:
        raise ValueError(f"unknown initializer: {init!r}") from None
