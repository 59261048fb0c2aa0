"""Activation functions (Keras-1 ``activation=`` strings) used by BERT.

Port of the slice of ``analytics_zoo_tpu/keras/activations.py`` that the
BERT path needs.  ``gelu`` is the tanh approximation there, BERT's original
form, while PyTorch's default ``gelu`` is the exact erf form: the exact one
is ``gelu_exact``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear(x):
    return x


def tanh(x):
    return torch.tanh(x)


def softmax(x):
    return torch.softmax(x, dim=-1)


def gelu(x):
    return F.gelu(x, approximate="tanh")


gelu_tanh = gelu


def gelu_exact(x):
    return F.gelu(x, approximate="none")


_REGISTRY = {
    "linear": linear, None: linear, "identity": linear, "tanh": tanh,
    "softmax": softmax, "gelu": gelu, "gelu_tanh": gelu_tanh,
    "gelu_exact": gelu_exact,
}


def get(act):
    if callable(act):
        return act
    try:
        return _REGISTRY[act]
    except KeyError:
        raise ValueError(f"unknown activation: {act!r}") from None
