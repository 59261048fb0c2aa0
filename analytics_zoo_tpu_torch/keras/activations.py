"""Activation functions (Keras-1 ``activation=`` strings).

Port of ``analytics_zoo_tpu/keras/activations.py``, name for name.
``hard_sigmoid`` is Keras-1's ``clip(0.2 x + 0.5, 0, 1)``, not PyTorch's
``hardsigmoid``.  ``gelu`` is the tanh approximation there, BERT's original
form, while PyTorch's default ``gelu`` is the exact erf form: the exact one
is ``gelu_exact``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear(x):
    return x


def relu(x):
    return F.relu(x)


def relu6(x):
    return F.relu6(x)


def tanh(x):
    return torch.tanh(x)


def sigmoid(x):
    return torch.sigmoid(x)


def hard_sigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def softmax(x):
    return torch.softmax(x, dim=-1)


def log_softmax(x):
    return torch.log_softmax(x, dim=-1)


def softplus(x):
    return F.softplus(x)


def softsign(x):
    return F.softsign(x)


def elu(x, alpha: float = 1.0):
    return F.elu(x, alpha)


def selu(x):
    return F.selu(x)


def gelu(x):
    return F.gelu(x, approximate="tanh")


gelu_tanh = gelu


def gelu_exact(x):
    return F.gelu(x, approximate="none")


def swish(x):
    return F.silu(x)


def exp(x):
    return torch.exp(x)


_REGISTRY = {
    "linear": linear, None: linear, "identity": linear,
    "relu": relu, "relu6": relu6, "tanh": tanh, "sigmoid": sigmoid,
    "hard_sigmoid": hard_sigmoid, "softmax": softmax,
    "log_softmax": log_softmax, "softplus": softplus, "softsign": softsign,
    "elu": elu, "selu": selu, "gelu": gelu, "gelu_tanh": gelu_tanh,
    "gelu_exact": gelu_exact,
    "swish": swish, "silu": swish, "exp": exp,
}


def get(act):
    if callable(act):
        return act
    try:
        return _REGISTRY[act]
    except KeyError:
        raise ValueError(f"unknown activation: {act!r}") from None
