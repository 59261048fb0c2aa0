"""Loss functions (Keras-1 objective strings).

Port of ``analytics_zoo_tpu/keras/losses.py``, name for name: every loss
is ``fn(y_pred, y_true) -> scalar`` (mean over the batch), with the JAX
package's clips (``EPS``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

EPS = 1e-7


def _like(y_true, y_pred, cast: bool = False):
    y = y_true.reshape(y_pred.shape)
    return y.to(y_pred.dtype) if cast else y


def mean_squared_error(y_pred, y_true):
    return torch.mean(torch.square(y_pred - _like(y_true, y_pred)))


def mean_absolute_error(y_pred, y_true):
    return torch.mean(torch.abs(y_pred - _like(y_true, y_pred)))


def mean_absolute_percentage_error(y_pred, y_true):
    y_true = _like(y_true, y_pred)
    return 100.0 * torch.mean(torch.abs(
        (y_true - y_pred) / torch.clamp(torch.abs(y_true), min=EPS)))


def mean_squared_logarithmic_error(y_pred, y_true):
    y_true = _like(y_true, y_pred)
    a = torch.log(torch.clamp(y_pred, min=EPS) + 1.0)
    b = torch.log(torch.clamp(y_true, min=EPS) + 1.0)
    return torch.mean(torch.square(a - b))


def binary_crossentropy(y_pred, y_true):
    y_true = _like(y_true, y_pred, cast=True)
    p = torch.clamp(y_pred, EPS, 1.0 - EPS)
    return -torch.mean(y_true * torch.log(p)
                       + (1.0 - y_true) * torch.log(1.0 - p))


def binary_crossentropy_from_logits(y_pred, y_true):
    y_true = _like(y_true, y_pred, cast=True)
    return torch.mean(torch.clamp(y_pred, min=0) - y_pred * y_true
                      + torch.log1p(torch.exp(-torch.abs(y_pred))))


def categorical_crossentropy(y_pred, y_true):
    """``y_true`` one-hot (B, C); ``y_pred`` probabilities."""
    p = torch.clamp(y_pred, EPS, 1.0)
    return -torch.mean(torch.sum(y_true * torch.log(p), dim=-1))


def _sparse_labels(y_pred, y_true):
    """Int labels shaped as ``y_pred``'s leading dims plus a gather axis;
    takes (B, C) and sequence outputs (B, T, C)."""
    return y_true.reshape(tuple(y_pred.shape[:-1]) + (1,)).long()


def sparse_categorical_crossentropy(y_pred, y_true):
    """``y_true`` int labels matching ``y_pred``'s leading dims; ``y_pred``
    probabilities, clipped to ``[EPS, 1]`` before the log."""
    p = torch.clamp(y_pred, EPS, 1.0)
    return -torch.log(p).gather(-1, _sparse_labels(y_pred, y_true)).mean()


def sparse_categorical_crossentropy_from_logits(y_pred, y_true):
    logp = F.log_softmax(y_pred, dim=-1)
    return -logp.gather(-1, _sparse_labels(y_pred, y_true)).mean()


def hinge(y_pred, y_true):
    y_true = _like(y_true, y_pred, cast=True)
    return torch.mean(torch.clamp(1.0 - y_true * y_pred, min=0.0))


def squared_hinge(y_pred, y_true):
    y_true = _like(y_true, y_pred, cast=True)
    return torch.mean(torch.square(torch.clamp(1.0 - y_true * y_pred,
                                               min=0.0)))


def poisson(y_pred, y_true):
    y_true = _like(y_true, y_pred)
    return torch.mean(y_pred - y_true * torch.log(y_pred + EPS))


def cosine_proximity(y_pred, y_true):
    y_true = _like(y_true, y_pred)
    norm = lambda t: torch.linalg.vector_norm(t, dim=-1, keepdim=True) + EPS
    return -torch.mean(torch.sum(y_true / norm(y_true) * (y_pred
                                                          / norm(y_pred)),
                                 dim=-1))


def kullback_leibler_divergence(y_pred, y_true):
    y_true = torch.clamp(_like(y_true, y_pred), EPS, 1.0)
    y_pred = torch.clamp(y_pred, EPS, 1.0)
    return torch.mean(torch.sum(y_true * torch.log(y_true / y_pred), dim=-1))


class CustomLoss:
    """Wrap a user ``fn(y_pred, y_true) -> scalar``."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, y_pred, y_true):
        return self.fn(y_pred, y_true)


_REGISTRY = {
    "mse": mean_squared_error, "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error, "mean_absolute_error": mean_absolute_error,
    "mape": mean_absolute_percentage_error,
    "mean_absolute_percentage_error": mean_absolute_percentage_error,
    "msle": mean_squared_logarithmic_error,
    "mean_squared_logarithmic_error": mean_squared_logarithmic_error,
    "binary_crossentropy": binary_crossentropy,
    "binary_crossentropy_from_logits": binary_crossentropy_from_logits,
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "sparse_categorical_crossentropy_from_logits":
        sparse_categorical_crossentropy_from_logits,
    "hinge": hinge, "squared_hinge": squared_hinge, "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "kld": kullback_leibler_divergence,
    "kullback_leibler_divergence": kullback_leibler_divergence,
}


def get(loss):
    if callable(loss):
        return loss
    try:
        return _REGISTRY[loss]
    except KeyError:
        raise ValueError(f"unknown loss: {loss!r}") from None
