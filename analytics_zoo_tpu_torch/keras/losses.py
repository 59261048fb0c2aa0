"""Loss functions (Keras-1 objective strings) the training slice uses.

Port of ``analytics_zoo_tpu/keras/losses.py``: every loss is
``fn(y_pred, y_true) -> scalar`` (mean over the batch).  ``get`` knows only
the names ported so far.
"""

from __future__ import annotations

import torch

EPS = 1e-7


def sparse_categorical_crossentropy(y_pred, y_true):
    """``y_true`` int labels matching ``y_pred``'s leading dims; ``y_pred``
    probabilities, clipped to ``[EPS, 1]`` before the log."""
    p = torch.clamp(y_pred, EPS, 1.0)
    labels = y_true.reshape(tuple(y_pred.shape[:-1]) + (1,)).long()
    return -torch.log(p).gather(-1, labels).mean()


_REGISTRY = {
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
}


def get(loss):
    if callable(loss):
        return loss
    try:
        return _REGISTRY[loss]
    except KeyError:
        raise ValueError(f"unknown loss: {loss!r} (the port has "
                         f"{sorted(_REGISTRY)})") from None
