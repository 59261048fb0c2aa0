"""Validation metrics the training slice uses.

Port of ``analytics_zoo_tpu/keras/metrics.py``.  Metrics are streaming:
``update(acc, y_pred, y_true) -> acc`` keeps its sums as tensors on the
predictions' device (no host read per batch), ``result(acc)`` reads them
once.  ``get`` knows only the names ported so far.
"""

from __future__ import annotations

from typing import Any

import torch


class Metric:
    name = "metric"

    def init(self) -> Any:
        return (0.0, 0)  # (sum, count)

    def update(self, acc, y_pred, y_true):
        raise NotImplementedError

    def result(self, acc) -> float:
        total, count = acc
        return float(total) / max(float(count), 1e-9)


class Accuracy(Metric):
    """Argmax accuracy for (B, C) probabilities or logits with int or
    one-hot labels, or threshold 0.5 for binary (B,) / (B, 1) outputs."""

    name = "accuracy"

    def update(self, acc, y_pred, y_true):
        total, count = acc
        if y_pred.dim() >= 2 and y_pred.shape[-1] > 1:
            pred = torch.argmax(y_pred, dim=-1)
            if y_true.shape == y_pred.shape:        # one-hot labels
                true = torch.argmax(y_true, dim=-1)
            else:                                   # class indices
                true = y_true.reshape(pred.shape).long()
        else:
            pred = (y_pred.reshape(-1) > 0.5).long()
            true = y_true.reshape(-1).long()
        correct = (pred == true).float().sum()
        return (total + correct, count + pred.numel())


_REGISTRY = {"accuracy": Accuracy, "acc": Accuracy}


def get(metric) -> Metric:
    if isinstance(metric, Metric):
        return metric
    if isinstance(metric, type) and issubclass(metric, Metric):
        return metric()
    try:
        return _REGISTRY[metric.lower()]()
    except (KeyError, AttributeError):
        raise ValueError(f"unknown metric: {metric!r} (the port has "
                         f"{sorted(_REGISTRY)})") from None
