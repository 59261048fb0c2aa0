"""Validation metrics: Accuracy, SparseCategoricalAccuracy, Top5Accuracy,
MAE, MSE, Loss, AUC.

Port of ``analytics_zoo_tpu/keras/metrics.py``.  Metrics are streaming:
``update(acc, y_pred, y_true) -> acc`` keeps its sums as tensors on the
predictions' device (no host read per batch), ``result(acc)`` reads them
once.  ``get`` takes every name of the JAX registry.

``Top5Accuracy`` breaks ties as ``lax.top_k`` does: among equal scores
the lower class index ranks first (a stable descending sort).
``AUC`` is the JAX metric's fixed 200-bin histogram of the positive
class's score, with the ROC area by the trapezoid rule.
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


class SparseCategoricalAccuracy(Accuracy):
    name = "sparse_categorical_accuracy"


class Top5Accuracy(Metric):
    name = "top5_accuracy"

    def update(self, acc, y_pred, y_true):
        total, count = acc
        order = torch.sort(y_pred, dim=-1, descending=True, stable=True)[1]
        top5 = order[..., :5]                               # (B, 5)
        if y_true.shape == y_pred.shape:                    # one-hot labels
            true = torch.argmax(y_true, dim=-1).reshape(-1, 1)
        else:
            true = y_true.reshape(-1, 1).long()
        hit = torch.any(top5 == true, dim=-1).float()
        return (total + hit.sum(), count + hit.numel())


class MAE(Metric):
    name = "mae"

    def update(self, acc, y_pred, y_true):
        total, count = acc
        err = torch.abs(y_pred - y_true.reshape(y_pred.shape))
        return (total + err.sum(), count + err.numel())


class MSE(Metric):
    name = "mse"

    def update(self, acc, y_pred, y_true):
        total, count = acc
        err = torch.square(y_pred - y_true.reshape(y_pred.shape))
        return (total + err.sum(), count + err.numel())


class Loss(Metric):
    """The mean of ``loss_fn`` over the batches."""

    name = "loss"

    def __init__(self, loss_fn):
        self.loss_fn = loss_fn

    def update(self, acc, y_pred, y_true):
        total, count = acc
        return (total + self.loss_fn(y_pred, y_true), count + 1.0)


class AUC(Metric):
    """Streaming ROC-AUC over a histogram of ``thresholds`` bins of the
    positive score (binary: (B,), (B, 1) or two-class (B, 2) outputs)."""

    name = "auc"

    def __init__(self, thresholds: int = 200):
        self.thresholds = thresholds

    def init(self):
        return (0.0, 0.0, 0.0, 0.0)  # tp_hist, fp_hist, P, N

    def update(self, acc, y_pred, y_true):
        tp, fp, P, N = acc
        if y_pred.dim() >= 2 and y_pred.shape[-1] == 2:
            if y_true.shape == y_pred.shape:    # one-hot binary labels
                y_true = y_true[..., 1]
            y_pred = y_pred[..., 1]             # P(positive class)
        elif y_pred.dim() >= 2 and y_pred.shape[-1] == 1:
            y_pred = y_pred[..., 0]
        elif y_pred.dim() >= 2 and y_pred.shape[-1] > 2:
            raise ValueError(
                f"AUC is binary; got {y_pred.shape[-1]}-class predictions")
        scores = torch.clamp(y_pred.reshape(-1).float(), 0.0, 1.0)
        labels = y_true.reshape(-1) > 0.5
        bins = torch.clamp((scores * self.thresholds).to(torch.int64), 0,
                           self.thresholds - 1)
        zeros = scores.new_zeros(self.thresholds)
        pos = zeros.index_add(0, bins, labels.float())
        neg = zeros.index_add(0, bins, (~labels).float())
        return (tp + pos, fp + neg, P + labels.sum(), N + (~labels).sum())

    def result(self, acc):
        tp_hist, fp_hist, P, N = (torch.as_tensor(a, dtype=torch.float32)
                                  for a in acc)
        # TPR / FPR at descending thresholds by reverse cumulative sums
        tpr = torch.cumsum(tp_hist.flip(0), 0) / torch.clamp(P, min=1e-9)
        fpr = torch.cumsum(fp_hist.flip(0), 0) / torch.clamp(N, min=1e-9)
        zero = tpr.new_zeros(1)
        return float(torch.trapezoid(torch.cat([zero, tpr]),
                                     torch.cat([zero, fpr])))


_REGISTRY = {
    "accuracy": Accuracy, "acc": Accuracy,
    "sparse_categorical_accuracy": SparseCategoricalAccuracy,
    "top5accuracy": Top5Accuracy, "top5": Top5Accuracy,
    "mae": MAE, "mse": MSE, "auc": AUC,
}


def get(metric) -> Metric:
    if isinstance(metric, Metric):
        return metric
    if isinstance(metric, type) and issubclass(metric, Metric):
        return metric()
    try:
        return _REGISTRY[metric.lower()]()
    except (KeyError, AttributeError):
        raise ValueError(f"unknown metric: {metric!r}") from None
