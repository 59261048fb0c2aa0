"""AnomalyDetector: stacked LSTMs over sliding windows, a dense forecast,
and the top-N absolute errors flagged.

Port of ``analytics_zoo_tpu/models/anomalydetection.py``: the same graph,
layer names and parameter tree, ``unroll`` and ``detect_anomalies`` (host
numpy, copied), and ``fit(warm_start=)``.  Takes ``device=`` (default: the
card; raises without one).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras.engine import Input
from analytics_zoo_tpu_torch.models.common import ZooModel


class AnomalyDetector(ZooModel):
    def __init__(self, feature_shape: Tuple[int, int],
                 hidden_layers: Sequence[int] = (8, 32, 15),
                 dropouts: Sequence[float] = (0.2, 0.2, 0.2), **kw):
        if len(hidden_layers) != len(dropouts):
            raise ValueError(
                f"hidden_layers ({len(hidden_layers)}) and dropouts "
                f"({len(dropouts)}) must have the same length")
        inp = Input(feature_shape, name="window")
        h = inp
        for i, (width, drop) in enumerate(zip(hidden_layers, dropouts)):
            last = i == len(hidden_layers) - 1
            h = L.LSTM(width, return_sequences=not last,
                       name=f"lstm_{i}")(h)
            h = L.Dropout(drop)(h)
        out = L.Dense(1, name="head")(h)
        super().__init__(input=inp, output=out, **kw)

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 1,
            validation_data=None, distributed: bool = True,
            seed: Optional[int] = None, warm_start: bool = False, **kw):
        """Train on unrolled windows; ``warm_start=True`` continues the last
        fit's estimator (weights, optimizer state, step)."""
        return super().fit(x, y=y, batch_size=batch_size,
                           nb_epoch=nb_epoch,
                           validation_data=validation_data,
                           distributed=distributed, seed=seed,
                           warm_start=warm_start, **kw)

    @staticmethod
    def unroll(data: np.ndarray, unroll_length: int,
               predict_step: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """Sliding windows: x[i] = data[i : i+L], y[i] = data[i+L+step-1]."""
        data = np.asarray(data, np.float32)
        if data.ndim == 1:
            data = data[:, None]
        n = len(data) - unroll_length - predict_step + 1
        x = np.stack([data[i:i + unroll_length] for i in range(n)])
        y = data[unroll_length + predict_step - 1:
                 unroll_length + predict_step - 1 + n, 0]
        return x, y.astype(np.float32)

    def detect_anomalies(self, y_true: np.ndarray, y_pred: np.ndarray,
                         anomaly_size: int = 5) -> np.ndarray:
        """Indices of the top-``anomaly_size`` absolute errors."""
        err = np.abs(np.asarray(y_true).ravel() -
                     np.asarray(y_pred).ravel())
        return np.argsort(-err)[:anomaly_size]
