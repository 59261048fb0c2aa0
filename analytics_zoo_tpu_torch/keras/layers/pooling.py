"""Pooling layers (channels-last).

Port of ``analytics_zoo_tpu/keras/layers/pooling.py``
(``lax.reduce_window`` there, no Pallas kernel): max / average pooling
in 1, 2 and 3 D, the global pools and the ``Pooling1D`` / ``Pooling2D``
aliases.  ``same`` pads as XLA does (``total // 2`` low, the rest high),
explicitly: max pooling pads with -inf (PyTorch caps implicit padding at
half the window), and ``same`` average pooling divides each window's sum
by the count of real cells in it.  A 1-D pool runs as a 2-D one over a
unit height.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.keras.engine import Layer
from analytics_zoo_tpu_torch.keras.layers.convolutional import (
    _pad_spatial, _same_pads, _to_cf, _to_cl)

_MAX = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _pair(v, n):
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v,) * n


def _pool_out(size, k, s, pad):
    if size is None:
        return None
    if pad == "SAME":
        return -(-size // s)
    return (size - k) // s + 1


class _PoolND(Layer):
    ndim = 2
    op = "max"

    def __init__(self, pool_size=2, strides=None, border_mode="valid", **kw):
        super().__init__(**kw)
        self.pool_size = _pair(pool_size, self.ndim)
        self.strides = _pair(strides, self.ndim) if strides else self.pool_size
        self.padding = border_mode.upper()

    def forward(self, x):
        xc = _to_cf(x)
        k, s = self.pool_size, self.strides
        if self.ndim == 1:                     # as 2-D over a unit height
            xc, k, s = xc.unsqueeze(2), (1,) + k, (1,) + s
        nd = len(k)
        pads = (_same_pads(xc.shape[2:], k, s, (1,) * nd)
                if self.padding == "SAME" else [(0, 0)] * nd)
        if self.op == "max":
            y = _MAX[nd](_pad_spatial(xc, pads, float("-inf")), k, s)
        elif self.padding == "SAME":
            total = _AVG[nd](_pad_spatial(xc, pads), k, s,
                             divisor_override=1)
            ones = torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=xc.dtype,
                              device=xc.device)
            cnt = _AVG[nd](_pad_spatial(ones, pads), k, s,
                           divisor_override=1)
            y = total / cnt
        else:
            y = _AVG[nd](xc, k, s, divisor_override=1) / float(math.prod(k))
        if self.ndim == 1:
            y = y.squeeze(2)
        return _to_cl(y)

    def compute_output_shape(self, s):
        spatial = [_pool_out(s[1 + i], self.pool_size[i], self.strides[i],
                             self.padding) for i in range(self.ndim)]
        return (s[0], *spatial, s[-1])


class MaxPooling1D(_PoolND):
    ndim, op = 1, "max"

    def __init__(self, pool_length=2, stride=None, **kw):
        super().__init__(pool_length, stride, **kw)


class AveragePooling1D(_PoolND):
    ndim, op = 1, "avg"

    def __init__(self, pool_length=2, stride=None, **kw):
        super().__init__(pool_length, stride, **kw)


class MaxPooling2D(_PoolND):
    ndim, op = 2, "max"


class AveragePooling2D(_PoolND):
    ndim, op = 2, "avg"


class MaxPooling3D(_PoolND):
    ndim, op = 3, "max"

    def __init__(self, pool_size=(2, 2, 2), strides=None, **kw):
        super().__init__(pool_size, strides, **kw)


class AveragePooling3D(_PoolND):
    ndim, op = 3, "avg"

    def __init__(self, pool_size=(2, 2, 2), strides=None, **kw):
        super().__init__(pool_size, strides, **kw)


class _GlobalPool(Layer):
    op = "max"
    axes = (1,)

    def forward(self, x):
        if self.op == "max":
            return torch.amax(x, dim=self.axes)
        return torch.mean(x, dim=self.axes)

    def compute_output_shape(self, s):
        return (s[0], s[-1])


class GlobalMaxPooling1D(_GlobalPool):
    op, axes = "max", (1,)


class GlobalAveragePooling1D(_GlobalPool):
    op, axes = "avg", (1,)


class GlobalMaxPooling2D(_GlobalPool):
    op, axes = "max", (1, 2)


class GlobalAveragePooling2D(_GlobalPool):
    op, axes = "avg", (1, 2)


class GlobalMaxPooling3D(_GlobalPool):
    op, axes = "max", (1, 2, 3)


class GlobalAveragePooling3D(_GlobalPool):
    op, axes = "avg", (1, 2, 3)


class Pooling1D(MaxPooling1D):
    pass


class Pooling2D(MaxPooling2D):
    pass
