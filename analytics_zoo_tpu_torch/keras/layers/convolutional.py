"""Convolution, padding, cropping, up-sampling and resizing layers.

Port of ``analytics_zoo_tpu/keras/layers/convolutional.py``.  Layout is
channels-last, as in the JAX package, and kernels are stored as the JAX
trees store them, ``(k..., in, out)`` (``Deconvolution2D``: ``(kh, kw,
nb_filter, in)``; the depthwise kernel ``(kh, kw, 1, in * depth_multiplier)``),
so trees cross with no transpose: a call permutes the input to
channels-first and the kernel to PyTorch's ``(out, in, k...)`` and calls
``F.conv*d``.  No Pallas kernel stands behind these layers in the JAX
package (``lax.conv_general_dilated``), so plain PyTorch calls port them.

Padding follows XLA: ``same`` pads ``total = max((ceil(n / s) - 1) * s +
(k - 1) * d + 1 - n, 0)`` with ``total // 2`` on the low side and the
rest on the high side, for every stride and dilation (PyTorch's
``padding="same"`` refuses a stride above 1 and puts the odd cell on the
other side), explicitly with ``F.pad``.  ``Deconvolution2D`` is
``lax.conv_transpose(..., transpose_kernel=True)``: the full transposed
convolution cropped and padded to XLA's window, its size by
``compute_output_shape``.  ``ResizeBilinear`` is ``jax.image.resize(...,
"bilinear")``: half-pixel centres, a triangle kernel widened by the
scale when it shrinks (antialiasing), weights renormalised at the edges,
applied as one weight matrix per axis.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras import activations, initializers
from analytics_zoo_tpu_torch.keras.engine import Layer
from analytics_zoo_tpu_torch.keras.layers.core import _Built

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _pair(v, n=2):
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v,) * n


def _conv_out(size, k, stride, pad):
    if size is None:
        return None
    if pad == "SAME":
        return -(-size // stride)
    return (size - k) // stride + 1


def _same_pads(sizes, kernel, strides, dilation):
    """XLA's SAME padding: ``(low, high)`` per spatial dim."""
    pads = []
    for n, k, s, d in zip(sizes, kernel, strides, dilation):
        eff = (k - 1) * d + 1
        total = max((-(-n // s) - 1) * s + eff - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pad_spatial(x, pads, value=0.0):
    """Pad the trailing spatial dims of a channels-first tensor."""
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    if not any(flat):
        return x
    return F.pad(x, flat, value=value)


def _to_cf(x):
    """Channels-last -> channels-first."""
    return x.movedim(-1, 1)


def _to_cl(x):
    return x.movedim(1, -1)


def _conv_cl(x, w, strides, padding, dilation=None, groups=1):
    """Channels-last ``x`` (B, *spatial, C) by a ``(k..., in, out)`` kernel
    under XLA's padding rule (``padding`` "SAME", "VALID" or explicit
    pairs); the result channels-last."""
    nd = w.dim() - 2
    dilation = dilation or (1,) * nd
    xc = _to_cf(x)
    if padding == "SAME":
        pads = _same_pads(xc.shape[2:], w.shape[:nd], strides, dilation)
    elif padding == "VALID":
        pads = [(0, 0)] * nd
    else:
        pads = list(padding)
    xc = _pad_spatial(xc, pads)
    wt = w.permute((nd + 1, nd) + tuple(range(nd)))
    return _to_cl(_CONV[nd](xc, wt, None, tuple(strides), 0, tuple(dilation),
                            groups))


class _ConvND(_Built):
    """Shared machinery of the 1/2/3-D convolutions."""

    ndim = 2

    def __init__(self, nb_filter: int, kernel_size: Sequence[int],
                 activation=None, subsample=1, border_mode: str = "valid",
                 dilation=1, init="glorot_uniform", bias: bool = True, **kw):
        super().__init__(**kw)
        self.nb_filter = nb_filter
        self.kernel_size = _pair(kernel_size, self.ndim)
        self.strides = _pair(subsample, self.ndim)
        self.dilation = _pair(dilation, self.ndim)
        self.padding = border_mode.upper()  # VALID | SAME
        self.activation = activations.get(activation)
        self.kernel_init = initializers.get(init)
        self.use_bias = bias
        self._defer()

    def build(self, input_shape):
        self.W = nn.Parameter(torch.empty(
            self.kernel_size + (input_shape[-1], self.nb_filter)))
        if self.use_bias:
            self.b = nn.Parameter(torch.zeros(self.nb_filter))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        if not self.built:
            return
        self.kernel_init(self.W, generator)
        if self.use_bias:
            self.b.zero_()

    def forward(self, x):
        y = _conv_cl(x, self.W, self.strides, self.padding, self.dilation)
        if self.use_bias:
            y = y + self.b
        return self.activation(y)

    def compute_output_shape(self, input_shape):
        spatial = [
            _conv_out(input_shape[1 + i],
                      (self.kernel_size[i] - 1) * self.dilation[i] + 1,
                      self.strides[i], self.padding)
            for i in range(self.ndim)]
        return (input_shape[0], *spatial, self.nb_filter)


class Convolution1D(_ConvND):
    ndim = 1

    def __init__(self, nb_filter, filter_length, **kw):
        super().__init__(nb_filter, (filter_length,), **kw)


class Convolution2D(_ConvND):
    ndim = 2

    def __init__(self, nb_filter, nb_row, nb_col=None, **kw):
        if nb_col is None:
            nb_row, nb_col = _pair(nb_row)
        super().__init__(nb_filter, (nb_row, nb_col), **kw)


class Convolution3D(_ConvND):
    ndim = 3

    def __init__(self, nb_filter, kernel_dim1, kernel_dim2=None,
                 kernel_dim3=None, **kw):
        if kernel_dim2 is None:
            k = _pair(kernel_dim1, 3)
        else:
            k = (kernel_dim1, kernel_dim2, kernel_dim3)
        super().__init__(nb_filter, k, **kw)


class AtrousConvolution1D(Convolution1D):
    def __init__(self, nb_filter, filter_length, atrous_rate=2, **kw):
        super().__init__(nb_filter, filter_length, dilation=(atrous_rate,),
                         **kw)


class AtrousConvolution2D(Convolution2D):
    def __init__(self, nb_filter, nb_row, nb_col=None, atrous_rate=(2, 2),
                 **kw):
        super().__init__(nb_filter, nb_row, nb_col,
                         dilation=_pair(atrous_rate), **kw)


class Deconvolution2D(_Built):
    """Transposed convolution, ``W: (kh, kw, nb_filter, in)`` read as the
    JAX layer reads it: output channel ``o`` sums input channel ``i``
    through ``W[:, :, i, o]``, so ``nb_filter`` must equal the input's
    channels."""

    def __init__(self, nb_filter, nb_row, nb_col, subsample=(1, 1),
                 activation=None, init="glorot_uniform", bias=True,
                 border_mode="valid", **kw):
        super().__init__(**kw)
        self.nb_filter = nb_filter
        self.kernel_size = (nb_row, nb_col)
        self.strides = _pair(subsample)
        self.activation = activations.get(activation)
        self.kernel_init = initializers.get(init)
        self.use_bias = bias
        self.padding = border_mode.upper()
        self._defer()

    def build(self, input_shape):
        self.W = nn.Parameter(torch.empty(
            self.kernel_size + (self.nb_filter, input_shape[-1])))
        if self.use_bias:
            self.b = nn.Parameter(torch.zeros(self.nb_filter))

    reset_parameters = _ConvND.reset_parameters

    def _window(self, n, k, s):
        """(crop from the full transposed output's start, output size):
        ``lax.conv_transpose``'s padding of the dilated input."""
        if self.padding == "SAME":
            pad_len = k + s - 2
            pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
            return k - 1 - pad_a, n * s
        return 0, n * s + max(k - s, 0)

    def forward(self, x):
        if x.shape[-1] != self.nb_filter:
            # the JAX layer's kernel is (kh, kw, nb_filter, in), but
            # lax.conv_transpose(transpose_kernel=True) under "HWOI" reads
            # its third axis as the input's channels: it runs only when
            # the two agree, and so does this port of it
            raise ValueError(
                f"Deconvolution2D: nb_filter {self.nb_filter} must equal "
                f"the input's channels {x.shape[-1]} (the JAX layer's "
                f"kernel layout)")
        xc = _to_cf(x)
        y = F.conv_transpose2d(xc, self.W.permute(2, 3, 0, 1), None,
                               self.strides)
        for ax, (n, k, s) in enumerate(zip(xc.shape[2:], self.kernel_size,
                                           self.strides)):
            start, size = self._window(n, k, s)
            dim = 2 + ax
            short = start + size - y.shape[dim]
            if short > 0:
                pad = [0, 0] * (y.dim() - 1 - dim) + [0, short]
                y = F.pad(y, pad)
            y = y.narrow(dim, start, size)
        y = _to_cl(y)
        if self.use_bias:
            y = y + self.b
        return self.activation(y)

    def compute_output_shape(self, input_shape):
        def out(size, k, s):
            if size is None:
                return None
            if self.padding == "SAME":
                return size * s
            return size * s + max(k - s, 0)
        h = out(input_shape[1], self.kernel_size[0], self.strides[0])
        w = out(input_shape[2], self.kernel_size[1], self.strides[1])
        return (input_shape[0], h, w, self.nb_filter)


class SeparableConvolution2D(_Built):
    """A depthwise convolution (``depth_multiplier`` maps per channel)
    then a 1x1 pointwise one."""

    def __init__(self, nb_filter, nb_row, nb_col=None, depth_multiplier=1,
                 subsample=(1, 1), border_mode="valid", activation=None,
                 init="glorot_uniform", bias=True, **kw):
        super().__init__(**kw)
        if nb_col is None:
            nb_row, nb_col = _pair(nb_row)
        self.nb_filter = nb_filter
        self.kernel_size = (nb_row, nb_col)
        self.depth_multiplier = depth_multiplier
        self.strides = _pair(subsample)
        self.padding = border_mode.upper()
        self.activation = activations.get(activation)
        self.kernel_init = initializers.get(init)
        self.use_bias = bias
        self._defer()

    def build(self, input_shape):
        mid = input_shape[-1] * self.depth_multiplier
        self.depthwise = nn.Parameter(torch.empty(self.kernel_size
                                                  + (1, mid)))
        self.pointwise = nn.Parameter(torch.empty(1, 1, mid, self.nb_filter))
        if self.use_bias:
            self.b = nn.Parameter(torch.zeros(self.nb_filter))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        if not self.built:
            return
        self.kernel_init(self.depthwise, generator)
        self.kernel_init(self.pointwise, generator)
        if self.use_bias:
            self.b.zero_()

    def forward(self, x):
        y = _conv_cl(x, self.depthwise, self.strides, self.padding,
                     groups=x.shape[-1])
        y = _conv_cl(y, self.pointwise, (1, 1), "VALID")
        if self.use_bias:
            y = y + self.b
        return self.activation(y)

    def compute_output_shape(self, input_shape):
        h = _conv_out(input_shape[1], self.kernel_size[0], self.strides[0],
                      self.padding)
        w = _conv_out(input_shape[2], self.kernel_size[1], self.strides[1],
                      self.padding)
        return (input_shape[0], h, w, self.nb_filter)


class LocallyConnected1D(_Built):
    """Conv1D without weight sharing: ``W: (out_len, filter_length * in,
    nb_filter)``."""

    def __init__(self, nb_filter, filter_length, activation=None,
                 subsample_length=1, init="glorot_uniform", bias=True,
                 border_mode="valid", **kw):
        super().__init__(**kw)
        self.nb_filter = nb_filter
        self.filter_length = filter_length
        self.stride = subsample_length
        self.activation = activations.get(activation)
        self.kernel_init = initializers.get(init)
        self.use_bias = bias
        if border_mode != "valid":
            raise ValueError("LocallyConnected1D supports only valid padding")
        self._defer()

    def _out_len(self, length):
        return (length - self.filter_length) // self.stride + 1

    def build(self, input_shape):
        out_len = self._out_len(input_shape[1])
        self.W = nn.Parameter(torch.empty(
            out_len, self.filter_length * input_shape[-1], self.nb_filter))
        if self.use_bias:
            self.b = nn.Parameter(torch.zeros(out_len, self.nb_filter))

    reset_parameters = _ConvND.reset_parameters

    def forward(self, x):
        # (B, L, C, fl) -> (B, L, fl * C), each window flattened row-major
        # as the JAX slices are
        patches = x.unfold(1, self.filter_length, self.stride)
        patches = patches.transpose(2, 3).reshape(
            x.shape[0], patches.shape[1], -1)
        y = torch.einsum("blk,lko->blo", patches, self.W)
        if self.use_bias:
            y = y + self.b
        return self.activation(y)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self._out_len(input_shape[1]),
                self.nb_filter)


class LocallyConnected2D(_Built):
    def __init__(self, nb_filter, nb_row, nb_col, activation=None,
                 subsample=(1, 1), init="glorot_uniform", bias=True, **kw):
        super().__init__(**kw)
        self.nb_filter = nb_filter
        self.kernel_size = (nb_row, nb_col)
        self.strides = _pair(subsample)
        self.activation = activations.get(activation)
        self.kernel_init = initializers.get(init)
        self.use_bias = bias
        self._defer()

    def _out_hw(self, shape):
        h = (shape[1] - self.kernel_size[0]) // self.strides[0] + 1
        w = (shape[2] - self.kernel_size[1]) // self.strides[1] + 1
        return h, w

    def build(self, input_shape):
        h, w = self._out_hw(input_shape)
        k = self.kernel_size[0] * self.kernel_size[1] * input_shape[-1]
        self.W = nn.Parameter(torch.empty(h * w, k, self.nb_filter))
        if self.use_bias:
            self.b = nn.Parameter(torch.zeros(h * w, self.nb_filter))

    reset_parameters = _ConvND.reset_parameters

    def forward(self, x):
        h, w = self._out_hw(x.shape)
        (kh, kw), (sh, sw) = self.kernel_size, self.strides
        # (B, h, w, C, kh, kw) -> (B, h * w, kh * kw * C)
        patches = x.unfold(1, kh, sh).unfold(2, kw, sw)
        patches = patches.permute(0, 1, 2, 4, 5, 3).reshape(
            x.shape[0], h * w, -1)
        y = torch.einsum("blk,lko->blo", patches, self.W)
        if self.use_bias:
            y = y + self.b
        y = y.reshape(x.shape[0], h, w, self.nb_filter)
        return self.activation(y)

    def compute_output_shape(self, input_shape):
        h, w = self._out_hw(input_shape)
        return (input_shape[0], h, w, self.nb_filter)


class ShareConvolution2D(_Built):
    """A convolution over NCHW input (``dim_ordering="th"`` only) with
    explicit zero padding ``pad_h`` / ``pad_w``; ``W: (nb_row, nb_col, in,
    nb_filter)``.  The bias and activation apply channels-last, as in the
    JAX layer."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 init="glorot_uniform", activation=None, subsample=(1, 1),
                 pad_h: int = 0, pad_w: int = 0, propagate_back: bool = True,
                 dim_ordering: str = "th", bias: bool = True, **kw):
        super().__init__(**kw)
        if dim_ordering != "th":
            raise ValueError("ShareConvolution2D currently only supports "
                             "format NCHW (dim_ordering='th'), got "
                             f"{dim_ordering!r}")
        self.nb_filter = nb_filter
        self.nb_row = nb_row
        self.nb_col = nb_col
        self.kernel_init = initializers.get(init)
        self.activation = activations.get(activation)
        self.subsample = _pair(subsample)
        self.pad_h = pad_h
        self.pad_w = pad_w
        self.use_bias = bias
        self._defer()

    def build(self, input_shape):
        self.W = nn.Parameter(torch.empty(self.nb_row, self.nb_col,
                                          input_shape[1], self.nb_filter))
        if self.use_bias:
            self.b = nn.Parameter(torch.zeros(self.nb_filter))

    reset_parameters = _ConvND.reset_parameters

    def forward(self, x):
        y = _conv_cl(_to_cl(x), self.W, self.subsample,
                     ((self.pad_h, self.pad_h), (self.pad_w, self.pad_w)))
        if self.use_bias:
            y = y + self.b
        return _to_cf(self.activation(y))

    def compute_output_shape(self, s):
        def out(size, k, stride, pad):
            return (None if size is None
                    else (size + 2 * pad - k) // stride + 1)
        rows = out(s[2], self.nb_row, self.subsample[0], self.pad_h)
        cols = out(s[3], self.nb_col, self.subsample[1], self.pad_w)
        return (s[0], self.nb_filter, rows, cols)


ShareConv2D = ShareConvolution2D


# ---- padding / cropping / resizing ----------------------------------------

def _pad_cl(x, pads):
    """Zero-pad the spatial dims of a channels-last tensor by ``pads``,
    one ``(low, high)`` per spatial dim."""
    flat = [0, 0] + [p for lo_hi in reversed(pads) for p in lo_hi]
    return F.pad(x, flat)


class ZeroPadding1D(Layer):
    def __init__(self, padding=1, **kw):
        super().__init__(**kw)
        self.padding = (_pair(padding, 2)
                        if isinstance(padding, (tuple, list))
                        else (padding, padding))

    def forward(self, x):
        return _pad_cl(x, [self.padding])

    def compute_output_shape(self, s):
        return (s[0], None if s[1] is None else s[1] + sum(self.padding), s[2])


class ZeroPadding2D(Layer):
    def __init__(self, padding=(1, 1), **kw):
        super().__init__(**kw)
        p = padding
        if len(p) == 2:
            self.pads = ((p[0], p[0]), (p[1], p[1]))
        else:
            self.pads = ((p[0], p[1]), (p[2], p[3]))

    def forward(self, x):
        return _pad_cl(x, self.pads)

    def compute_output_shape(self, s):
        h = None if s[1] is None else s[1] + sum(self.pads[0])
        w = None if s[2] is None else s[2] + sum(self.pads[1])
        return (s[0], h, w, s[3])


class ZeroPadding3D(Layer):
    def __init__(self, padding=(1, 1, 1), **kw):
        super().__init__(**kw)
        self.padding = tuple(padding)

    def forward(self, x):
        return _pad_cl(x, [(p, p) for p in self.padding])

    def compute_output_shape(self, s):
        p = self.padding
        dims = [None if d is None else d + 2 * p[i]
                for i, d in enumerate(s[1:4])]
        return (s[0], *dims, s[4])


class Cropping1D(Layer):
    def __init__(self, cropping=(1, 1), **kw):
        super().__init__(**kw)
        self.cropping = tuple(cropping)

    def forward(self, x):
        a, b = self.cropping
        return x[:, a:x.shape[1] - b, :]

    def compute_output_shape(self, s):
        return (s[0], None if s[1] is None else s[1] - sum(self.cropping),
                s[2])


class Cropping2D(Layer):
    def __init__(self, cropping=((0, 0), (0, 0)), **kw):
        super().__init__(**kw)
        self.cropping = cropping

    def forward(self, x):
        (t, b), (l, r) = self.cropping
        return x[:, t:x.shape[1] - b, l:x.shape[2] - r, :]

    def compute_output_shape(self, s):
        (t, b), (l, r) = self.cropping
        h = None if s[1] is None else s[1] - t - b
        w = None if s[2] is None else s[2] - l - r
        return (s[0], h, w, s[3])


class Cropping3D(Layer):
    def __init__(self, cropping=((1, 1), (1, 1), (1, 1)), **kw):
        super().__init__(**kw)
        self.cropping = cropping

    def forward(self, x):
        (a1, b1), (a2, b2), (a3, b3) = self.cropping
        return x[:, a1:x.shape[1] - b1, a2:x.shape[2] - b2,
                 a3:x.shape[3] - b3, :]

    def compute_output_shape(self, s):
        dims = [None if d is None else d - sum(c)
                for d, c in zip(s[1:4], self.cropping)]
        return (s[0], *dims, s[4])


class UpSampling1D(Layer):
    def __init__(self, length=2, **kw):
        super().__init__(**kw)
        self.length = length

    def forward(self, x):
        return torch.repeat_interleave(x, self.length, dim=1)

    def compute_output_shape(self, s):
        return (s[0], None if s[1] is None else s[1] * self.length, s[2])


class UpSampling2D(Layer):
    def __init__(self, size=(2, 2), **kw):
        super().__init__(**kw)
        self.size = _pair(size)

    def forward(self, x):
        y = torch.repeat_interleave(x, self.size[0], dim=1)
        return torch.repeat_interleave(y, self.size[1], dim=2)

    def compute_output_shape(self, s):
        h = None if s[1] is None else s[1] * self.size[0]
        w = None if s[2] is None else s[2] * self.size[1]
        return (s[0], h, w, s[3])


class UpSampling3D(Layer):
    def __init__(self, size=(2, 2, 2), **kw):
        super().__init__(**kw)
        self.size = tuple(size)

    def forward(self, x):
        for ax, s in enumerate(self.size):
            x = torch.repeat_interleave(x, s, dim=ax + 1)
        return x

    def compute_output_shape(self, s):
        dims = [None if d is None else d * f
                for d, f in zip(s[1:4], self.size)]
        return (s[0], *dims, s[4])


def _bilinear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """``(n_in, n_out)`` weights of ``jax.image.resize``'s linear kernel
    (``scale_and_translate`` with antialiasing, translation 0)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    dist = torch.abs(sample[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None]) / kernel_scale
    w = torch.clamp(1.0 - dist, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


class ResizeBilinear(Layer):
    def __init__(self, output_height: int, output_width: int, **kw):
        super().__init__(**kw)
        self.out_hw = (output_height, output_width)

    def forward(self, x):
        wh = _bilinear_weights(x.shape[1], self.out_hw[0], x.device)
        ww = _bilinear_weights(x.shape[2], self.out_hw[1], x.device)
        y = torch.einsum("bhwc,hH->bHwc", x, wh.to(x.dtype))
        return torch.einsum("bhwc,wW->bhWc", y, ww.to(x.dtype))

    def compute_output_shape(self, s):
        return (s[0], *self.out_hw, s[3])
