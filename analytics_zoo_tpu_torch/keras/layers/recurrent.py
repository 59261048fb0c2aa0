"""Recurrent layers: SimpleRNN, LSTM, GRU, Bidirectional, TimeDistributed,
ConvLSTM2D / 3D.

Port of ``analytics_zoo_tpu/keras/layers/recurrent.py`` (``lax.scan``
there, no Pallas kernel).  Each cell is a plain PyTorch loop over time;
``torch.nn.LSTM`` / ``GRU`` (cuDNN) compute other cells: the inner
activation defaults to Keras-1 ``hard_sigmoid``, the LSTM's forget bias
starts at 1, and the GRU applies ``r`` after the recurrent product, with
its bias on the input side only.  The input product ``x @ W`` is taken
once for all steps before the loop (the same arithmetic), so a step is
one ``(B, H) x (H, nH)`` product and the gate arithmetic.  The steps
read the input products through one ``unbind`` and the gates through
``chunk``: the backward of a per-step slice would zero-fill and add a
gradient of the whole tensor at every step.
``go_backwards`` runs the scan over reversed time and, with
``return_sequences``, reverses the outputs back, as the JAX ``_scan``
does.

``Bidirectional`` holds its two layers under the JAX tree's keys,
``forward`` and ``backward``; ``TimeDistributed``'s tree is its inner
layer's own (the JAX tree is not nested), so it shares the inner
layer's parameter dicts (``core._adopt``).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from analytics_zoo_tpu_torch.keras import activations, initializers
from analytics_zoo_tpu_torch.keras.engine import Layer
from analytics_zoo_tpu_torch.keras.layers.convolutional import _conv_cl
from analytics_zoo_tpu_torch.keras.layers.core import (
    _adopt, _Built, _call_inner)


class Recurrent(_Built):
    """The ``return_sequences`` / ``go_backwards`` plumbing shared by
    SimpleRNN, LSTM and GRU."""

    #: gates packed in W / U / b (1 for SimpleRNN, 4 LSTM, 3 GRU)
    gates = 1

    def __init__(self, output_dim: int, activation="tanh",
                 inner_activation="hard_sigmoid", return_sequences=False,
                 go_backwards=False, init="glorot_uniform",
                 inner_init="glorot_uniform", **kw):
        super().__init__(**kw)
        self.output_dim = output_dim
        self.activation = activations.get(activation)
        self.inner_activation = activations.get(inner_activation)
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards
        self.kernel_init = initializers.get(init)
        self.inner_init = initializers.get(inner_init)
        self._defer()

    def build(self, input_shape):
        d, h, g = input_shape[-1], self.output_dim, self.gates
        self.W = nn.Parameter(torch.empty(d, g * h))
        self.U = nn.Parameter(torch.empty(h, g * h))
        self.b = nn.Parameter(torch.zeros(g * h))

    def _bias_init(self, b: torch.Tensor) -> None:
        b.zero_()

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        if not self.built:
            return
        self.kernel_init(self.W, generator)
        self.inner_init(self.U, generator)
        self._bias_init(self.b)

    def compute_output_shape(self, s):
        if self.return_sequences:
            return (s[0], s[1], self.output_dim)
        return (s[0], self.output_dim)

    def _input_products(self, x):
        """``x @ W`` for every step at once, time-major ``(T, B, nH)``."""
        return torch.matmul(x, self.W).transpose(0, 1)

    def _step(self, xw, carry):
        """One step from the input product ``xw``: ``(output, carry)``."""
        raise NotImplementedError

    def _zeros(self, x):
        return x.new_zeros((x.shape[0], self.output_dim))

    def _scan(self, x, carry):
        # one unbind, not a select per step: the backward of T selects
        # would zero-fill and add a whole (T, B, nH) gradient per step
        steps = self._input_products(x).unbind(0)
        if self.go_backwards:
            steps = reversed(steps)
        ys = []
        for xw in steps:
            y, carry = self._step(xw, carry)
            ys.append(y)
        if self.return_sequences:
            if self.go_backwards:
                ys.reverse()
            return torch.stack(ys, dim=1)
        return ys[-1]


class SimpleRNN(Recurrent):
    gates = 1

    def _step(self, xw, h):
        h = self.activation(xw + torch.matmul(h, self.U) + self.b)
        return h, h

    def forward(self, x):
        return self._scan(x, self._zeros(x))


class LSTM(Recurrent):
    """Gates i, f, c, o packed in one ``(D, 4H)`` product; the forget
    bias starts at 1."""

    gates = 4

    def _bias_init(self, b):
        h = self.output_dim
        b.zero_()
        b[h:2 * h] = 1.0

    def _step(self, xw, carry):
        h_prev, c_prev = carry
        z = xw + torch.matmul(h_prev, self.U) + self.b
        # chunk: one backward (a cat) for the four gates, not four
        # zero-filled slice gradients
        zi, zf, zg, zo = z.chunk(4, dim=1)
        i = self.inner_activation(zi)
        f = self.inner_activation(zf)
        g = self.activation(zg)
        o = self.inner_activation(zo)
        c = f * c_prev + i * g
        y = o * self.activation(c)
        return y, (y, c)

    def scan_with_state(self, x, h0=None, c0=None):
        """The cell over (B, T, D) from ``(h0, c0)`` (zeros by default), in
        time order: ``(ys, final_h, final_c)``, the seam encoder-decoder
        models build on."""
        zeros = self._zeros(x)
        carry = (h0 if h0 is not None else zeros,
                 c0 if c0 is not None else zeros)
        ys = []
        for xw in self._input_products(x).unbind(0):
            y, carry = self._step(xw, carry)
            ys.append(y)
        return torch.stack(ys, dim=1), carry[0], carry[1]

    def forward(self, x):
        zeros = self._zeros(x)
        return self._scan(x, (zeros, zeros))


class GRU(Recurrent):
    """Gates z, r, h; ``r`` scales the recurrent product of the candidate,
    and the bias is on the input side only."""

    gates = 3

    def _input_products(self, x):
        return (torch.matmul(x, self.W) + self.b).transpose(0, 1)

    def _step(self, xz, h_prev):
        xz_z, xz_r, xz_h = xz.chunk(3, dim=1)
        hz_z, hz_r, hz_h = torch.matmul(h_prev, self.U).chunk(3, dim=1)
        z = self.inner_activation(xz_z + hz_z)
        r = self.inner_activation(xz_r + hz_r)
        hh = self.activation(xz_h + r * hz_h)
        y = z * h_prev + (1 - z) * hh
        return y, y

    def forward(self, x):
        return self._scan(x, self._zeros(x))


class Bidirectional(Layer):
    """``layer`` over time forwards and a copy of it backwards, merged by
    ``merge_mode`` (concat / sum / mul / ave)."""

    def __init__(self, layer: Recurrent, merge_mode: str = "concat", **kw):
        super().__init__(**kw)
        backward = copy.deepcopy(layer)
        backward.name = layer.name + "_bwd"
        backward.go_backwards = not layer.go_backwards
        # the JAX tree's keys; "forward" is also nn.Module's method, so the
        # children live in _modules and are read from there
        self._modules["forward"] = layer
        self._modules["backward"] = backward
        self.merge_mode = merge_mode
        self.built = layer.built
        if self.built:
            backward.reset_parameters()
        elif self.input_shape is not None:
            self.ensure_built(self.input_shape)

    def build(self, input_shape):
        for layer in self._modules.values():
            layer.ensure_built(input_shape)

    def forward(self, x):
        yf = self._modules["forward"](x)
        yb = self._modules["backward"](x)
        if self.merge_mode == "concat":
            return torch.cat([yf, yb], dim=-1)
        if self.merge_mode == "sum":
            return yf + yb
        if self.merge_mode == "mul":
            return yf * yb
        if self.merge_mode == "ave":
            return (yf + yb) / 2.0
        raise ValueError(f"unknown merge mode {self.merge_mode}")

    def compute_output_shape(self, s):
        out = self._modules["forward"].compute_output_shape(s)
        if self.merge_mode == "concat":
            return tuple(out[:-1]) + (out[-1] * 2,)
        return out


class TimeDistributed(Layer):
    """``layer`` applied to every timestep, as one call over the (B * T)
    rows; its parameter tree is the inner layer's."""

    def __init__(self, layer: Layer, **kw):
        super().__init__(**kw)
        _adopt(self, layer)
        self.built = getattr(layer, "built", True)
        if not self.built and self.input_shape is not None:
            self.ensure_built(self.input_shape)

    def build(self, input_shape):
        self.inner.ensure_built((input_shape[0],) + tuple(input_shape[2:]))

    def reset_parameters(self, generator=None) -> None:
        if isinstance(self.inner, Layer):
            self.inner.reset_parameters(generator)

    def forward(self, x, seed: Optional[int] = None):
        B, T = x.shape[0], x.shape[1]
        y = _call_inner(self.inner, self.training,
                        x.reshape((B * T,) + tuple(x.shape[2:])), seed)
        return y.reshape((B, T) + tuple(y.shape[1:]))

    def compute_output_shape(self, s):
        inner = self.inner.compute_output_shape((s[0],) + tuple(s[2:]))
        return (s[0], s[1]) + tuple(inner[1:])


class ConvLSTM2D(_Built):
    """Convolutional LSTM (channels-last) over (B, T, H, W, C): ``W: (k,
    k, in, 4f)``, ``U: (k, k, f, 4f)``, ``b: (4f,)``, gates i, f, c, o."""

    def __init__(self, nb_filter: int, nb_kernel: int,
                 return_sequences: bool = False, border_mode: str = "same",
                 init="glorot_uniform", inner_activation="hard_sigmoid",
                 activation="tanh", **kw):
        super().__init__(**kw)
        self.nb_filter = nb_filter
        self.kernel = (nb_kernel, nb_kernel)
        self.return_sequences = return_sequences
        self.padding = border_mode.upper()
        self.kernel_init = initializers.get(init)
        self.activation = activations.get(activation)
        self.inner_activation = activations.get(inner_activation)
        if type(self) is ConvLSTM2D:
            self._defer()

    def build(self, input_shape):
        f = self.nb_filter
        self.W = nn.Parameter(torch.empty(self.kernel
                                          + (input_shape[-1], 4 * f)))
        self.U = nn.Parameter(torch.empty(self.kernel + (f, 4 * f)))
        self.b = nn.Parameter(torch.zeros(4 * f))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        if not self.built:
            return
        self.kernel_init(self.W, generator)
        self.kernel_init(self.U, generator)
        self.b.zero_()

    def _conv(self, x, w):
        return _conv_cl(x, w, (1,) * len(self.kernel), self.padding)

    def forward(self, x):
        f = self.nb_filter
        spatial = self._spatial(x.shape[2:2 + len(self.kernel)])
        h = c = x.new_zeros((x.shape[0], *spatial, f))
        ys = []
        for xt in x.unbind(1):
            z = self._conv(xt, self.W) + self._conv(h, self.U) + self.b
            zi, zf, zg, zo = z.chunk(4, dim=-1)
            i = self.inner_activation(zi)
            fg = self.inner_activation(zf)
            g = self.activation(zg)
            o = self.inner_activation(zo)
            c = fg * c + i * g
            h = o * self.activation(c)
            ys.append(h)
        if self.return_sequences:
            return torch.stack(ys, dim=1)
        return ys[-1]

    def _spatial(self, hw):
        if self.padding == "SAME":
            return tuple(hw)
        return tuple(d - k + 1 for d, k in zip(hw, self.kernel))

    def compute_output_shape(self, s):
        spatial = self._spatial(s[2:2 + len(self.kernel)])
        if self.return_sequences:
            return (s[0], s[1], *spatial, self.nb_filter)
        return (s[0], *spatial, self.nb_filter)


class ConvLSTM3D(ConvLSTM2D):
    """Volumetric convolutional LSTM over (B, T, D, H, W, C)."""

    def __init__(self, nb_filter: int, nb_kernel: int, **kw):
        super().__init__(nb_filter, nb_kernel, **kw)
        self.kernel = (nb_kernel,) * 3
        self._defer()
