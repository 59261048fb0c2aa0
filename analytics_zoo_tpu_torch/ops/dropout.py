"""Counter-hash dropout: Bernoulli masks from a seed and the element index.

Port of ``analytics_zoo_tpu/ops/dropout.py``.  The mask is a hash of
(seed, flat element index), bit-identical to the JAX package's
single-multiply hash, so a seed gives the same mask in both packages and
the backward rebuilds it from the seed instead of saving it.  A seed is a
Python int read as wrapping int32, or a 0-d int32 tensor: the training
step derives its seeds on the card from a step counter in device memory,
so that a CUDA graph replaying the step drops other elements at every
replay (an int would be frozen into the graph at its capture).  The JAX
package also folds PRNG keys into seeds; keys do not exist in the port.
``derive_seed`` splits a seed per site as the JAX one does, so a model
given the same seed drops the same elements in both packages.  The index
is the element's index in the global array: a process that holds a block
of it (its rows of the global batch) passes the block's first global
index as ``offset`` and draws its part of the global mask, which is what
the JAX package draws over the whole array under GSPMD; offset 0 is the
mask of an array that is the whole.

The hash is 32-bit unsigned arithmetic; torch has no uint32 arithmetic, so
it runs in int64 holding values in ``[0, 2**32)`` (see
``ops/attention.py``), the same operations on an int and on a tensor.  It
is plain torch, as it is plain jnp in the JAX package: no hand-written
kernel.

The layers whose JAX draws come from ``jax.random`` (spatial and Gaussian
dropout, Gaussian noise, the Gaussian sampler, RReLU's slopes), which no
port can reproduce, draw from the same kind of counter hash instead:
``hash_uniform`` (24 bits of the full ``_mix32`` of seed and index),
``hash_bernoulli`` and ``hash_normal`` (Box-Muller over two uniforms of
derived seeds).  A seed on the card (a 0-d int32 tensor) draws anew at
every replay of a captured step, as the masks do.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from analytics_zoo_tpu_torch.ops._kernels import _as_i32
from analytics_zoo_tpu_torch.ops.attention import (
    _MIX_C1, _M32, _SEED_C, _dropout_thresh, _mix32, _mul32, _u32)

__all__ = ["as_seed", "derive_seed", "hash_bernoulli", "hash_dropout",
           "hash_normal", "hash_uniform", "process_offset"]


def as_seed(rng_or_seed):
    """The int32 seed of an int (wrapping), a tensor seed as a 0-d int32
    tensor, or None for None.  JAX PRNG keys, which the JAX version folds
    into a seed, do not exist here."""
    if rng_or_seed is None:
        return None
    if isinstance(rng_or_seed, torch.Tensor):
        if rng_or_seed.numel() != 1 or rng_or_seed.is_floating_point() \
                or rng_or_seed.dtype == torch.bool:
            raise TypeError(f"a tensor dropout seed is one integer, got "
                            f"{tuple(rng_or_seed.shape)} {rng_or_seed.dtype}")
        if rng_or_seed.dtype == torch.int32:
            return rng_or_seed.reshape(())
        return _i32(rng_or_seed.reshape(()).to(torch.int64) & _M32)
    if isinstance(rng_or_seed, bool) or not isinstance(
            rng_or_seed, (int, np.integer)):
        raise TypeError(f"a dropout seed is an int or an integer tensor, "
                        f"got {type(rng_or_seed).__name__}")
    return _as_i32(rng_or_seed)


def process_offset(shape) -> int:
    """The global index of the first element of an array of ``shape``
    whose leading axis holds this process's rows of the global batch, in
    the live context's job (``parallel.distributed.batch_offset``): the
    ``offset`` a layer draws with, 0 for one process."""
    from analytics_zoo_tpu_torch.parallel import distributed
    rows = shape[0] if len(shape) else 0
    if not rows:
        return 0
    return distributed.batch_offset(rows) * (math.prod(shape) // rows)


def _i32(u: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` -> the int32 of the same bits."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def derive_seed(rng_or_seed, salt):
    """A decorrelated child seed, ``mix32(seed ^ salt * golden)`` in
    wrapping int32, as the JAX version; None stays None.  Ints give an
    int; a tensor seed or salt (a device step counter) gives a 0-d int32
    tensor of the same value, computed on its device."""
    s = as_seed(rng_or_seed)
    if s is None:
        return None
    # an int operand stays a Python int (a scalar of the tensor op): a
    # host value copied to the card is not allowed in a graph's capture
    su = _u32(s) if isinstance(s, torch.Tensor) else s & _M32
    tu = _mul32(_u32(salt) if isinstance(salt, torch.Tensor)
                else int(salt) & _M32, _SEED_C)
    if isinstance(s, torch.Tensor) and isinstance(salt, torch.Tensor):
        tu = tu.to(s.device)
    x = _mix32(su ^ tu)
    return _i32(x) if isinstance(x, torch.Tensor) else _as_i32(x)


def _counter_base(seed, device):
    """``seed * golden mod 2**32``: an int, or an int64 tensor on
    ``device`` for a tensor seed."""
    s = as_seed(seed)
    if isinstance(s, torch.Tensor):
        return _mul32(_u32(s).to(device), _SEED_C)
    return _mul32(s & _M32, _SEED_C)


def _counter(shape, seed, device, offset: int) -> torch.Tensor:
    """``offset + idx + seed * golden mod 2**32`` for every element of
    ``shape`` in order, as int64."""
    return (torch.arange(offset, offset + math.prod(shape),
                         dtype=torch.int64, device=device)
            + _counter_base(seed, device)) & _M32


def _mask(shape, seed, rate: float, device=None,
          offset: int = 0) -> torch.Tensor:
    """Boolean keep-mask of ``shape``: the JAX ``_mask`` bit for bit
    (``idx + seed * C``, two shift-left injections with wraparound, one
    multiply, logical right shifts), ``idx`` counted from ``offset``."""
    z = _counter(shape, seed, device, offset)
    z = z ^ ((z << 9) & _M32)
    z = z ^ ((z << 11) & _M32)
    z = _mul32(z ^ (z >> 13), _MIX_C1)
    z = z ^ (z >> 15)
    return ((z >> 8) >= _dropout_thresh(rate)).reshape(shape)


def _apply(x, seed, rate: float, offset: int = 0):
    """``keep ? x / (1 - rate) : 0``, the scale rounded to x's dtype first
    as the JAX version's weakly typed constant is."""
    keep = _mask(x.shape, seed, rate, x.device, offset)
    return torch.where(keep, x * _scale(rate, x.dtype), 0.0)


@functools.lru_cache(maxsize=None)
def _scale(rate: float, dtype: torch.dtype) -> float:
    """``1 / (1 - rate)`` rounded to ``dtype``, as a Python number (a
    device tensor made from a host value would be a copy, which a CUDA
    graph's capture does not allow)."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=dtype))


class _HashDropout(torch.autograd.Function):
    """Saves only the seed; the backward rebuilds the mask from it."""

    @staticmethod
    def forward(ctx, x, seed, rate, offset):
        ctx.seed, ctx.rate, ctx.offset = seed, rate, offset
        return _apply(x, seed, rate, offset)

    @staticmethod
    def backward(ctx, dy):
        return _apply(dy, ctx.seed, ctx.rate, ctx.offset), None, None, None


def hash_dropout(x, rate: float, rng=None, seed=None, *, offset: int = 0):
    """Drop elements of ``x`` with probability ``rate``; survivors scale by
    1/(1-rate).  The mask is a deterministic hash of (seed, element
    index); ``seed`` (or ``rng``: an int or a 0-d integer tensor here)
    picks it.  ``offset`` is the global index of ``x``'s first element
    when ``x`` is a block of a larger array (a process's rows of the
    global batch).  No-op when rate <= 0 or no seed is given."""
    if rate <= 0.0:
        return x
    s = as_seed(seed if seed is not None else rng)
    if s is None:
        return x
    return _HashDropout.apply(x, s, float(rate), int(offset))


def hash_uniform(shape, seed, device=None,
                 dtype: torch.dtype = torch.float32,
                 offset: int = 0) -> torch.Tensor:
    """Uniforms in (0, 1) of ``shape``: 24 bits of ``mix32(index + seed *
    golden)`` per element, centred in their bin (never 0 or 1); ``index``
    counts from ``offset`` (see ``hash_dropout``)."""
    bits = _mix32(_counter(shape, seed, device, offset)) >> 8
    return ((bits.to(torch.float32) + 0.5) * 2.0 ** -24).to(dtype) \
        .reshape(shape)


def hash_bernoulli(shape, seed, p: float, device=None,
                   offset: int = 0) -> torch.Tensor:
    """Boolean tensor of ``shape``, each element True with probability
    ``p``, from ``hash_uniform``."""
    return hash_uniform(shape, seed, device, offset=offset) < p


def hash_normal(shape, seed, device=None,
                dtype: torch.dtype = torch.float32,
                offset: int = 0) -> torch.Tensor:
    """Standard normals of ``shape`` by Box-Muller over two uniforms drawn
    under the derived seeds ``derive_seed(seed, 1)`` and ``(seed, 2)``."""
    u1 = hash_uniform(shape, derive_seed(seed, 1), device, offset=offset)
    u2 = hash_uniform(shape, derive_seed(seed, 2), device, offset=offset)
    return (torch.sqrt(-2.0 * torch.log(u1))
            * torch.cos((2.0 * math.pi) * u2)).to(dtype)
