"""Counter-hash dropout: Bernoulli masks from a seed and the element index.

Port of ``analytics_zoo_tpu/ops/dropout.py``.  The mask is a hash of
(seed, flat element index), bit-identical to the JAX package's
single-multiply hash, so a seed gives the same mask in both packages and
the backward rebuilds it from the seed instead of saving it.  Seeds are
Python ints read as wrapping int32: the JAX package also folds PRNG keys
into seeds, and keys do not exist in the port, so ``as_seed`` takes an int
or None.  ``derive_seed`` splits a seed per site as the JAX one does, so a
model given the same int seed drops the same elements in both packages.

The hash is 32-bit unsigned arithmetic; torch has no uint32 arithmetic, so
it runs in int64 holding values in ``[0, 2**32)`` (see
``ops/attention.py``).  It is plain torch, as it is plain jnp in the JAX
package: no hand-written kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.ops._kernels import _as_i32
from analytics_zoo_tpu_torch.ops.attention import (
    _MIX_C1, _M32, _SEED_C, _dropout_thresh, _mix32, _mul32)

__all__ = ["as_seed", "derive_seed", "hash_dropout"]


def as_seed(rng_or_seed) -> Optional[int]:
    """The int32 seed of an int (wrapping), or None for None.  JAX PRNG
    keys, which the JAX version folds into a seed, do not exist here."""
    if rng_or_seed is None:
        return None
    if isinstance(rng_or_seed, bool) or not isinstance(
            rng_or_seed, (int, np.integer)):
        raise TypeError(f"a dropout seed is an int, got "
                        f"{type(rng_or_seed).__name__}")
    return _as_i32(rng_or_seed)


def derive_seed(rng_or_seed, salt: int) -> Optional[int]:
    """A decorrelated child seed, ``mix32(seed ^ salt * golden)`` in
    wrapping int32, as the JAX version; None stays None."""
    s = as_seed(rng_or_seed)
    if s is None:
        return None
    return _as_i32(_mix32((s & _M32) ^ _mul32(int(salt) & _M32, _SEED_C)))


def _mask(shape, seed: int, rate: float, device=None) -> torch.Tensor:
    """Boolean keep-mask of ``shape``: the JAX ``_mask`` bit for bit
    (``idx + seed * C``, two shift-left injections with wraparound, one
    multiply, logical right shifts)."""
    z = (torch.arange(math.prod(shape), dtype=torch.int64, device=device)
         + _mul32(seed & _M32, _SEED_C)) & _M32
    z = z ^ ((z << 9) & _M32)
    z = z ^ ((z << 11) & _M32)
    z = _mul32(z ^ (z >> 13), _MIX_C1)
    z = z ^ (z >> 15)
    return ((z >> 8) >= _dropout_thresh(rate)).reshape(shape)


def _apply(x, seed: int, rate: float):
    """``keep ? x / (1 - rate) : 0``, the scale rounded to x's dtype first
    as the JAX version's weakly typed constant is."""
    keep = _mask(x.shape, seed, rate, x.device)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, torch.zeros_like(scale))


class _HashDropout(torch.autograd.Function):
    """Saves only the seed; the backward rebuilds the mask from it."""

    @staticmethod
    def forward(ctx, x, seed, rate):
        ctx.seed, ctx.rate = seed, rate
        return _apply(x, seed, rate)

    @staticmethod
    def backward(ctx, dy):
        return _apply(dy, ctx.seed, ctx.rate), None, None


def hash_dropout(x, rate: float, rng=None, seed=None):
    """Drop elements of ``x`` with probability ``rate``; survivors scale by
    1/(1-rate).  The mask is a deterministic hash of (seed, element
    index); ``seed`` (or ``rng``, also an int here) picks it.  No-op when
    rate <= 0 or no seed is given."""
    if rate <= 0.0:
        return x
    s = as_seed(seed if seed is not None else rng)
    if s is None:
        return x
    return _HashDropout.apply(x, s, float(rate))
