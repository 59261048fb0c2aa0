"""Per-batch preprocessing chains that run on the host or inside the step.

Port of ``analytics_zoo_tpu/data/transforms.py``.  A ``Transforms`` chain
is one op list with two interpreters:

- ``apply_host(x)``: eager numpy, applied per batch inside the ingest
  pipeline (the unfused path).  Fires the ``transform_apply`` chaos point
  and feeds ``zoo_data_transform_eager_seconds_total``.
- ``apply_jax(x)``: the same ops as torch ops on the batch's own device,
  called by the estimator inside its step (eager steps, the step a CUDA
  graph captures, evaluate and predict), so the chain runs on the card
  beside the model.  It keeps the JAX name so code written against the
  JAX surface runs unchanged.  It reads nothing back to the host and
  copies nothing from it: ``normalize``'s constants reach the device once,
  on the first call (the estimator's warm-up step runs before a capture),
  and ``one_hot`` compares against an ``arange`` made on the device.

``fuse=True`` (default) marks the chain for the step: the ingest pipeline
then yields raw decoded batches and the estimator applies the chain.
``fuse=False`` applies it eagerly in the pipeline.  ``signature`` is the
chain's value identity; the estimator captures a new step when it changes.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.data.featureset import tree_map
from analytics_zoo_tpu_torch.testing import chaos

Tree = Any

_m_eager_s = obs.lazy_counter(
    "zoo_data_transform_eager_seconds_total",
    "host time spent applying eager (unfused) transform chains")


def _apply_field(x: Tree, field, fn: Callable):
    """``fn`` on one named / indexed field of a batch tree, or on every
    leaf when ``field`` is None."""
    if field is None:
        return tree_map(fn, x)
    if isinstance(x, dict):
        out = dict(x)
        out[field] = fn(x[field])
        return out
    if isinstance(x, (list, tuple)):
        items = list(x)
        items[int(field)] = fn(items[int(field)])
        return type(x)(items) if isinstance(x, tuple) else items
    raise ValueError(
        f"field={field!r} given but the batch is a bare array; use "
        "field=None")


def _torch_dtype(name: str) -> torch.dtype:
    return torch.bool if name == "bool" else getattr(torch, name)


class Transforms:
    """An ordered chain of per-batch ops with a host and an in-step
    interpreter.  Chainable builder::

        tf = (Transforms()
              .cast("int32", field="ids")
              .normalize(mean, std, field="pixels")
              .map(lambda a: a * 2.0 - 1.0, tag="rescale"))
    """

    def __init__(self, fuse: bool = True):
        self.fuse = bool(fuse)
        self._ops: list = []      # (name, field, params...)
        # normalize's constants on each device, made on first use
        self._consts: Dict[tuple, torch.Tensor] = {}

    # ---- builders ---------------------------------------------------------
    def normalize(self, mean, std, field=None) -> "Transforms":
        """Per-feature ``(x - mean) / std`` (broadcasting)."""
        self._ops.append(("normalize", field,
                          np.asarray(mean, np.float32),
                          np.asarray(std, np.float32)))
        return self

    def cast(self, dtype, field=None) -> "Transforms":
        self._ops.append(("cast", field, np.dtype(dtype).name))
        return self

    def one_hot(self, depth: int, field=None,
                dtype="float32") -> "Transforms":
        """Integer codes -> dense one-hot rows."""
        self._ops.append(("one_hot", field, int(depth),
                          np.dtype(dtype).name))
        return self

    def crop(self, oy: int, ox: int, h: int, w: int,
             field=None) -> "Transforms":
        """Static-offset crop of (B, H, W, C) batches."""
        self._ops.append(("crop", field, int(oy), int(ox), int(h),
                          int(w)))
        return self

    def map(self, fn: Callable, tag: str, field=None) -> "Transforms":
        """``fn`` sees numpy arrays on the host and torch tensors in the
        step: use operators and methods both define.  ``tag`` names the op
        in the chain's signature, so two chains with different functions
        under one tag are a caller bug."""
        self._ops.append(("map", field, str(tag), fn))
        return self

    # ---- signatures -------------------------------------------------------
    @property
    def signature(self) -> Tuple:
        """Value identity: op names, fields and static params (a map op
        contributes its tag)."""
        sig = [bool(self.fuse)]
        for op in self._ops:
            name, field = op[0], op[1]
            if name == "normalize":
                sig.append((name, field, op[2].tobytes(), op[3].tobytes()))
            elif name == "map":
                sig.append((name, field, op[2]))
            else:
                sig.append((name, field) + tuple(op[2:]))
        return tuple(sig)

    def __len__(self) -> int:
        return len(self._ops)

    # ---- interpreters -----------------------------------------------------
    def _run(self, x: Tree, normalize_fn, cast_fn, one_hot_fn) -> Tree:
        for i, op in enumerate(self._ops):
            name, field = op[0], op[1]
            if name == "normalize":
                fn = lambda a, i=i: normalize_fn(a, i)
            elif name == "cast":
                fn = lambda a, d=op[2]: cast_fn(a, d)
            elif name == "one_hot":
                fn = lambda a, d=op[2], t=op[3]: one_hot_fn(a, d, t)
            elif name == "crop":
                oy, ox, h, w = op[2:]
                fn = lambda a, y=oy, x0=ox, hh=h, ww=w: \
                    a[:, y:y + hh, x0:x0 + ww, :]
            else:  # map
                fn = op[3]
            x = _apply_field(x, field, fn)
        return x

    def apply_host(self, x: Tree) -> Tree:
        """Eager numpy interpretation (the unfused path).  Fires the
        ``transform_apply`` chaos point before touching the batch, so an
        injected fault never leaves a half-transformed batch behind."""
        chaos.fire("transform_apply")
        t0 = time.perf_counter()

        def normalize_np(a, i):
            return (a - self._ops[i][2]) / self._ops[i][3]

        def one_hot_np(a, depth, dt):
            return (np.asarray(a)[..., None] == np.arange(depth)).astype(dt)

        out = self._run(x, normalize_np, lambda a, d: a.astype(d),
                        one_hot_np)
        _m_eager_s.inc(time.perf_counter() - t0)
        return out

    def _const(self, i: int, j: int, device) -> torch.Tensor:
        key = (i, j, str(device))
        t = self._consts.get(key)
        if t is None:
            t = torch.from_numpy(self._ops[i][j]).to(device)
            self._consts[key] = t
        return t

    def apply_jax(self, x: Tree) -> Tree:
        """The chain as torch ops on each tensor's own device (the fused
        path, called inside the estimator's step)."""

        def normalize_t(a, i):
            return (a - self._const(i, 2, a.device)) \
                / self._const(i, 3, a.device)

        def one_hot_t(a, depth, dt):
            codes = torch.arange(depth, device=a.device, dtype=a.dtype)
            return (a[..., None] == codes).to(_torch_dtype(dt))

        return self._run(x, normalize_t,
                         lambda a, d: a.to(_torch_dtype(d)), one_hot_t)
