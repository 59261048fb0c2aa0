"""LocalEstimator: training on in-memory arrays, one device, no FeatureSet.

Port of ``analytics_zoo_tpu/estimator/local_estimator.py``: ``fit`` /
``evaluate`` / ``predict`` over ``(x, y)`` arrays (x an array or a list of
arrays), an eager step a batch on the device the model's weights are on.
The batch order is the JAX one (``_as_batches``: epoch ``e`` shuffled by
``np.random.RandomState(e)``, the ragged tail dropped in training), and
``history`` holds one ``{"epoch", "loss"}`` per epoch (with ``val_<name>``
when ``validation_data`` is given).

The model keeps its weights: a port model is built with weights (or is
built from a sample batch when it still waits for its input's shape), so
``fit`` adopts them and trains them in place, and ``params`` / ``state``
read them in the JAX tree layout.  The optimizer state lives across
``fit`` calls.  ``optmethod`` takes what the port's optimizers take: a
registry string or an ``Optimizer`` object; a ``torch.optim`` instance, a
tf.keras optimizer or a per-name dict is the conversion of ``net/``
(ROADMAP Queue 1 item 6).  Dropout draws from an int ``seed`` (default 0)
derived per step, since the JAX ``PRNGKey`` stream cannot be reproduced;
with dropout off a trajectory equals the JAX one.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.unported import QUEUE_ITEMS
from analytics_zoo_tpu_torch.data.featureset import to_device
from analytics_zoo_tpu_torch.estimator.estimator import grads_of
from analytics_zoo_tpu_torch.interop import params_tree, state_tree
from analytics_zoo_tpu_torch.keras import losses as _losses
from analytics_zoo_tpu_torch.keras import metrics as _metrics
from analytics_zoo_tpu_torch.keras import optimizers as _optim
from analytics_zoo_tpu_torch.keras.engine import _seeded
from analytics_zoo_tpu_torch.ops.dropout import as_seed, derive_seed

__all__ = ["LocalEstimator"]


def _rows(x) -> int:
    return x[0].shape[0] if isinstance(x, (list, tuple)) else x.shape[0]


def _as_batches(x, y, batch_size: int, shuffle: bool, seed: int,
                drop_remainder: bool = True) -> Iterator[Tuple]:
    n = _rows(x)
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    last = n - batch_size + 1 if drop_remainder else n
    for s in range(0, last, batch_size):
        sel = idx[s:s + batch_size]
        bx = ([a[sel] for a in x] if isinstance(x, (list, tuple))
              else x[sel])
        yield bx, (y[sel] if y is not None else None)


def _to_optimizer(opt) -> _optim.Optimizer:
    """``net/utils.py`` ``to_optax`` for what the port has: registry
    strings and the port's ``Optimizer`` objects."""
    if isinstance(opt, (str, _optim.Optimizer)):
        return _optim.get(opt)
    mod = type(opt).__module__ or ""
    if (isinstance(opt, dict) or mod.startswith(("torch", "tensorflow",
                                                  "keras"))
            or hasattr(opt, "get_config")):
        raise NotImplementedError(
            f"LocalEstimator(optmethod={type(opt).__name__}) is not ported "
            f"yet ({QUEUE_ITEMS[6]})")
    raise ValueError(f"We don't support {opt!r} for now")


def _shape_of(sample):
    """The ``input_shape`` of a sample batch, as ``_init_from_batch``
    derives it."""
    shape = lambda a: (None,) + tuple(np.asarray(a).shape[1:])
    if isinstance(sample, (list, tuple)):
        shapes = [shape(a) for a in sample]
        return shapes[0] if len(shapes) == 1 else shapes
    return shape(sample)


class LocalEstimator:
    """Train / evaluate / predict on in-memory arrays, on one device."""

    def __init__(self, model, criterion="mse", optmethod="sgd",
                 metrics: Optional[Sequence] = None):
        self.model = model
        self.loss = (_losses.get(criterion) if not callable(criterion)
                     else criterion)
        self.optimizer = _to_optimizer(optmethod)
        self.metrics = [_metrics.get(m) for m in (metrics or [])]
        self.opt_state = None
        self.history: List[Dict[str, float]] = []
        self._steps = 0

    @property
    def params(self) -> dict:
        """The model's parameters in the JAX tree layout (numpy)."""
        return params_tree(self.model)

    @property
    def state(self) -> dict:
        """The model's buffers (the JAX ``state``) in the same layout."""
        return state_tree(self.model)

    def _device(self) -> torch.device:
        for t in self.model.parameters():
            return t.device
        return getattr(self.model, "device", None) or torch.device("cpu")

    def _trainable(self) -> Dict[str, torch.Tensor]:
        return {n: p for n, p in self.model.named_parameters()
                if p.requires_grad}

    def _forward(self, x, seed=None):
        if seed is not None and _seeded(self.model):
            return self.model(x, seed=seed)
        return self.model(x)

    # ------------------------------------------------------------------ fit
    def fit(self, train_data: Tuple, batch_size: int, epochs: int = 1,
            validation_data: Optional[Tuple] = None,
            seed: Optional[int] = None,
            shuffle: bool = True) -> List[Dict[str, float]]:
        """``train_data`` / ``validation_data`` are ``(x, y)`` with x an
        ndarray or a list of ndarrays."""
        x, y = train_data
        n = _rows(x)
        if batch_size > n:
            raise ValueError(
                f"batch_size {batch_size} exceeds dataset size {n}")
        if not getattr(self.model, "built", True):
            sample = next(_as_batches(x, y, min(batch_size, 2), False, 0))[0]
            self.model.init(input_shape=_shape_of(sample))
        dev = self._device()
        params = self._trainable()
        if self.opt_state is None:
            self.opt_state = self.optimizer.init(params)
        seed = as_seed(seed) if seed is not None else 0
        for epoch in range(epochs):
            losses = []
            self.model.train()
            try:
                for bx, by in _as_batches(x, y, batch_size, shuffle, epoch):
                    losses.append(self._step(
                        params, to_device(bx, dev), to_device(by, dev),
                        derive_seed(seed, self._steps)))
                    self._steps += 1
            finally:
                self.model.eval()
            rec = {"epoch": epoch,
                   "loss": float(torch.stack(losses).mean())
                   if losses else float("nan")}
            if validation_data is not None:
                rec.update({f"val_{k}": v for k, v in
                            self.evaluate(validation_data,
                                          batch_size).items()})
            self.history.append(rec)
        return self.history

    def _step(self, params, bx, by, seed) -> torch.Tensor:
        """One optimizer step; the loss as a device scalar."""
        loss = self.loss(self._forward(bx, seed), by)
        grads = grads_of(loss, list(params.values()))
        self.optimizer.update(params, dict(zip(params, grads)),
                              self.opt_state)
        return loss.detach()

    # ------------------------------------------------------------ evaluate
    def evaluate(self, data: Tuple, batch_size: int) -> Dict[str, float]:
        """The mean of the batches' losses (the ragged tail a batch of its
        own) and the metrics over every row."""
        x, y = data
        dev = self._device()
        losses: List[float] = []
        accs = [m.init() for m in self.metrics]
        self.model.eval()
        with torch.inference_mode():
            for bx, by in _as_batches(x, y, batch_size, False, 0,
                                      drop_remainder=False):
                preds = self.model(to_device(bx, dev))
                by = to_device(by, dev)
                losses.append(float(self.loss(preds, by)))
                accs = [m.update(a, preds, by)
                        for m, a in zip(self.metrics, accs)]
        out = {"loss": float(np.mean(losses))}
        out.update({m.name: m.result(a)
                    for m, a in zip(self.metrics, accs)})
        return out

    # ------------------------------------------------------------- predict
    def predict(self, x, batch_size: int = 256) -> np.ndarray:
        dev = self._device()
        outs = []
        self.model.eval()
        with torch.inference_mode():
            for bx, _ in _as_batches(x, None, min(batch_size, _rows(x)),
                                     False, 0, drop_remainder=False):
                outs.append(self.model(to_device(bx, dev)).float().cpu()
                            .numpy())
        return np.concatenate(outs)
