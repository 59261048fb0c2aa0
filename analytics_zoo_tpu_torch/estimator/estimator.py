"""The training engine: Estimator.train / evaluate / predict on one card.

Port of ``analytics_zoo_tpu/estimator/estimator.py`` without the mesh.  A
step is the JAX step (``estimator.py:352-361,437-482``) with nothing
sharded: the forward in training mode, the loss, ``backward`` (through
the attention kernels on the card), optional clipping by value or by
global norm, and the optimizer's in-place update.  PyTorch runs eagerly,
so there is no compiled step to cache.

``mixed_precision=True`` runs the forward and backward in
``compute_dtype`` (bf16) from the f32 master weights: each step casts the
weights with a differentiable ``.to`` and runs the model on the casts
(``torch.func.functional_call``), so the gradients reach the f32 masters
through the cast, and the optimizer state stays f32.

Dropout seeds: the JAX estimator folds a PRNG key per step, which the port
cannot reproduce.  Here step ``i`` of a run seeded with ``seed`` gets the
int seed ``derive_seed(seed, i)`` (``i`` the global step), and the model
derives its per-layer seeds from that as the JAX layers do.

Not ported (each raises ``NotImplementedError`` naming ROADMAP):
``steps_per_dispatch > 1`` (its counterpart on the card is a CUDA graph),
``grad_accum_steps > 1``, the sharded update and tensor parallelism,
``remat``, ``grad_dtype``, checkpoints, TensorBoard and ``resume``.
Validation during training runs ``evaluate`` at the epoch ends
``validation_trigger`` picks (default every epoch), as the JAX estimator
does: the history gains ``val_<name>`` entries and the trigger state's
``score`` is the first of them.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from analytics_zoo_tpu_torch.common.config import ZooConfig
from analytics_zoo_tpu_torch.common.context import resolve_device
from analytics_zoo_tpu_torch.common.unported import reject
from analytics_zoo_tpu_torch.common.triggers import (EveryEpoch, Trigger,
                                                     TriggerState)
from analytics_zoo_tpu_torch.data.featureset import tree_map
from analytics_zoo_tpu_torch.keras import losses as losses_mod
from analytics_zoo_tpu_torch.keras import metrics as metrics_mod
from analytics_zoo_tpu_torch.keras import optimizers as optim_mod
from analytics_zoo_tpu_torch.ops.dropout import as_seed, derive_seed

_ROADMAP = "not ported yet (ROADMAP Queue 1 item 2: training)"


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"Estimator {what} is {_ROADMAP}")


class Estimator:
    """Drives training, evaluation and prediction of a port model: an
    ``nn.Module`` called as ``model(x, seed=...)`` (``KerasNet``).  The
    model moves to ``device`` (default: the card; raises without one)."""

    def __init__(self, model, optimizer=None, loss=None,
                 metrics: Optional[List] = None,
                 config: Optional[ZooConfig] = None, device=None,
                 tensorboard_dir: Optional[str] = None,
                 app_name: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_trigger: Optional[Trigger] = None,
                 gradient_clip_norm: Optional[float] = None,
                 gradient_clip_value=None, remat: bool = False,
                 mixed_precision: bool = False, steps_per_dispatch: int = 1,
                 grad_dtype: Optional[str] = None,
                 shard_optimizer: Optional[bool] = None,
                 grad_accum_steps: Optional[int] = None,
                 shard_model: Optional[bool] = None):
        reject("Estimator", 2, app_name=app_name,
               checkpoint_trigger=checkpoint_trigger)
        config = config or ZooConfig()
        cfg = config.train
        accum = (cfg.grad_accum_steps if grad_accum_steps is None
                 else grad_accum_steps)
        for what, asked in (
                ("steps_per_dispatch > 1 (CUDA graphs on the card)",
                 int(steps_per_dispatch) > 1),
                ("grad_accum_steps > 1", int(accum) > 1),
                ("shard_optimizer", shard_optimizer or (
                    shard_optimizer is None and cfg.shard_optimizer)),
                ("shard_model", bool(shard_model)),
                ("remat", remat),
                ("grad_dtype", grad_dtype is not None),
                ("checkpoint_dir", bool(checkpoint_dir
                                        or cfg.checkpoint_dir)),
                ("tensorboard_dir", bool(tensorboard_dir))):
            if asked:
                raise _unported(what)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optimizer = optim_mod.get(optimizer) if optimizer else None
        self.loss = losses_mod.get(loss) if loss else None
        self.metrics = [metrics_mod.get(m) for m in (metrics or [])]
        self.clip_norm = gradient_clip_norm or cfg.gradient_clip_norm
        self.clip_value = gradient_clip_value or cfg.gradient_clip_value
        self.mixed_precision = mixed_precision
        self.compute_dtype = getattr(torch, config.compute_dtype)
        self.opt_state = None
        self.global_step = 0
        self.history: List[Dict[str, float]] = []

    # ---------------------------------------------------------------- train
    def _params(self) -> Dict[str, torch.Tensor]:
        return {n: p for n, p in self.model.named_parameters()
                if p.requires_grad}

    def _forward(self, x, seed: Optional[int]):
        if not self.mixed_precision:
            return self.model(x, seed=seed)
        dt = self.compute_dtype
        low = lambda t: t.to(dt) if t.is_floating_point() else t
        casts = {n: low(p) for n, p in self.model.named_parameters()}
        preds = functional_call(self.model, casts, (tree_map(low, x),),
                                {"seed": seed})
        return tree_map(lambda t: t.float() if t.is_floating_point() else t,
                        preds)

    def _train_step(self, x, y, seed: Optional[int]) -> torch.Tensor:
        """One optimizer step on batch ``(x, y)``; returns the loss as a
        device scalar (no host read)."""
        params = self._params()
        loss = self.loss(self._forward(x, seed), y)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        if self.clip_value is not None:
            lo, hi = (self.clip_value if isinstance(self.clip_value, tuple)
                      else (-self.clip_value, self.clip_value))
            for g in grads.values():
                g.clamp_(lo, hi)
        if self.clip_norm is not None:
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads.values()]))
            scale = torch.clamp(self.clip_norm / (norm + 1e-6), max=1.0)
            for g in grads.values():
                g.mul_(scale)
        self.optimizer.update(params, grads, self.opt_state)
        return loss.detach()

    def train(self, featureset, batch_size: int, epochs: int = 1,
              validation_data=None, validation_trigger=None,
              end_trigger: Optional[Trigger] = None,
              seed: Optional[int] = None, variables=None,
              resume: bool = False) -> List[Dict[str, float]]:
        """Train for ``epochs`` or until ``end_trigger`` fires; a later
        call continues the global step and the optimizer state.
        ``variables`` loads ``(params, state)`` in the JAX layout first.
        Returns ``history``: one ``{epoch, loss, seconds}`` per finished
        epoch, with ``val_<name>`` where it was validated."""
        if self.optimizer is None or self.loss is None:
            raise RuntimeError("Estimator needs optimizer and loss to train")
        if resume:
            raise _unported("resume")
        if variables is not None:
            self.model.set_weights(variables)
        if self.opt_state is None:
            self.opt_state = self.optimizer.init(self._params())
        base = as_seed(seed) if seed is not None else 0
        validation_trigger = validation_trigger or EveryEpoch()
        self.model.train()
        try:
            for epoch in range(epochs):
                if self._run_epoch(featureset, batch_size, epoch, base,
                                   validation_data, validation_trigger,
                                   end_trigger):
                    break
        finally:
            self.model.eval()
        return self.history

    def _run_epoch(self, featureset, batch_size, epoch, base,
                   validation_data, validation_trigger, end_trigger) -> bool:
        """Returns True when the end trigger fired."""
        losses = []
        t_epoch = time.perf_counter()
        for x, y in featureset.batches(batch_size, epoch=epoch,
                                       device=self.device):
            losses.append(self._train_step(
                x, y, derive_seed(base, self.global_step)))
            self.global_step += 1
            ts = TriggerState(epoch=epoch + 1, iteration=self.global_step)
            if end_trigger is not None and end_trigger(ts):
                return True
        # one host read per epoch: the mean of its step losses
        mean_loss = (float(torch.stack(losses).mean()) if losses
                     else float("nan"))
        entry = {"epoch": epoch + 1, "loss": mean_loss,
                 "seconds": time.perf_counter() - t_epoch}
        ts = TriggerState(epoch=epoch + 1, iteration=self.global_step,
                          epoch_finished=True, loss=mean_loss)
        if validation_data is not None and validation_trigger(ts):
            scores = self.evaluate(validation_data, batch_size)
            self.model.train()
            entry.update({f"val_{k}": v for k, v in scores.items()})
            ts.score = next(iter(scores.values()), None)
        self.history.append(entry)
        return bool(end_trigger is not None and end_trigger(ts))

    # ----------------------------------------------------------- eval/infer
    def evaluate(self, featureset, batch_size: int = 32,
                 variables=None) -> Dict[str, float]:
        """Metrics (and the mean loss) over the whole dataset, in order,
        the ragged tail included."""
        if variables is not None:
            self.model.set_weights(variables)
        self.model.eval()
        accs = [m.init() for m in self.metrics]
        loss_sum, n_total = 0.0, 0
        with torch.inference_mode():
            for x, y, n in featureset.batches_with_counts(
                    batch_size, drop_remainder=False, device=self.device):
                preds = self.model(x)
                accs = [m.update(a, preds, y)
                        for m, a in zip(self.metrics, accs)]
                if self.loss is not None:
                    loss_sum = loss_sum + self.loss(preds, y) * n
                n_total += n
        out = {m.name: m.result(a) for m, a in zip(self.metrics, accs)}
        if self.loss is not None and n_total:
            out["loss"] = float(loss_sum) / n_total
        return out

    def predict(self, featureset, batch_size: int = 32, variables=None):
        """The model's outputs over the dataset, in order, as numpy."""
        if variables is not None:
            self.model.set_weights(variables)
        self.model.eval()
        outs = []
        with torch.inference_mode():
            for x, _, _ in featureset.batches_with_counts(
                    batch_size, drop_remainder=False, device=self.device):
                outs.append(tree_map(lambda t: t.float().cpu().numpy(),
                                     self.model(x)))
        if not outs:
            return None
        if isinstance(outs[0], np.ndarray):
            return np.concatenate(outs)
        return [np.concatenate(parts) for parts in zip(*outs)]
