"""The training engine: Estimator.train / evaluate / predict on one card.

Port of ``analytics_zoo_tpu/estimator/estimator.py`` without the mesh.  A
step is the JAX step (``estimator.py:352-482``) with nothing sharded: the
forward in training mode, the loss, the gradients (through the attention
kernels on the card), optional clipping by value or by global norm, and
the optimizer's in-place update.

``mixed_precision=True`` runs the forward and backward in
``compute_dtype`` (bf16): a bf16 shadow of the f32 master weights is
refreshed at the start of every step and the model runs on it
(``torch.func.functional_call``); the gradients are taken with respect to
the shadow, as the JAX step takes them with respect to its bf16 params,
and are widened to f32 for the optimizer, or stay bf16 up to it with
``grad_dtype="bfloat16"``.  ``grad_accum_steps=N`` splits each batch into
N microbatches in order and averages their gradients in an f32 (or the
parameters') accumulator; ``remat=True`` recomputes the forward in the
backward (``torch.utils.checkpoint``), and the hash dropout recomputes the
same mask.

Multi-step dispatch.  Everything a step reads lives on the card: the
weights, the optimizer state with its step count, a device step counter
the per-step dropout seed derives from (``derive_seed(seed, step)``, as
the JAX step folds its key with its step), the batch (gathered from the
DEVICE tier through a device cursor, or copied into static buffers from
the host tier) and a device slot the loss is written to.  So with
``steps_per_dispatch=K`` on the card one whole step is captured once as a
CUDA graph (``torch.cuda.CUDAGraph``) after a discarded warm-up step on a
side stream, and a dispatch is that graph replayed: K times for a host
group, or for the DEVICE tier as many steps as ``_plan_chain`` allows, up
to the next step a trigger could fire at (``TrainConfig.
max_steps_per_dispatch`` at most).  Triggers, checkpoints, validation and
TensorBoard then act at the dispatch ends the JAX estimator acts at
(``_fires_in_range``, ``_post_dispatch``).  A failed capture raises; it
never falls back to eager steps.  On the CPU (the tests) the same K steps
run one after another with the same device-tensor seeds and count; with
K = 1 every step is an eager step.  The launch counts of the kernel
wrappers count replays (``ops._kernels.recording`` / ``replayed``).

A step repeats bit for bit on the card: the embedding lookups sum their
gradients in a fixed order (``keras/layers/embedding.py`` ``gather_rows``)
and cuDNN runs its deterministic algorithms during the step.

Checkpoints (``checkpoint_dir`` / ``checkpoint_trigger`` /
``keep_checkpoints``) write ``(params, opt_state, state, meta)`` with the
epoch and the data cursor; ``train(resume=True)`` and the retry after a
failed epoch (``TrainConfig.failure_retry_times``, ``RetryPolicy``
backoff, single process) restore the latest one with ``copy_`` into the
tensors a captured graph reads.  ``tensorboard_dir`` / ``app_name`` write
the loss, throughput and learning rate per K-group of every dispatch.
Validation runs ``evaluate`` at the epoch ends ``validation_trigger``
picks (default every epoch).

Dropout seeds: the JAX estimator folds a PRNG key per step, which the port
cannot reproduce.  Here step ``i`` of a run seeded with ``seed`` gets
``derive_seed(seed, i)`` (``i`` the global step), computed on the device
from the device step counter when K > 1 and as a host int when K = 1 (the
same value), and the model derives its per-layer seeds from that as the
JAX layers do.

Observability, as in the JAX estimator: the ``zoo_train_*`` /
``zoo_estimator_*`` series (``zoo_train_loss`` from the epoch's one host
read, never a per-dispatch read), the spans ``train.epoch``,
``train.step`` (one dispatch: K graph replays or K eager steps, opened and
closed on the host around them, never inside a capture),
``train.retry``, ``train.checkpoint`` and ``train.prefetch`` (the host
tier's feed thread, which hands host batches to the loop), the step
timer as ``zoo_train_seconds{name="train_step"}``, and the
``train_state`` pool on the device-memory ledger (parameter and optimizer
bytes counted once from the tensors when training starts).

Not ported: the sharded update and tensor parallelism (``shard_optimizer``,
``shard_model``: ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
from concurrent.futures import CancelledError
from dataclasses import replace
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint as _remat

from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common.config import ZooConfig
from analytics_zoo_tpu_torch.common.context import resolve_device
from analytics_zoo_tpu_torch.common.resilience import RetryPolicy
from analytics_zoo_tpu_torch.common.timer import Timers
from analytics_zoo_tpu_torch.common.triggers import (EveryEpoch, Trigger,
                                                     TriggerState)
from analytics_zoo_tpu_torch.common.unported import QUEUE_ITEMS
from analytics_zoo_tpu_torch.data.featureset import tree_leaves, tree_map
from analytics_zoo_tpu_torch.estimator.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint)
from analytics_zoo_tpu_torch.keras import losses as losses_mod
from analytics_zoo_tpu_torch.keras import metrics as metrics_mod
from analytics_zoo_tpu_torch.keras import optimizers as optim_mod
from analytics_zoo_tpu_torch.keras.layers.normalization import recomputing
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops.dropout import as_seed, derive_seed

logger = logging.getLogger("analytics_zoo_tpu_torch.estimator")

# registry series: per-DISPATCH cost only, and no record reads a CUDA
# tensor (the loss gauge is set from the epoch's one host read)
_m_steps = obs.lazy_counter("zoo_train_steps_total",
                            "optimizer steps run")
_m_epochs = obs.lazy_counter("zoo_train_epochs_total",
                             "epochs completed")
_m_sps = obs.lazy_gauge("zoo_train_samples_per_sec",
                        "training throughput over the last epoch")
_m_loss = obs.lazy_gauge("zoo_train_loss", "mean loss of the last epoch")
_m_data_wait = obs.lazy_counter(
    "zoo_train_data_wait_seconds_total",
    "time the train loop spent blocked on the input pipeline")
_m_opt_bytes = obs.lazy_gauge(
    "zoo_estimator_opt_state_bytes_per_device",
    "per-device optimizer-state bytes after placement (the ZeRO-sharded "
    "update shrinks this ~dp-fold)")
_m_accum = obs.lazy_gauge(
    "zoo_train_accum_microbatches",
    "gradient-accumulation fill: microbatches per optimizer step")
_m_weight_bytes = obs.lazy_gauge(
    "zoo_estimator_weight_bytes_per_device",
    "per-device parameter bytes after placement (tensor-parallel "
    "2D-mesh training shrinks this ~mp-fold vs replicated)")
_m_mesh = obs.lazy_gauge(
    "zoo_train_mesh_shape",
    "training mesh axis sizes (one series per axis)", ("axis",))


class GraphCaptureError(RuntimeError):
    """Capturing the training step as a CUDA graph failed (never retried,
    never replaced by eager steps)."""


#: failures the retry loop re-raises at once: interrupts, the card's own
#: faults (a refused launch, a failed build or capture, no memory)
_NOT_RETRIED = (KeyboardInterrupt, torch.cuda.OutOfMemoryError,
                _kernels.KernelBuildError, _kernels.KernelLaunchError,
                GraphCaptureError)


class _Source:
    """Where a step reads its batch: ``rows`` batches stacked on a leading
    axis (the resident DEVICE-tier epoch, or the static buffers a host
    group is copied into), the order to read them in (``ids``, on the
    device) and the device cursor into that order, which each step
    advances and wraps."""

    def __init__(self, xs, ys, rows: int, ids: torch.Tensor):
        self.xs, self.ys, self.rows, self.ids = xs, ys, rows, ids


class _CapturedStep:
    """One training step captured as a CUDA graph.  A discarded warm-up
    step runs first on a side stream (kernel builds and loads, cuBLAS
    handles, lazy module loading), its effect on the training state undone
    by copying the state back; the capture launches nothing either.  Each
    replay runs the whole step and adds the launches the capture
    recorded to the kernel wrappers' counts.  ``src`` is the source the
    step reads: the graph holds it, so the addresses it replays stay
    alive, and it is replayed only for that same source."""

    def __init__(self, body, state_tensors, src: _Source):
        self.src = src
        saved = [t.detach().clone() for t in state_tensors]
        try:
            with _kernels.recording():
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    body()
                torch.cuda.current_stream().wait_stream(side)
            with torch.no_grad():
                for t, s in zip(state_tensors, saved):
                    t.copy_(s)
            del saved
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            self.record: Dict[str, tuple] = {}
            self.graph = torch.cuda.CUDAGraph()
            with _kernels.recording(self.record):
                with torch.cuda.graph(self.graph):
                    body()
        except Exception as exc:
            raise GraphCaptureError(
                f"capturing the training step as a CUDA graph failed: "
                f"{type(exc).__name__}: {exc}") from exc

    def replay(self, n: int) -> None:
        for _ in range(n):
            self.graph.replay()
        _kernels.replayed(self.record, n)


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
        config = config or ZooConfig()
        cfg = config.train
        for what, asked in (
                ("shard_optimizer", shard_optimizer or (
                    shard_optimizer is None and cfg.shard_optimizer)),
                ("shard_model", bool(shard_model))):
            if asked:
                raise NotImplementedError(
                    f"Estimator({what}=...) is not ported yet "
                    f"({QUEUE_ITEMS[5]})")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optimizer = optim_mod.get(optimizer) if optimizer else None
        self.loss = losses_mod.get(loss) if loss else None
        self.metrics = [metrics_mod.get(m) for m in (metrics or [])]
        self.checkpoint_dir = checkpoint_dir or cfg.checkpoint_dir
        self.checkpoint_trigger = checkpoint_trigger or EveryEpoch()
        self.clip_norm = gradient_clip_norm or cfg.gradient_clip_norm
        self.clip_value = gradient_clip_value or cfg.gradient_clip_value
        self.retry_times = cfg.failure_retry_times
        # the JAX loop's retry discipline: decorrelated-jitter backoff
        # between checkpoint restores; CancelledError included
        self._retry_policy = RetryPolicy(
            max_retries=self.retry_times, base_s=0.1, cap_s=5.0,
            retry_on=(Exception, CancelledError), scope="estimator")
        self.keep_checkpoints = cfg.keep_checkpoints
        self.max_steps_per_dispatch = cfg.max_steps_per_dispatch
        self.tensorboard_dir = tensorboard_dir
        self.app_name = app_name or "zoo"
        # step times land in the registry as
        # zoo_train_seconds{name="train_step"} histogram series
        self.timers = Timers(metrics_prefix="zoo_train")
        self._prefetch_depth = int(config.data.prefetch)
        # one card: every mesh axis of the JAX layout has size 1
        self._mesh_axes = tuple(config.mesh.axis_names)
        self.remat = remat
        self.mixed_precision = mixed_precision
        self.compute_dtype = getattr(torch, config.compute_dtype)
        # bf16 gradients up to the optimizer: mixed precision only
        self.grad_dtype = grad_dtype
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        self.grad_accum_steps = max(1, int(
            cfg.grad_accum_steps if grad_accum_steps is None
            else grad_accum_steps))
        self.opt_state = None
        self.global_step = 0
        self.history: List[Dict[str, float]] = []
        # device state of the step, allocated once (a graph reads it)
        self._p16: Optional[Dict[str, torch.Tensor]] = None
        self._step_dev: Optional[torch.Tensor] = None
        self._seed = 0
        self._seed_dev: Optional[torch.Tensor] = None
        self._cursor: Optional[torch.Tensor] = None
        self._slot: Optional[torch.Tensor] = None
        self._loss_buf: Optional[torch.Tensor] = None
        self._host_src: Dict[tuple, _Source] = {}
        self._graph = None
        self._resume_cursor = None
        self._epoch_step0 = 0

    @contextlib.contextmanager
    def _step_scope(self, n: int):
        """One dispatch (n steps): span + timer, both feeding the
        registry.  Opened and closed on the host around the launches (or
        graph replays), so nothing of it is captured."""
        with obs.span("train.step", steps=n):
            with self.timers.time("train_step"):
                yield

    # ------------------------------------------------------------ the step
    def _params(self) -> Dict[str, torch.Tensor]:
        return {n: p for n, p in self.model.named_parameters()
                if p.requires_grad}

    @property
    def _graphs_on(self) -> bool:
        """Whether dispatches replay a captured step (K > 1 on the card)."""
        return self.steps_per_dispatch > 1 and self.device.type == "cuda"

    def _forward(self, p_fwd, x, seed):
        """Predictions in f32 from the weights ``p_fwd`` (the masters, or
        their bf16 shadow under mixed precision)."""
        if not self.mixed_precision:
            return self.model(x, seed=seed)
        dt = self.compute_dtype
        low = lambda t: t.to(dt) if t.is_floating_point() else t
        preds = functional_call(self.model, p_fwd, (tree_map(low, x),),
                                {"seed": seed})
        return tree_map(lambda t: t.float() if t.is_floating_point() else t,
                        preds)

    def _grads(self, p_fwd, x, y, seed):
        """One microbatch's loss and its raw gradients w.r.t. ``p_fwd``."""
        if self.remat:
            # the hash dropout recomputes the same mask; no RNG state to
            # keep (none is drawn)
            preds = _remat(lambda xx: self._forward(p_fwd, xx, seed), x,
                           use_reentrant=False, preserve_rng_state=False,
                           context_fn=_remat_contexts)
        else:
            preds = self._forward(p_fwd, x, seed)
        loss = self.loss(preds, y)
        return loss, grads_of(loss, list(p_fwd.values()))

    def _cast_grads(self, grads):
        if not self.mixed_precision:
            return grads
        dt = (getattr(torch, self.grad_dtype) if self.grad_dtype is not None
              else torch.float32)
        return [g.to(dt) if g.is_floating_point() else g for g in grads]

    def _accum_grads(self, p_fwd, x, y, seed):
        """Microbatches in order, their gradients summed in an f32 (under
        mixed precision) or the parameters' accumulator and averaged,
        then cast once; the loss is their mean."""
        n = self.grad_accum_steps
        split = lambda a: a.reshape((n, a.shape[0] // n) + a.shape[1:])
        xs, ys = tree_map(split, x), tree_map(split, y)
        acc, losses = None, []
        for j in range(n):
            pick = lambda a: a[j]
            lv, g = self._grads(p_fwd, tree_map(pick, xs), tree_map(pick, ys),
                                None if seed is None
                                else derive_seed(seed, j))
            losses.append(lv.detach())
            if acc is None:
                acc = [torch.zeros_like(
                    t, dtype=torch.float32 if self.mixed_precision
                    and t.is_floating_point() else t.dtype) for t in g]
            torch._foreach_add_(acc, [t.to(a.dtype) for t, a in zip(g, acc)])
        torch._foreach_div_(acc, float(n))
        return torch.stack(losses).mean(), self._cast_grads(acc)

    def _train_step(self, x, y, seed) -> torch.Tensor:
        """One optimizer step on batch ``(x, y)``; returns the loss as a
        device scalar (no host read)."""
        params = self._params()
        if self.mixed_precision:
            with torch.no_grad():
                for n, p in params.items():
                    self._p16[n].copy_(p)
            p_fwd = self._p16
        else:
            p_fwd = params
        if self.grad_accum_steps > 1:
            loss, grads = self._accum_grads(p_fwd, x, y, seed)
        else:
            loss, grads = self._grads(p_fwd, x, y, seed)
            grads = self._cast_grads(grads)
        with torch.no_grad():
            if self.clip_value is not None:
                lo, hi = (self.clip_value
                          if isinstance(self.clip_value, tuple)
                          else (-self.clip_value, self.clip_value))
                for g in grads:
                    g.clamp_(lo, hi)
            if self.clip_norm is not None:
                norm = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(g.float()) for g in grads]))
                scale = torch.clamp(self.clip_norm / (norm + 1e-6), max=1.0)
                torch._foreach_mul_(grads, scale)
        self.optimizer.update(params, dict(zip(params, grads)),
                              self.opt_state)
        return loss.detach()

    def _step_from(self, src: _Source) -> None:
        """One step reading its batch through the device cursor: the
        gather, the seed from the device step counter, the step, and the
        loss into the next device slot.  Nothing is read on the host, so
        this is what a CUDA graph captures."""
        j = src.ids.index_select(0, self._cursor.reshape(1))
        take = lambda a: a.index_select(0, j)[0]
        x, y = tree_map(take, src.xs), tree_map(take, src.ys)
        with torch.no_grad():
            self._cursor.add_(1).remainder_(src.rows)
        # K > 1: the seed derives on the device from the device step
        # counter (what a replay must read anew); K = 1 runs every step
        # eagerly with the host's step count and derives the same value
        # as an int, without the launches of a device derivation
        seed = (derive_seed(self._seed_dev, self._step_dev)
                if self.steps_per_dispatch > 1
                else derive_seed(self._seed, self.global_step))
        with _deterministic_cudnn():
            loss = self._train_step(x, y, seed)
        with torch.no_grad():
            self._step_dev.add_(1)
            self._loss_buf.index_copy_(0, self._slot.reshape(1),
                                       loss.float().reshape(1))
            self._slot.add_(1)

    def _state_tensors(self) -> List[torch.Tensor]:
        """Every tensor a step changes (what a warm-up step restores)."""
        out = [p.data for p in self.model.parameters()]
        out += [b for b in self.model.buffers()]
        out += _opt_tensors(self.opt_state)
        out += [self._step_dev, self._cursor, self._slot, self._loss_buf]
        return out

    def _run_steps(self, n: int, src: _Source) -> torch.Tensor:
        """``n`` steps from ``src`` as one dispatch: ``n`` replays of the
        captured step on the card (K > 1), else ``n`` eager steps.
        Returns their losses, an ``(n,)`` device tensor."""
        self._slot.zero_()
        if self._graphs_on:
            if self._graph is None or self._graph.src is not src:
                self._graph = None          # one graph (its pool) at a time
                torch.cuda.empty_cache()
                self._graph = _CapturedStep(lambda: self._step_from(src),
                                            self._state_tensors(), src)
            self._graph.replay(n)
        else:
            for _ in range(n):
                self._step_from(src)
        return self._loss_buf[:n].clone()

    def _prepare(self, seed) -> None:
        """Allocate the step's device state before any capture: optimizer
        state, the bf16 shadow, counters, the loss slots."""
        dev = self.device
        if self.opt_state is None:
            self.opt_state = self.optimizer.init(self._params())
        if self.mixed_precision and self._p16 is None:
            self._p16 = {n: p.detach().to(self.compute_dtype)
                         .requires_grad_() for n, p in self._params().items()}
        if self._step_dev is None:
            zero = lambda dt: torch.zeros((), dtype=dt, device=dev)
            self._step_dev = zero(torch.int64)
            self._seed_dev = zero(torch.int32)
            self._cursor = zero(torch.int64)
            self._slot = zero(torch.int64)
            k = self.steps_per_dispatch
            cap = max(k, (int(self.max_steps_per_dispatch) // k) * k)
            self._loss_buf = torch.zeros(cap, dtype=torch.float32,
                                         device=dev)
        self._step_dev.fill_(self.global_step)
        self._seed = as_seed(seed) if seed is not None else 0
        self._seed_dev.fill_(self._seed)

    def _register_memory_pool(self) -> None:
        """The ``train_state`` pool of the device-memory ledger: weight +
        optimizer-state bytes (``numel * element_size`` of the tensors),
        counted ONCE here and kept as plain ints, so the ledger's sampler
        and scrape threads never touch a tensor.  The per-device byte
        gauges are views routed through the ledger.  Train state is all
        pinned: nothing in it is evictable."""
        nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
        params = list(self.model.parameters())
        opt_ts = _opt_tensors(self.opt_state)
        weights, opt = int(nbytes(params)), int(nbytes(opt_ts))
        blocks = len(params) + len(opt_ts)
        devs = obs.device_memory_stats()
        capacity = int(devs[0].get("bytes_limit", 0)) if devs else 0
        job = self.app_name
        books = {f"{job}/weights": weights, f"{job}/opt_state": opt}

        def snap(books=books, capacity=capacity, blocks=blocks):
            used = sum(books.values())
            return {"capacity_bytes": capacity, "used_bytes": used,
                    "pinned_bytes": used, "blocks": blocks,
                    "owners": dict(books)}

        self._mem_pool = obs.get_memory_ledger().register(
            "train_state", snap, owner=self,
            gauges=((_m_weight_bytes, lambda s, w=weights: w),
                    (_m_opt_bytes, lambda s, o=opt: o)))

    # ---------------------------------------------------------------- train
    def train(self, featureset, batch_size: int, epochs: int = 1,
              validation_data=None, validation_trigger=None,
              end_trigger: Optional[Trigger] = None,
              seed: Optional[int] = None, variables=None,
              resume: bool = False) -> List[Dict[str, float]]:
        """Train for ``epochs`` or until ``end_trigger`` fires; a later
        call continues the global step and the optimizer state.
        ``variables`` loads ``(params, state)`` in the JAX layout first;
        ``resume`` restores the latest checkpoint of ``checkpoint_dir``
        (weights, optimizer state, step, epoch).  Returns ``history``: one
        ``{epoch, loss, seconds}`` per finished epoch, with
        ``val_<name>`` where it was validated."""
        if self.optimizer is None or self.loss is None:
            raise RuntimeError("Estimator needs optimizer and loss to train")
        if batch_size % self.grad_accum_steps:
            raise ValueError(
                f"batch_size {batch_size} must divide by grad_accum_steps "
                f"= {self.grad_accum_steps}")
        if variables is not None:
            self.model.set_weights(variables)
        self._prepare(seed)
        self._register_memory_pool()
        _m_accum.set(float(self.grad_accum_steps))
        for ax in self._mesh_axes:
            _m_mesh.labels(axis=ax).set(1.0)
        start_epoch = 0
        if resume and self.checkpoint_dir:
            ck = latest_checkpoint(self.checkpoint_dir)
            if ck:
                meta = self._restore(ck)
                start_epoch = int(meta["epoch"])
                self._resume_cursor = meta.get("data_cursor")
                logger.info("resumed from %s (step %d, epoch %d)", ck,
                            self.global_step, start_epoch)
        validation_trigger = validation_trigger or EveryEpoch()
        # a step-0 checkpoint makes the retry loop survivable before the
        # first trigger-driven checkpoint lands
        if self.checkpoint_dir and latest_checkpoint(
                self.checkpoint_dir) is None:
            self._maybe_checkpoint(start_epoch)
        tb = None
        if self.tensorboard_dir:
            from analytics_zoo_tpu_torch.tensorboard import TrainSummary
            tb = TrainSummary(self.tensorboard_dir, self.app_name)
        self.model.train()
        try:
            self._train_loop(featureset, batch_size, epochs, start_epoch,
                             self._retry_policy.new_state(), tb,
                             validation_data, validation_trigger,
                             end_trigger)
        finally:
            self.model.eval()
            if tb:
                tb.close()
        return self.history

    def _train_loop(self, featureset, batch_size, epochs, start_epoch,
                    retry, tb, validation_data, validation_trigger,
                    end_trigger) -> bool:
        epoch, stop = start_epoch, False
        esp = None
        while epoch < epochs and not stop:
            try:
                with obs.span("train.epoch", epoch=epoch) as esp:
                    stop = self._run_epoch(
                        featureset, batch_size, epoch, epochs, tb,
                        validation_data, validation_trigger, end_trigger)
                epoch += 1
            except _NOT_RETRIED:
                raise
            except (Exception, CancelledError) as exc:
                ck = (latest_checkpoint(self.checkpoint_dir)
                      if self.checkpoint_dir else None)
                if ck is None or not retry.should_retry(exc):
                    raise
                logger.warning("training failed (%s); retry %d/%d from the "
                               "latest checkpoint after backoff", exc,
                               retry.attempts, self.retry_times)
                # joined to the epoch it recovers: the failed epoch span
                # (closed, error recorded) is this span's parent, so the
                # trace reads failure → backoff → restore
                with obs.span("train.retry", parent=esp,
                              attempt=retry.attempts,
                              error=f"{type(exc).__name__}: {exc}"[:200]):
                    retry.backoff()
                    meta = self._restore(ck)
                    epoch = int(meta["epoch"])
                    self._resume_cursor = meta.get("data_cursor")
                self.model.train()
        return stop

    def _run_epoch(self, featureset, batch_size, epoch, epochs, tb,
                   validation_data, validation_trigger, end_trigger) -> bool:
        """Returns True when the end trigger fired."""
        losses, tb_pend = [], []
        t_epoch = time.perf_counter()
        step0 = self.global_step
        # the data cursor of a resume: consumed here, and honoured only by
        # a featureset that can start an epoch at a step (none of the
        # ported tiers: ROADMAP Queue 1 item 3), as in the JAX package
        start_step = 0
        rc, self._resume_cursor = self._resume_cursor, None
        if rc and getattr(featureset, "supports_cursor", False) \
                and int(rc.get("epoch", -1)) == epoch:
            start_step = int(rc.get("step", 0))
        self._epoch_step0 = self.global_step - start_step
        stacked = None
        if hasattr(featureset, "stacked_epoch"):
            stacked = featureset.stacked_epoch(batch_size, epoch,
                                               self.device)
        args = (batch_size, epoch, tb, tb_pend, losses, end_trigger, t_epoch)
        if stacked is not None:
            if self._run_resident_epoch(stacked, *args):
                return True
        elif self._run_host_epoch(featureset, *args):
            return True
        # one host read for the epoch: the mean loss and TB's group means
        mean_loss = self._epoch_flush(tb, tb_pend, losses, t_epoch)
        entry = {"epoch": epoch + 1, "loss": mean_loss,
                 "seconds": time.perf_counter() - t_epoch}
        # the loss gauge reads the epoch's one host read above
        _m_epochs.inc()
        _m_loss.set(mean_loss)
        _m_sps.set((self.global_step - step0) * batch_size
                   / max(entry["seconds"], 1e-9))
        ts = TriggerState(epoch=epoch + 1, iteration=self.global_step,
                          epoch_finished=True, loss=mean_loss)
        if validation_data is not None and validation_trigger(ts):
            scores = self.evaluate(validation_data, batch_size)
            self.model.train()
            entry.update({f"val_{k}": v for k, v in scores.items()})
            ts.score = next(iter(scores.values()), None)
        self.history.append(entry)
        logger.info("epoch %d/%d: %s (%d steps)", epoch + 1, epochs, entry,
                    self.global_step - step0)
        if self.checkpoint_dir and self.checkpoint_trigger(ts):
            self._maybe_checkpoint(epoch + 1)
        return bool(end_trigger is not None and end_trigger(ts))

    def _run_resident_epoch(self, stacked, batch_size, epoch, tb, tb_pend,
                            losses, end_trigger, t_epoch):
        """DEVICE tier: the epoch is resident; each dispatch runs a chain
        of steps planned up to the next possible trigger fire
        (``_plan_chain``), whole K-groups, then the ragged tail as single
        steps; with K = 1 every step is a dispatch."""
        xs, ys, steps, perm = stacked
        src = self._resident_source(
            xs, ys, steps, np.arange(steps) if perm is None else perm)
        k = self.steps_per_dispatch
        full = (steps // k) * k if k > 1 else 0
        done = 0
        while done < full:
            n = self._plan_chain(k, full - done, end_trigger)
            with self._step_scope(n):
                lv = self._run_steps(n, src)
            done += n
            if self._post_dispatch(n, k, lv, batch_size, epoch, tb, tb_pend,
                                   losses, end_trigger, t_epoch):
                return True
        for _ in range(full, steps):
            with self._step_scope(1):
                lv = self._run_steps(1, src)
            if self._post_dispatch(1, 1, lv, batch_size, epoch, tb, tb_pend,
                                   losses, end_trigger, t_epoch):
                return True
        return False

    def _resident_source(self, xs, ys, steps, order) -> _Source:
        """The resident epoch as a step's source: the epoch's batch order
        uploaded into a device buffer kept per epoch tensor (a graph reads
        its address), the cursor at the epoch's start."""
        src = self._host_src.get(("resident", id(xs)))
        if src is None or src.xs is not xs:
            self._host_src = {k: v for k, v in self._host_src.items()
                              if k[0] != "resident"}
            ids = torch.zeros(steps, dtype=torch.int64, device=self.device)
            src = _Source(xs, ys, steps, ids)
            self._host_src[("resident", id(xs))] = src
        src.ids.copy_(torch.from_numpy(np.asarray(order, np.int64)))
        self._cursor.zero_()
        return src

    def _host_source(self, x, y) -> _Source:
        """Static buffers of K batches shaped like ``(x, y)`` (made once
        per batch shape), which a host group is copied into."""
        leaves = tree_leaves((x, y))
        key = ("host",) + tuple((tuple(a.shape), a.dtype) for a in leaves)
        src = self._host_src.get(key)
        if src is None:
            k = self.steps_per_dispatch
            buf = lambda a: torch.zeros((k,) + tuple(a.shape),
                                        dtype=a.dtype, device=self.device)
            ids = torch.arange(k, dtype=torch.int64, device=self.device)
            src = _Source(tree_map(buf, x), tree_map(buf, y), k, ids)
            self._host_src[key] = src
        return src

    def _run_host_epoch(self, featureset, batch_size, epoch, tb, tb_pend,
                        losses, end_trigger, t_epoch):
        """Host (DRAM) tier: groups of K batches, each copied into the
        static buffers and run as one dispatch; a ragged tail of fewer than
        K batches runs as single steps.  The batches come off the feed as
        host tensors (``_prefetch``); their copy to the card happens here,
        on the training thread's stream."""
        k = self.steps_per_dispatch
        pend = []

        def dispatch(group, k_gran):
            src = self._host_source(*group[0])
            with torch.no_grad():
                for i, (x, y) in enumerate(group):
                    for dst, a in zip(tree_leaves((src.xs, src.ys)),
                                      tree_leaves((x, y))):
                        dst[i].copy_(a)
            self._cursor.zero_()
            with self._step_scope(len(group)):
                lv = self._run_steps(len(group), src)
            return self._post_dispatch(len(group), k_gran, lv, batch_size,
                                       epoch, tb, tb_pend, losses,
                                       end_trigger, t_epoch)

        feed = _prefetch(featureset.batches(batch_size, epoch=epoch,
                                            device=torch.device("cpu")),
                         depth=self._prefetch_depth)
        for xy in feed:
            pend.append(xy)
            if len(pend) == k:
                if dispatch(pend, k):
                    return True
                pend = []
        for xy in pend:
            if dispatch([xy], 1):
                return True
        return False

    def _plan_chain(self, k: int, remaining: int, end_trigger) -> int:
        """Steps for the next dispatch: whole K-groups up to (and
        including) the group covering the earliest possible trigger fire,
        at most ``max_steps_per_dispatch``.  Data-dependent or unknown
        triggers bound at the next step (no chaining)."""
        triggers = []
        if end_trigger is not None:
            triggers.append(end_trigger)
        if self.checkpoint_dir:
            triggers.append(self.checkpoint_trigger)
        cap = max(k, (int(self.max_steps_per_dispatch) // k) * k)
        bounds = []
        for t in triggers:
            fn = getattr(t, "next_possible_fire", None)
            b = fn(self.global_step) if fn is not None \
                else self.global_step + 1
            if b is not None:
                bounds.append(b)
        if bounds:
            rel = max(min(bounds) - self.global_step, 1)
            return min(-(-rel // k) * k, remaining, cap)
        return min(remaining, cap)

    def _post_dispatch(self, n, k_gran, lv, batch_size, epoch, tb,
                       tb_pend, losses, end_trigger, t_epoch) -> bool:
        """Advance the host step count, buffer TB, evaluate triggers for
        the n steps a dispatch covered.  Returns True when the end trigger
        fired.  ``lv`` stays on the device; only a loss-reading trigger
        (MinLoss) reads it."""
        self.global_step += n
        _m_steps.inc(n)
        losses.append(lv)
        if tb:
            tb_pend.append((self.global_step, lv, k_gran, batch_size))
        ts = TriggerState(epoch=epoch + 1, iteration=self.global_step,
                          loss=_LazyLoss(lv))
        prev_step = self.global_step - n
        in_epoch = self.global_step - self._epoch_step0
        if end_trigger is not None and _fires_in_range(
                end_trigger, ts, prev_step, self.global_step):
            self._maybe_checkpoint(epoch, step_in_epoch=in_epoch)
            self._flush_tb(tb, tb_pend, t_epoch)
            return True
        if self.checkpoint_dir and _fires_in_range(
                self.checkpoint_trigger, ts, prev_step, self.global_step):
            self._maybe_checkpoint(epoch, step_in_epoch=in_epoch)
        return False

    # ------------------------------------------------------- TensorBoard
    @staticmethod
    def _tb_parts(tb_pend):
        """Per-K-group device means and their (step, samples) for the
        buffered dispatches (an n-step chain is n/K groups)."""
        parts, metas = [], []
        for last_step, lv, k, bs in tb_pend:
            arr = lv.reshape(-1)
            m = max(int(arr.numel()) // max(k, 1), 1)
            parts.append(arr.reshape(m, -1).mean(dim=1))
            metas.extend((last_step - (m - 1 - j) * k, bs * k)
                         for j in range(m))
        return parts, metas

    def _write_tb(self, tb, tb_pend, metas, vals, t_epoch) -> None:
        """Per-K-group events at their exact steps; throughput is the
        epoch's average rate (a dispatch's host time says little of its
        device time)."""
        lrs = self.optimizer.learning_rates([s for s, _ in metas])
        per_group = (max(time.perf_counter() - t_epoch, 1e-9)
                     / len(metas))
        for (stepn, n), v, lr in zip(metas, vals, lrs):
            tb.record_step(stepn, float(v), n / per_group, lr)
        tb_pend.clear()

    def _flush_tb(self, tb, tb_pend, t_epoch) -> None:
        if not tb or not tb_pend:
            return
        parts, metas = self._tb_parts(tb_pend)
        vals = torch.cat(parts).cpu().numpy()
        self._write_tb(tb, tb_pend, metas, vals, t_epoch)

    def _epoch_flush(self, tb, tb_pend, losses, t_epoch) -> float:
        """The epoch's one host read: TB's group means and the epoch's
        mean loss in one concatenated tensor."""
        parts, metas = (self._tb_parts(tb_pend) if tb and tb_pend
                        else ([], []))
        mean = (torch.cat([l.reshape(-1) for l in losses]).mean()[None]
                if losses else None)
        if not parts and mean is None:
            return float("nan")
        arr = torch.cat(parts + ([mean] if mean is not None else [])) \
            .cpu().numpy()
        mean_loss = float(arr[-1]) if mean is not None else float("nan")
        if parts:
            self._write_tb(tb, tb_pend, metas,
                           arr[:len(arr) - (1 if mean is not None else 0)],
                           t_epoch)
        return mean_loss

    # --------------------------------------------------------- checkpoints
    def _maybe_checkpoint(self, epoch: int, step_in_epoch: int = 0) -> None:
        """Write ``(params, opt_state, state, meta)`` at the global step;
        meta carries the epoch to resume at and the data cursor (batches
        of it consumed by completed steps)."""
        if not self.checkpoint_dir:
            return
        params = {n: p.detach() for n, p in self.model.named_parameters()}
        buffers = {n: b for n, b in self.model.named_buffers()}
        meta = {"epoch": epoch,
                "data_cursor": {"epoch": epoch, "step": step_in_epoch}}
        # nests under train.epoch when triggered inside an epoch (the
        # step-0 bootstrap checkpoint roots alone)
        with obs.span("train.checkpoint", step=self.global_step):
            save_checkpoint(self.checkpoint_dir, self.global_step,
                            (params, _opt_tree(self.opt_state), buffers,
                             meta), keep=self.keep_checkpoints)

    @torch.no_grad()
    def _restore(self, path: str) -> dict:
        """Load the checkpoint at ``path`` (the port's or the JAX
        package's) into the tensors in place (``copy_``: a captured graph
        keeps reading them); returns its meta."""
        (params, opt, buffers, meta), step = restore_checkpoint(path)
        if self.opt_state is None:
            self.opt_state = self.optimizer.init(self._params())
        _copy_named("parameter", dict(self.model.named_parameters()),
                    params)
        _copy_named("buffer", dict(self.model.named_buffers()), buffers)
        _copy_opt(self.opt_state, opt)
        self.global_step = int(step)
        if self._step_dev is not None:
            self._step_dev.fill_(self.global_step)
        return meta

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
            for x, y, n in self._feed(featureset, batch_size):
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

    def _feed(self, featureset, batch_size: int):
        """Every row in order, the ragged tail included, read ahead as
        host batches (``_prefetch``) and moved to the device here."""
        to_dev = lambda t: tree_map(lambda a: a.to(self.device), t)
        for x, y, n in _prefetch(featureset.batches_with_counts(
                batch_size, drop_remainder=False,
                device=torch.device("cpu")), depth=self._prefetch_depth):
            yield to_dev(x), None if y is None else to_dev(y), n

    def predict(self, featureset, batch_size: int = 32, variables=None):
        """The model's outputs over the dataset, in order, as numpy."""
        if variables is not None:
            self.model.set_weights(variables)
        self.model.eval()
        outs = []
        with torch.inference_mode():
            for x, _, _ in self._feed(featureset, batch_size):
                outs.append(tree_map(lambda t: t.float().cpu().numpy(),
                                     self.model(x)))
        if not outs:
            return None
        if isinstance(outs[0], np.ndarray):
            return np.concatenate(outs)
        return [np.concatenate(parts) for parts in zip(*outs)]


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms for the enclosed forward and
    backward.  A convolution's weight gradient otherwise sums in an order
    that changes from call to call on the card, so a step would not repeat
    bit for bit (graph replays against eager steps), and Adagrad or Adam
    turns such a last-bit difference of a small gradient into a full
    step.  The setting is process-wide while the step runs."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def _prefetch(iterator, depth: int):
    """The host tier's feed: up to ``depth`` batches read ahead on a worker
    thread (``depth <= 0``: read in line), with the time the loop waits
    counted into ``zoo_train_data_wait_seconds_total``.  The worker only
    reads the source (host tensors, no CUDA work), so it cannot disturb a
    graph capture on the training thread.  Abandoning the generator (an
    end trigger, an exception) stops the worker."""
    if depth <= 0:
        return _sync_counted(iterator)
    return _prefetch_threaded(iterator, depth)


def _sync_counted(iterator):
    """Synchronous passthrough with the data-wait accounting."""
    it = iter(iterator)
    while True:
        t_wait = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        _m_data_wait.inc(time.perf_counter() - t_wait)
        yield item


def _prefetch_threaded(iterator, depth: int):
    buf: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    sentinel = object()
    stop = threading.Event()
    errbox = []
    # the worker's span joins the consumer's ambient span (the
    # train.epoch driving this feed) by explicit parent handoff:
    # contextvars do not cross the thread hop
    parent = obs.current_span()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                buf.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        with obs.span("train.prefetch", parent=parent) as psp:
            try:
                for item in iterator:
                    if not _put(item):
                        return
            except BaseException as e:   # surfaced on the consuming thread
                errbox.append(e)
                if psp is not None:
                    psp.set(error_type=type(e).__name__)
            finally:
                _put(sentinel)
                # the worker owns the iterator: close it here (closing a
                # running generator from the consumer raises ValueError)
                close = getattr(iterator, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:
                        pass

    t = threading.Thread(target=worker, name="train-prefetch", daemon=True)
    t.start()
    try:
        while True:
            t_wait = time.perf_counter()
            item = buf.get()
            _m_data_wait.inc(time.perf_counter() - t_wait)
            if item is sentinel:
                if errbox:
                    raise errbox[0]
                return
            yield item
    finally:
        stop.set()
        try:                          # unblock a worker stuck on put()
            while True:
                buf.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5.0)
        if t.is_alive():
            # blocked inside the source's read: the worker stops (and
            # closes the source) as soon as that read returns
            logger.warning("prefetch worker still blocked in the source "
                           "iterator after 5s; it will stop and close the "
                           "source when the pending read returns")


def grads_of(loss: torch.Tensor, params: List[torch.Tensor]
             ) -> List[torch.Tensor]:
    """``d loss / d p`` for each of ``params``; zeros for a parameter the
    loss does not reach (a head that reads the sequence output leaves the
    pooler unused), as ``jax.grad`` gives, so the optimizer's decay still
    sees it."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, params)]


def _remat_contexts():
    """(forward, recomputation) contexts of a rematerialised step: the
    recomputation leaves BatchNormalization's running statistics as the
    forward left them."""
    return contextlib.nullcontext(), recomputing()


def _fires_in_range(trigger, ts, prev_step, cur_step):
    """Evaluate a (stateless) trigger at every iteration a dispatch
    covered: with K steps per dispatch the step counter advances in
    strides of K, and a ``SeveralIteration(n)`` boundary inside
    ``(prev_step, cur_step]`` must still fire.  Starts at the trigger's
    own earliest possible fire."""
    if cur_step - prev_step <= 1:
        return trigger(ts)
    fn = getattr(trigger, "next_possible_fire", None)
    start = prev_step + 1
    if fn is not None:
        b = fn(prev_step)
        if b is None or b > cur_step:
            return False
        start = max(start, b)
    return any(trigger(replace(ts, iteration=i))
               for i in range(start, cur_step + 1))


class _LazyLoss:
    """The loss handed to triggers as a device tensor: only a loss-reading
    trigger (MinLoss) pays the host read."""

    __slots__ = ("_lv", "_val")

    def __init__(self, lv):
        self._lv = lv
        self._val = None

    def _value(self) -> float:
        if self._val is None:
            self._val = float(self._lv.float().mean())
        return self._val

    def __float__(self):
        return self._value()

    def __lt__(self, other):
        return self._value() < other

    def __le__(self, other):
        return self._value() <= other

    def __gt__(self, other):
        return self._value() > other

    def __ge__(self, other):
        return self._value() >= other


def _opt_tree(state: dict) -> dict:
    """The optimizer state's tensors (its count and slots) for a
    checkpoint; the decay mask (names) is rebuilt by ``init``."""
    return {k: v for k, v in state.items()
            if isinstance(v, (torch.Tensor, dict))}


def _opt_tensors(state) -> List[torch.Tensor]:
    if state is None:
        return []
    out = []
    for v in _opt_tree(state).values():
        out.extend(v.values() if isinstance(v, dict) else [v])
    return out


def _copy_named(what: str, dst: Dict[str, torch.Tensor], src: dict) -> None:
    missing = sorted(set(dst) - set(src))
    extra = sorted(set(src) - set(dst))
    if missing or extra:
        raise KeyError(f"checkpoint {what}s do not match the model: "
                       f"missing {missing}, extra {extra}")
    for name, t in dst.items():
        if tuple(src[name].shape) != tuple(t.shape):
            raise ValueError(f"checkpoint {what} {name!r} has shape "
                             f"{tuple(src[name].shape)}, the model "
                             f"{tuple(t.shape)}")
    for name, t in dst.items():
        t.copy_(src[name])


def _copy_opt(state: dict, src: dict) -> None:
    for key, v in _opt_tree(state).items():
        if key not in src:
            raise KeyError(f"checkpoint optimizer state has no {key!r} "
                           f"(it holds {sorted(src)})")
        if isinstance(v, dict):
            _copy_named(f"optimizer {key}", v, src[key])
        else:
            v.copy_(src[key].reshape(v.shape))
