"""The training engine: Estimator.train / evaluate / predict.

Port of ``analytics_zoo_tpu/estimator/estimator.py``.  A step is the JAX
step (``estimator.py:213-482``): the forward in training mode, the loss,
the gradients (through the attention kernels on the card), optional
clipping by value or by global norm, and the optimizer's in-place update.

The mesh.  An estimator runs under its context: ``ctx=``, else the live
one (``common.context.current_context``; none: no mesh, every axis of
size 1).  As in the JAX package's single-controller model, one process
holds every shard of the context's ``Mesh``.  When they all lie on the
model's device (``["cuda:0"] * n`` on one card), the step below runs
from there.  When they lie on several devices (a mesh over several
cards), each data position runs its rows on its own device and stream:
the per-position step of ``estimator/positions.py``, which runs eager
(no CUDA graph), and which the estimator's private selector
(``_positions_on_shared_devices``) also runs on a shared device.  With
``dp`` / ``mp`` the "data" / "model" axis
sizes, ``shard_model`` (default True) places the weights and their
optimizer slots by ``parallel/sharding.py``'s Megatron rules when
``mp > 1``, and ``shard_optimizer`` (ZeRO) places the slots and the
gradient by ``parallel/zero.py``'s specs when ``dp > 1`` (``_place``).
The master weights are then ``ShardedTensor``s (``params``), the slots
too; a step's forward and backward run over the whole global batch on
the module's parameters, which is what GSPMD's program computes (the hash
dropout over global rows, BatchNorm's global statistics), with attention
split per (data, model) block under a 2D mesh
(``sharded_flash_attention``: one kernel launch a block).  The gradient
is then cut by the update's shardings (a reduce-scatter, on one card a
slice), each distinct block -- a data position's share of a leaf, in
position order -- is updated in place in its master shard and slot
shards (``optimizer.update_blocks``; norms over a whole leaf or tree sum
the squares of its blocks in that order), and the updated shards are
gathered back into the module's parameters (``ShardedTensor.
all_gather_into``; a shard that is a view of them costs nothing).  Every
address is fixed, so the sharded step captures as a CUDA graph too.
``shard_model=False`` on a 2D mesh also hides the model axis from the
layers (``_trace_ctx``): attention runs unsharded.  ``params`` and
``opt_state`` report ``parallel.zero.bytes_per_device`` equal to the JAX
estimator's for the same model and mesh.

Several processes (a context of a job, ``init_zoo_context`` with a
coordinator), under any layout the JAX builder takes: a process may hold
several data rows of the mesh, or part of a model group (``Mesh.
data_groups``: the processes holding the same data coordinates form a
group).  Each process runs the forward and backward on the rows of its
data coordinates of every global batch (the featureset's per-process
feed, the same rows in each process of a group, the dropout masks at the
group's global rows), then the loss and the gradients are averaged over
the groups by one all-reduce a dtype (``_across``, the gradients
flattened into one buffer, each group's lowest process adding its
values and the others zeros), and each process updates the blocks it
holds.  Under ZeRO, or with a model group split across processes, a
process lacks some blocks: their owners (the lowest process holding
each) send them after the update (``_StepPlan.exchange`` into the master
shards, and ``gather``'s all-gather of the master blocks into the
module's weights); norms over a whole leaf or tree add each block once,
in its owner (``plan.cross``).  With positions on several devices in
each process (or by the private selector), each process runs the
per-position step of ``estimator/positions.py`` over its positions, its
local sums first.  Such a step runs eager (no CUDA graph: a gloo
collective cannot be captured), its all-reduce on the host between the
backward and the update; with a gradient accumulation the whole
accumulator is averaged.  A failed epoch
re-raises instead of retrying in place (a job restarts and resumes from
its checkpoint, as in the JAX package); replicated state is checkpointed
by process 0 alone, a leaf sharded over processes by every process (its
host files).  BatchNormalization's statistics stay each process's own.

``mixed_precision=True`` runs the forward and backward in
``compute_dtype`` (bf16): a bf16 shadow of the f32 master weights is
refreshed at the start of every step and the model runs on it
(``torch.func.functional_call``); the gradients are taken with respect to
the shadow, as the JAX step takes them with respect to its bf16 params,
and are widened to f32 for the optimizer, or stay bf16 up to it with
``grad_dtype="bfloat16"``.  ``grad_accum_steps=N`` splits each batch into
N microbatches in order and averages their gradients in an f32 (or the
parameters') accumulator, sharded as the gradient under ZeRO;
``remat=True`` recomputes the forward in the
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
epoch and the data cursor (placed leaves as their full arrays, or per
host: ``estimator/checkpoint.py``), and restore onto any mesh shape;
``train(resume=True)`` and the retry after a failed epoch
(``TrainConfig.failure_retry_times``, ``RetryPolicy`` backoff, one
process) restore the latest one with ``copy_`` into the
tensors a captured graph reads.  ``tensorboard_dir`` / ``app_name`` write
the loss, throughput and learning rate per K-group of every dispatch.
Validation runs ``evaluate`` at the epoch ends ``validation_trigger``
picks (default every epoch).  The cursor (``data.cursor.DataCursor``) is
honoured by a featureset with ``supports_cursor`` (the sharded tier,
``data/sharded.py``), which resumes mid-epoch at that batch; such a set
stages its batches on the card itself.  A featureset's ``fuse=True``
transform chain (``data/transforms.py``) runs inside the step, eager or
captured, and in ``evaluate`` / ``predict``; its signature keys the
captured step.

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
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import queue
import threading
import time
from concurrent.futures import CancelledError
from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint as _remat

from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common.config import MeshConfig, ZooConfig
from analytics_zoo_tpu_torch.common.context import (
    ZooContext, context_scope, current_context,
    resolve_device)
from analytics_zoo_tpu_torch.common.resilience import RetryPolicy
from analytics_zoo_tpu_torch.common.timer import Timers
from analytics_zoo_tpu_torch.common.triggers import (EveryEpoch, Trigger,
                                                     TriggerState)
from analytics_zoo_tpu_torch.data.cursor import DataCursor
from analytics_zoo_tpu_torch.data.featureset import tree_leaves, tree_map
from analytics_zoo_tpu_torch.estimator.checkpoint import (
    latest_checkpoint, needs_per_host, restore_checkpoint, save_checkpoint)
from analytics_zoo_tpu_torch.estimator.positions import Positions
from analytics_zoo_tpu_torch.keras import losses as losses_mod
from analytics_zoo_tpu_torch.keras import metrics as metrics_mod
from analytics_zoo_tpu_torch.keras import optimizers as optim_mod
from analytics_zoo_tpu_torch.keras.layers.normalization import recomputing
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops.dropout import as_seed, derive_seed
from analytics_zoo_tpu_torch.parallel.mesh import (
    ShardedTensor, block_table, device_put, exchange, _same_memory)
from analytics_zoo_tpu_torch.parallel.sharding import (
    named_shardings, partition_specs)
from analytics_zoo_tpu_torch.parallel.zero import (
    bytes_per_device, replicated_shardings, zero_shardings)

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


#: the private selector: the per-position step on a mesh whose positions
#: share one device (how the tests and the smoke run hold it)
_SHARED_DEVICE_POSITIONS = False


@contextlib.contextmanager
def _positions_on_shared_devices():
    """Estimators made inside the ``with`` run the per-position step over
    their mesh's positions even where these share one device."""
    global _SHARED_DEVICE_POSITIONS
    prev, _SHARED_DEVICE_POSITIONS = _SHARED_DEVICE_POSITIONS, True
    try:
        yield
    finally:
        _SHARED_DEVICE_POSITIONS = prev


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
        # the per-position step's host copy of the order and its cursor
        self.order = list(range(rows))
        self.at = 0


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


def _block_key(block, shape) -> tuple:
    """A block's slice bounds (None: the whole leaf of ``shape``)."""
    if block is None:
        block = tuple(slice(0, n) for n in shape)
    return tuple((b.start, b.stop) for b in block)


def _holder(placed: ShardedTensor, block, shape) -> int:
    """A position of this process whose shard of ``placed`` holds all of
    ``block``, or -1."""
    for p in placed.sharding.mesh.local_positions:
        held = placed.sharding.index(p, shape)
        if all(h.start <= b.start and b.stop <= h.stop
               for h, b in zip(held, block)):
            return p
    return -1


def _relative(block, within) -> Tuple[slice, ...]:
    """``block``'s slices (global) relative to ``within``'s start."""
    return tuple(slice(b.start - w.start, b.stop - w.start)
                 for b, w in zip(block, within))


def _whole(block, shape) -> bool:
    return all(b.start == 0 and b.stop == n for b, n in zip(block, shape))


class _StepPlan:
    """What a step updates, block by block: for each trainable leaf (in
    the module's order) each distinct block of its update sharding (in
    mesh-position order, one block when the update is not sharded), with
    the block's view of the master weight, of each optimizer slot and,
    under accumulation with ZeRO, of the gradient accumulator.  Worked out
    once at placement; the views' addresses are what a captured step
    replays.

    ``cut`` is the reduce-scatter of a step's gradients (views: the whole
    batch's gradient is already summed over the data positions), and
    ``gather`` the all-gather of the updated master shards into the
    module's parameters (``refresh``: the other way, after the module's
    weights were written from outside a step).

    Over several processes the blocks are this process's.  A block that
    other processes do not hold (the update sharded over a "data" axis the
    processes split) is sent by its owner, the lowest process holding it,
    after the update (``exchange``: one all-gather a dtype) into the
    master shards of the processes that lack it; ``owned`` marks the
    blocks this process counts in a norm over a whole leaf or tree, and
    ``cross`` is what the optimizer needs for such norms (None when every
    process holds every block)."""

    def __init__(self, module_params: Dict[str, torch.Tensor],
                 trainable: List[str], masters: Optional[dict],
                 update_sh: Optional[dict], opt_state: dict,
                 slot_names: List[str], acc: Optional[dict] = None):
        self.module_params = module_params
        self.masters = masters
        self.acc = acc
        self.owned: List[bool] = []
        self.remote: Dict[torch.dtype, tuple] = {}
        self.cross = None
        self.names, self.ps, self.cuts = [], [], []
        self.slots: Dict[str, List[torch.Tensor]] = {k: [] for k in
                                                     slot_names}
        self.groups: Optional[List[List[int]]] = [] if masters else None
        self.acc_blocks: List[torch.Tensor] = []
        group = None if masters is None else \
            next(iter(update_sh.values())).mesh.group
        me = None if group is None else group.rank
        for n in trainable:
            full = module_params[n]
            shape = tuple(full.shape)
            owner = {}
            if masters is None:
                blocks = [(0, None)]
            else:
                blocks = [(p, None if _whole(b, shape) else b) for p, b in
                          update_sh[n].unique_blocks(shape)]
                self.groups.append(list(range(len(self.names),
                                              len(self.names)
                                              + len(blocks))))
                if group is not None:
                    owner = self._remote(n, full, masters[n], update_sh[n],
                                         shape, group)
            for p, block in blocks:
                self.owned.append(me is None
                                  or owner[_block_key(block, shape)] == me)
                self.names.append(n)
                self.cuts.append((n, block))
                self.ps.append(self._view(full, masters and masters[n],
                                          p, block, shape))
                for k in slot_names:
                    self.slots[k].append(self._view(
                        None, opt_state[k][n], p, block, shape))
                if acc is not None:
                    self.acc_blocks.append(self._view(None, acc[n], p,
                                                      block, shape))
        if self.remote:
            self.cross = (self.owned, group.all_reduce)
        self._group = group
        # the leaves whose master shards are not the module's memory, or
        # that have blocks only other processes hold
        self._gathered = [] if masters is None else [
            n for n in module_params if not all(
                _same_memory(module_params[n][sl], t)
                for sl, t in masters[n].unique_shards())
            or (group is not None and any(
                p < 0 for _, _, p in block_table(
                    masters[n].sharding, masters[n].shape)))]

    @staticmethod
    def _view(full, placed, p, block, shape):
        """Position ``p``'s view of ``block`` (None: the whole leaf) in
        ``placed`` (a ShardedTensor; ``full`` when unplaced)."""
        if not isinstance(placed, ShardedTensor):
            t = placed if placed is not None else full
            return t if block is None else t[block]
        held = placed.sharding.index(p, shape)
        t = placed.shards[p]
        if block is None:
            block = tuple(slice(0, n) for n in shape)
        rel = _relative(block, held)
        return t if _whole(rel, tuple(t.shape)) else t[rel]

    def _remote(self, n, full, master, sharding, shape, group) -> dict:
        """Record leaf ``n``'s blocks that some process lacks in
        ``remote`` (its ``exchange`` entries); returns ``{block key:
        owner}`` of every block of this process."""
        owners = {}
        for slices, holders, p in block_table(sharding, shape):
            owner = min(holders)
            if p >= 0:
                owners[_block_key(slices, shape)] = owner
            if len(holders) == group.size:
                continue
            src = (self._view(full, master, p, slices, shape)
                   if owner == group.rank else None)
            # a block whose master block this process lacks too comes
            # with that block (``gather``'s all-gather)
            q = -1 if p >= 0 else _holder(master, slices, shape)
            dst = (None if q < 0 else self._view(full, master, q, slices,
                                                 shape))
            _, entries = self.remote.setdefault(
                master.dtype, (master.local_shard, []))
            entries.append((owner, math.prod(sl.stop - sl.start
                                             for sl in slices), src, dst))
        return owners

    def exchange(self) -> None:
        """The blocks this process lacks, from their owners (after the
        update, before ``gather``)."""
        for like, entries in self.remote.values():
            exchange(entries, self._group, like)

    def cut(self, grads: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        # a strided block is copied dense: one strided tensor in a list
        # sends a whole ``_foreach`` op to a kernel a tensor
        return [grads[n] if block is None
                else grads[n][block].contiguous() for n, block in self.cuts]

    def gather(self) -> None:
        for n in self._gathered:
            self.masters[n].all_gather_into(self.module_params[n])

    @torch.no_grad()
    def refresh(self) -> None:
        if self.masters is not None:
            for n, m in self.masters.items():
                m.scatter_(self.module_params[n])


class Estimator:
    """Drives training, evaluation and prediction of a port model: an
    ``nn.Module`` called as ``model(x, seed=...)`` (``KerasNet``).  The
    model moves to ``device`` (default: the device of the context's mesh,
    else the card; raises without one)."""

    def __init__(self, model, optimizer=None, loss=None,
                 metrics: Optional[List] = None,
                 ctx: Optional[ZooContext] = None,
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
        self.ctx = ctx if ctx is not None else current_context()
        config = config or (self.ctx.config if self.ctx is not None
                            else ZooConfig())
        cfg = config.train
        if device is None and self.ctx is not None:
            device = self.ctx.mesh.local_devices[0]
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
        # no context: every mesh axis of the JAX layout has size 1
        self._mesh_axes = tuple(config.mesh.axis_names)
        # ZeRO over "data" and Megatron placement over "model"
        self.shard_optimizer = (cfg.shard_optimizer if shard_optimizer
                                is None else bool(shard_optimizer))
        self.shard_model = (cfg.shard_model if shard_model is None
                            else bool(shard_model))
        # the processes of a job the step spans (None: this one alone)
        self._group = (self.ctx.group if self.ctx is not None
                       and self.ctx.process_count > 1 else None)
        self._masters: Optional[Dict[str, ShardedTensor]] = None
        self._plan: Optional[_StepPlan] = None
        self._trace = None
        # the per-position step: positions on several devices (or on one,
        # by the private selector); built at the first use
        self._per_position = self.ctx is not None and (
            self.ctx.distinct_devices or _SHARED_DEVICE_POSITIONS)
        self._pp: Optional[Positions] = None
        if self._group is not None:
            # the data groups (processes taking the same rows) whose sums
            # the all-reduce counts once each: a group's lowest process
            # adds its own, the others zeros (raises for a layout the
            # port does not split)
            self._leaders = [g[0] for g in
                             self._trace_ctx().mesh.data_groups()]
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
        # the featureset's fuse=True transform chain, run inside the step
        # (set per call), and the signature the captured step was made for
        self._fused_tf = None
        self._graph_tf = None
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
        """Whether dispatches replay a captured step (K > 1 on the card,
        one process: a step of several processes runs eager, its
        all-reduce on the host between the backward and the update)."""
        return (self.steps_per_dispatch > 1 and self.device.type == "cuda"
                and self._group is None and not self._per_position)

    def _forward(self, p_fwd, x, seed, replica=None):
        """Predictions in f32 from the weights ``p_fwd`` (the masters, or
        their bf16 shadow under mixed precision), the module's other
        tensors taken from ``replica`` where given (a data position's)."""
        if replica is None and not self.mixed_precision:
            return self.model(x, seed=seed)
        mixed, dt = self.mixed_precision, self.compute_dtype
        if mixed:
            x = tree_map(lambda t: t.to(dt) if t.is_floating_point() else t,
                         x)
        preds = functional_call(
            self.model, p_fwd if replica is None else {**replica, **p_fwd},
            (x,), {"seed": seed})
        if not mixed:
            return preds
        return tree_map(lambda t: t.float() if t.is_floating_point() else t,
                        preds)

    def _fwd_weights(self, params, shadow):
        """The weights the forward reads: under mixed precision
        ``shadow``, the bf16 copy of ``params`` taken anew; else
        ``params``."""
        if not self.mixed_precision:
            return params
        with torch.no_grad():
            for n, p in params.items():
                shadow[n].copy_(p)
        return shadow

    def _shadow(self, params):
        """A bf16 shadow of ``params`` (mixed precision's forward
        weights), on their devices."""
        return {n: p.detach().to(self.compute_dtype).requires_grad_()
                for n, p in params.items()}

    def _grads(self, p_fwd, x, y, seed, forward=None):
        """One microbatch's loss and its raw gradients w.r.t. ``p_fwd``;
        ``forward(x)`` gives the predictions (default ``_forward`` of
        ``p_fwd``)."""
        forward = forward or (lambda xx: self._forward(p_fwd, xx, seed))
        if self.remat:
            # the hash dropout recomputes the same mask; no RNG state to
            # keep (none is drawn)
            preds = _remat(forward, x, use_reentrant=False,
                           preserve_rng_state=False,
                           context_fn=_remat_contexts)
        else:
            preds = forward(x)
        loss = self.loss(preds, y)
        return loss, grads_of(loss, list(p_fwd.values()))

    def _add_grads(self, acc, grads):
        """``grads`` added into the accumulator ``acc``, made at the first
        call (None): f32 under mixed precision, else the gradients'
        dtypes; returns it."""
        if acc is None:
            acc = [torch.zeros_like(
                t, dtype=torch.float32 if self.mixed_precision
                and t.is_floating_point() else t.dtype) for t in grads]
        torch._foreach_add_(acc, [t.to(a.dtype) for t, a in zip(grads, acc)])
        return acc

    def _clip(self, grads, cross=None) -> None:
        """Clip the update's gradient blocks in place: by value, then by
        the global norm, the blocks' norms taken in the plan's order on
        the first block's device (``cross``: over processes, the blocks
        this process counts, their squares summed over processes)."""
        if self.clip_value is not None:
            lo, hi = (self.clip_value if isinstance(self.clip_value, tuple)
                      else (-self.clip_value, self.clip_value))
            for g in grads:
                g.clamp_(lo, hi)
        if self.clip_norm is None:
            return
        dev = grads[0].device
        norms = [torch.linalg.vector_norm(g.float()).to(dev) for g in grads]
        if cross is None:
            norm = torch.linalg.vector_norm(torch.stack(norms))
        else:
            owned, total = cross
            norm = total(torch.stack([
                v for v, o in zip(norms, owned) if o]).square().sum()).sqrt()
        scale = torch.clamp(self.clip_norm / (norm + 1e-6), max=1.0)
        for d in dict.fromkeys(g.device for g in grads):
            torch._foreach_mul_([g for g in grads if g.device == d],
                                scale.to(d))

    def _cast_grads(self, grads):
        if not self.mixed_precision:
            return grads
        dt = (getattr(torch, self.grad_dtype) if self.grad_dtype is not None
              else torch.float32)
        return [g.to(dt) if g.is_floating_point() else g for g in grads]

    def _accum_grads(self, p_fwd, x, y, seed):
        """Microbatches in order, their gradients summed in an f32 (under
        mixed precision) or the parameters' accumulator and averaged,
        then cast once; the loss is their mean.  Under ZeRO the
        accumulator is sharded as the gradient (each microbatch's gradient
        reduce-scattered into it) and the step's blocks are its shards;
        else it is whole and cut after."""
        n = self.grad_accum_steps
        split = lambda a: a.reshape((n, a.shape[0] // n) + a.shape[1:])
        if self._group is not None:
            # microbatch j is rows [j*B/n, (j+1)*B/n) of the global batch,
            # whose rows the data groups hold in order: gather it (one
            # all-gather a leaf, the groups' lowest processes' parts) and
            # compute this process's B/(nG) rows of each microbatch, the
            # rows its dropout offset names
            g_at, G = self._trace_ctx().mesh.data_group()

            def split(a):
                parts = self._group.all_gather(a)
                g = torch.cat([parts[q] for q in self._leaders])
                return g.reshape((n, G, g.shape[0] // (n * G))
                                 + g.shape[1:])[:, g_at]
        xs, ys = tree_map(split, x), tree_map(split, y)
        plan = self._plan
        sharded = plan.acc is not None
        acc, losses = None, []
        if sharded:
            with torch.no_grad():
                torch._foreach_zero_(plan.acc_blocks)
        for j in range(n):
            pick = lambda a: a[j]
            lv, g = self._grads(p_fwd, tree_map(pick, xs), tree_map(pick, ys),
                                None if seed is None
                                else derive_seed(seed, j))
            losses.append(lv.detach())
            if sharded:
                with torch.no_grad():
                    for name, t in zip(p_fwd, g):
                        plan.acc[name].reduce_scatter_(t, accumulate=True)
                continue
            acc = self._add_grads(acc, g)
        if sharded:
            blocks = plan.acc_blocks
            torch._foreach_div_(blocks, float(n))
            return torch.stack(losses).mean(), self._cast_grads(blocks)
        torch._foreach_div_(acc, float(n))
        loss, acc = self._across(torch.stack(losses).mean(), acc)
        return loss, plan.cut(dict(zip(p_fwd, self._cast_grads(acc))))

    def _across(self, loss, grads, parts: Optional[int] = None):
        """The loss and the gradients averaged over the processes (one
        all-reduce a dtype, of the gradients flattened into one buffer),
        as the global batch's; unchanged for one process.  Each data
        group (``Mesh.data_groups``: the processes that took the same
        rows) counts once: its lowest process adds its values, the others
        zeros (exact), and the sum is divided by ``parts``, the equal
        parts it adds up (default the groups, each process holding its
        group's mean; the per-position step passes the data positions,
        each group holding its positions' sum)."""
        if self._group is None:
            return loss, grads
        parts = float(parts or len(self._leaders))
        grads = list(grads)

        def mean(t):
            if self._group.rank not in self._leaders:
                t.zero_()
            return self._group.all_reduce(t).div_(parts)
        with torch.no_grad():
            by_dtype: Dict[torch.dtype, List[int]] = {}
            for i, g in enumerate(grads):
                by_dtype.setdefault(g.dtype, []).append(i)
            for dt, idx in by_dtype.items():
                flat = mean(torch.cat([grads[i].reshape(-1) for i in idx]))
                for i, part in zip(idx, flat.split(
                        [grads[i].numel() for i in idx])):
                    grads[i] = part.view(grads[i].shape)
            loss = mean(loss.detach().clone())
        return loss, grads

    def _train_step(self, x, y, seed) -> torch.Tensor:
        """One optimizer step on batch ``(x, y)``; returns the loss as a
        device scalar (no host read)."""
        plan = self._plan
        p_fwd = self._fwd_weights(self._params(), self._p16)
        if self.grad_accum_steps > 1:
            loss, grads = self._accum_grads(p_fwd, x, y, seed)
        else:
            loss, grads = self._across(*self._grads(p_fwd, x, y, seed))
            grads = plan.cut(dict(zip(p_fwd, self._cast_grads(grads))))
        with torch.no_grad():
            self._clip(grads, plan.cross)
        self.optimizer.update_blocks(optim_mod.Blocks(
            plan.names, plan.ps, grads, plan.slots, plan.groups,
            self.opt_state.get("decayed", ()), plan.cross), self.opt_state)
        with torch.no_grad():
            plan.exchange()
            plan.gather()
        return loss.detach()

    def _step_from(self, src: _Source) -> None:
        """One step reading its batch through the device cursor: the
        gather, the seed from the device step counter, the step, and the
        loss into the next device slot.  Nothing is read on the host, so
        this is what a CUDA graph captures."""
        j = src.ids.index_select(0, self._cursor.reshape(1))
        take = lambda a: a.index_select(0, j)[0]
        x, y = tree_map(take, src.xs), tree_map(take, src.ys)
        if self._fused_tf is not None:
            # the fused chain: torch ops on the batch, inside the step a
            # graph captures
            x = self._fused_tf.apply_jax(x)
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
        for m in (self._masters or {}).values():
            out += [t for _, t in m.unique_shards()]
        out += [self._step_dev, self._cursor, self._slot, self._loss_buf]
        return out

    def _run_steps(self, n: int, src: _Source) -> torch.Tensor:
        """``n`` steps from ``src`` as one dispatch: ``n`` replays of the
        captured step on the card (K > 1), else ``n`` eager steps.
        Returns their losses, an ``(n,)`` device tensor."""
        if self._per_position:
            picks = [src.order[(src.at + j) % src.rows] for j in range(n)]
            src.at += n
            take = lambda i: lambda a: a[int(i)]
            return self._position_steps([(tree_map(take(i), src.xs),
                                          tree_map(take(i), src.ys))
                                         for i in picks])
        self._slot.zero_()
        if self._graphs_on:
            key = (self._fused_tf.signature if self._fused_tf is not None
                   else None)
            if (self._graph is None or self._graph.src is not src
                    or self._graph_tf != key):
                self._graph = None          # one graph (its pool) at a time
                torch.cuda.empty_cache()
                self._graph = _CapturedStep(lambda: self._step_from(src),
                                            self._state_tensors(), src)
                self._graph_tf = key
            self._graph.replay(n)
        else:
            for _ in range(n):
                self._step_from(src)
        return self._loss_buf[:n].clone()

    def _position_steps(self, batches) -> torch.Tensor:
        """Eager per-position steps over ``batches``, each seeded from the
        host step count (the value the device derivation gives); returns
        their losses, an ``(n,)`` tensor on the model's device."""
        losses = []
        with _deterministic_cudnn():
            for j, (x, y) in enumerate(batches):
                seed = derive_seed(self._seed, self.global_step + j)
                losses.append(self._pp.step(x, y, seed))
        return torch.stack(losses)

    def _positions(self) -> Positions:
        """The per-position step's replicas and streams (made once; the
        module's weights copied into them again at every call, as they
        are the truth between calls)."""
        if self._pp is None:
            self._pp = Positions(self, self._trace_ctx().mesh)
        else:
            self._pp.refresh()
        return self._pp

    def _feed_device(self):
        """Where a featureset stages training batches: the model's device,
        or (None) the positions' devices for the per-position step."""
        return None if self._per_position else self.device

    # -------------------------------------------------------- placement
    @property
    def params(self) -> Dict[str, object]:
        """The weights by dotted name: as placed on the mesh
        (``ShardedTensor``s under the step's shardings) once training has
        placed them, else the module's parameters."""
        if self._masters is not None:
            return self._masters
        return {n: p.detach() for n, p in self.model.named_parameters()}

    def _trace_ctx(self) -> Optional[ZooContext]:
        """The context the layers see while this estimator runs: its own,
        or, with ``shard_model=False`` on a mesh with model > 1, a
        data-only view of the same devices (attention then runs
        unsharded, as on a 1D mesh)."""
        if self.ctx is None:
            return None
        if self.shard_model or self.ctx.axis_size("model") <= 1:
            return self.ctx
        if self._trace is None:
            mesh = self.ctx.mesh
            cfg = dataclasses.replace(
                self.ctx.config,
                mesh=MeshConfig(data=mesh.size, model=1, sequence=1,
                                expert=1, pipeline=1))
            self._trace = ZooContext(cfg, mesh.reshaped((mesh.size,),
                                                        ("data",)))
        return self._trace

    def _scope(self):
        tc = self._trace_ctx()
        return context_scope(tc) if tc is not None \
            else contextlib.nullcontext()

    def _fs_kw(self) -> dict:
        """The context a featureset batches training steps for (its
        data-axis check; over processes, the rows of this process's data
        coordinates in the layers' view of the mesh, which the step and
        the dropout offsets read)."""
        if self.ctx is None:
            return {}
        return {"ctx": self._trace_ctx() if self._group is not None
                else self.ctx}

    def _place(self) -> None:
        """Place the weights and the optimizer state on the mesh, as the
        JAX step's shardings give them (``estimator.py:219-270``):
        weights by the Megatron rules when ``shard_model`` and mp > 1
        (the slots follow them), the slots and the gradient by the ZeRO
        specs when ``shard_optimizer`` and dp > 1 (composed with the
        Megatron specs), replicated otherwise.  Then the step's plan."""
        module = {n: p.detach() for n, p in self.model.named_parameters()}
        trainable = list(self._params())
        slot_names = self.optimizer.slot_names(self.opt_state)
        acc = None
        if self.ctx is None:
            self._plan = _StepPlan(module, trainable, None, None,
                                   self.opt_state, slot_names)
            return
        # the per-position step places over the layers' view of the mesh
        # (data only under shard_model=False)
        ctx = self._trace_ctx() if self._per_position else self.ctx
        mesh, axis = ctx.mesh, ctx.data_axis
        zshard = self.shard_optimizer and ctx.axis_size(axis) > 1
        msharded = self.shard_model and ctx.axis_size("model") > 1
        opt_tree = _opt_tree(self.opt_state)
        psh, gsh, osh = _shardings(mesh, axis, module, opt_tree, zshard,
                                   msharded)
        if self._per_position:
            pp = self._positions()
            self.opt_state = {**self.opt_state, **pp.place(
                opt_tree, psh, gsh, osh, slot_names)}
            self._masters = pp.masters
            self._plan = pp
            return
        self._masters = device_put(module, psh)
        self.opt_state = {**self.opt_state, **device_put(opt_tree, osh)}
        if zshard and self.grad_accum_steps > 1 and self._group is None:
            # (over processes the whole accumulator is averaged first)
            acc = {n: device_put(torch.zeros(
                module[n].shape, dtype=torch.float32 if self.mixed_precision
                and module[n].is_floating_point() else module[n].dtype,
                device=self.device), gsh[n]) for n in trainable}
        self._plan = _StepPlan(module, trainable, self._masters, gsh,
                               self.opt_state, slot_names, acc)

    def _prepare(self, seed) -> None:
        """Allocate the step's device state before any capture: optimizer
        state (placed on the mesh with the weights), the bf16 shadow,
        counters, the loss slots."""
        dev = self.device
        if self.opt_state is None:
            self.opt_state = self.optimizer.init(self._params())
        if self._plan is None:
            self._place()
        else:
            # the module's weights are the truth between calls (set_weights,
            # a load): the master shards take them again
            self._plan.refresh()
        if (self.mixed_precision and self._p16 is None
                and not self._per_position):
            self._p16 = self._shadow(self._params())
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
        opt_tree = _opt_tree(self.opt_state)
        weights = int(bytes_per_device(self.params))
        opt = int(bytes_per_device(opt_tree))
        blocks = len(self.params) + len(tree_leaves(opt_tree))
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
        accum = self.grad_accum_steps
        if accum > 1:
            dp = self.ctx.axis_size(self.ctx.data_axis) if self.ctx else 1
            if batch_size % (accum * dp) != 0:
                raise ValueError(
                    f"batch_size {batch_size} must divide by "
                    f"grad_accum_steps*dp = {accum}*{dp} (each microbatch "
                    "still shards over the data axis)")
        if variables is not None:
            self.model.set_weights(variables)
        self._adopt_transforms(featureset)
        self._prepare(seed)
        self._register_memory_pool()
        _m_accum.set(float(self.grad_accum_steps))
        shape = (self.ctx.mesh.shape if self.ctx is not None
                 else dict.fromkeys(self._mesh_axes, 1))
        for ax, size in shape.items():
            _m_mesh.labels(axis=ax).set(float(size))
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
            # the layers see this estimator's mesh (2D attention routing)
            # for the whole loop, whatever the global context is
            with self._scope():
                self._train_loop(featureset, batch_size, epochs,
                                 start_epoch, self._retry_policy.new_state(),
                                 tb, validation_data, validation_trigger,
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
                if self._group is not None:
                    # a failure one process saw cannot be rejoined to peers
                    # already blocked in the next collective: the job
                    # restarts and resumes from the checkpoint (JAX
                    # estimator.py:803-812)
                    raise
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
        # the data cursor of a resume: consumed here (matched or not), and
        # honoured by a featureset that can start an epoch at a step
        start_step = 0
        rc, self._resume_cursor = self._resume_cursor, None
        if rc and getattr(featureset, "supports_cursor", False):
            cur = DataCursor.from_state(rc)
            if cur.epoch == epoch:
                start_step = cur.step
        self._epoch_step0 = self.global_step - start_step
        stacked = None
        if hasattr(featureset, "stacked_epoch"):
            stacked = featureset.stacked_epoch(batch_size, epoch,
                                               self._feed_device(),
                                               **self._fs_kw())
        args = (batch_size, epoch, tb, tb_pend, losses, end_trigger, t_epoch)
        if stacked is not None:
            if self._run_resident_epoch(stacked, *args):
                return True
        elif self._run_host_epoch(featureset, *args, start_step=start_step):
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
        src.order, src.at = [int(i) for i in order], 0
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
                        losses, end_trigger, t_epoch, start_step=0):
        """Host tiers: groups of K batches, each copied into the static
        buffers and run as one dispatch; a ragged tail of fewer than K
        batches runs as single steps.  The in-memory, generator and disk
        tiers hand host tensors over (``_prefetch``), copied to the card
        here on the training thread's stream.  A cursor-capable set (the
        sharded tier) starts at ``start_step`` and stages its batches on
        the card itself (a stream of its own, after which this stream
        waits on its event), so the copy into the static buffers is one
        on the card: a graph reads fixed addresses, and the stage thread
        never writes a buffer a replay may still read."""
        k = self.steps_per_dispatch
        pend = []

        def dispatch(group, k_gran):
            if self._per_position:
                with self._step_scope(len(group)):
                    lv = self._position_steps(group)
                return self._post_dispatch(len(group), k_gran, lv,
                                           batch_size, epoch, tb, tb_pend,
                                           losses, end_trigger, t_epoch)
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

        if getattr(featureset, "supports_cursor", False):
            feed = _sync_counted(featureset.batches(
                batch_size, epoch=epoch, device=self._feed_device(),
                start_step=start_step, **self._fs_kw()))
        else:
            feed = _prefetch(featureset.batches(batch_size, epoch=epoch,
                                                device=torch.device("cpu"),
                                                **self._fs_kw()),
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
        params = self.params
        buffers = {n: b for n, b in self.model.named_buffers()}
        meta = {"epoch": epoch,
                "data_cursor": DataCursor(epoch=epoch,
                                          step=step_in_epoch).state()}
        bundle = (params, _opt_tree(self.opt_state), buffers, meta)
        # writers: process 0 alone for replicated state; every process
        # when a sharded leaf spans processes (its host files, JAX
        # estimator.py:1205-1218)
        if (self._group is not None and self._group.rank != 0
                and not needs_per_host(bundle)):
            return
        # nests under train.epoch when triggered inside an epoch (the
        # step-0 bootstrap checkpoint roots alone)
        with obs.span("train.checkpoint", step=self.global_step):
            save_checkpoint(self.checkpoint_dir, self.global_step, bundle,
                            keep=self.keep_checkpoints)

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
        if self._plan is not None:
            # full arrays carved by this mesh's shardings (any mesh shape)
            self._plan.refresh()
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
        self._adopt_transforms(featureset)
        self.model.eval()
        accs = [m.init() for m in self.metrics]
        loss_sum, n_total = 0.0, 0
        fwd = self._predictor()
        with torch.inference_mode(), self._scope():
            for x, y, n in self._feed(featureset, batch_size):
                preds = fwd(x)
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
        host batches (``_prefetch``) and moved to the device here, where a
        fused transform chain then runs.  Any batch size: under a mesh, a
        batch the data axis does not divide runs its attention unsharded
        (where the JAX package pads it), so no data-axis check applies."""
        to_dev = lambda t: tree_map(lambda a: a.to(self.device), t)
        tf = self._fused_tf
        for x, y, n in _prefetch(featureset.batches_with_counts(
                batch_size, drop_remainder=False,
                device=torch.device("cpu")), depth=self._prefetch_depth):
            x = to_dev(x)
            yield (x if tf is None else tf.apply_jax(x),
                   None if y is None else to_dev(y), n)

    def _predictor(self):
        """The forward ``evaluate`` and ``predict`` run: the module, or
        over the per-position step's replicas, each position its row block
        of the batch (``Positions.predict``)."""
        if not self._per_position:
            return self.model
        return self._positions().predict

    def _adopt_transforms(self, featureset) -> None:
        """The featureset's ``fuse=True`` chain runs in the step (a
        ``fuse=False`` chain already ran in the ingest pipeline)."""
        tfm = getattr(featureset, "transforms", None)
        self._fused_tf = (tfm if tfm is not None
                          and getattr(tfm, "fuse", False) else None)

    def predict(self, featureset, batch_size: int = 32, variables=None):
        """The model's outputs over the dataset, in order, as numpy."""
        if variables is not None:
            self.model.set_weights(variables)
        self._adopt_transforms(featureset)
        self.model.eval()
        outs = []
        fwd = self._predictor()
        with torch.inference_mode(), self._scope():
            for x, _, _ in self._feed(featureset, batch_size):
                outs.append(tree_map(lambda t: t.float().cpu().numpy(),
                                     fwd(x)))
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


def _shardings(mesh, axis: str, module: dict, opt_tree: dict, zshard: bool,
               msharded: bool):
    """The step's shardings ``(psh, gsh, osh)`` of the weights (the
    Megatron rules under ``msharded``, else replicated), of the gradient
    and update blocks (the ZeRO specs over ``axis`` under ``zshard``,
    composed with the Megatron ones; else the weights') and of the
    optimizer state (likewise)."""
    pspecs = partition_specs(module, mesh) if msharded else None
    ospecs = partition_specs(opt_tree, mesh) if msharded else None
    psh = (named_shardings(mesh, pspecs) if msharded
           else replicated_shardings(module, mesh))
    if zshard:
        return (psh, zero_shardings(module, mesh, axis, base_specs=pspecs),
                zero_shardings(opt_tree, mesh, axis, base_specs=ospecs))
    return psh, psh, (named_shardings(mesh, ospecs) if msharded
                      else replicated_shardings(opt_tree, mesh))


def _opt_tree(state: dict) -> dict:
    """The optimizer state's tensors (its count and slots) for a
    checkpoint; the decay mask (names) is rebuilt by ``init``."""
    return {k: v for k, v in state.items()
            if isinstance(v, (torch.Tensor, ShardedTensor, dict))}


def _opt_tensors(state) -> List[torch.Tensor]:
    """The optimizer state's tensors (a placed leaf's distinct shards)."""
    if state is None:
        return []
    out = []
    for leaf in tree_leaves(_opt_tree(state)):
        if isinstance(leaf, ShardedTensor):
            out.extend(t for _, t in leaf.unique_shards())
        else:
            out.append(leaf)
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
        _copy_into(t, src[name])


def _copy_into(dst, src: torch.Tensor) -> None:
    """A full checkpoint array into a tensor, or carved into a placed
    leaf's shards."""
    if isinstance(dst, ShardedTensor):
        dst.scatter_(src.to(dst.local_shard.device))
    else:
        dst.copy_(src)


def _copy_opt(state: dict, src: dict) -> None:
    for key, v in _opt_tree(state).items():
        if key == "schedule_count" and key not in src:
            # a checkpoint of one count (the port's before it kept
            # optax's second): the two counts are always equal
            key_src = "count"
        else:
            key_src = key
        if key_src not in src:
            raise KeyError(f"checkpoint optimizer state has no {key!r} "
                           f"(it holds {sorted(src)})")
        if isinstance(v, dict):
            _copy_named(f"optimizer {key}", v, src[key_src])
        else:
            _copy_into(v, src[key_src].reshape(v.shape))
