"""Device choice and the process-wide runtime context.

Port of ``analytics_zoo_tpu/common/context.py``.  An entry point runs on
``cuda`` unless its caller names another device; with no card and no
device named it raises rather than run on the CPU.  ``init_zoo_context``
builds the device mesh (``parallel.mesh.Mesh``) by the JAX package's
rule, from a ``ZooConfig`` or from ``load_config``'s file, environment
and overrides, and keeps it as the process's context: a second call
returns the same context, as ``initNNContext`` does, until
``reset_context``.  ``get_context`` returns the context (building the
default one if there is none), ``current_context`` peeks without building
one, and ``context_scope`` / ``device_scope`` pin a context for the
calling thread.  ``ZooContext`` carries the mesh's sharding helpers
(``sharding``, ``data_sharding``, ``replicated``, ``replicate``), over the
port's ``NamedSharding`` and ``device_put``.

Several processes: a ``ZooConfig`` with ``coordinator_address``,
``num_processes`` and ``process_id`` makes ``init_zoo_context``
rendezvous over ``torch.distributed`` (``parallel.distributed.
initialize``, where the JAX package calls ``jax.distributed.initialize``)
and build a mesh over every process's positions: process ``r`` drives
``cuda:(r % device_count)`` (the host under ``platform="cpu"``) unless
``devices=`` names its own, and its positions come after those of the
processes before it, in the order of ``jax.devices()``, reshaped by the
axes as the JAX builder reshapes them: a process may hold several rows
of the "data" axis, or part of a model group (``Mesh.data_groups``:
processes that hold the same data coordinates take the same rows).  The context reports ``process_index``,
``process_count`` and the group's ``backend``; ``replicate`` places a
value every process supplies whole, as in the JAX package.  A context of
a given group and rank is built directly: ``ZooContext(config,
_build_mesh(devices, mesh_config, group))``.  Within a process a mesh
over several cards (the default over every visible one) puts each
position on its own card: ``distinct_devices`` says so, and the estimator
then runs each data position's work on its own card and stream
(``estimator/positions.py``); positions that share a device
(``["cuda:0"] * 4``) run the sharded step from that device.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Optional, Sequence, Union

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.config import (
    MeshConfig, ZooConfig, load_config)
from analytics_zoo_tpu_torch.parallel import distributed
from analytics_zoo_tpu_torch.parallel.mesh import (
    Mesh, NamedSharding, PartitionSpec, device_put)

logger = logging.getLogger("analytics_zoo_tpu_torch")

_lock = threading.Lock()
_context: Optional["ZooContext"] = None


class NoCudaDeviceError(RuntimeError):
    """No CUDA device is visible and the caller named no device."""


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device, and raises ``NoCudaDeviceError`` when there is none."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise NoCudaDeviceError(f"device {dev} asked for, but no CUDA "
                                    "device is visible")
        return dev
    if not torch.cuda.is_available():
        raise NoCudaDeviceError(
            "no CUDA device is visible; the port runs on the card by "
            "default. Pass device='cpu' to run the plain PyTorch versions "
            "on the CPU.")
    return torch.device("cuda", torch.cuda.current_device())


def _platform_devices(platform: Optional[str]) -> list:
    """The devices of a ``ZooConfig.platform``: every visible CUDA device
    for None, ``"cuda"`` or ``"gpu"``, the host for ``"cpu"``."""
    if platform == "cpu":
        return [torch.device("cpu")]
    if platform not in (None, "cuda", "gpu"):
        raise ValueError(f"platform {platform!r}: the port runs on "
                         "'cuda' (or 'gpu', or None: the card) or 'cpu'")
    resolve_device()
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class ZooContext:
    """The config tree, the device mesh built from it, and its sharding
    helpers."""

    def __init__(self, config: ZooConfig, mesh: Mesh):
        self.config = config
        self.mesh = mesh
        #: the torch device type of the mesh: "cuda" or "cpu"
        self.platform = mesh.local_devices[0].type

    # ---- processes --------------------------------------------------------
    @property
    def process_index(self) -> int:
        return self.mesh.process_index

    @property
    def process_count(self) -> int:
        return self.mesh.process_count

    @property
    def group(self):
        """The processes' ``parallel.distributed.Group`` (None: one)."""
        return self.mesh.group

    @property
    def backend(self) -> Optional[str]:
        """The collectives' backend, "nccl" or "gloo" (None: one
        process)."""
        return None if self.mesh.group is None else self.mesh.group.backend

    # ---- axis facts -------------------------------------------------------
    @property
    def num_devices(self) -> int:
        return self.mesh.size

    @property
    def data_axis(self) -> str:
        return "data"

    def axis_size(self, name: str) -> int:
        return self.mesh.shape.get(name, 1)

    @property
    def distinct_devices(self) -> bool:
        """Whether this process's mesh positions lie on more than one
        device (several cards, or ``["cpu", "meta"] * n``)."""
        return self.mesh.distinct_devices

    @property
    def global_batch_divisor(self) -> int:
        """Global batch sizes must divide by this (the data axis' size)."""
        return self.axis_size("data")

    # ---- sharding helpers -------------------------------------------------
    def sharding(self, *spec) -> NamedSharding:
        return NamedSharding(self.mesh, PartitionSpec(*spec))

    @property
    def data_sharding(self) -> NamedSharding:
        return self.sharding("data")

    @property
    def replicated(self) -> NamedSharding:
        return self.sharding()

    def replicate(self, tree):
        """``tree`` (tensors or numpy arrays) placed whole at every mesh
        position of this process (``parallel.mesh.device_put``): every
        process supplies the full value, the JAX package's contract."""
        return device_put(tree, self.replicated)

    def __repr__(self):
        procs = ("" if self.process_count == 1 else
                 f", process {self.process_index} of {self.process_count}"
                 f" over {self.backend}")
        return (f"ZooContext(platform={self.platform}, "
                f"mesh={self.mesh.shape}{procs})")


def _build_mesh(devices: Sequence[torch.device], mc: MeshConfig,
                group=None) -> Mesh:
    """The mesh ``mc`` lays out over ``devices``; with a ``group`` of P
    processes, ``devices`` are this process's and the mesh has P times as
    many positions, process ``q``'s after those of the processes before
    it, reshaped by ``mc.axis_names`` whatever groups that splits across
    processes (the JAX builder's rule)."""
    local = list(devices)
    procs = 1 if group is None else group.size
    devices = local * procs
    n = len(devices)
    sizes = {"data": mc.data, "model": mc.model, "sequence": mc.sequence,
             "expert": mc.expert, "pipeline": mc.pipeline}
    fixed = 1
    fill_axis = None
    for name in mc.axis_names:
        s = sizes[name]
        if s == -1:
            if fill_axis is not None:
                raise ValueError("only one mesh axis may be -1")
            fill_axis = name
        else:
            fixed *= s
    if fill_axis is not None:
        if n % fixed != 0:
            raise ValueError(f"{n} devices not divisible by fixed axes {fixed}")
        sizes[fill_axis] = n // fixed
    total = int(np.prod([sizes[a] for a in mc.axis_names]))
    if total != n:
        raise ValueError(f"mesh {sizes} does not cover {n} devices")
    shape = tuple(sizes[a] for a in mc.axis_names)
    flat = np.empty(n, dtype=object)
    flat[:] = list(devices)
    if procs == 1:
        return Mesh(flat.reshape(shape), mc.axis_names)
    # the devices in jax.devices() order: process 0's, then process 1's,
    # ..., reshaped by the axes: a process may hold part of a model group
    # or several rows of the data axis
    owners = np.repeat(np.arange(procs), len(local)).reshape(shape)
    return Mesh(flat.reshape(shape), mc.axis_names, processes=owners,
                process_index=group.rank, group=group)


def init_zoo_context(conf: Optional[ZooConfig] = None,
                     config_path: Optional[str] = None, *,
                     devices: Optional[Sequence] = None,
                     **overrides) -> ZooContext:
    """Initialize (or fetch) the process's context, whose mesh lays
    ``devices`` out by ``cfg.mesh``.

    Idempotent, as in the JAX package: while a context exists, a call
    returns it and ignores its arguments; ``reset_context`` drops it.

    ``cfg`` is ``conf``, or else ``load_config(config_path,
    **overrides)``: defaults < json/yaml file < ``ZOO_TPU_*`` environment
    < overrides, as in the JAX package.

    ``devices`` defaults to the devices of ``cfg.platform``: every visible
    CUDA device for None, ``"cuda"`` or ``"gpu"`` (``NoCudaDeviceError``
    when there is none), the host for ``"cpu"``; any other platform
    raises ``ValueError``.  A caller may name devices, repeated as often
    as the mesh has shards: ``["cpu"] * 8`` runs an 8-shard mesh on the
    host (as the tests do), ``["cuda:0"] * 4`` four shards on one card.

    With ``cfg.coordinator_address`` and ``cfg.num_processes`` > 1 the
    process first rendezvouses with the others as ``cfg.process_id``
    (``parallel.distributed.initialize``); its default device is then
    ``cuda:(process_id % device_count)``, made the current device (or the
    host under ``platform="cpu"``), and ``devices`` name this process's
    own.
    """
    global _context
    with _lock:
        if _context is not None:
            return _context
        cfg = conf or load_config(config_path, **overrides)
        group = None
        if cfg.coordinator_address and (cfg.num_processes or 1) > 1:
            rank = int(cfg.process_id or 0)
            if devices is None:
                devices = _platform_devices(cfg.platform)
                devices = [devices[rank % len(devices)]]
            else:
                devices = [resolve_device(d) for d in devices]
            if devices[0].type == "cuda":
                torch.cuda.set_device(devices[0])
            group = distributed.initialize(cfg.coordinator_address,
                                           cfg.num_processes, rank,
                                           devices[0])
        elif devices is None:
            devices = _platform_devices(cfg.platform)
        else:
            devices = [resolve_device(d) for d in devices]
        _context = ZooContext(cfg, _build_mesh(devices, cfg.mesh, group))
        logger.info("initialized %s", _context)
        return _context


_tls = threading.local()


def get_context() -> ZooContext:
    """The calling thread's scoped context, else the process's, built
    with the defaults (on the card) if there is none yet."""
    scoped = getattr(_tls, "ctx", None)
    if scoped is not None:
        return scoped
    if _context is None:
        return init_zoo_context()
    return _context


def current_context() -> Optional[ZooContext]:
    """The active context (thread-scoped first) WITHOUT initializing one:
    the layers peek at it to see whether a 2D (data × model) mesh is live,
    from code that may run before any context exists."""
    scoped = getattr(_tls, "ctx", None)
    if scoped is not None:
        return scoped
    return _context


class context_scope:
    """Pin ``get_context()`` / ``current_context()`` to ``ctx`` in the
    calling thread, for the body of a ``with``."""

    def __init__(self, ctx: ZooContext):
        self._ctx = ctx

    def __enter__(self) -> ZooContext:
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        _tls.ctx = self._prev
        return False


class device_scope(context_scope):
    """Scope the context to a sub-mesh of ``devices``: inside the ``with``,
    the calling thread sees a context of the same config whose mesh is
    data-parallel over ``devices`` alone."""

    def __init__(self, devices):
        if not isinstance(devices, (list, tuple)):
            devices = [devices]
        if not devices:
            raise ValueError("device_scope needs at least one device")
        base = get_context()
        cfg = dataclasses.replace(
            base.config,
            mesh=MeshConfig(data=len(devices), model=1, sequence=1,
                            expert=1, pipeline=1))
        super().__init__(ZooContext(cfg, _build_mesh(
            [resolve_device(d) for d in devices], cfg.mesh)))


def reset_context() -> None:
    """Drop the process's context (and the calling thread's scope), so
    that the next ``init_zoo_context`` builds a new mesh."""
    global _context
    with _lock:
        _context = None
        _tls.ctx = None


def set_context(ctx: ZooContext) -> None:
    global _context
    with _lock:
        _context = ctx
