"""Processes: the port's counterpart of ``jax.distributed`` and
``jax.experimental.multihost_utils``.

``initialize`` is the rendezvous ``common.context.init_zoo_context`` runs
when a ``ZooConfig`` names a coordinator: ``torch.distributed`` with
``init_method="tcp://<coordinator_address>"``, ``rank=process_id`` and
``world_size=num_processes``, over gloo.  The processes then exchange the
identity of the device each one drives (its host name and the card's
UUID, or "cpu"), and the backend follows from that topology, never from a
failure: NCCL when every process drives a card of its own, gloo when
processes share a card (NCCL refuses two ranks on one device) or run on
the CPU.  An NCCL group that fails to form raises; it never gives way to
gloo.  The result is a ``Group``: the torch process group, this process's
rank among ``size``, the backend's name and the timeout every collective
waits at most (``ZOO_TPU_COLLECTIVE_TIMEOUT_S``, default 600 s).  Under
gloo a process whose peer died raises within it instead of hanging.
Under NCCL the wait has no timeout of its own: the group's watchdog,
given the same timeout, aborts the survivor's process instead of raising
in it.

A ``Group`` can also wrap a process group built by the caller (tests build
``torch.distributed.ProcessGroupGloo`` over a ``HashStore`` and run two
ranks as two threads of one process).  Its collectives go through the
process group's own methods, so either kind works; gloo takes CUDA
tensors for them.

The functions below (``process_index``, ``process_count``, ``barrier``,
``all_reduce``, ``broadcast``, ``process_allgather``, ``batch_offset``)
act on the group of the live context (``common.context.current_context``:
the calling thread's ``context_scope`` first); without one, or with one
of a single process, they act on this process alone.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

#: how long a collective waits for its peers, in seconds
DEFAULT_TIMEOUT_S = 600.0


def collective_timeout_s() -> float:
    """``ZOO_TPU_COLLECTIVE_TIMEOUT_S`` if set, else ``DEFAULT_TIMEOUT_S``."""
    return float(os.environ.get("ZOO_TPU_COLLECTIVE_TIMEOUT_S",
                                DEFAULT_TIMEOUT_S))


class Group:
    """The processes of a job: ``pg`` (a torch process group) over which
    this process is ``rank`` of ``size``, named ``backend`` ("gloo" or
    "nccl").  ``device`` is where a host value is staged for a collective
    (the card under NCCL, the host under gloo).  ``reduced_bytes`` counts
    the bytes this process has all-reduced, ``reduce_seconds`` the host
    time its all-reduces took (waiting for the slowest process
    included)."""

    def __init__(self, pg, rank: int, size: int, backend: str = "gloo",
                 timeout_s: Optional[float] = None, device=None):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} is not in [0, {size})")
        self.pg = pg
        self.rank = int(rank)
        self.size = int(size)
        self.backend = backend
        self.timeout_s = (collective_timeout_s() if timeout_s is None
                          else float(timeout_s))
        self.device = torch.device(device if device is not None
                                   else ("cuda" if backend == "nccl"
                                         else "cpu"))
        self.reduced_bytes = 0
        self.reduce_seconds = 0.0

    def _wait(self, work, what: str) -> None:
        try:
            if self.backend == "nccl":
                # a dead peer: the NCCL watchdog aborts this process
                # after the group's timeout, nothing raises here
                work.wait()
            else:
                work.wait(datetime.timedelta(seconds=self.timeout_s))
        except Exception as exc:
            raise RuntimeError(
                f"{what} over {self.backend} (rank {self.rank} of "
                f"{self.size}) failed within {self.timeout_s:g} s: "
                f"{exc}") from exc

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` summed (``op="mean"``: averaged) over the processes, in
        place; returns ``t``."""
        if op not in ("sum", "mean"):
            raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")
        t0 = time.perf_counter()
        self._wait(self.pg.allreduce([t]), "all_reduce")
        self.reduce_seconds += time.perf_counter() - t0
        self.reduced_bytes += t.numel() * t.element_size()
        if op == "mean":
            t.div_(self.size)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` of process ``src`` copied into every process's ``t``."""
        opts = dist.BroadcastOptions()
        opts.rootRank = int(src)
        self._wait(self.pg.broadcast([t], opts), "broadcast")
        return t

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every process's ``t`` (same shape and dtype in each), in rank
        order."""
        out = [torch.empty_like(t) for _ in range(self.size)]
        self._wait(self.pg.allgather([out], [t.contiguous()]), "all_gather")
        return out

    def barrier(self, tag: str = "") -> None:
        """Return once every process has reached the barrier of ``tag``."""
        if self.backend == "nccl":
            # a device all-reduce: an NCCL barrier guesses the rank's card
            self.all_reduce(torch.zeros(1, device=self.device))
            torch.cuda.synchronize(self.device)
            return
        self._wait(self.pg.barrier(), f"barrier {tag!r}")

    def __repr__(self):
        return (f"Group(rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r})")


def _device_identity(device: torch.device) -> str:
    """The host and card a process drives ("cpu" for the host)."""
    if device.type != "cuda":
        return "cpu"
    props = torch.cuda.get_device_properties(device)
    card = getattr(props, "uuid", None) or device.index
    return f"{socket.gethostname()}/{card}"


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, device: torch.device) -> Group:
    """Rendezvous with the other ``num_processes - 1`` processes at
    ``coordinator_address`` ("host:port", where process 0 listens) and
    return the job's ``Group`` with its backend chosen by topology (see
    the module docstring).  Process ``process_id`` drives ``device``."""
    if not coordinator_address or ":" not in coordinator_address:
        raise ValueError(f"coordinator_address must be 'host:port', got "
                         f"{coordinator_address!r}")
    n, rank = int(num_processes), int(process_id)
    timeout_s = collective_timeout_s()
    timeout = datetime.timedelta(seconds=timeout_s)
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method="tcp://"
                                + coordinator_address, rank=rank,
                                world_size=n, timeout=timeout)
    elif (dist.get_rank(), dist.get_world_size()) != (rank, n):
        raise RuntimeError(
            f"torch.distributed is already initialised as rank "
            f"{dist.get_rank()} of {dist.get_world_size()}, not {rank} of "
            f"{n}")
    idents: List[Any] = [None] * n
    dist.all_gather_object(idents, _device_identity(device))
    own_cards = device.type == "cuda" and len(set(idents)) == n
    if own_cards:
        # every rank must join new_group; each reads the same identities
        pg = dist.new_group(backend="nccl", timeout=timeout)
        group = Group(pg, rank, n, "nccl", timeout_s, device)
        group.all_reduce(torch.zeros(1, device=device))   # forms the ring
        return group
    return Group(dist.group.WORLD, rank, n, "gloo", timeout_s, "cpu")


def shutdown() -> None:
    """Leave the job's process group (the default one) if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


# ---- the live context's group ---------------------------------------------

def _group(ctx=None) -> Optional[Group]:
    if ctx is None:
        from analytics_zoo_tpu_torch.common.context import current_context
        ctx = current_context()
    return None if ctx is None else ctx.mesh.group


def process_index(ctx=None) -> int:
    """This process's index among the job's (0 without a group)."""
    g = _group(ctx)
    return 0 if g is None else g.rank


def process_count(ctx=None) -> int:
    """The number of processes of the job (1 without a group)."""
    g = _group(ctx)
    return 1 if g is None else g.size


def barrier(tag: str = "", ctx=None) -> None:
    """``multihost_utils.sync_global_devices``: wait for every process."""
    g = _group(ctx)
    if g is not None and g.size > 1:
        g.barrier(tag)


def all_reduce(t: torch.Tensor, op: str = "sum", ctx=None) -> torch.Tensor:
    """``t`` summed (or averaged) over the processes, in place."""
    g = _group(ctx)
    if g is None or g.size == 1:
        return t
    return g.all_reduce(t, op)


def broadcast(t: torch.Tensor, src: int = 0, ctx=None) -> torch.Tensor:
    """Process ``src``'s ``t`` in every process, in place."""
    g = _group(ctx)
    if g is None or g.size == 1:
        return t
    return g.broadcast(t, src)


def process_allgather(in_tree, tiled: bool = False, ctx=None):
    """``multihost_utils.process_allgather``: every leaf (an array, a
    tensor or a number) gathered from every process as numpy, stacked on
    a new leading axis in process order (``tiled``: concatenated along
    the first axis)."""
    from analytics_zoo_tpu_torch.parallel.mesh import tree_map
    g = _group(ctx)

    def leaf(x):
        arr = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
               else np.asarray(x))
        if g is None or g.size == 1:
            parts = [arr]
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr)).to(g.device)
            parts = [p.cpu().numpy().reshape(arr.shape)
                     for p in g.all_gather(t)]
        return (np.concatenate(parts) if tiled and arr.ndim
                else np.stack(parts))
    return tree_map(leaf, in_tree)


def batch_offset(rows: int, ctx=None) -> int:
    """The global index of this process's first row of the global batch,
    when each process holds ``rows`` rows of it (``process_index *
    rows``); 0 for one process.  The dropout draws add it, so a process's
    masks are its rows of the global masks."""
    return process_index(ctx) * int(rows)
