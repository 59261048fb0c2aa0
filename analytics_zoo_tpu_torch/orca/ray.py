"""The RayOnSpark counterpart: a group of worker processes that train
as one job.

Port of ``analytics_zoo_tpu/orca/ray.py``.  ``RayContext`` keeps the
lifecycle surface: ``init()`` brings the worker group up, ``run(fn, args,
timeout)`` starts ``num_workers`` processes and returns each one's
``fn(rank, *args)``, ``stop()`` tears them down, and workers left behind
are reaped at interpreter exit (``atexit``, the JVMGuard role);
``ProcessMonitor`` watches and kills them.

Workers start with ``spawn`` (a forked child cannot use CUDA).  Before
``fn`` runs, each worker builds the port's context with
``common.context.init_zoo_context``: for several workers a ``ZooConfig``
naming the coordinator ``127.0.0.1:<coordinator_port>``, ``num_processes``
and its rank, so the workers rendezvous over ``torch.distributed`` as the
processes of a multi-host job do (on the card: worker ``r`` drives
``cuda:(r % device_count)``, gloo when workers share a card, NCCL when
each has its own).  Workers run on the card unless the caller asks for
the host (``platform="cpu"``).  ``fn`` must be module-level (picklable),
like a Ray remote function.
"""

from __future__ import annotations

import atexit
import multiprocessing as mp
import os
import signal
import socket
import time
import traceback
from typing import Any, Callable, List, Optional

_ACTIVE: List["RayContext"] = []


def _reap_all() -> None:
    for ctx in list(_ACTIVE):
        ctx.stop(force=True)


atexit.register(_reap_all)


def _worker_main(rank: int, world_size: int, coordinator: str,
                 platform: Optional[str], fn: Callable, args: tuple,
                 conn) -> None:
    """A worker: the context (with the rendezvous), then ``fn``; its
    result or traceback goes back through ``conn``."""
    from analytics_zoo_tpu_torch.parallel import distributed
    try:
        from analytics_zoo_tpu_torch.common.config import ZooConfig
        from analytics_zoo_tpu_torch.common.context import init_zoo_context
        cfg = ZooConfig(platform=platform)
        if world_size > 1:
            cfg = cfg.replace(coordinator_address=coordinator,
                              num_processes=world_size, process_id=rank)
        init_zoo_context(cfg)
        result = fn(rank, *args)
        conn.send(("ok", result))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()
        distributed.shutdown()


class ProcessMonitor:
    """Watches worker processes and reaps them (ref ``ray/process.py``)."""

    def __init__(self, procs: List[mp.Process]):
        self.procs = procs

    def alive(self) -> List[bool]:
        return [p.is_alive() for p in self.procs]

    def kill_all(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        deadline = time.time() + 5.0
        for p in self.procs:
            p.join(max(0.0, deadline - time.time()))
            if p.is_alive():
                os.kill(p.pid, signal.SIGKILL)
                p.join(5.0)


class RayContext:
    """A worker group with the RayContext lifecycle surface.

    >>> ctx = RayContext(num_workers=2, platform="cpu")
    >>> ctx.init()
    >>> results = ctx.run(train_fn, args=(...,))   # fn(rank, *args) each
    >>> ctx.stop()

    ``platform``: None (the card) or "cpu", as ``ZooConfig.platform``.
    """

    _current: Optional["RayContext"] = None

    def __init__(self, num_workers: int = 1, coordinator_port: int = 0,
                 platform: Optional[str] = None):
        self.num_workers = num_workers
        self.coordinator_port = coordinator_port or self._free_port()
        self.platform = platform
        self.monitor: Optional[ProcessMonitor] = None
        self._initialized = False

    @staticmethod
    def _free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def init(self) -> "RayContext":
        if self._initialized:
            return self
        self._initialized = True
        _ACTIVE.append(self)
        RayContext._current = self
        return self

    @classmethod
    def get(cls) -> Optional["RayContext"]:
        return cls._current

    def run(self, fn: Callable, args: tuple = (),
            timeout: float = 600.0) -> List[Any]:
        """Run ``fn(rank, *args)`` on every worker; return the results in
        rank order.  The workers start together and rendezvous before
        ``fn`` runs; a worker that fails, dies or outlasts ``timeout``
        raises ``RuntimeError`` naming it, and every worker is stopped
        before this returns."""
        if not self._initialized:
            raise RuntimeError("RayContext not initialized; call init()")
        coordinator = f"127.0.0.1:{self.coordinator_port}"
        mp_ctx = mp.get_context("spawn")
        procs, conns = [], []
        try:
            for rank in range(self.num_workers):
                parent, child = mp_ctx.Pipe()
                p = mp_ctx.Process(
                    target=_worker_main,
                    args=(rank, self.num_workers, coordinator,
                          self.platform, fn, args, child),
                    daemon=True)
                p.start()
                child.close()
                procs.append(p)
                conns.append(parent)
        except BaseException:
            # started workers would wait in the rendezvous forever
            ProcessMonitor(procs).kill_all()
            raise
        self.monitor = ProcessMonitor(procs)
        results: List[Any] = [None] * self.num_workers
        errors = []
        deadline = time.time() + timeout
        try:
            for rank, conn in enumerate(conns):
                remaining = max(0.1, deadline - time.time())
                if not conn.poll(remaining):
                    errors.append(f"worker {rank}: timeout after {timeout}s")
                    continue
                try:
                    status, payload = conn.recv()
                except EOFError:
                    procs[rank].join(5.0)
                    errors.append(
                        f"worker {rank}: died without reporting "
                        f"(exitcode={procs[rank].exitcode})")
                    continue
                if status == "ok":
                    results[rank] = payload
                else:
                    errors.append(f"worker {rank}:\n{payload}")
        finally:
            self.monitor.kill_all()
        if errors:
            raise RuntimeError("worker failures:\n" + "\n".join(errors))
        return results

    def stop(self, force: bool = False) -> None:
        if self.monitor is not None:
            self.monitor.kill_all()
        self._initialized = False
        if self in _ACTIVE:
            _ACTIVE.remove(self)
        if RayContext._current is self:
            RayContext._current = None
