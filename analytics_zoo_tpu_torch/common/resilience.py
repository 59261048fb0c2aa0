"""Resilience primitives the LLM engine uses: deadlines and admission.

Copied from ``analytics_zoo_tpu/common/resilience.py`` (the port cannot
import that module: every ``analytics_zoo_tpu`` import loads jax):

- ``Deadline``: an absolute point in time work must finish by, monotonic
  inside the process and an epoch timestamp on the wire;
  ``deadline_scope`` / ``current_deadline`` carry one as the ambient
  deadline of a call (a context variable).
- ``AdmissionController``: credit-based admission; work beyond a bounded
  in-flight depth is rejected explicitly (``try_acquire`` False, then
  ``shed``) instead of queueing without bound.

The metric gauges, trace events and flight-recorder hooks of the JAX
module are not ported (ROADMAP Queue 1 item 6, observability): expired and
shed work is counted in plain integers (``expired_counts``,
``AdmissionController.shed_count``).  Retry policies and circuit breakers
belong to parts not ported yet (the Redis broker and the model registry,
ROADMAP Queue 1 item 1).
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Dict, Iterator, Optional

from analytics_zoo_tpu_torch.common.unported import reject

__all__ = ["AdmissionController", "Deadline", "DeadlineExceeded",
           "current_deadline", "deadline_scope", "expired_counts",
           "record_expired"]


class DeadlineExceeded(RuntimeError):
    """Raised (or recorded as an error result) when work outlives its
    time budget.  Distinct from TimeoutError: a deadline is an
    end-to-end budget attached to the REQUEST, not one call's wait."""


class Deadline:
    """An absolute point in time work must finish by.

    Internally monotonic (immune to wall-clock steps); ``wall()``
    converts to an epoch timestamp for the wire and ``from_wall`` back —
    cross-host propagation therefore assumes NTP-sane clocks, the
    standard deadline-propagation tradeoff.
    """

    __slots__ = ("expires_mono",)

    def __init__(self, budget_s: float):
        self.expires_mono = time.monotonic() + float(budget_s)

    @classmethod
    def at_mono(cls, expires_mono: float) -> "Deadline":
        dl = cls.__new__(cls)
        dl.expires_mono = float(expires_mono)
        return dl

    @classmethod
    def from_wall(cls, wall_ts: float) -> "Deadline":
        """Rebuild from an epoch-seconds deadline stamped on the wire."""
        return cls.at_mono(time.monotonic() + (float(wall_ts) - time.time()))

    def wall(self) -> float:
        """Epoch-seconds form for the wire (``from_wall`` inverts)."""
        return time.time() + self.remaining()

    def remaining(self) -> float:
        """Seconds left; negative when expired."""
        return self.expires_mono - time.monotonic()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def timeout(self, default: float) -> float:
        """A wait bound honoring this deadline: min(default, remaining),
        floored at 0 so an expired deadline polls instead of blocking."""
        return max(0.0, min(float(default), self.remaining()))

    def raise_if_expired(self, what: str = "work") -> None:
        if self.expired:
            raise DeadlineExceeded(
                f"{what} exceeded its deadline by {-self.remaining():.3f}s")

    def __repr__(self) -> str:
        return f"Deadline(remaining={self.remaining():.3f}s)"


_current_deadline: "contextvars.ContextVar[Optional[Deadline]]" = \
    contextvars.ContextVar("zoo_deadline", default=None)


def current_deadline() -> Optional[Deadline]:
    """The ambient deadline of this (logical) call, or None."""
    return _current_deadline.get()


@contextlib.contextmanager
def deadline_scope(deadline) -> Iterator[Optional[Deadline]]:
    """Set the ambient deadline for the dynamic extent of the block.

    ``deadline`` is a ``Deadline``, a float budget in seconds, or None
    (no-op scope, so call sites need no conditional).  Context variables
    do not cross thread hops by themselves: pipeline stages carry the
    ``Deadline`` object on the work item and enter a scope again when
    they pick the item up.
    """
    if deadline is not None and not isinstance(deadline, Deadline):
        deadline = Deadline(float(deadline))
    token = _current_deadline.set(deadline)
    try:
        yield deadline
    finally:
        _current_deadline.reset(token)


class AdmissionController:
    """Credit-based admission: at most ``capacity`` work units in flight.

    Credits are acquired when work is ADMITTED (read off the transport)
    and released when it completes (result or error written), so
    admitted-but-unfinished work is bounded and offered load beyond it is
    rejected explicitly instead of growing every queue.
    ``force_acquire`` admits regardless of credits: the shutdown drain
    uses it so entries whose stream cursor already advanced are never
    dropped.
    """

    def __init__(self, capacity: int, name: str = "serving"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.name = name
        self._cond = threading.Condition()
        self._capacity = int(capacity)
        self._in_flight = 0
        self._shed = 0

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def in_flight(self) -> int:
        return self._in_flight

    @property
    def shed_count(self) -> int:
        return self._shed

    def try_acquire(self, n: int = 1) -> bool:
        """Admit ``n`` units iff credits are available right now."""
        with self._cond:
            if self._in_flight + n <= self._capacity:
                self._in_flight += n
                return True
            return False

    def acquire(self, n: int = 1, timeout: float = 0.0,
                stop: Optional[threading.Event] = None) -> bool:
        """Admit ``n`` units, waiting up to ``timeout`` seconds for
        credits (bounded queueing).  Returns False on timeout or when
        ``stop`` is set (the caller tells them apart by the event).
        Never raises."""
        deadline = time.monotonic() + max(0.0, float(timeout))
        with self._cond:
            while self._in_flight + n > self._capacity:
                if stop is not None and stop.is_set():
                    return False
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                # wake now and then to look at the stop event (a release
                # normally notifies much sooner)
                self._cond.wait(min(remaining, 0.05))
            self._in_flight += n
            return True

    def force_acquire(self, n: int = 1) -> None:
        """Admit unconditionally (the drain path): in-flight may exceed
        capacity; the books stay exact so later releases balance."""
        with self._cond:
            self._in_flight += n

    def release(self, n: int = 1) -> None:
        with self._cond:
            self._in_flight = max(0, self._in_flight - n)
            self._cond.notify_all()

    def shed(self, n: int = 1, scope: Optional[str] = None,
             trace_id: Optional[int] = None) -> None:
        """Account an explicit rejection of ``n`` units (``trace_id``, the
        trace event's, is not ported yet and raises)."""
        reject("AdmissionController.shed", 6, trace_id=trace_id)
        with self._cond:
            self._shed += n


_expired_lock = threading.Lock()
#: work units dropped for an expired deadline, by scope
expired_counts: Dict[str, int] = {}


def record_expired(n: int = 1, scope: str = "serving",
                   trace_id: Optional[int] = None) -> None:
    """Account ``n`` work units dropped for an expired deadline
    (``trace_id``, the trace event's, is not ported yet and raises)."""
    reject("record_expired", 6, trace_id=trace_id)
    with _expired_lock:
        expired_counts[scope] = expired_counts.get(scope, 0) + n
