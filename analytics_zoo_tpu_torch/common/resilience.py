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
``AdmissionController.shed_count``).
- ``RetryPolicy`` / ``RetryState``: bounded retry with decorrelated-jitter
  backoff, which the estimator's retry from the latest checkpoint runs
  through.

Circuit breakers belong to parts not ported yet (the Redis broker and the
model registry, ROADMAP Queue 1 item 1).
"""

from __future__ import annotations

import contextlib
import contextvars
import random
import threading
import time
from concurrent.futures import CancelledError
from typing import Callable, Dict, Iterator, Optional, Tuple, Type

from analytics_zoo_tpu_torch.common.unported import reject

__all__ = ["AdmissionController", "Deadline", "DeadlineExceeded",
           "RetryPolicy", "RetryState", "current_deadline", "deadline_scope",
           "expired_counts", "record_expired"]


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


# ---- retry ----------------------------------------------------------------


class RetryPolicy:
    """Bounded retry with decorrelated-jitter exponential backoff.

    ``sleep = min(cap, uniform(base, 3 * prev))``: retries from a
    thundering herd spread out instead of re-colliding on synchronized
    powers of two.  Deadline-aware: a retry that could not complete before
    the ambient (or explicitly passed) ``Deadline`` is not attempted.
    ``KeyboardInterrupt`` / ``SystemExit`` are never retried,
    ``CancelledError`` only when ``retry_on`` names it, and a backoff
    sleep ends early when the caller's ``cancel`` event fires.
    """

    def __init__(self, max_retries: int = 3, base_s: float = 0.05,
                 cap_s: float = 2.0,
                 retry_on: Tuple[Type[BaseException], ...] = (
                     ConnectionError, TimeoutError),
                 retry_if: Optional[Callable[[BaseException], bool]] = None,
                 scope: str = "default", seed: Optional[int] = None):
        self.max_retries = int(max_retries)
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.retry_on = retry_on
        self.retry_if = retry_if
        self.scope = scope
        self.seed = seed

    def _retryable(self, exc: BaseException) -> bool:
        if isinstance(exc, (KeyboardInterrupt, SystemExit)):
            return False
        if isinstance(exc, CancelledError):
            return any(issubclass(t, CancelledError)
                       for t in self.retry_on)
        if self.retry_if is not None and self.retry_if(exc):
            return True
        return isinstance(exc, self.retry_on)

    def new_state(self) -> "RetryState":
        """Attempt tracking for loop-shaped callers (the estimator's epoch
        loop) that cannot wrap their body in a closure for ``call``."""
        return RetryState(self)

    def call(self, fn: Callable, *args,
             deadline: Optional[Deadline] = None,
             cancel: Optional[threading.Event] = None, **kw):
        """Run ``fn(*args, **kw)``, retrying transient failures."""
        state = self.new_state()
        while True:
            try:
                return fn(*args, **kw)
            except BaseException as exc:
                if not state.should_retry(exc, deadline=deadline):
                    raise
                state.backoff(cancel=cancel)


class RetryState:
    """One retry sequence: attempt accounting and jittered backoff."""

    def __init__(self, policy: RetryPolicy):
        self.policy = policy
        self.attempts = 0          # failures seen so far
        self._prev_delay = policy.base_s
        self._pending_delay: Optional[float] = None
        self._rng: Optional[random.Random] = None

    def next_delay(self) -> float:
        """The delay the next ``backoff`` sleeps, drawn once per attempt
        (the deadline check validates the delay that will be slept)."""
        if self._pending_delay is None:
            if self._rng is None:
                self._rng = random.Random(self.policy.seed)
            self._pending_delay = min(
                self.policy.cap_s,
                self._rng.uniform(self.policy.base_s,
                                  max(self.policy.base_s,
                                      3.0 * self._prev_delay)))
        return self._pending_delay

    def should_retry(self, exc: BaseException,
                     deadline: Optional[Deadline] = None) -> bool:
        """Record a failure; True iff the policy allows another attempt
        (retryable class, attempts left, and backoff + one attempt fits
        the deadline)."""
        self.attempts += 1
        if self.attempts > self.policy.max_retries:
            return False
        if not self.policy._retryable(exc):
            return False
        dl = deadline or current_deadline()
        if dl is not None and dl.remaining() <= self.next_delay():
            return False
        return True

    def backoff(self, cancel: Optional[threading.Event] = None) -> None:
        """Sleep the decorrelated-jitter delay; returns early when
        ``cancel`` fires."""
        delay = self.next_delay()
        self._pending_delay = None
        self._prev_delay = delay
        if cancel is not None:
            cancel.wait(delay)
        else:
            time.sleep(delay)
