"""Device health monitoring: periodic liveness probes of each card.

Port of ``analytics_zoo_tpu/common/health.py``.  ``HealthMonitor`` probes
each device on a period with a tiny computation and exposes the last
status; a failed probe flips ``healthy``, feeds the device's circuit
breaker and fires the registered callbacks.  The probe is
``torch.arange(8, dtype=torch.float32, device=d)``, times 2, summed and
read back (56), run on a CUDA stream of the prober's own: PyTorch's side
streams do not wait on other streams, so a long training dispatch on
another stream does not read as a timeout.  ``device`` is the port's
usual argument: one device or a list of them, default every visible CUDA
device (``NoCudaDeviceError`` without one); tests pass ``"cpu"``.

Each device has one long-lived prober thread bounded by
``probe_timeout_s``, so a wedged device reads unhealthy without hanging
the monitor or leaking a thread per interval.  The ``health_probe`` chaos
point fires before each probe.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from concurrent.futures import CancelledError
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common.context import resolve_device
from analytics_zoo_tpu_torch.common.resilience import CircuitBreaker
from analytics_zoo_tpu_torch.testing import chaos

logger = logging.getLogger("analytics_zoo_tpu_torch.health")

Devices = Union[None, str, torch.device, Sequence[Union[str, torch.device]]]


def _devices(device: Devices) -> List[torch.device]:
    if device is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            resolve_device(None)            # raises NoCudaDeviceError
        return [torch.device("cuda", i) for i in range(n)]
    if isinstance(device, (str, torch.device)):
        return [resolve_device(device)]
    return [resolve_device(d) for d in device]


class HealthMonitor:
    """Periodic per-device liveness probes.

    Usage::

        mon = HealthMonitor(interval_s=30).start()
        ...
        mon.status()   # {"healthy": True, "devices": {...}, ...}
        mon.stop()
    """

    def __init__(self, interval_s: float = 30.0,
                 probe_timeout_s: float = 10.0,
                 on_failure: Optional[Callable[[Dict], None]] = None,
                 breaker_failures: int = 3,
                 breaker_recovery_s: float = 60.0,
                 device: Devices = None):
        self.devices = _devices(device)
        self.interval_s = interval_s
        self.probe_timeout_s = probe_timeout_s
        self.breaker_failures = breaker_failures
        self.breaker_recovery_s = breaker_recovery_s
        self._callbacks: List[Callable[[Dict], None]] = (
            [on_failure] if on_failure else [])
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._status: Dict = {"healthy": True, "devices": {}, "probes": 0,
                              "last_probe_ts": None}
        self._probers: Dict[str, "_DeviceProber"] = {}
        # per-device circuit breakers fed by probe verdicts:
        # breaker_failures consecutive failed probes eject the device
        # (state "open"); a successful probe after breaker_recovery_s
        # closes it again.  Schedulers consult
        # ``breaker_for(device).allow()`` before placing work.
        self._breakers: Dict[str, CircuitBreaker] = {}

    # ---- probe ------------------------------------------------------------
    def _probe_device(self, d, stream=None):
        chaos.fire("health_probe")
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            x = torch.arange(8, dtype=torch.float32, device=d)
            # the read back waits for this stream only
            return (x * 2.0).sum().cpu().numpy()

    def breaker_for(self, device) -> CircuitBreaker:
        """The per-device circuit breaker (created on demand).  State is
        driven by probe verdicts (this monitor IS the prober), so
        schedulers check the read-only ``.admissible`` before placing
        work — ``allow()`` would consume the half-open probe budget
        without ever reporting a verdict back."""
        key = str(device)
        with self._lock:
            b = self._breakers.get(key)
            if b is None:
                b = CircuitBreaker(
                    f"device:{key}",
                    failure_threshold=self.breaker_failures,
                    recovery_s=self.breaker_recovery_s)
                self._breakers[key] = b
            return b

    def _prober_for(self, d) -> "_DeviceProber":
        key = str(d)
        p = self._probers.get(key)
        if p is None or not p.alive:
            p = _DeviceProber(d, self._probe_device)
            self._probers[key] = p
        return p

    def probe_once(self) -> Dict:
        """Run one health probe across all addressable devices.

        Each device has ONE long-lived worker bounded by
        ``probe_timeout_s`` — a WEDGED device (transfer hangs instead of
        erroring) is reported unhealthy without hanging the monitor, and
        while its probe is still outstanding no new probe is scheduled
        (a persistently wedged device must not leak one blocked thread
        per interval)."""
        devices = self.devices
        dev_status = {}
        all_ok = True
        for d in devices:
            t0 = time.perf_counter()
            kind, payload = self._prober_for(d).probe(self.probe_timeout_s)
            if kind == "ok":
                ok = bool(np.isclose(float(payload), 56.0))
                err = None if ok else f"bad probe result {payload}"
            elif kind == "stuck":
                ok, err = False, ("previous probe still outstanding "
                                  "(device wedged); not re-probing")
            elif kind == "timeout":
                ok, err = False, (f"probe timed out after "
                                  f"{self.probe_timeout_s}s (device wedged)")
            else:
                ok, err = False, str(payload)[:200]
            breaker = self.breaker_for(d)
            if ok:
                breaker.record_success()
            else:
                # journaled (not just logged): a probe failure shows up
                # in the event timeline next to the breaker transitions
                # and whatever serving spans it coincided with
                obs.add_event("probe_failed", span=None, device=str(d),
                              error=(err or "")[:200])
                breaker.record_failure()
            dev_status[str(d)] = {
                "ok": ok,
                "latency_ms": round(1e3 * (time.perf_counter() - t0), 2),
                "breaker": breaker.state,
                **({"error": err} if err else {}),
            }
            all_ok = all_ok and ok
        with self._lock:
            was_healthy = self._status["healthy"]
            self._status = {
                "healthy": all_ok,
                "devices": dev_status,
                "probes": self._status["probes"] + 1,
                "last_probe_ts": time.time(),
                "process_index": 0,
            }
            snap = dict(self._status)
        if was_healthy and not all_ok:
            logger.error("device health probe FAILED: %s",
                         {k: v for k, v in dev_status.items()
                          if not v["ok"]})
            for cb in self._callbacks:
                try:
                    cb(snap)
                except (Exception, CancelledError):
                    logger.exception("health callback failed")
        return snap

    # ---- lifecycle --------------------------------------------------------
    def on_failure(self, cb: Callable[[Dict], None]) -> "HealthMonitor":
        self._callbacks.append(cb)
        return self

    def start(self) -> "HealthMonitor":
        if self._thread and self._thread.is_alive():
            return self
        self._stop.clear()
        # device status as registry gauges (zoo_device_healthy{device=..},
        # zoo_health_healthy, zoo_health_probes) — sampled from the
        # last probe at scrape time, so /metrics shows health for free
        obs.install_health_gauges(self)
        # synchronous first probe: .healthy must reflect a REAL probe from
        # the moment start() returns, not the constructor's optimism
        try:
            self.probe_once()
        except Exception:
            logger.exception("initial health probe crashed")

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.probe_once()
                except (Exception, CancelledError):
                    # CancelledError would otherwise kill the monitor
                    # thread silently: probes just stop, with .healthy
                    # frozen at the last verdict
                    logger.exception("health probe crashed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="zoo-health")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        for p in self._probers.values():
            p.shutdown()

    def status(self) -> Dict:
        with self._lock:
            return dict(self._status)

    @property
    def healthy(self) -> bool:
        return self.status()["healthy"]


class _DeviceProber:
    """One long-lived probe worker per device.

    A wedged transfer blocks THIS worker only; ``probe`` reports
    ``("stuck", None)`` while the previous request is outstanding instead
    of spawning another thread (a persistently wedged device would leak
    one forever-blocked thread per interval).  On a card the worker probes
    on a CUDA stream of its own."""

    def __init__(self, device, fn):
        self.device = device
        self._fn = fn
        self._req = threading.Event()
        self._done = threading.Event()
        self._result = ("err", RuntimeError("never ran"))
        self._busy = False
        self._shutdown = False
        self._stream = None
        # serializes concurrent probe() callers (the monitor loop vs a
        # user's probe_once()): without it a racing caller would see
        # _busy=True mid-probe and falsely report a healthy device stuck
        self._probe_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"zoo-health-{device}")
        self._thread.start()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def _loop(self):
        while True:
            self._req.wait()
            self._req.clear()
            if self._shutdown:
                return
            try:
                if self._stream is None and self.device.type == "cuda":
                    self._stream = torch.cuda.Stream(self.device)
                self._result = ("ok", self._fn(self.device, self._stream))
            except (Exception, CancelledError) as exc:
                # a cancellation from a wedged-then-killed transfer must
                # record an error result, not kill the prober
                self._result = ("err", exc)
            self._done.set()

    def probe(self, timeout_s: float):
        """-> ("ok", value) | ("err", exc) | ("timeout"|"stuck", None)."""
        with self._probe_lock:
            if self._busy:
                if not self._done.is_set():
                    return ("stuck", None)  # still wedged: don't pile on
                self._busy = False          # late completion: recovered
            self._done.clear()
            self._busy = True
            self._req.set()
            if not self._done.wait(timeout_s):
                return ("timeout", None)
            self._busy = False
            return self._result

    def shutdown(self):
        self._shutdown = True
        self._req.set()
