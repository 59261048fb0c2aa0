"""Device health probes and circuit breakers in the port, on the CPU.

``CircuitBreaker`` walks the JAX breaker's states under the same call
sequence and injected clock.  ``HealthMonitor(device="cpu")`` probes the
host, opens the device's breaker after planned ``health_probe`` faults,
fires ``on_failure`` once per healthy -> unhealthy flip, recovers, and
publishes the ``zoo_device_healthy`` gauges.
"""

import pytest

from analytics_zoo_tpu.common import resilience as J
from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common import resilience as T
from analytics_zoo_tpu_torch.common.health import HealthMonitor
from analytics_zoo_tpu_torch.testing import chaos


def _walk(mod):
    t = {"now": 0.0}
    b = mod.CircuitBreaker("walk", failure_threshold=3, recovery_s=10.0,
                           half_open_probes=1, clock=lambda: t["now"])
    seen = []
    steps = [("fail", 0), ("fail", 0), ("allow", 0), ("fail", 0),
             ("allow", 9.0), ("admissible", 10.5), ("allow", 10.5),
             ("allow", 10.5), ("fail", 10.5), ("allow", 12.0),
             ("allow", 21.0), ("ok", 21.0), ("allow", 21.0),
             ("fail", 21.0), ("ok", 21.0), ("fail", 21.0), ("reset", 21),
             ("allow", 21.0)]
    for op, now in steps:
        t["now"] = now
        if op == "fail":
            b.record_failure()
            got = None
        elif op == "ok":
            b.record_success()
            got = None
        elif op == "reset":
            b.reset()
            got = None
        elif op == "admissible":
            got = b.admissible
        else:
            got = b.allow()
        seen.append((op, got, b.state))
    return seen


def test_breaker_transitions_equal_jax():
    assert _walk(T) == _walk(J)
    for mod in (T, J):
        b = mod.CircuitBreaker("guard", failure_threshold=1,
                               recovery_s=60.0)
        with pytest.raises(RuntimeError):
            with b.guard("probe"):
                raise RuntimeError("boom")
        assert b.state == "open"
        with pytest.raises(mod.CircuitOpenError):
            with b.guard("probe"):
                pass
        with pytest.raises(ValueError):
            mod.CircuitBreaker("bad", failure_threshold=0)
    T.CircuitBreaker("gauge-test", failure_threshold=1).record_failure()
    assert 'zoo_resilience_breaker_state{breaker="gauge-test"} 2' \
        in obs.render()
    for exc in (ConnectionError(), TimeoutError(), ValueError(),
                type("BusyLoadingError", (Exception,), {})()):
        assert T.is_transient_broker_error(exc) == \
            J.is_transient_broker_error(exc)


def test_monitor_probes_faults_and_recovers(tmp_path):
    obs.configure_flight_recorder(dir=str(tmp_path))
    fired = []
    mon = HealthMonitor(interval_s=3600, breaker_failures=3,
                        breaker_recovery_s=0.0, device="cpu",
                        on_failure=fired.append)
    try:
        s0 = mon.start().status()
        assert s0["healthy"] and s0["devices"]["cpu"]["ok"]
        assert s0["devices"]["cpu"]["breaker"] == "closed"
        inj = chaos.ChaosInjector()
        inj.plan("health_probe", fault="raise", times=3)
        with chaos.installed(inj):
            for _ in range(3):
                s = mon.probe_once()
                assert not s["healthy"]
        assert inj.injected("health_probe") == 3
        assert len(fired) == 1 and not fired[0]["healthy"]
        assert mon.breaker_for("cpu")._state == "open"
        text = obs.render()
        assert 'zoo_device_healthy{device="cpu"} 0' in text
        assert mon.probe_once()["healthy"]
        assert mon.breaker_for("cpu").state == "closed"
        inj = chaos.ChaosInjector()
        inj.plan("health_probe", fault="cancel", times=1)
        with chaos.installed(inj):
            assert not mon.probe_once()["healthy"]
        assert mon.probe_once()["healthy"]
        assert len(fired) == 2
    finally:
        mon.stop()
