"""Per-tenant isolation for the serving engine.

Port of ``analytics_zoo_tpu/serving/tenancy.py`` (host-only, copied
because any ``analytics_zoo_tpu`` import loads jax).  A ``tenant`` field
rides the wire beside ``model`` / ``deadline_ts``, and the pipelined
engine gates each entry on its tenant's own credit pool:

- ``TenantPolicy``: a tenant's admission ``credits`` (its own
  ``AdmissionController`` pool), its scheduling ``weight`` and an optional
  default deadline.
- ``TenancyController``: resolve + the per-tenant credit gate
  (``tenant_acquire`` / ``tenant_release``) + per-tenant shed, deadline
  and usage counters.  Acquisition never blocks: a tenant past its quota
  sheds at its own gate, so its overload never holds up another tenant.
- ``WeightedScheduler``: weighted fair queuing over tenants in the
  engine's batched flush: each tenant accrues virtual time ``records /
  weight`` as it is served, each linger window's dispatch budget goes
  least virtual time first, and the overflow of a full window waits for
  the next one.

The chaos point ``tenant_admit`` fires inside ``tenant_acquire`` before
any book moves, so a fault there leaves the credit books balanced.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common.resilience import AdmissionController
from analytics_zoo_tpu_torch.testing import chaos

__all__ = ["TenancyController", "TenantPolicy", "TenantState",
           "WeightedScheduler", "DEFAULT_TENANT"]

#: entries carrying no wire ``tenant`` field account to this tenant
#: when the controller declares it (otherwise they are rejected)
DEFAULT_TENANT = "default"

_m_admitted = obs.lazy_counter(
    "zoo_tenant_admitted_total",
    "records admitted through a tenant's credit gate", ["tenant"])
_m_served = obs.lazy_counter(
    "zoo_tenant_served_total",
    "records served to completion, by tenant", ["tenant"])
_m_shed = obs.lazy_counter(
    "zoo_tenant_shed_total",
    "records shed at their tenant's own credit gate", ["tenant"])
_m_expired = obs.lazy_counter(
    "zoo_tenant_expired_total",
    "records expired past their deadline, by tenant (the per-tenant "
    "deadline-violation count of the SLO book)", ["tenant"])
_m_errors = obs.lazy_counter(
    "zoo_tenant_errors_total",
    "records error-finished, by tenant", ["tenant"])
_m_credits = obs.lazy_gauge(
    "zoo_tenant_credits",
    "a tenant's admission credit capacity", ["tenant"])


@dataclass
class TenantPolicy:
    """One tenant's declared share of the engine."""
    name: str
    credits: int = 64
    weight: float = 1.0
    default_deadline_ms: float = 0.0

    def __post_init__(self):
        if not self.name or "\x1f" in self.name:
            raise ValueError("tenant name must be non-empty and free "
                             "of the wire unit separator")
        if self.credits < 1:
            raise ValueError("tenant credits must be >= 1")
        if self.weight <= 0:
            raise ValueError("tenant weight must be > 0")


class TenantState:
    """Live books for one tenant: its credit pool + SLO counters."""

    __slots__ = ("policy", "admission", "admitted", "served", "shed",
                 "expired", "errors")

    def __init__(self, policy: TenantPolicy):
        self.policy = policy
        self.admission = AdmissionController(
            policy.credits, name=f"tenant-{policy.name}")
        self.admitted = 0
        self.served = 0
        self.shed = 0
        self.expired = 0
        self.errors = 0
        _m_credits.labels(tenant=policy.name).set(float(policy.credits))

    @property
    def name(self) -> str:
        return self.policy.name


class WeightedScheduler:
    """Weighted fair queuing by virtual time: ``pick`` the tenant with
    the least accrued ``served_records / weight``; a newly active
    tenant joins at the current minimum so it cannot starve the others
    by replaying its idle period.  Thread-safe; deterministic ties by
    name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._vtime: Dict[str, float] = {}

    def order(self, tenants: Iterable[str]) -> List[str]:
        """Tenants sorted into service order (least virtual time
        first)."""
        with self._lock:
            names = list(tenants)
            floor = min(self._vtime.values()) if self._vtime else 0.0
            for name in names:
                self._vtime.setdefault(name, floor)
            return sorted(names, key=lambda n: (self._vtime[n], n))

    def charge(self, tenant: str, records: int, weight: float) -> None:
        with self._lock:
            floor = min(self._vtime.values()) if self._vtime else 0.0
            cur = self._vtime.get(tenant, floor)
            self._vtime[tenant] = cur + records / max(weight, 1e-9)


class TenancyController:
    """Resolve + gate + account, one instance per engine.

    Policies are fixed at construction (the wire ``tenant`` field is
    matched against REGISTERED names only — request traffic can never
    mint label cardinality, same rule as the multi-model tier)."""

    def __init__(self, policies: Sequence[TenantPolicy]):
        if not policies:
            raise ValueError("TenancyController needs at least one "
                             "TenantPolicy")
        self._states: Dict[str, TenantState] = {}
        for p in policies:
            if p.name in self._states:
                raise ValueError(f"duplicate tenant {p.name!r}")
            self._states[p.name] = TenantState(p)
        self.scheduler = WeightedScheduler()
        self._lock = threading.Lock()

    def tenants(self) -> List[str]:
        return sorted(self._states)

    def resolve(self, name: Optional[str]) -> TenantState:
        """The entry's tenant state; unnamed entries map to the
        ``default`` tenant when declared.  ``KeyError`` on unknown
        names (the engine rejects the entry — never a new pool)."""
        key = name or DEFAULT_TENANT
        state = self._states.get(key)
        if state is None:
            raise KeyError(f"unknown tenant {key!r}; registered: "
                           f"{self.tenants()}")
        return state

    # ---- credit gate ------------------------------------------------------
    def tenant_acquire(self, state: TenantState, n: int = 1) -> bool:
        """Non-blocking admit of ``n`` records against the tenant's own
        pool.  False = shed at THIS tenant's gate (callers answer 429);
        other tenants' pools are untouched by construction."""
        chaos.fire("tenant_admit")
        if not state.admission.try_acquire(n):
            return False
        with self._lock:
            state.admitted += n
        _m_admitted.labels(tenant=state.name).inc(n)
        return True

    def tenant_force_acquire(self, state: TenantState, n: int = 1) -> None:
        """Admit past the bound (drain path / oversized entries): the
        books stay exact so releases and gauges remain truthful."""
        state.admission.force_acquire(n)
        with self._lock:
            state.admitted += n
        _m_admitted.labels(tenant=state.name).inc(n)

    def tenant_release(self, state: TenantState, n: int = 1) -> None:
        state.admission.release(n)

    # ---- SLO accounting ----------------------------------------------------
    def count_shed(self, state: TenantState, n: int = 1) -> None:
        with self._lock:
            state.shed += n
        _m_shed.labels(tenant=state.name).inc(n)

    def count_served(self, state: TenantState, n: int = 1) -> None:
        with self._lock:
            state.served += n
        _m_served.labels(tenant=state.name).inc(n)

    def count_expired(self, state: TenantState, n: int = 1) -> None:
        with self._lock:
            state.expired += n
        _m_expired.labels(tenant=state.name).inc(n)

    def count_error(self, state: TenantState, n: int = 1) -> None:
        with self._lock:
            state.errors += n
        _m_errors.labels(tenant=state.name).inc(n)

    def usage(self) -> Dict[str, Dict[str, int]]:
        """The per-tenant SLO book (``metrics()`` / tests): every
        admitted record is accounted to exactly one terminal outcome
        once the engine drains."""
        with self._lock:
            return {name: {"admitted": s.admitted, "served": s.served,
                           "shed": s.shed, "expired": s.expired,
                           "errors": s.errors,
                           "in_flight": s.admission.in_flight,
                           "credits": s.admission.capacity,
                           "weight": s.policy.weight}
                    for name, s in self._states.items()}

    @classmethod
    def from_config(cls, tenants) -> Optional["TenancyController"]:
        """Build from ``ServingConfig.tenants`` — a tuple/list of
        ``(name, credits, weight)`` rows (dataclass configs must stay
        picklable)."""
        if not tenants:
            return None
        policies = []
        for row in tenants:
            if isinstance(row, TenantPolicy):
                policies.append(row)
                continue
            row = tuple(row)
            policies.append(TenantPolicy(
                str(row[0]),
                int(row[1]) if len(row) > 1 else 64,
                float(row[2]) if len(row) > 2 else 1.0))
        return cls(policies)
