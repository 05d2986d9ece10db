"""Tenant model for the multi-tenant fleet scheduler — the port of
``metis_tpu/sched/tenant.py``.

Tangram (arXiv 2606.16907) is the contract this module encodes: a tenant
asks for *capacity* — a priority, a quota floor it must never fall below,
an optional ceiling, and the workload it runs — and the scheduler hides
*which* devices satisfy it.  A :class:`TenantSpec` is therefore everything
the fleet partitioner (``sched/fleet.py``) needs to carve a sub-cluster
and run the right planner on it, and nothing about device identity.

Validation happens at construction / registration, not at schedule time:
a tenant that could never be scheduled (zero quota, floor above ceiling)
is rejected with a typed :class:`~metis_tpu_torch.core.errors.TenantSpecError`
before it can distort a fleet partition.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from metis_tpu_torch.core.config import ModelSpec, SearchConfig
from metis_tpu_torch.core.errors import TenantSpecError
from metis_tpu_torch.inference.workload import InferenceWorkload, workload_from_dict


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's capacity ask + workload.

    ``priority``: bigger wins — both when surplus capacity is granted and
    when a shrink forces preemption (lowest priority is displaced first).
    Ties break on ``name`` (ascending for grants, so ``"a"`` outranks
    ``"b"``; descending for preemption) — deterministic by construction,
    never by registration order or dict iteration.

    ``quota_floor``: devices this tenant is guaranteed; the scheduler
    raises :class:`~metis_tpu_torch.core.errors.FleetOverCommitError` rather
    than ever allocating below it.  0 = best-effort.
    ``quota_ceiling``: devices this tenant may at most hold (``None`` =
    unbounded).  A ceiling of 0 is a zero-quota tenant — rejected here.

    ``workload``: ``None`` plans the tenant as training
    (``planner.api.plan_hetero``); an :class:`InferenceWorkload` routes it
    through the serving planner (``inference.planner.plan_inference``)
    with the workload's SLOs.
    """

    name: str
    model: ModelSpec
    config: SearchConfig
    priority: int = 0
    quota_floor: int = 0
    quota_ceiling: int | None = None
    workload: InferenceWorkload | None = None

    def __post_init__(self) -> None:
        if not self.name or not self.name.strip():
            raise TenantSpecError("tenant name must be non-empty")
        if self.quota_floor < 0:
            raise TenantSpecError(
                f"tenant {self.name!r}: quota_floor must be >= 0, "
                f"got {self.quota_floor}")
        if self.quota_ceiling is not None:
            if self.quota_ceiling == 0:
                raise TenantSpecError(
                    f"tenant {self.name!r}: quota_ceiling=0 is a "
                    "zero-quota tenant — it could never hold a device; "
                    "remove the tenant instead of registering it")
            if self.quota_ceiling < 0:
                raise TenantSpecError(
                    f"tenant {self.name!r}: quota_ceiling must be >= 1 "
                    f"or None, got {self.quota_ceiling}")
            if self.quota_ceiling < self.quota_floor:
                raise TenantSpecError(
                    f"tenant {self.name!r}: quota_ceiling "
                    f"{self.quota_ceiling} < quota_floor "
                    f"{self.quota_floor}")

    @property
    def kind(self) -> str:
        """"training" or "inference" — which planner prices this tenant."""
        return "inference" if self.workload is not None else "training"

    def ceiling_or(self, cap: int) -> int:
        """The effective ceiling against a fleet of ``cap`` devices."""
        return cap if self.quota_ceiling is None else min(self.quota_ceiling,
                                                          cap)


def tenant_from_dict(d: dict) -> TenantSpec:
    """Rebuild a TenantSpec from its JSON form (the serve daemon's
    ``POST /tenant`` body).  Model/config reuse the daemon's existing
    dict-to-dataclass rebuilders so a tenant registered over HTTP plans
    byte-identically to one constructed in-process."""
    from metis_tpu_torch.serve.daemon import (
        model_spec_from_dict,
        search_config_from_dict,
    )

    wl = d.get("workload")
    return TenantSpec(
        name=str(d["name"]),
        model=model_spec_from_dict(d["model"]),
        config=search_config_from_dict(d["config"]),
        priority=int(d.get("priority", 0)),
        quota_floor=int(d.get("quota_floor", 0)),
        quota_ceiling=(int(d["quota_ceiling"])
                       if d.get("quota_ceiling") is not None else None),
        workload=workload_from_dict(wl) if wl else None,
    )


@dataclass
class TenantRegistry:
    """Name-keyed tenant set with the two deterministic orders the
    scheduler consumes.  Mutation is registration-time only — the
    partitioner reads a stable snapshot."""

    _tenants: dict[str, TenantSpec] = field(default_factory=dict)

    def register(self, spec: TenantSpec) -> TenantSpec:
        if spec.name in self._tenants:
            raise TenantSpecError(
                f"tenant {spec.name!r} is already registered")
        self._tenants[spec.name] = spec
        return spec

    def remove(self, name: str) -> TenantSpec:
        try:
            return self._tenants.pop(name)
        except KeyError:
            raise TenantSpecError(f"no such tenant: {name!r}") from None

    def get(self, name: str) -> TenantSpec:
        try:
            return self._tenants[name]
        except KeyError:
            raise TenantSpecError(f"no such tenant: {name!r}") from None

    def __len__(self) -> int:
        return len(self._tenants)

    def __contains__(self, name: str) -> bool:
        return name in self._tenants

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._tenants))

    @property
    def total_quota_floor(self) -> int:
        return sum(t.quota_floor for t in self._tenants.values())

    def allocation_order(self) -> tuple[TenantSpec, ...]:
        """Grant order: priority descending, name ascending on ties —
        the order capacity flows TO tenants."""
        return tuple(sorted(self._tenants.values(),
                            key=lambda t: (-t.priority, t.name)))

    def preemption_order(self) -> tuple[TenantSpec, ...]:
        """Reclaim order: priority ascending, name descending on ties —
        the exact reverse of :meth:`allocation_order`, so the last tenant
        capacity would flow to is the first it is taken from."""
        return tuple(reversed(self.allocation_order()))
