"""Multi-tenant fleet scheduling: tenant registry + quota-safe fleet
partitioner over the single-job training/inference planners — the port of
``metis_tpu/sched``."""
from metis_tpu_torch.sched.fleet import (
    FleetPlan,
    FleetScheduler,
    TenantAllocation,
)
from metis_tpu_torch.sched.tenant import (
    TenantRegistry,
    TenantSpec,
    tenant_from_dict,
)

__all__ = [
    "FleetPlan",
    "FleetScheduler",
    "TenantAllocation",
    "TenantRegistry",
    "TenantSpec",
    "tenant_from_dict",
]
