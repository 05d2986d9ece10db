"""Core types, config, errors, events, tracing and timing of the port."""
from metis_tpu_torch.core.types import (
    Strategy,
    UniformPlan,
    InterStagePlan,
    IntraStagePlan,
    PlanCost,
    RankedPlan,
    divisors,
    dump_ranked_plans,
)
from metis_tpu_torch.core.config import (
    ModelSpec,
    SearchConfig,
)
from metis_tpu_torch.core.errors import (
    MetisError,
    ProfileMissError,
    InfeasiblePlanError,
    ClusterSpecError,
)

__all__ = [
    "Strategy",
    "UniformPlan",
    "InterStagePlan",
    "IntraStagePlan",
    "PlanCost",
    "RankedPlan",
    "divisors",
    "dump_ranked_plans",
    "ModelSpec",
    "SearchConfig",
    "MetisError",
    "ProfileMissError",
    "InfeasiblePlanError",
    "ClusterSpecError",
]
