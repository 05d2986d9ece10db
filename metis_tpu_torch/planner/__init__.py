"""Planner entry points of the port (``metis_tpu/planner/api.py``)."""
from metis_tpu_torch.planner.api import (
    PlannerResult,
    RankedUniformPlan,
    UniformPlannerResult,
    plan_hetero,
    plan_uniform,
)

__all__ = [
    "PlannerResult",
    "RankedUniformPlan",
    "UniformPlannerResult",
    "plan_hetero",
    "plan_uniform",
]
from metis_tpu_torch.planner.replan import (
    ClusterDelta,
    ReplanReport,
    grow_cluster,
    replan,
    shrink_cluster,
)

__all__ += ["ClusterDelta", "ReplanReport", "grow_cluster", "replan",
            "shrink_cluster"]
