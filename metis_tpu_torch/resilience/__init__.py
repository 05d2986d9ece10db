"""Fault tolerance: deterministic fault injection, bounded retry, and the
training supervisor that drives checkpoint/replan/restore recovery (the
port of ``metis_tpu/resilience``)."""
from metis_tpu_torch.resilience.faults import (
    INJECTION_POINTS,
    NULL_INJECTOR,
    FaultInjector,
    FaultSpec,
    parse_fault_script,
)
from metis_tpu_torch.resilience.retry import RetryPolicy
from metis_tpu_torch.resilience.supervisor import (
    RecoveryRecord,
    RetryingCheckpointWriter,
    SupervisorReport,
    TrainingSupervisor,
    migration_decision,
)

__all__ = [
    "INJECTION_POINTS",
    "NULL_INJECTOR",
    "FaultInjector",
    "FaultSpec",
    "parse_fault_script",
    "RetryPolicy",
    "RecoveryRecord",
    "RetryingCheckpointWriter",
    "SupervisorReport",
    "TrainingSupervisor",
    "migration_decision",
]
