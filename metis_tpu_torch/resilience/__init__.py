"""Fault tolerance: deterministic fault injection, bounded retry, and the
training supervisor that drives checkpoint/replan/restore recovery (the
port of ``metis_tpu/resilience``), plus the fleet drill
(``resilience/fleet_drill.py``)."""
import importlib

# the reference's exports, resolved on first use: the fleet drill's fleet
# leg runs on the host without importing torch (the supervisor imports it)
_EXPORTS = {
    "INJECTION_POINTS": "metis_tpu_torch.resilience.faults",
    "NULL_INJECTOR": "metis_tpu_torch.resilience.faults",
    "FaultInjector": "metis_tpu_torch.resilience.faults",
    "FaultSpec": "metis_tpu_torch.resilience.faults",
    "parse_fault_script": "metis_tpu_torch.resilience.faults",
    "RetryPolicy": "metis_tpu_torch.resilience.retry",
    "RecoveryRecord": "metis_tpu_torch.resilience.supervisor",
    "RetryingCheckpointWriter": "metis_tpu_torch.resilience.supervisor",
    "SupervisorReport": "metis_tpu_torch.resilience.supervisor",
    "TrainingSupervisor": "metis_tpu_torch.resilience.supervisor",
    "migration_decision": "metis_tpu_torch.resilience.supervisor",
}


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_EXPORTS[name]), name)


__all__ = list(_EXPORTS)
