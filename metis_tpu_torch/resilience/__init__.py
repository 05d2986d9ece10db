"""Fault tolerance: deterministic fault injection and bounded retry (the
port of ``metis_tpu/resilience``; the training supervisor comes with
ROADMAP §A.5)."""
from metis_tpu_torch.resilience.faults import (
    INJECTION_POINTS,
    NULL_INJECTOR,
    FaultInjector,
    FaultSpec,
    parse_fault_script,
)
from metis_tpu_torch.resilience.retry import RetryPolicy

__all__ = [
    "INJECTION_POINTS",
    "NULL_INJECTOR",
    "FaultInjector",
    "FaultSpec",
    "parse_fault_script",
    "RetryPolicy",
]
