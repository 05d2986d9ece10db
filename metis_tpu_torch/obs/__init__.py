"""Observability of the port: plan fingerprints and the accuracy ledger
(``metis_tpu/obs/ledger.py``)."""
from metis_tpu_torch.obs.ledger import (
    AccuracyLedger,
    AccuracyMonitor,
    AccuracySample,
    DriftDetector,
    DriftStatus,
    LedgerSummary,
    fingerprint_artifact,
    fingerprint_ranked_plan,
    fingerprint_uniform_plan,
    plan_fingerprint,
)

__all__ = [
    "AccuracyLedger",
    "AccuracyMonitor",
    "AccuracySample",
    "DriftDetector",
    "DriftStatus",
    "LedgerSummary",
    "fingerprint_artifact",
    "fingerprint_ranked_plan",
    "fingerprint_uniform_plan",
    "plan_fingerprint",
]
