"""Observability of the port: plan fingerprints, the accuracy ledger
(``metis_tpu/obs/ledger.py``) and the decision log
(``metis_tpu/obs/provenance.py``)."""
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
from metis_tpu_torch.obs.provenance import (
    DecisionLog,
    DecisionRecord,
    PlanDiff,
    causal_chain,
    diff_plans,
)

__all__ = [
    "AccuracyLedger",
    "AccuracyMonitor",
    "AccuracySample",
    "DecisionLog",
    "DecisionRecord",
    "DriftDetector",
    "DriftStatus",
    "LedgerSummary",
    "PlanDiff",
    "causal_chain",
    "diff_plans",
    "fingerprint_artifact",
    "fingerprint_ranked_plan",
    "fingerprint_uniform_plan",
    "plan_fingerprint",
]
