"""Observability of the port: plan fingerprints, the accuracy ledger
(``metis_tpu/obs/ledger.py``), the decision log
(``metis_tpu/obs/provenance.py``) and the metrics plane
(``metis_tpu/obs/metrics.py``)."""
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
from metis_tpu_torch.obs.metrics import NULL_METRICS, MetricsRegistry
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
    "MetricsRegistry",
    "NULL_METRICS",
    "PlanDiff",
    "causal_chain",
    "diff_plans",
    "fingerprint_artifact",
    "fingerprint_ranked_plan",
    "fingerprint_uniform_plan",
    "plan_fingerprint",
]
