"""Latency-SLO inference planning — the port of ``metis_tpu/inference``.

A serving workload is a planning target beside training: :mod:`workload`
models the traffic (arrival rate, prompt/output lengths, SLOs) and derives
prefill/decode phase timings from the same per-layer profiles the training
planner runs on (a measured decode table where the profile has one);
:mod:`planner` searches disaggregated prefill/decode pool splits and ranks
them by sustainable throughput under p99 TTFT/TPOT SLOs; :mod:`replay`
sweeps a diurnal arrival-rate curve against the plan daemon and drives
elastic scale-up/down through ``POST /cluster_delta``.
"""
from metis_tpu_torch.inference.workload import InferenceWorkload, workload_from_dict
from metis_tpu_torch.inference.planner import (
    InferencePlannerResult,
    PoolPlan,
    RankedInferencePlan,
    dump_inference_plans,
    plan_inference,
)
from metis_tpu_torch.inference.replay import diurnal_rate, replay_traffic

__all__ = [
    "InferenceWorkload",
    "workload_from_dict",
    "InferencePlannerResult",
    "PoolPlan",
    "RankedInferencePlan",
    "dump_inference_plans",
    "plan_inference",
    "diurnal_rate",
    "replay_traffic",
]
