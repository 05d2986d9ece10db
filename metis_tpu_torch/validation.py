"""Cost-model validation: predicted vs measured step time — the port of the
measured half of ``metis_tpu/validation.py`` (``ValidationReport``,
``measure_uniform_plan_ms`` for pp = 1, ``_timed_steps_ms``,
``validate_uniform_plan``).

The measured side runs the same code production training uses
(``execution.builder.build_executable``), so a validation failure indicts
the cost model, not a bespoke measurement rig.  The calibration fits of the
reference come with the planner slice; until then
``predict_uniform_plan_ms`` prices the one plan this slice executes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from metis_tpu_torch.core.config import ModelSpec
from metis_tpu_torch.core.device import resolve_device
from metis_tpu_torch.core.errors import MetisError
from metis_tpu_torch.core.timing import two_point_queue_ms
from metis_tpu_torch.core.types import UniformPlan


@dataclass(frozen=True)
class ValidationReport:
    """One predicted-vs-measured comparison."""

    plan: UniformPlan
    predicted_ms: float
    measured_ms: float
    steps: int

    @property
    def error_pct(self) -> float:
        """Signed prediction error: positive = cost model over-predicts."""
        return (self.predicted_ms - self.measured_ms) / self.measured_ms * 100

    @property
    def abs_error_pct(self) -> float:
        return abs(self.error_pct)

    def within(self, threshold_pct: float) -> bool:
        return self.abs_error_pct <= threshold_pct

    def to_json_dict(self) -> dict:
        return {
            "plan": {"dp": self.plan.dp, "pp": self.plan.pp, "tp": self.plan.tp,
                     "mbs": self.plan.mbs, "gbs": self.plan.gbs},
            "predicted_ms": self.predicted_ms,
            "measured_ms": self.measured_ms,
            "error_pct": self.error_pct,
            "steps": self.steps,
        }


def predict_uniform_plan_ms(profiles, device_type: str,
                            plan: UniformPlan) -> float:
    """The cost model's step time for a pp = dp = tp = 1 plan (the case of
    ``metis_tpu/cost/estimator.py:536-555`` with one stage and no
    communication): every microbatch runs every layer, then one optimizer
    step and one batch fetch.  The fwd/bwd sync term is 0 for profiles whose
    layer times sum to the measured total, as this port's profiler writes."""
    if (plan.pp, plan.dp, plan.tp) != (1, 1, 1):
        raise NotImplementedError(
            "multi-device plans are priced by the planner's estimator, which "
            "comes with the planner slice")
    prof = profiles.get(device_type, plan.tp, plan.mbs)
    meta = profiles.type_meta[device_type]
    num_mbs = plan.num_microbatches
    return (num_mbs * (prof.total_time_ms + prof.fb_sync_ms)
            + meta.optimizer_time_ms + meta.batch_generator_ms)


def measure_uniform_plan_ms(
    plan: UniformPlan,
    model: ModelSpec,
    device: str | torch.device = "cuda",
    steps: int = 5,
    warmup: int = 2,
    seed: int = 0,
    dtype: torch.dtype | None = None,
) -> float:
    """Median wall time (ms) of one full training step of ``plan`` executed
    on ``device`` through ``build_executable`` (pp = 1, one device)."""
    from metis_tpu_torch.execution.builder import build_executable
    from metis_tpu_torch.execution.mesh import PlanArtifact
    from metis_tpu_torch.models import config_for_model_spec

    dev = resolve_device(device)
    if plan.dp * plan.pp * plan.tp != 1:
        raise MetisError(
            f"plan needs {plan.dp * plan.pp * plan.tp} devices; this slice "
            "executes on one")
    cfg = config_for_model_spec(
        model, **({"dtype": dtype} if dtype is not None else {}))
    exe = build_executable(cfg, PlanArtifact.from_uniform_plan(plan), device=dev)
    state = exe.init(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (plan.gbs, cfg.seq_len),
                           generator=gen, device=dev)

    def run_once():
        nonlocal state
        state, loss = exe.step(state, tokens, tokens)
        return loss

    return _timed_steps_ms(run_once, dev, steps, warmup)


def _timed_steps_ms(run_once, device: torch.device, steps: int,
                    warmup: int) -> float:
    """Time chained train steps.

    CPU: per-step wall times, median (each step is synchronous).  CUDA:
    queue the steps (they chain through the updated state, so they run in
    order on the stream) and fence once with ``torch.cuda.synchronize`` —
    the two-point form cancels the launch and fence overhead."""
    if device.type == "cpu":
        for _ in range(warmup):
            run_once()
        samples = []
        for _ in range(steps):
            t0 = time.perf_counter()
            run_once()
            samples.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(samples))

    def enqueue(n: int):
        for _ in range(n):
            run_once()

    return two_point_queue_ms(enqueue, max(steps, 1),
                              sync=lambda _: torch.cuda.synchronize(device))


def validate_uniform_plan(
    plan: UniformPlan,
    predicted_ms: float,
    model: ModelSpec,
    device: str | torch.device = "cuda",
    steps: int = 5,
    warmup: int = 2,
    seed: int = 0,
) -> ValidationReport:
    """Execute ``plan`` and compare against the cost model's prediction."""
    measured = measure_uniform_plan_ms(
        plan, model, device, steps=steps, warmup=warmup, seed=seed)
    return ValidationReport(
        plan=plan, predicted_ms=predicted_ms, measured_ms=measured, steps=steps)
