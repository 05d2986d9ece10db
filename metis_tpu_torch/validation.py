"""Cost-model validation: predicted vs measured step time — the port of
``metis_tpu/validation.py`` for pp = 1 plans (``ValidationReport``,
``measure_uniform_plan_ms``, ``_timed_steps_ms``, ``validate_uniform_plan``,
``validate_planner_choice``, ``contention_calibrated`` and
``affine_loo_calibrated``).

The measured side runs the same code production training uses
(``execution.builder.build_executable``), so a validation failure indicts
the cost model, not a bespoke measurement rig.  A dp x tp plan runs one rank
per device through ``execution.dist.spawn``, and rank 0's timing is the
measurement; a plan that needs more devices than the device list holds (by
default one on the CPU, every visible card on CUDA) raises — it is never
shrunk to fit.  Predictions come from the
planner: ``planner.api.plan_uniform`` ranks the plans with the ported
``UniformCostEstimator``, and ``validate_planner_choice`` measures the top
of that ranking.
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Sequence

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


def measure_uniform_plan_ms(
    plan: UniformPlan,
    model: ModelSpec,
    device: str | torch.device = "cuda",
    steps: int = 5,
    warmup: int = 2,
    seed: int = 0,
    dtype: torch.dtype | None = None,
    devices: Sequence | None = None,
) -> float:
    """Median wall time (ms) of one full training step of ``plan`` (pp = 1)
    executed through ``build_executable``: on ``device`` when the plan needs
    one device, else on one rank per entry of ``devices`` (default: one
    device on the CPU, every visible card on CUDA) over NCCL on CUDA, gloo
    on the CPU."""
    from metis_tpu_torch.execution import dist as mdist
    from metis_tpu_torch.models import config_for_model_spec

    dev = resolve_device(device)
    if plan.pp > 1:
        raise NotImplementedError(
            "pipelined plans run on the pipeline executor of a later slice")
    need = plan.dp * plan.tp
    cfg = config_for_model_spec(
        model, **({"dtype": dtype} if dtype is not None else {}))
    if need == 1:
        return _measure_plan_rank(0, dev, plan, cfg, steps, warmup, seed)
    devs = list(devices if devices is not None else mdist.default_devices(dev))
    if need > len(devs):
        raise MetisError(
            f"plan needs {need} devices, have {len(devs)}; a plan is never "
            "shrunk to fit")
    devs = devs[:need]
    return mdist.spawn(_measure_plan_rank, need, mdist.default_backend(devs),
                       devs, plan, cfg, steps, warmup, seed)[0]


def _measure_plan_rank(rank: int, device: torch.device, plan: UniformPlan,
                       cfg, steps: int, warmup: int, seed: int) -> float:
    """One rank of ``measure_uniform_plan_ms`` (the only one at one device)."""
    from metis_tpu_torch.execution.builder import build_executable
    from metis_tpu_torch.execution.mesh import PlanArtifact

    exe = build_executable(cfg, PlanArtifact.from_uniform_plan(plan),
                           device=device)
    state = exe.init(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (plan.gbs, cfg.seq_len),
                           generator=gen, device=device)

    def run_once():
        nonlocal state
        state, loss = exe.step(state, tokens, tokens)
        return loss

    return _timed_steps_ms(run_once, device, steps, warmup)


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
    devices: Sequence | None = None,
) -> ValidationReport:
    """Execute ``plan`` and compare against the cost model's prediction."""
    measured = measure_uniform_plan_ms(
        plan, model, device, steps=steps, warmup=warmup, seed=seed,
        devices=devices)
    return ValidationReport(
        plan=plan, predicted_ms=predicted_ms, measured_ms=measured, steps=steps)


def contention_calibrated(reports: Sequence, key=None,
                          fit_points: int = 1) -> tuple[dict, list]:
    """Fit-and-hold-out environment calibration (the reference's
    ``contention_calibrated``): within each group of ``key(report)`` (default:
    one group) the first ``fit_points`` reports fit a scalar factor, the
    geometric mean of their measured / predicted ratios, and the remaining
    reports are re-issued with predictions ``predicted * factor``.

    Returns ``(factors, held_out)``: factors keyed by group key (None for
    the default single group)."""
    groups: dict = {}
    for r in reports:
        groups.setdefault(key(r) if key is not None else None, []).append(r)
    factors: dict = {}
    held_out: list = []
    k_fit = max(fit_points, 1)
    for k, rs in groups.items():
        fit = rs[:k_fit]
        factors[k] = math.exp(
            sum(math.log(r.measured_ms / r.predicted_ms) for r in fit)
            / len(fit))
        held_out.extend(
            dataclasses.replace(r, predicted_ms=r.predicted_ms * factors[k])
            for r in rs[k_fit:])
    return factors, held_out


def affine_loo_calibrated(
    reports: Sequence, regressor=None
) -> tuple[dict, list]:
    """Leave-one-out affine calibration: ``measured ~= a * predicted +
    c * regressor`` with ``a, c >= 0``, fit by least squares on all OTHER
    reports — every report is evaluated with the fit that EXCLUDED it, so
    each error is a held-out number while no plan is wasted as a pure fit
    point.  When measured times are flat it converges to a ~= 0 with a
    constant term; when compute dominates the slope recovers.

    ``regressor(report)`` supplies the second column (default: 1.0 — a
    fixed per-step dispatch overhead).  Falls back to the scalar
    ``contention_calibrated`` below 3 reports.  Returns ``(fit,
    loo_reports)`` with fit refit on ALL points for the record."""
    if len(reports) < 3:
        k = max(1, len(reports) - 1)
        f, held = contention_calibrated(reports, fit_points=k)
        return ({"factor": round(f.get(None, 1.0), 4), "overhead_ms": 0.0,
                 "mode": "scalar", "fit_points": k}, held)

    preds = np.array([r.predicted_ms for r in reports], np.float64)
    meas = np.array([r.measured_ms for r in reports], np.float64)
    reg = np.array([regressor(r) if regressor is not None else 1.0
                    for r in reports], np.float64)

    def fit(p, m, g):
        a_mat = np.stack([p, g], axis=1)
        (a, c), *_ = np.linalg.lstsq(a_mat, m, rcond=None)
        if a < 0:  # dispatch-flat regime: overhead-only model
            a = 0.0
            c = float((m * g).sum() / (g * g).sum())
        elif c < 0:  # compute-only model
            c = 0.0
            a = float((p * m).sum() / (p * p).sum())
        return float(a), float(c)

    out = []
    idx = np.arange(len(reports))
    for i, r in enumerate(reports):
        mask = idx != i
        a, c = fit(preds[mask], meas[mask], reg[mask])
        out.append(dataclasses.replace(
            r, predicted_ms=a * preds[i] + c * reg[i]))
    a_all, c_all = fit(preds, meas, reg)
    return ({"factor": round(a_all, 4), "overhead_ms": round(c_all, 4),
             "mode": "affine_loo", "fit_points": len(reports)}, out)


def validate_planner_choice(
    ranked_plans,
    model: ModelSpec,
    device: str | torch.device = "cuda",
    top_k: int = 1,
    steps: int = 5,
    warmup: int = 2,
) -> list[ValidationReport]:
    """Validate the top-k plans of a ``UniformPlannerResult`` — the full
    predicted-vs-measured loop over what the planner would deploy.  Each
    prediction is the plan's ``cost.total_ms`` from the estimator.

    Plans the uniform executor cannot realize (pipeline depth not dividing
    the block count evenly) are skipped, not failed, as in the reference.
    Runs on ``device`` (the card unless the caller asks for the CPU); a
    plan of several devices on one rank per visible card
    (``measure_uniform_plan_ms``)."""
    dev = resolve_device(device)
    reports = []
    for ranked in ranked_plans:
        if len(reports) >= top_k:
            break
        if ranked.plan.pp > 1 and model.num_blocks % ranked.plan.pp != 0:
            continue
        reports.append(
            validate_uniform_plan(
                ranked.plan, ranked.cost.total_ms, model, dev,
                steps=steps, warmup=warmup))
    return reports
