"""Cost-model validation: predicted vs measured step time — the port of
``metis_tpu/validation.py``: uniform plans (``measure_uniform_plan_ms``,
``validate_uniform_plan``, ``validate_planner_choice``), hetero plans
(``HeteroValidationReport``, ``measure_ranked_plan_ms``,
``measure_ranked_plan``, ``validate_hetero_choice``) and the calibration
fits
(``contention_calibrated``, ``dispatch_affine_calibrated``,
``affine_loo_calibrated``, ``features_loo_calibrated``,
``select_loo_calibrated``, ``apply_frozen_fit``).

The measured side runs the same code production training uses
(``execution.builder.build_executable``, ``execution.hetero``), so a
validation failure indicts the cost model, not a bespoke measurement rig:
pp = 1 uniform plans on the gspmd route, pp > 1 uniform plans on the
pipeline route with the plan's microbatch count, hetero plans on the hetero
executor with every stage's ZeRO, cp and ep (or, when the plan was priced
with the 1f1b or interleaved schedule, on the pipeline route running that
schedule; a one-stage plan with cp, sp or ZeRO on the gspmd route), each
rank's peak memory beside the planner's stage estimate.  A plan of several
devices runs one rank per device through ``execution.dist.spawn``; its step
is timed up to a barrier after every rank's optimizer step, so the time
covers the whole pipeline, and rank 0 reports it.  A plan that needs more
devices than the device list holds (by default one on the CPU, every
visible card on CUDA) raises — it is never shrunk to fit.
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
    """Median wall time (ms) of one full training step of ``plan`` executed
    through ``build_executable``: on ``device`` when the plan needs one
    device, else on one rank per entry of ``devices`` (default: one device
    on the CPU, every visible card on CUDA) over NCCL on CUDA, gloo on the
    CPU.  pp > 1 plans run the pipeline route with the plan's microbatch
    count — the execution the GPipe cost formula claims to price."""
    from metis_tpu_torch.execution.mesh import PlanArtifact
    from metis_tpu_torch.models import config_for_model_spec

    cfg = config_for_model_spec(
        model, **({"dtype": dtype} if dtype is not None else {}))
    if cfg.num_blocks % plan.pp:
        raise MetisError(
            f"num_blocks={cfg.num_blocks} not divisible by pp={plan.pp}; "
            "the uniform executor needs even stages")
    artifact = PlanArtifact.from_uniform_plan(plan)
    return _measure(artifact.to_json(), cfg, artifact.num_devices, device,
                    devices, steps, warmup, seed)[0][0]


def _measure(artifact_json: str, cfg, need: int, device, devices,
             steps: int, warmup: int, seed: int, backend: str | None = None,
             pool=None, **build) -> list[tuple[float, int | None]]:
    """Time ``build_executable``'s step of the artifact: in this process
    at one device, else on ``need`` ranks (over ``backend``, by default
    NCCL on CUDA and gloo on the CPU), or as a job of ``pool`` (an
    ``execution.dist.RankPool`` of ``need`` ranks) when one is given.  Per
    rank: its time, and its peak memory in bytes on CUDA (None on the
    CPU)."""
    from metis_tpu_torch.execution import dist as mdist

    dev = resolve_device(device)
    if need == 1:
        return [_measure_plan_rank(0, dev, artifact_json, cfg, steps, warmup,
                                   seed, build)]
    if pool is not None:
        if pool.world != need:
            raise MetisError(f"plan needs {need} ranks, the pool has {pool.world}")
        return pool.run(_measure_plan_rank, artifact_json, cfg, steps, warmup,
                        seed, build)
    devs = list(devices if devices is not None else mdist.default_devices(dev))
    if need > len(devs):
        raise MetisError(
            f"plan needs {need} devices, have {len(devs)}; a plan is never "
            "shrunk to fit")
    devs = devs[:need]
    return mdist.spawn(_measure_plan_rank, need,
                       backend or mdist.default_backend(devs), devs,
                       artifact_json, cfg, steps, warmup, seed, build)


def _measure_plan_rank(rank: int, device: torch.device, artifact_json: str,
                       cfg, steps: int, warmup: int, seed: int,
                       build: dict) -> tuple[float, int | None]:
    """One rank of ``_measure`` (the only one at one device)."""
    import torch.distributed as dist

    from metis_tpu_torch.execution.builder import build_executable
    from metis_tpu_torch.execution.mesh import PlanArtifact

    artifact = PlanArtifact.from_json(artifact_json)
    exe = build_executable(cfg, artifact, device=device, **build)
    state = exe.init(seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (artifact.gbs, cfg.seq_len),
                           generator=gen, device=device)

    def run_once():
        nonlocal state
        state, loss = exe.step(state, tokens, tokens)
        return loss

    barrier = dist.barrier if dist.is_initialized() else None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ms = _timed_steps_ms(run_once, device, steps, warmup, barrier)
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else None)
    return ms, peak


def _timed_steps_ms(run_once, device: torch.device, steps: int,
                    warmup: int, barrier=None) -> float:
    """Time chained train steps.

    CPU: per-step wall times, median (each step is synchronous; with a
    ``barrier``, each is timed up to it).  CUDA: queue the steps (they
    chain through the updated state, so they run in order on the stream)
    and fence once with ``torch.cuda.synchronize`` (and the barrier, after
    which every rank's last optimizer step has run) — the two-point form
    cancels the launch and fence overhead."""
    if device.type == "cpu":
        def one():
            run_once()
            if barrier is not None:
                barrier()

        for _ in range(warmup):
            one()
        samples = []
        for _ in range(steps):
            t0 = time.perf_counter()
            one()
            samples.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(samples))

    def enqueue(n: int):
        for _ in range(n):
            run_once()

    def fence(_):
        torch.cuda.synchronize(device)
        if barrier is not None:
            barrier()

    return two_point_queue_ms(enqueue, max(steps, 1), sync=fence)


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


@dataclass(frozen=True)
class HeteroValidationReport:
    """Predicted-vs-measured comparison for a hetero ``RankedPlan``; on CUDA
    also each rank's measured peak memory (``peak_memory_mb``) beside the
    planner's memory demand of each stage (``stage_memory_mb``: the stage's
    capacity less its ``memory_state`` headroom; for a stage of one device
    type the demand of one replica's rows, what each of its devices holds;
    None without a cluster)."""

    plan_dict: dict
    predicted_ms: float
    measured_ms: float
    steps: int
    stage_memory_mb: tuple[float, ...] | None = None
    peak_memory_mb: tuple[float, ...] | None = None

    @property
    def error_pct(self) -> float:
        return (self.predicted_ms - self.measured_ms) / self.measured_ms * 100

    @property
    def abs_error_pct(self) -> float:
        return abs(self.error_pct)

    def within(self, threshold_pct: float) -> bool:
        return self.abs_error_pct <= threshold_pct

    def to_json_dict(self) -> dict:
        return {
            "plan": self.plan_dict,
            "predicted_ms": self.predicted_ms,
            "measured_ms": self.measured_ms,
            "error_pct": self.error_pct,
            "steps": self.steps,
            **{k: list(v) for k, v in (("stage_memory_mb", self.stage_memory_mb),
                                       ("peak_memory_mb", self.peak_memory_mb))
               if v is not None},
        }


def measure_ranked_plan_ms(
    ranked,
    model: ModelSpec,
    device: str | torch.device = "cuda",
    devices: Sequence | None = None,
    cluster=None,
    profiles=None,
    steps: int = 5,
    warmup: int = 2,
    seed: int = 0,
    dtype: torch.dtype | None = None,
    backend: str | None = None,
) -> float:
    """Median wall time (ms) of one training step of a hetero ``RankedPlan``
    (``measure_ranked_plan``)."""
    return measure_ranked_plan(ranked, model, device, devices, cluster,
                               profiles, steps, warmup, seed, dtype,
                               backend)[0]


def measure_ranked_plan(
    ranked,
    model: ModelSpec,
    device: str | torch.device = "cuda",
    devices: Sequence | None = None,
    cluster=None,
    profiles=None,
    steps: int = 5,
    warmup: int = 2,
    seed: int = 0,
    dtype: torch.dtype | None = None,
    backend: str | None = None,
    pool=None,
) -> tuple[float, list[int | None]]:
    """Median wall time (ms) of one training step of a hetero ``RankedPlan``
    executed by the hetero executor (``execution.hetero``) — non-uniform
    layer partitions, per-stage strategies with their ZeRO, cp and ep, and
    (with ``cluster`` + ``profiles``) the data balancer's uneven
    per-replica rows — on one rank per device as ``measure_uniform_plan_ms``
    (``backend``: ``"gloo"`` to share a card; ``pool``: a rank pool to run
    on instead of a launch of its own), rank 0's time; and each
    rank's peak memory in bytes (None on the CPU).  A plan priced with the
    1f1b or interleaved schedule runs on the pipeline route with that
    schedule; a one-stage plan with context or sequence parallelism or ZeRO
    on the gspmd route."""
    from metis_tpu_torch.execution.mesh import PlanArtifact
    from metis_tpu_torch.models import config_for_model_spec

    cfg = config_for_model_spec(
        model, **({"dtype": dtype} if dtype is not None else {}))
    artifact = PlanArtifact.from_ranked_plan(ranked)
    build: dict = {}
    strategies = ranked.intra.strategies
    if getattr(ranked.intra, "schedule", "gpipe") == "gpipe" and not (
            len(strategies) == 1 and artifact.mesh_shape
            and (strategies[0].cp > 1 or strategies[0].sp
                 or strategies[0].zero)):
        # an artifact without mesh fields routes to the hetero executor,
        # which takes the data balancer's rows from ``cluster`` +
        # ``profiles``; a one-stage plan with cp, sp or ZeRO keeps its mesh
        # and runs on the gspmd route, as a schedule-tagged plan runs on
        # the pipeline route its own schedule
        artifact = dataclasses.replace(artifact, mesh_axes=(), mesh_shape=())
        build = dict(cluster=cluster, profiles=profiles)
    ranks = _measure(artifact.to_json(), cfg, artifact.num_devices, device,
                     devices, steps, warmup, seed, backend, pool, **build)
    return ranks[0][0], [peak for _, peak in ranks]


def validate_hetero_choice(
    ranked_plans,
    model: ModelSpec,
    device: str | torch.device = "cuda",
    devices: Sequence | None = None,
    cluster=None,
    profiles=None,
    top_k: int = 1,
    steps: int = 5,
    warmup: int = 2,
    backend: str | None = None,
    pool=None,
) -> list[HeteroValidationReport]:
    """North-star error metric over the top-k hetero plans a planner run
    would deploy; each prediction is the plan's ``cost.total_ms``, each
    rank's peak memory stands beside the planner's stage estimate (module
    doc of ``HeteroValidationReport``).  Runs on ``device`` (the card
    unless the caller asks for the CPU), on ranks of ``pool`` when one is
    given (``measure_ranked_plan``)."""
    device = resolve_device(device)
    reports = []
    for ranked in list(ranked_plans)[:top_k]:
        measured, peaks = measure_ranked_plan(
            ranked, model, device, devices, cluster=cluster,
            profiles=profiles, steps=steps, warmup=warmup, backend=backend,
            pool=pool)
        reports.append(HeteroValidationReport(
            plan_dict=ranked.to_json_dict(),
            predicted_ms=ranked.cost.total_ms,
            measured_ms=measured,
            steps=steps,
            stage_memory_mb=_stage_memory_mb(ranked, cluster),
            peak_memory_mb=(None if None in peaks
                            else tuple(p / 2**20 for p in peaks))))
    return reports


def _stage_memory_mb(ranked, cluster) -> tuple[float, ...] | None:
    """The planner's memory demand of each stage of ``ranked`` (MB): the
    stage's capacity on ``cluster`` less its ``memory_state`` headroom."""
    state = ranked.intra.memory_state
    if cluster is None or not state:
        return None
    from metis_tpu_torch.balance.stage_perf import rank_device_types

    inter = ranked.inter
    types = rank_device_types(cluster, inter.node_sequence)
    out = []
    for s, headroom in enumerate(state):
        start, end = inter.stage_rank_range(s)
        capacity = sum(cluster.memory_mb(t) for t in types[start:end])
        out.append(capacity - headroom)
    return tuple(out)


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


def dispatch_affine_calibrated(
    reports: Sequence, batches_of
) -> tuple[dict, list]:
    """Two-parameter fit-and-hold-out calibration for executors whose
    per-step overhead scales with the microbatch count (the multi-mesh
    hetero executor host-syncs each microbatch's loss).

    NOTE: the bench validation now uses :func:`affine_loo_calibrated`
    (leave-one-out, noise-robust); this exact 2-point form remains the
    minimal-data option — it identifies both parameters from just two
    reports where LOO needs three:

        measured ~= factor * predicted + overhead_ms * batches

    The first TWO reports (with distinct microbatch counts) fit
    (factor, overhead_ms) exactly; the rest are held out with calibrated
    predictions.  Falls back to the scalar ``contention_calibrated`` fit
    when the 2x2 system is singular or fewer than 3 reports exist.
    ``batches_of(report)`` extracts the microbatch count."""
    def scalar_fallback():
        factors, held = contention_calibrated(reports)
        # fit_points tells callers which leading reports are held IN (the
        # scalar path fits on one, the affine on two) so calibration and
        # held-out plans are never double-reported
        return ({"factor": factors.get(None, 1.0), "overhead_ms": 0.0,
                 "fit_points": 1 if reports else 0}, held)

    if len(reports) < 3:
        return scalar_fallback()
    r1, r2 = reports[0], reports[1]
    p1, b1, m1 = r1.predicted_ms, batches_of(r1), r1.measured_ms
    p2, b2, m2 = r2.predicted_ms, batches_of(r2), r2.measured_ms
    det = p1 * b2 - p2 * b1
    if abs(det) < 1e-12:
        return scalar_fallback()
    a = (m1 * b2 - m2 * b1) / det
    b = (p1 * m2 - p2 * m1) / det
    # physical clamps: negative factor/overhead means the two fit points
    # don't separate compute from dispatch — fall back to the scalar fit
    if a <= 0 or b < 0:
        return scalar_fallback()
    held_out = [
        dataclasses.replace(
            r, predicted_ms=a * r.predicted_ms + b * batches_of(r))
        for r in reports[2:]
    ]
    return {"factor": a, "overhead_ms": b, "fit_points": 2}, held_out


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


def features_loo_calibrated(
    reports: Sequence,
    features: Sequence,
    names: Sequence[str] | None = None,
) -> tuple[dict, list]:
    """Leave-one-out NONNEGATIVE least-squares over arbitrary feature
    columns: ``measured ~= sum_k coef_k * features[k](report)``, every
    report scored by the fit that EXCLUDED it (the LOO honesty contract of
    :func:`affine_loo_calibrated`, generalized past two columns).

    Motivating case — stage ranks sharing one device's or host's cores:
    both the compute slowdown AND the per-microbatch overhead scale with
    the resident stage count, which a 2-column affine (predicted, batches)
    fit cannot express and (predicted*stages, batches*stages) columns can.

    Falls back to :func:`affine_loo_calibrated`'s scalar path when there
    are fewer than ``len(features) + 2`` reports (an NNLS with as many
    points as columns just interpolates; LOO then scores extrapolations of
    a saturated model)."""
    k = len(features)
    if len(reports) < k + 2:
        return affine_loo_calibrated(reports)

    from scipy.optimize import nnls  # after fallback: that path needs no scipy

    x = np.array([[float(f(r)) for f in features] for r in reports],
                 np.float64)
    y = np.array([r.measured_ms for r in reports], np.float64)
    out = []
    idx = np.arange(len(reports))
    for i, r in enumerate(reports):
        mask = idx != i
        coef, _ = nnls(x[mask], y[mask])
        out.append(dataclasses.replace(r, predicted_ms=float(x[i] @ coef)))
    coef_all, _ = nnls(x, y)
    labels = list(names) if names is not None else [
        f"f{j}" for j in range(k)]
    return ({"coefficients": {n: round(float(c), 4)
                              for n, c in zip(labels, coef_all)},
             "mode": "features_loo", "fit_points": len(reports)}, out)


#: Candidate contention models for hetero validation runs whose stages share
#: devices.  No single fixed model is stable across measurement episodes —
#: the episode's noise structure decides which physical effect dominates.
HETERO_FIT_CANDIDATES = {
    "scalar": ([lambda r: r.predicted_ms], ["pred"]),
    "affine_const": ([lambda r: r.predicted_ms, lambda r: 1.0],
                     ["pred", "const"]),
    "affine_batches": ([lambda r: r.predicted_ms,
                        lambda r: r.plan_dict["batches"]],
                       ["pred", "batches"]),
    "stage_contention": (
        [lambda r: r.predicted_ms * r.plan_dict["num_stages"],
         lambda r: r.plan_dict["batches"] * r.plan_dict["num_stages"]],
        ["pred_x_stages", "batches_x_stages"]),
}


def select_loo_calibrated(
    reports: Sequence,
    candidates: dict | None = None,
) -> tuple[dict, list]:
    """Per-run model selection over a small fixed candidate family, each
    scored leave-one-out; the winner is the candidate with the lowest LOO
    mean absolute error.  EVERY candidate's held-out mean is recorded in
    the returned fit dict (``candidate_means_pct``) so the selection is
    transparent — the reader sees how close the race was, and the ~4-way
    min's optimism bias is inspectable rather than hidden."""
    cands = candidates if candidates is not None else HETERO_FIT_CANDIDATES
    best_name, best_fit, best_out, best_mean = None, None, None, None
    means: dict[str, float] = {}
    for name, (feats, labels) in cands.items():
        fit, out = features_loo_calibrated(reports, feats, labels)
        if fit.get("mode") != "features_loo" or not out:
            # too few reports for this candidate: features_loo fell back to
            # a DIFFERENT model — scoring the fallback under this
            # candidate's name would record fits that never ran (several
            # 2-column candidates would collapse to one identical affine
            # while appearing as distinct scores)
            continue
        mean = sum(r.abs_error_pct for r in out) / len(out)
        means[name] = round(mean, 1)
        if best_mean is None or mean < best_mean:
            best_name, best_fit, best_out, best_mean = name, fit, out, mean
    if best_fit is None:
        # no candidate had enough reports to genuinely fit: return the
        # shared fallback under its OWN mode label, not "select_loo"
        return affine_loo_calibrated(reports)
    best_fit = dict(best_fit)
    best_fit["selected"] = best_name
    best_fit["candidate_means_pct"] = means
    best_fit["mode"] = "select_loo"
    return best_fit, best_out


def apply_frozen_fit(fit: dict, reports: Sequence,
                     candidates: dict | None = None) -> list:
    """Score ``reports`` with a FROZEN calibration fit dict — no refitting,
    no model selection.  The selection-free counterpart of the per-run LOO
    numbers: a fit chosen and coefficient-fitted on one measurement episode
    is applied verbatim to a DIFFERENT episode's raw reports, so the
    returned errors carry none of the ~K-way-min optimism bias of
    :func:`select_loo_calibrated`.

    Accepts the fit dicts produced by :func:`contention_calibrated` /
    :func:`affine_loo_calibrated` (``factor`` + ``overhead_ms``) and
    :func:`features_loo_calibrated` / :func:`select_loo_calibrated`
    (``coefficients`` by label, with ``selected`` naming the candidate in
    ``candidates`` whose feature columns the labels describe)."""
    if "coefficients" in fit:
        cands = candidates if candidates is not None else HETERO_FIT_CANDIDATES
        name = fit.get("selected")
        feats, labels = cands.get(name, (None, None))
        if feats is None:
            # unknown/renamed candidate: fall back to matching the frozen
            # coefficient labels against the candidates' column label sets
            feats, labels = next(
                (fl for fl in cands.values()
                 if set(fl[1]) == set(fit["coefficients"])), (None, None))
        if feats is None:
            raise MetisError(
                f"cannot resolve feature columns for frozen fit {fit}")
        coefs = [float(fit["coefficients"][lab]) for lab in labels]
        return [dataclasses.replace(
            r, predicted_ms=float(sum(c * f(r) for c, f in zip(coefs, feats))))
            for r in reports]
    factor = float(fit.get("factor", 1.0))
    overhead = float(fit.get("overhead_ms", 0.0))
    return [dataclasses.replace(
        r, predicted_ms=factor * r.predicted_ms + overhead) for r in reports]


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
