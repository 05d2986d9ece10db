"""Cost-model accuracy ledger: predicted-vs-measured drift tracking.

The port's copy of ``metis_tpu/obs/ledger.py``.

Metis is, at its core, a cost model — the plan is only as good as the
estimator's fidelity (PAPER.md §0), yet until this module nothing ever
checked a plan's predicted step time against what ``execution/`` measures.
This closes the loop:

- :func:`plan_fingerprint` gives every plan a stable identity computed
  identically from a planner ``RankedPlan`` and an execution
  ``PlanArtifact``, so predictions written at search time join with
  measurements written steps (or days) later.
- :class:`AccuracyLedger` persists both sides as append-only JSONL
  (``prediction`` and ``measurement`` records) and computes the summary
  stats — MAPE, signed error (systematic bias), error percentiles,
  per-plan and per-stage residuals — that ``metis-tpu accuracy`` renders.
- :class:`DriftDetector` turns the rolling error into an alarm with
  hysteresis: one ``drift_alarm`` event per excursion above the band, no
  re-fire until the error drops below the clear threshold — the signal
  ``planner.replan.replan_on_drift`` keys on.
- :class:`AccuracyMonitor` is the train-loop composition of all three
  (``execution/train.StepTimer`` feeds it one measured step at a time).

The ledger file is shareable state, not telemetry: committing one per
deployment gives the next planner run (and ``cost/calibration.
fit_ledger_correction``) the residuals to refit against.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import IO, Any, Iterable, Sequence

from metis_tpu_torch.core.events import EventLog, NULL_LOG

# ---------------------------------------------------------------------------
# plan fingerprints
# ---------------------------------------------------------------------------

# Strategy keys with their defaults: both sides of the join (planner
# Strategy dataclasses, artifact dicts that may predate newer axes) expand
# to the same canonical form before hashing.
_STRATEGY_DEFAULTS = {
    "dp": 1, "tp": 1, "sp": False, "cp": 1, "ep": 1, "zero": 0,
    "cp_mode": "ring",
}


def _canonical_strategies(strategies: Iterable) -> list[dict]:
    out = []
    for s in strategies:
        d = dict(s) if isinstance(s, dict) else dataclasses.asdict(s)
        out.append({k: d.get(k, default)
                    for k, default in sorted(_STRATEGY_DEFAULTS.items())})
    return out


def plan_fingerprint(
    *,
    layer_partition: Sequence[int],
    strategies: Iterable,
    gbs: int,
    microbatches: int,
    node_sequence: Sequence[str] = (),
    device_groups: Sequence[int] = (),
    schedule: str = "gpipe",
    virtual_stages: int = 1,
    extra: dict | None = None,
) -> str:
    """Stable 12-hex identity of a plan's execution-relevant shape.

    Hashes the canonical JSON of the fields that determine what actually
    runs; cosmetic fields (cost, rank, search accounting) are excluded so
    the same plan found by two searches — or round-tripped through a
    ``PlanArtifact`` — fingerprints identically.
    """
    canonical = {
        "layer_partition": list(layer_partition),
        "strategies": _canonical_strategies(strategies),
        "gbs": int(gbs),
        "microbatches": int(microbatches),
        "node_sequence": list(node_sequence),
        "device_groups": list(device_groups),
        "schedule": schedule,
        "virtual_stages": int(virtual_stages),
    }
    if extra:
        canonical.update(extra)
    payload = json.dumps(canonical, sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(payload.encode()).hexdigest()[:12]


def fingerprint_ranked_plan(ranked) -> str:
    """Fingerprint of a ``planner.api`` RankedPlan (hetero search output)."""
    inter, intra = ranked.inter, ranked.intra
    return plan_fingerprint(
        layer_partition=intra.layer_partition,
        strategies=intra.strategies,
        gbs=inter.gbs,
        microbatches=inter.batches,
        node_sequence=inter.node_sequence,
        device_groups=inter.device_groups,
        schedule=intra.schedule,
        virtual_stages=intra.virtual_stages,
    )


def fingerprint_uniform_plan(plan) -> str:
    """Fingerprint of a ``core.types`` UniformPlan — matches
    ``fingerprint_artifact(PlanArtifact.from_uniform_plan(plan))``."""
    return plan_fingerprint(
        layer_partition=(),
        strategies=({"dp": plan.dp, "tp": plan.tp},),
        gbs=plan.gbs,
        microbatches=plan.num_microbatches,
        extra={"pp": plan.pp},
    )


def fingerprint_artifact(art) -> str:
    """Fingerprint of an ``execution.mesh`` PlanArtifact.

    Matches ``fingerprint_ranked_plan`` for artifacts captured with
    ``from_ranked_plan`` and ``fingerprint_uniform_plan`` for
    ``from_uniform_plan`` ones (whose pp lives only in the mesh shape —
    hetero artifacts carry it in ``device_groups`` instead).
    """
    extra = None
    if not art.device_groups and not art.layer_partition and art.mesh_shape:
        axes = tuple(art.mesh_axes)
        if "pp" in axes:
            extra = {"pp": int(art.mesh_shape[axes.index("pp")])}
    return plan_fingerprint(
        layer_partition=art.layer_partition,
        strategies=art.strategies,
        gbs=art.gbs,
        microbatches=art.microbatches,
        node_sequence=art.node_sequence,
        device_groups=art.device_groups,
        schedule=art.schedule,
        virtual_stages=art.virtual_stages,
        extra=extra,
    )


# ---------------------------------------------------------------------------
# query fingerprints (serve-layer cache keys)
# ---------------------------------------------------------------------------

# SearchConfig fields that cannot change the ranked result, only how fast
# (or how verbosely) it is computed: the parallel worker count and the
# heartbeat cadence.  Byte-identity across these is the contract the
# serial/parallel parity tests already pin, so two queries differing only
# here may share a cache entry.  Every OTHER field — including the cost-
# model toggles ``use_overlap_model``/``use_batch_eval`` — is hashed, so a
# config flip can never return a stale cached plan.
_RESULT_NEUTRAL_CONFIG_FIELDS = frozenset({"workers", "progress_every"})


def calibration_fingerprint(calibration) -> str | None:
    """12-hex identity of a ``cost.calibration.CollectiveCalibration``'s
    pricing-relevant content (fitted curves, not raw samples); None for
    None.  Two calibrations that price collectives identically — same
    platform/device/group-size fits — fingerprint identically."""
    if calibration is None:
        return None
    if hasattr(calibration, "to_json_dict"):
        d = dict(calibration.to_json_dict())
        d.pop("samples", None)
    else:  # already a plain dict (e.g. loaded JSON)
        d = {k: v for k, v in dict(calibration).items() if k != "samples"}
    payload = json.dumps(d, sort_keys=True, separators=(",", ":"),
                         default=str)
    return hashlib.sha1(payload.encode()).hexdigest()[:12]


def query_fingerprint(model, cluster, config, *, calibration=None,
                      workload=None, extra: dict | None = None) -> str:
    """Stable 12-hex identity of a plan *query*: model × cluster × gbs ×
    every cost-relevant ``SearchConfig`` field × calibration identity ×
    workload kind.

    This is the serve-layer cache key (``serve/cache.PlanCache``), distinct
    from :func:`plan_fingerprint` on purpose: a plan fingerprint identifies
    a search *result*'s execution shape (it must stay stable across cost-
    model changes so predictions join with measurements), while a query
    fingerprint identifies a search *input* — flip any knob that could
    change the ranking and the key must change.  sha1 over canonical JSON,
    not ``hash()``, so the key is stable across processes and restarts.

    ``workload`` (an ``inference.workload.InferenceWorkload``, or None for
    training) is hashed structurally: a training query hashes the literal
    string "training" while an inference query hashes its kind tag plus
    every SLO/traffic field, so a cached training plan can never alias an
    inference query for the same model/cluster — nor can two inference
    queries differing in any SLO field alias each other.
    """
    cfg = dataclasses.asdict(config)
    for name in _RESULT_NEUTRAL_CONFIG_FIELDS:
        cfg.pop(name, None)
    canonical = {
        "model": dataclasses.asdict(model),
        "cluster": {
            "nodes": [[n.device_type, int(n.num_devices)]
                      for n in cluster.nodes],
            "devices": {
                name: dataclasses.asdict(dev)
                for name, dev in sorted(cluster.devices.items())
            },
        },
        "config": cfg,
        "calibration": calibration_fingerprint(calibration),
        "workload": ("training" if workload is None
                     else {"kind": "inference",
                           **dataclasses.asdict(workload)}),
    }
    if extra:
        canonical.update(extra)
    payload = json.dumps(canonical, sort_keys=True, separators=(",", ":"),
                         default=str)
    return hashlib.sha1(payload.encode()).hexdigest()[:12]


# ---------------------------------------------------------------------------
# ledger records
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AccuracySample:
    """One measured step joined against its plan's prediction (if any).

    ``components`` holds measured per-``CostBreakdown``-component times
    when the measurement was component-resolved (empty otherwise — the
    residual decomposition then falls back to proportional attribution);
    ``device_type`` labels which hardware measured the step, so residual
    distributions can be grouped per device type."""

    fingerprint: str
    measured_ms: float
    predicted_ms: float | None = None
    step: int | None = None
    source: str = "train"
    stage_ms: tuple[float, ...] = ()
    components: dict[str, float] = dataclasses.field(default_factory=dict)
    device_type: str = ""

    @property
    def error_pct(self) -> float | None:
        """Signed (predicted - measured) / measured, percent; None when the
        plan was never predicted (or measured zero)."""
        if self.predicted_ms is None or self.measured_ms <= 0:
            return None
        return (self.predicted_ms - self.measured_ms) / self.measured_ms * 100

    @property
    def abs_error_pct(self) -> float | None:
        e = self.error_pct
        return None if e is None else abs(e)


@dataclass(frozen=True)
class LedgerSummary:
    """Aggregate accuracy stats over a ledger (``metis-tpu accuracy``)."""

    n_samples: int
    n_matched: int            # samples with a joined prediction
    n_plans: int              # distinct fingerprints measured
    mape_pct: float | None
    signed_error_pct: float | None   # mean signed error — systematic bias
    p50_abs_pct: float | None
    p90_abs_pct: float | None
    max_abs_pct: float | None
    worst: tuple[dict, ...] = ()          # worst samples, most wrong first
    by_plan: dict[str, dict] = dataclasses.field(default_factory=dict)
    stage_residuals: tuple[dict, ...] = ()  # per stage idx, where measurable

    def to_json_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["worst"] = list(self.worst)
        d["stage_residuals"] = list(self.stage_residuals)
        return d


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        raise ValueError("empty")
    idx = min(int(round(q * (len(sorted_vals) - 1))), len(sorted_vals) - 1)
    return sorted_vals[idx]


class AccuracyLedger:
    """Append-only JSONL of predicted-vs-measured records, keyed by plan
    fingerprint.

    Two record kinds share the file: ``{"kind": "prediction", fingerprint,
    predicted_ms, components, stage_ms, ...}`` written once per planned
    run, and ``{"kind": "measurement", fingerprint, measured_ms, step,
    source, stage_ms}`` written per measured step (train) or per validated
    plan (validate).  Opening an existing path loads both sides and re-joins
    them, so the file round-trips; ``AccuracyLedger(None)`` is an in-memory
    ledger (nothing persisted).

    Loading is fault-hardened the same way ``serve.persist.Oplog`` is:
    a torn trailing line (crash mid-append), a record with NaN/inf
    times, or a measurement missing its value is SKIPPED and counted
    (``n_skipped``; one ``ledger_skip`` event with the per-reason
    tally) instead of crashing the open or poisoning residual fits.
    """

    def __init__(self, path: str | Path | None = None,
                 events: EventLog = NULL_LOG):
        self.path = Path(path) if path is not None else None
        self.events = events
        self._fh: IO[str] | None = None
        self.predictions: dict[str, dict] = {}
        self.samples: list[AccuracySample] = []
        self.n_skipped = 0
        if self.path is not None and self.path.exists():
            self._load()

    @staticmethod
    def _finite(v) -> bool:
        return (isinstance(v, (int, float))
                and math.isfinite(v))

    def _load(self) -> None:
        skipped: dict[str, int] = {}
        for line in self.path.read_text().splitlines():
            if not line.strip():
                continue
            reason = None
            try:
                rec = json.loads(line)
                kind = rec.get("kind")
                if kind == "prediction":
                    fp = rec["fingerprint"]
                    if not self._finite(rec.get("predicted_ms")):
                        reason = "non_finite"
                    else:
                        self.predictions[fp] = rec
                elif kind == "measurement":
                    rec["fingerprint"]
                    m = rec.get("measured_ms")
                    if m is None:
                        # predicted-only / valueless measurement row
                        reason = "missing_measurement"
                    elif not self._finite(m):
                        reason = "non_finite"
                    else:
                        self.samples.append(self._join(rec))
            except json.JSONDecodeError:
                reason = "torn_line"
            except (KeyError, TypeError, ValueError):
                reason = "bad_record"
            if reason is not None:
                skipped[reason] = skipped.get(reason, 0) + 1
        if skipped:
            self.n_skipped = sum(skipped.values())
            self.events.emit("ledger_skip", n_skipped=self.n_skipped,
                             reasons=dict(sorted(skipped.items())))

    def _join(self, rec: dict) -> AccuracySample:
        pred = self.predictions.get(rec["fingerprint"])
        return AccuracySample(
            fingerprint=rec["fingerprint"],
            measured_ms=rec["measured_ms"],
            predicted_ms=pred["predicted_ms"] if pred else None,
            step=rec.get("step"),
            source=rec.get("source", "train"),
            stage_ms=tuple(rec.get("stage_ms", ())),
            components=dict(rec.get("components") or {}),
            device_type=rec.get("device_type", ""),
        )

    def _append(self, rec: dict) -> None:
        if self.path is None:
            return
        if self._fh is None:
            self._fh = open(self.path, "a", buffering=1)
        self._fh.write(json.dumps(rec, default=str) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "AccuracyLedger":
        return self

    def __exit__(self, *exc: object) -> bool:
        self.close()
        return False

    # -- writes ------------------------------------------------------------
    def record_prediction(
        self,
        fingerprint: str,
        predicted_ms: float,
        components: dict[str, float] | None = None,
        stage_ms: Sequence[float] = (),
        **meta: Any,
    ) -> dict:
        rec = {
            "kind": "prediction", "ts": time.time(),
            "fingerprint": fingerprint, "predicted_ms": predicted_ms,
            "components": dict(components or {}),
            "stage_ms": list(stage_ms), **meta,
        }
        self.predictions[fingerprint] = rec
        self._append(rec)
        return rec

    def record_measurement(
        self,
        fingerprint: str,
        measured_ms: float,
        step: int | None = None,
        stage_ms: Sequence[float] = (),
        source: str = "train",
        **extra: Any,
    ) -> AccuracySample:
        rec = {
            "kind": "measurement", "ts": time.time(),
            "fingerprint": fingerprint, "measured_ms": measured_ms,
            "step": step, "source": source, "stage_ms": list(stage_ms),
            **extra,
        }
        self._append(rec)
        sample = self._join(rec)
        self.samples.append(sample)
        return sample

    # -- stats -------------------------------------------------------------
    def summary(self, fingerprint: str | None = None,
                worst_k: int = 5) -> LedgerSummary:
        samples = [s for s in self.samples
                   if fingerprint is None or s.fingerprint == fingerprint]
        matched = [s for s in samples if s.error_pct is not None]
        abs_errs = sorted(s.abs_error_pct for s in matched)
        by_plan: dict[str, dict] = {}
        for s in samples:
            d = by_plan.setdefault(s.fingerprint, {
                "n": 0, "n_matched": 0, "abs_errs": [], "signed": [],
                "predicted_ms": (self.predictions.get(s.fingerprint) or {})
                .get("predicted_ms"),
            })
            d["n"] += 1
            if s.error_pct is not None:
                d["n_matched"] += 1
                d["abs_errs"].append(s.abs_error_pct)
                d["signed"].append(s.error_pct)
        for fp, d in by_plan.items():
            errs, signed = d.pop("abs_errs"), d.pop("signed")
            d["mape_pct"] = (round(sum(errs) / len(errs), 3)
                             if errs else None)
            d["signed_error_pct"] = (round(sum(signed) / len(signed), 3)
                                     if signed else None)
        worst = tuple(
            {"fingerprint": s.fingerprint, "step": s.step,
             "source": s.source, "predicted_ms": s.predicted_ms,
             "measured_ms": s.measured_ms,
             "error_pct": round(s.error_pct, 3)}
            for s in sorted(matched, key=lambda s: -s.abs_error_pct)[:worst_k]
        )
        return LedgerSummary(
            n_samples=len(samples),
            n_matched=len(matched),
            n_plans=len(by_plan),
            mape_pct=(round(sum(abs_errs) / len(abs_errs), 3)
                      if abs_errs else None),
            signed_error_pct=(round(
                sum(s.error_pct for s in matched) / len(matched), 3)
                if matched else None),
            p50_abs_pct=(round(_percentile(abs_errs, 0.5), 3)
                         if abs_errs else None),
            p90_abs_pct=(round(_percentile(abs_errs, 0.9), 3)
                         if abs_errs else None),
            max_abs_pct=round(abs_errs[-1], 3) if abs_errs else None,
            worst=worst,
            by_plan=by_plan,
            stage_residuals=self._stage_residuals(samples),
        )

    def _stage_residuals(
            self, samples: Sequence[AccuracySample]) -> tuple[dict, ...]:
        """Per-stage signed residuals, for samples whose measurement AND
        prediction both carry per-stage times (the multi-controller /
        per-stage executors); empty when neither side is stage-resolved."""
        acc: dict[int, list[float]] = {}
        for s in samples:
            pred = self.predictions.get(s.fingerprint)
            if not s.stage_ms or not pred or not pred.get("stage_ms"):
                continue
            for i, (p, m) in enumerate(zip(pred["stage_ms"], s.stage_ms)):
                if m > 0:
                    acc.setdefault(i, []).append((p - m) / m * 100)
        return tuple(
            {"stage": i, "n": len(errs),
             "signed_error_pct": round(sum(errs) / len(errs), 3),
             "mape_pct": round(sum(abs(e) for e in errs) / len(errs), 3)}
            for i, errs in sorted(acc.items())
        )

    def component_residuals(
            self, fingerprint: str | None = None,
            by_device: bool = False) -> dict[str, dict]:
        """Per-``CostBreakdown``-component residual distributions in ms.

        For every matched sample whose prediction carries ``components``:
        a component-resolved measurement (``record_measurement(...,
        components={...})``) yields the exact residual ``predicted_c -
        measured_c`` per component both sides carry (a component absent
        from the measurement is skipped for that sample — e.g.
        ``migration`` appears only on migrated plans); an unresolved
        measurement attributes the total residual proportionally to the
        predicted component shares, so the per-component residuals still
        sum to the total residual by additivity.

        Returns ``{component: {n, mean_ms, var_ms, p50_abs_ms,
        p95_abs_ms}}`` — or, with ``by_device=True``, the same keyed by
        device type first (samples without a ``device_type`` group under
        ``""``).  Empty dict when nothing is component-attributable.
        This is the model-confidence context ``DecisionRecord.confidence``
        carries for the ranking margin (``metis-tpu accuracy
        --components`` renders it)."""
        acc: dict[tuple[str, str], list[float]] = {}
        for s in self.samples:
            if fingerprint is not None and s.fingerprint != fingerprint:
                continue
            pred = self.predictions.get(s.fingerprint)
            if not pred or not pred.get("components"):
                continue
            pcomps = pred["components"]
            ptotal = pred.get("predicted_ms") or sum(pcomps.values())
            dev = s.device_type or pred.get("device_type", "") or ""
            for comp, pv in pcomps.items():
                if s.components:
                    if comp not in s.components:
                        continue
                    r = pv - s.components[comp]
                elif ptotal > 0 and s.measured_ms > 0:
                    r = pv / ptotal * (ptotal - s.measured_ms)
                else:
                    continue
                acc.setdefault((dev, comp), []).append(r)

        def stats(residuals: list[float]) -> dict:
            n = len(residuals)
            mean = sum(residuals) / n
            var = max(sum(r * r for r in residuals) / n - mean * mean, 0.0)
            abs_sorted = sorted(abs(r) for r in residuals)
            return {"n": n, "mean_ms": round(mean, 4),
                    "var_ms": round(var, 4),
                    "p50_abs_ms": round(_percentile(abs_sorted, 0.5), 4),
                    "p95_abs_ms": round(_percentile(abs_sorted, 0.95), 4)}

        if by_device:
            out: dict[str, dict] = {}
            for (dev, comp), residuals in sorted(acc.items()):
                out.setdefault(dev, {})[comp] = stats(residuals)
            return out
        merged: dict[str, list[float]] = {}
        for (_dev, comp), residuals in acc.items():
            merged.setdefault(comp, []).extend(residuals)
        return {comp: stats(residuals)
                for comp, residuals in sorted(merged.items())}


# ---------------------------------------------------------------------------
# drift detection
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DriftStatus:
    """Snapshot of a DriftDetector — the replan-trigger contract
    (``planner.replan.replan_on_drift`` keys on ``in_drift``)."""

    in_drift: bool
    rolling_mape_pct: float | None
    n: int
    alarms: int
    band_pct: float


class DriftDetector:
    """Rolling-MAPE drift alarm with hysteresis.

    ``observe(error_pct)`` per accuracy sample; when the rolling window's
    MAPE exceeds ``band_pct`` (with at least ``min_samples`` observed) the
    detector enters drift, emits exactly ONE ``drift_alarm`` event, and
    stays armed-off until the rolling MAPE falls below ``clear_pct``
    (default band/2) — so a run hovering at the band cannot spam alarms.
    """

    def __init__(self, band_pct: float = 20.0, min_samples: int = 5,
                 window: int = 32, clear_pct: float | None = None,
                 events: EventLog = NULL_LOG,
                 fingerprint: str | None = None):
        self.band_pct = band_pct
        self.min_samples = max(int(min_samples), 1)
        self.clear_pct = band_pct / 2 if clear_pct is None else clear_pct
        self.events = events
        self.fingerprint = fingerprint
        self._errors: deque[float] = deque(maxlen=max(int(window), 1))
        self.in_drift = False
        self.alarms = 0

    @property
    def n(self) -> int:
        return len(self._errors)

    @property
    def rolling_mape_pct(self) -> float | None:
        if not self._errors:
            return None
        return sum(self._errors) / len(self._errors)

    def observe(self, error_pct: float) -> bool:
        """Feed one signed error; True exactly when the alarm fires."""
        self._errors.append(abs(error_pct))
        mape = self.rolling_mape_pct
        if self.in_drift:
            if mape < self.clear_pct:
                self.in_drift = False  # re-armed: a new excursion can fire
            return False
        if self.n >= self.min_samples and mape > self.band_pct:
            self.in_drift = True
            self.alarms += 1
            fields = {"mape_pct": round(mape, 3), "band_pct": self.band_pct,
                      "n": self.n}
            if self.fingerprint is not None:
                fields["fingerprint"] = self.fingerprint
            self.events.emit("drift_alarm", **fields)
            return True
        return False

    def status(self) -> DriftStatus:
        return DriftStatus(
            in_drift=self.in_drift,
            rolling_mape_pct=self.rolling_mape_pct,
            n=self.n,
            alarms=self.alarms,
            band_pct=self.band_pct,
        )


class AccuracyMonitor:
    """Train-loop composition: ledger + events + drift detector.

    One ``observe(measured_ms)`` per measured step writes the measurement
    record, emits an ``accuracy_sample`` event (when the plan has a
    prediction to compare against), and feeds the drift detector — which
    emits at most one ``drift_alarm`` per excursion.  ``skip_steps``
    swallows the first N steps (compilation dominates them; charging the
    cost model for XLA compile time would be a false alarm generator).
    """

    def __init__(self, ledger: AccuracyLedger, fingerprint: str,
                 events: EventLog = NULL_LOG, band_pct: float = 20.0,
                 min_samples: int = 5, skip_steps: int = 1,
                 source: str = "train"):
        self.ledger = ledger
        self.fingerprint = fingerprint
        self.events = events
        self.source = source
        self.skip_steps = skip_steps
        self._skipped = 0
        self.detector = DriftDetector(
            band_pct=band_pct, min_samples=min_samples, events=events,
            fingerprint=fingerprint)

    def observe(self, measured_ms: float, step: int | None = None,
                stage_ms: Sequence[float] = ()) -> AccuracySample | None:
        if self._skipped < self.skip_steps:
            self._skipped += 1
            return None
        sample = self.ledger.record_measurement(
            self.fingerprint, measured_ms, step=step, stage_ms=stage_ms,
            source=self.source)
        err = sample.error_pct
        if err is not None:
            self.events.emit(
                "accuracy_sample", fingerprint=self.fingerprint,
                predicted_ms=sample.predicted_ms, measured_ms=measured_ms,
                error_pct=round(err, 3), step=step, source=self.source)
            self.detector.observe(err)
        return sample

    def status(self) -> DriftStatus:
        return self.detector.status()
