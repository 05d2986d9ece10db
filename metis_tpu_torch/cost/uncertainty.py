"""Distributional cost modeling: residual fits, risk scoring, variance.

The port's copy of ``metis_tpu/cost/uncertainty.py``.

The planner's estimators emit point costs; the accuracy ledger
(obs/ledger.py) measures how wrong those points are, per cost component
and per device type.  This module closes the loop (ROADMAP item 4): it
fits the ledger's *relative* residuals into a :class:`ResidualModel`
(lognormal when the ratio samples support it, empirical quantiles
otherwise — the "lognormal-or-empirical" rule, per device type), and
exposes the three consumers the uncertainty layer needs:

* a :class:`RiskScorer` — multiplicative tail factor per device-type
  set, used by planner/api.py, search/prune.py and search/exact.py to
  rank by a tail quantile or CVaR-alpha instead of the mean.  Factors
  are clamped at >= 1.0 and risk knobs at quantile >= 0.5, so a risk
  score is never below the point estimate — the exact backend's
  point-cost relaxation bounds stay admissible against score-space
  incumbents (prune strictly less than before, never wrongly);
* per-component ``(mean, variance)`` annotation for a
  :class:`~..core.types.CostBreakdown` — analytic propagation through
  the additive components, deterministic-seed Monte-Carlo for the
  pipeline-schedule max over stage times;
* :func:`certificate_confidence` — the honest "optimal at confidence
  p" for the exact backend's :class:`~..core.types.Certificate`:
  p -> 1 as residual variance -> 0, and degrades toward the coin-flip
  regime as variance grows.

Everything here is OPTIONAL: with no ResidualModel supplied every
search/ranking path takes the pre-existing point-estimate code and is
byte-identical to it (the frozen-golden contract).
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field, replace
from statistics import NormalDist
from typing import TYPE_CHECKING, Iterable, Mapping, Sequence

from ..core.events import NULL_LOG, EventLog

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..core.types import CostBreakdown
    from ..obs.ledger import AccuracyLedger

_NORMAL = NormalDist()

# Minimum matched samples before a per-device fit exists at all; below
# this the aggregate ("" device type) fit answers for everyone.
MIN_FIT_SAMPLES = 2
# Minimum samples for a parametric (lognormal) fit; fewer fall back to
# empirical quantiles of the observed ratios.
MIN_LOGNORMAL_SAMPLES = 4

_MC_DRAWS = 256
_MC_SEED = 0xC0FFEE


def z_score(q: float) -> float:
    """Standard-normal quantile (inverse CDF) of ``q`` in (0, 1)."""
    return _NORMAL.inv_cdf(min(max(q, 1e-9), 1.0 - 1e-9))


def normal_cdf(x: float) -> float:
    return _NORMAL.cdf(x)


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile of an ascending-sorted sequence."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


# ---------------------------------------------------------------------------
# per-device residual fits
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ResidualFit:
    """Distribution of measured/predicted step-time ratios for one
    device type ('' = all samples pooled).

    ``kind`` is ``"lognormal"`` (``mu``/``sigma`` are the log-ratio
    moments) when at least :data:`MIN_LOGNORMAL_SAMPLES` strictly
    positive ratios exist, else ``"empirical"`` (``ratios`` holds the
    sorted observations).  ``rel_sigma`` is the plain standard
    deviation of the ratios — the relative residual scale used for
    sigma_ms and confidence-p."""

    device_type: str
    n: int
    kind: str
    mu: float = 0.0
    sigma: float = 0.0
    ratios: tuple[float, ...] = ()
    rel_sigma: float = 0.0

    def quantile_factor(self, q: float) -> float:
        """Multiplicative tail factor: the q-quantile of the ratio
        distribution, clamped at >= 1.0 (see module docstring on
        admissibility)."""
        if self.kind == "lognormal":
            f = math.exp(self.mu + z_score(q) * self.sigma)
        else:
            f = _percentile(self.ratios, q)
        return max(f, 1.0)

    def cvar_factor(self, alpha: float) -> float:
        """CVaR-alpha of the ratio distribution (mean of the worst
        ``1 - alpha`` tail), clamped at >= 1.0."""
        if self.kind == "lognormal":
            # E[X | X > x_alpha] for X ~ LogNormal(mu, sigma):
            # exp(mu + sigma^2/2) * Phi(sigma - z_alpha) / (1 - alpha)
            z = z_score(alpha)
            tail = _NORMAL.cdf(self.sigma - z)
            f = math.exp(self.mu + 0.5 * self.sigma * self.sigma)
            f *= tail / max(1.0 - alpha, 1e-9)
        else:
            cut = _percentile(self.ratios, alpha)
            tail_vals = [r for r in self.ratios if r >= cut] or [cut]
            f = sum(tail_vals) / len(tail_vals)
        return max(f, 1.0)

    def to_json_dict(self) -> dict:
        return {"device_type": self.device_type, "n": self.n,
                "kind": self.kind, "mu": round(self.mu, 6),
                "sigma": round(self.sigma, 6),
                "rel_sigma": round(self.rel_sigma, 6)}


def _fit_ratios(device_type: str, ratios: list[float]) -> ResidualFit:
    n = len(ratios)
    mean = sum(ratios) / n
    var = max(sum(r * r for r in ratios) / n - mean * mean, 0.0)
    rel_sigma = math.sqrt(var)
    if n >= MIN_LOGNORMAL_SAMPLES and all(r > 0 for r in ratios):
        logs = [math.log(r) for r in ratios]
        mu = sum(logs) / n
        lvar = max(sum(x * x for x in logs) / n - mu * mu, 0.0)
        return ResidualFit(device_type=device_type, n=n, kind="lognormal",
                           mu=mu, sigma=math.sqrt(lvar),
                           rel_sigma=rel_sigma)
    return ResidualFit(device_type=device_type, n=n, kind="empirical",
                       ratios=tuple(sorted(ratios)), rel_sigma=rel_sigma)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ResidualModel:
    """Per-device-type residual distributions fit from an AccuracyLedger.

    ``fits`` maps device type -> :class:`ResidualFit`; the pooled fit
    under ``""`` always exists when any fit does and answers for device
    types never measured.  ``component_stats`` carries the ledger's
    per-component residual moments (ms at ledger scale) keyed by device
    type first — the input for CostBreakdown variance annotation —
    and ``mean_predicted_ms`` anchors those ms-scale variances so they
    can be rescaled to a candidate plan's magnitude."""

    fits: dict[str, ResidualFit] = field(default_factory=dict)
    component_stats: dict[str, dict[str, dict]] = field(default_factory=dict)
    mean_predicted_ms: float = 0.0
    n_samples: int = 0

    def __bool__(self) -> bool:
        return bool(self.fits)

    def fit_for(self, device_types: Iterable[str] = ()) -> ResidualFit | None:
        """The riskiest (largest rel_sigma) fit among the given device
        types, falling back to the pooled fit for types never measured."""
        best: ResidualFit | None = None
        for t in device_types:
            f = self.fits.get(t)
            if f is not None and (best is None or f.rel_sigma > best.rel_sigma):
                best = f
        return best if best is not None else self.fits.get("")

    def rel_sigma(self, device_types: Iterable[str] = ()) -> float:
        f = self.fit_for(device_types)
        return f.rel_sigma if f else 0.0

    def sigma_ms(self, total_ms: float,
                 device_types: Iterable[str] = ()) -> float:
        """Residual standard deviation of a plan's total, in ms."""
        return abs(total_ms) * self.rel_sigma(device_types)

    def quantile_factor(self, q: float,
                        device_types: Iterable[str] = ()) -> float:
        f = self.fit_for(device_types)
        return f.quantile_factor(q) if f else 1.0

    def cvar_factor(self, alpha: float,
                    device_types: Iterable[str] = ()) -> float:
        f = self.fit_for(device_types)
        return f.cvar_factor(alpha) if f else 1.0

    # -- per-component variance -------------------------------------------

    def component_relvar(self, component: str,
                         device_types: Iterable[str] = ()) -> float:
        """Relative residual variance of one CostBreakdown component:
        ledger var_ms scaled by the ledger-scale mean predicted total,
        worst over the given device types (pooled stats fallback)."""
        if self.mean_predicted_ms <= 0:
            return 0.0
        worst = 0.0
        seen = False
        for t in device_types:
            stats = self.component_stats.get(t, {}).get(component)
            if stats:
                seen = True
                worst = max(worst, stats.get("var_ms", 0.0))
        if not seen:
            stats = self.component_stats.get("", {}).get(component)
            worst = stats.get("var_ms", 0.0) if stats else 0.0
        return worst / (self.mean_predicted_ms ** 2)

    def to_summary(self) -> dict:
        return {"n_samples": self.n_samples,
                "mean_predicted_ms": round(self.mean_predicted_ms, 4),
                "device_types": sorted(t for t in self.fits if t),
                "fits": {t: f.to_json_dict()
                         for t, f in sorted(self.fits.items())}}


def fit_residual_model(ledger: "AccuracyLedger", *,
                       min_samples: int = MIN_FIT_SAMPLES,
                       events: EventLog = NULL_LOG) -> ResidualModel | None:
    """Fit a :class:`ResidualModel` from a ledger's matched samples.

    Returns None when fewer than ``min_samples`` matched (predicted AND
    measured, both finite and positive) samples exist — callers treat
    None as "stay in point mode".  Emits one ``residual_fit`` event on
    success."""
    by_dev: dict[str, list[float]] = {}
    pooled: list[float] = []
    total_pred = 0.0
    for s in ledger.samples:
        p, m = s.predicted_ms, s.measured_ms
        if (p is None or not math.isfinite(p) or p <= 0
                or not math.isfinite(m) or m <= 0):
            continue
        ratio = m / p
        pooled.append(ratio)
        total_pred += p
        dev = s.device_type or ""
        if dev:
            by_dev.setdefault(dev, []).append(ratio)
    if len(pooled) < max(min_samples, 1):
        return None
    fits = {"": _fit_ratios("", pooled)}
    for dev, ratios in sorted(by_dev.items()):
        if len(ratios) >= max(min_samples, 1):
            fits[dev] = _fit_ratios(dev, ratios)
    model = ResidualModel(
        fits=fits,
        component_stats=dict(ledger.component_residuals(by_device=True)),
        mean_predicted_ms=total_pred / len(pooled),
        n_samples=len(pooled),
    )
    events.emit("residual_fit", n_samples=model.n_samples,
                n_device_types=len(fits) - 1,
                rel_sigma=round(fits[""].rel_sigma, 6),
                kind=fits[""].kind)
    return model


# ---------------------------------------------------------------------------
# risk scoring (the search-hot piece)
# ---------------------------------------------------------------------------


class RiskScorer:
    """Turns a point total into a tail-risk score for ranking.

    ``score(total_ms, node_sequence)`` = total * factor(device types),
    where the factor is the configured quantile (or CVaR-alpha) of the
    residual ratio distribution, worst-case over the plan's device
    types, clamped >= 1.0 and cached per type-set.  With uniform
    per-type variance the factor is a constant, so the score is a
    monotone transform of the point total and the ranking is unchanged
    — the satellite-3 invariant."""

    __slots__ = ("model", "mode", "param", "_cache")

    def __init__(self, model: ResidualModel, *, quantile: float = 0.0,
                 cvar_alpha: float = 0.0):
        if cvar_alpha:
            self.mode, self.param = "cvar", float(cvar_alpha)
        else:
            self.mode, self.param = "quantile", float(quantile or 0.5)
        self.model = model
        self._cache: dict[tuple[str, ...], float] = {}

    def factor(self, device_types: Iterable[str] = ()) -> float:
        key = tuple(sorted(set(device_types)))
        f = self._cache.get(key)
        if f is None:
            if self.mode == "cvar":
                f = self.model.cvar_factor(self.param, key)
            else:
                f = self.model.quantile_factor(self.param, key)
            self._cache[key] = f
        return f

    def score(self, total_ms: float,
              device_types: Iterable[str] = ()) -> float:
        return total_ms * self.factor(device_types)

    @property
    def z_q(self) -> float:
        """The standard-normal z of the configured tail point (the
        quantile, or the CVaR threshold alpha) — >= 0 by the knob
        validation, used to center confidence-p."""
        return max(z_score(self.param), 0.0)

    def describe(self) -> dict:
        """Risk-posture annotation for decision records / why."""
        if self.mode == "cvar":
            return {"ranking": "cvar", "cvar_alpha": self.param}
        return {"ranking": "quantile", "risk_quantile": self.param}


def make_risk_scorer(config, model: ResidualModel | None) -> RiskScorer | None:
    """Build the scorer a SearchConfig's risk knobs ask for, or None in
    point mode (no knobs set, or no/empty residual model)."""
    if model is None or not model:
        return None
    q = getattr(config, "risk_quantile", 0.0) or 0.0
    a = getattr(config, "cvar_alpha", 0.0) or 0.0
    if not q and not a:
        return None
    return RiskScorer(model, quantile=q, cvar_alpha=a)


# ---------------------------------------------------------------------------
# variance propagation
# ---------------------------------------------------------------------------


def propagate_sum_variance(variances: Iterable[float]) -> float:
    """Variance of a sum of independent components: the analytic rule."""
    return sum(max(v, 0.0) for v in variances)


def mc_max_moments(means: Sequence[float], sigmas: Sequence[float],
                   draws: int = _MC_DRAWS,
                   seed: int = _MC_SEED) -> tuple[float, float]:
    """(mean, variance) of ``max_i N(means[i], sigmas[i]^2)`` by
    deterministic-seed Monte-Carlo — the fallback for pipeline-schedule
    maxes, where no closed form exists.  Fixed seed keeps repeated
    explains byte-identical."""
    if not means:
        return 0.0, 0.0
    if all(s <= 0 for s in sigmas):
        m = max(means)
        return m, 0.0
    rng = random.Random(seed)
    acc = acc2 = 0.0
    for _ in range(draws):
        m = max(mu + sig * rng.gauss(0.0, 1.0)
                for mu, sig in zip(means, sigmas))
        acc += m
        acc2 += m * m
    mean = acc / draws
    return mean, max(acc2 / draws - mean * mean, 0.0)


def annotate_breakdown(breakdown: "CostBreakdown", model: ResidualModel,
                       device_types: Iterable[str] = ()) -> "CostBreakdown":
    """Attach per-component variances (ms^2) to a CostBreakdown.

    Additive components get the analytic rule: var_c = relvar_c *
    value_c^2, scaled from the ledger's per-component residual moments.
    The schedule's max over per-stage execution times (the ``compute``
    + ``imbalance`` pair) gets the Monte-Carlo fallback over the stage
    vector when it is present.  The input is returned unchanged (no
    ``component_variance``) when the model has no component stats."""
    types = tuple(device_types)
    variances: dict[str, float] = {}
    for comp, value in breakdown.components.items():
        rv = model.component_relvar(comp, types)
        if rv > 0:
            variances[comp] = rv * value * value
    if breakdown.stage_execution_ms:
        rel = model.rel_sigma(types)
        if rel > 0:
            stages = breakdown.stage_execution_ms
            mc_mean, mc_var = mc_max_moments(
                list(stages), [s * rel for s in stages])
            if mc_var > 0:
                # the schedule max rides the compute+imbalance pair;
                # fold the MC variance onto ``compute`` (the larger of
                # the two by construction) rather than double-charging
                variances["compute"] = max(
                    variances.get("compute", 0.0), mc_var)
            del mc_mean
    if not variances:
        return breakdown
    return replace(breakdown, component_variance={
        k: round(v, 6) for k, v in sorted(variances.items())})


def breakdown_sigma_ms(breakdown: "CostBreakdown") -> float:
    """Std-dev of the total implied by an annotated breakdown (sum
    rule over the per-component variances)."""
    return math.sqrt(propagate_sum_variance(
        breakdown.component_variance.values()))


# ---------------------------------------------------------------------------
# probabilistic certificates
# ---------------------------------------------------------------------------


def certificate_confidence(margin_ms: float, sigma_ms: float,
                           z_q: float = 0.0) -> float:
    """Honest confidence that the certified plan is truly optimal.

    ``margin_ms`` is the proven point-cost headroom between the
    incumbent and its nearest competitor (runner-up total when the
    search completed; the bound gap — possibly negative — when it
    stopped at the deadline).  Treating both true costs as independent
    normals around their point estimates with the residual sigma,
    p = Phi((margin + z_q * sigma) / (sigma * sqrt(2))).  sigma -> 0
    gives p -> 1 (a point certificate is certain of itself); sigma ->
    infinity decays p toward Phi(z_q / sqrt(2)) < 1 — confidence
    degrades honestly as residual variance grows."""
    if sigma_ms <= 0 or math.isinf(margin_ms):
        return 1.0
    return _NORMAL.cdf((margin_ms + z_q * sigma_ms)
                       / (sigma_ms * math.sqrt(2.0)))
