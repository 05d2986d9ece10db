"""Plan provenance: the decision log — the port of
``metis_tpu/obs/provenance.py``.

The system's flight data recorder: a durable, queryable record of why each
plan is running — what triggered each change, what the runner-up was, and
how far the cost model could be trusted at the margin.

- :class:`DecisionRecord` — one plan decision (cold search, cache-hit
  serve, drift replan, cluster-delta replan, fleet re-partition, tenant
  replan, migration choice, autoscale delta) with its query/plan
  fingerprints, the trigger cause, a **causal parent seq**, the trace_id,
  config/calibration/profile digests, the additive ``CostBreakdown``, the
  exact-backend ``Certificate`` when one exists, the runner-up plan and
  its margin, and per-component residual stats as model-confidence
  context for that margin.
- :class:`DecisionLog` — an append-only, sequence-numbered JSONL file.
  Reopening an existing log resumes the sequence (a restart never resets
  seq numbering), and every append also emits a ``decision_record`` event
  into the regular event stream so traces and decisions join.
- :func:`diff_plans` — attributes a decision change per
  ``CostBreakdown`` component (the additive deltas sum exactly to the
  total_ms delta) and per decision axis (stages / dp / tp / cp /
  placement / layer-cut / schedule).
- :func:`causal_chain` / :func:`render_chain` — walk parent seqs back to
  the root trigger (e.g. ``cluster_delta -> delta_replan ->
  migration_decision``) and render the chain with the attributed diff at
  each hop — what ``python -m metis_tpu_torch why`` prints.

The log's JSON lines are the reference's, field for field, so a log
written by either package reads in the other to equal records.  It is
durable state like the accuracy ledger, not telemetry: it is never
rotated, and ``tools/check_decisions_schema.py`` validates its invariants
(seq monotonicity, resolvable parents, additive breakdowns).
"""
from __future__ import annotations

import hashlib
import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import IO, Any, Sequence

from metis_tpu_torch.core.events import EventLog, NULL_LOG
from metis_tpu_torch.core.types import COST_COMPONENTS, CostBreakdown

# Every kind a DecisionRecord may carry — one per way the system picks
# (or re-picks) a plan.  ``cluster_delta`` is the capacity-change root
# decision the per-tenant / per-query replans hang off; ``autoscale_delta``
# is the same root when a predictive autoscaler (the reference's inference/replay.py)
# issued the delta.
DECISION_KINDS = (
    "cold_search",       # cache miss -> full (or warm-state) search
    "cache_hit",         # served straight from the plan cache
    "drift_replan",      # accuracy drift alarm -> re-search
    "cluster_delta",     # capacity changed (eviction / return / manual)
    "autoscale_delta",   # capacity changed by a forecast-driven policy
    "delta_replan",      # per-query re-search after a cluster delta
    "fleet_repartition", # multi-tenant carve re-scored (the reference's sched/fleet.py)
    "tenant_replan",     # one tenant's carve changed -> new plan
    "migration_decision",# migrate-vs-checkpoint-restore choice
    "profile_transfer",  # roofline transfer to an unprofiled device type
)


@dataclass(frozen=True)
class DecisionRecord:
    """One plan decision, as the decision log persists it.

    ``parent_seq`` is the causal edge: the seq of the decision that
    *caused* this one (a cache hit's parent is the cold search that
    filled the entry; a tenant replan's parent is the fleet re-partition;
    the re-partition's parent is the cluster delta).  ``None`` marks a
    causal root.  ``margin_ms`` is ``runner_up.total_ms - total_ms`` —
    how close the ranking was — and ``confidence`` carries the ledger's
    per-component residual stats so the margin can be judged against the
    model's demonstrated error ("runner-up was 3.1 ms away; p95 compute
    residual alone is 4.2 ms").
    """

    seq: int
    ts: float
    kind: str
    plan_fingerprint: str = ""
    query_fingerprint: str = ""
    cause: str = ""
    parent_seq: int | None = None
    trace_id: str | None = None
    tenant: str | None = None
    total_ms: float | None = None
    breakdown: dict | None = None       # CostBreakdown.to_json_dict()
    certificate: dict | None = None     # Certificate.to_json_dict()
    runner_up: dict | None = None       # {"plan_fingerprint", "total_ms"}
    margin_ms: float | None = None
    confidence: dict | None = None      # component -> residual stats
    digests: dict = field(default_factory=dict)  # config/calibration/profiles
    detail: dict = field(default_factory=dict)   # kind-specific extras

    def to_json_dict(self) -> dict:
        d = {"seq": self.seq, "ts": self.ts, "kind": self.kind,
             "plan_fingerprint": self.plan_fingerprint}
        if self.query_fingerprint:
            d["query_fingerprint"] = self.query_fingerprint
        if self.cause:
            d["cause"] = self.cause
        if self.parent_seq is not None:
            d["parent_seq"] = self.parent_seq
        if self.trace_id:
            d["trace_id"] = self.trace_id
        if self.tenant:
            d["tenant"] = self.tenant
        if self.total_ms is not None:
            d["total_ms"] = self.total_ms
        if self.breakdown is not None:
            d["breakdown"] = self.breakdown
        if self.certificate is not None:
            d["certificate"] = self.certificate
        if self.runner_up is not None:
            d["runner_up"] = self.runner_up
        if self.margin_ms is not None:
            d["margin_ms"] = self.margin_ms
        if self.confidence:
            d["confidence"] = self.confidence
        if self.digests:
            d["digests"] = self.digests
        if self.detail:
            d["detail"] = self.detail
        return d

    @staticmethod
    def from_json_dict(d: dict) -> "DecisionRecord":
        return DecisionRecord(
            seq=int(d["seq"]),
            ts=float(d.get("ts", 0.0)),
            kind=d["kind"],
            plan_fingerprint=d.get("plan_fingerprint", ""),
            query_fingerprint=d.get("query_fingerprint", ""),
            cause=d.get("cause", ""),
            parent_seq=(int(d["parent_seq"])
                        if d.get("parent_seq") is not None else None),
            trace_id=d.get("trace_id"),
            tenant=d.get("tenant"),
            total_ms=d.get("total_ms"),
            breakdown=d.get("breakdown"),
            certificate=d.get("certificate"),
            runner_up=d.get("runner_up"),
            margin_ms=d.get("margin_ms"),
            confidence=d.get("confidence"),
            digests=dict(d.get("digests", {})),
            detail=dict(d.get("detail", {})),
        )


class DecisionLog:
    """Append-only, sequence-numbered decision JSONL.

    ``DecisionLog(None)`` keeps decisions in memory only (tests, NULL
    wiring).  Opening an existing path reloads every record and resumes
    the sequence where the previous process left off, so a seq number is
    never issued twice.  Thread-safe; the append is a single buffered
    line write.
    """

    def __init__(self, path: str | Path | None = None,
                 events: EventLog = NULL_LOG):
        self.path = Path(path) if path is not None else None
        self.events = events
        self._fh: IO[str] | None = None
        self._lock = threading.RLock()
        self._records: list[DecisionRecord] = []
        self._by_seq: dict[int, DecisionRecord] = {}
        self._last_seq = 0
        if self.path is not None and self.path.exists():
            self._load()

    def _load(self) -> None:
        for line in self.path.read_text().splitlines():
            if not line.strip():
                continue
            try:
                rec = DecisionRecord.from_json_dict(json.loads(line))
            except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                continue  # the schema checker reports corruption; keep going
            self._records.append(rec)
            self._by_seq[rec.seq] = rec
            self._last_seq = max(self._last_seq, rec.seq)

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._last_seq

    def resume_seq(self, seq: int) -> None:
        """Fast-forward the sequence cursor to at least ``seq`` (never
        backwards).  A durable log resumes from its own file on open;
        this covers the in-memory case, where the caller remembers the
        seq a previous process reached — seq numbers are never reissued
        across a restart."""
        with self._lock:
            self._last_seq = max(self._last_seq, int(seq))

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def record(self, kind: str, plan_fingerprint: str = "",
               **fields: Any) -> DecisionRecord:
        """Append one decision; returns the record with its seq assigned.

        ``fields`` are DecisionRecord fields (query_fingerprint, cause,
        parent_seq, trace_id, tenant, total_ms, breakdown, certificate,
        runner_up, margin_ms, confidence, digests, detail).
        """
        with self._lock:
            self._last_seq += 1
            rec = DecisionRecord(
                seq=self._last_seq, ts=time.time(), kind=kind,
                plan_fingerprint=plan_fingerprint, **fields)
            self._records.append(rec)
            self._by_seq[rec.seq] = rec
            if self.path is not None:
                if self._fh is None:
                    self._fh = open(self.path, "a", buffering=1)
                self._fh.write(
                    json.dumps(rec.to_json_dict(), default=str) + "\n")
        ev = {"seq": rec.seq, "kind": kind, "fingerprint": plan_fingerprint}
        if rec.trace_id:
            ev["trace_id"] = rec.trace_id
        self.events.emit("decision_record", **ev)
        return rec

    def records(self, since: int = 0) -> list[DecisionRecord]:
        """Records with ``seq > since``, oldest first."""
        with self._lock:
            return [r for r in self._records if r.seq > since]

    def get(self, seq: int) -> DecisionRecord | None:
        with self._lock:
            return self._by_seq.get(seq)

    def find(self, plan_fingerprint: str | None = None,
             tenant: str | None = None,
             kind: str | None = None) -> DecisionRecord | None:
        """The LATEST record matching every given criterion, or None."""
        with self._lock:
            for rec in reversed(self._records):
                if plan_fingerprint is not None \
                        and rec.plan_fingerprint != plan_fingerprint:
                    continue
                if tenant is not None and rec.tenant != tenant:
                    continue
                if kind is not None and rec.kind != kind:
                    continue
                return rec
        return None

    def chain(self, leaf: DecisionRecord | int) -> list[DecisionRecord]:
        """Causal chain root..leaf (see :func:`causal_chain`)."""
        with self._lock:
            return causal_chain(self._records, leaf)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "DecisionLog":
        return self

    def __exit__(self, *exc: object) -> bool:
        self.close()
        return False


NULL_DECISIONS = DecisionLog(None)


# ---------------------------------------------------------------------------
# planner-result helpers
# ---------------------------------------------------------------------------


def artifact_digest(obj) -> str:
    """12-hex sha1 of any JSON-serializable object (canonical form) — the
    generic digest ``DecisionRecord.digests`` values use."""
    payload = json.dumps(obj, sort_keys=True, separators=(",", ":"),
                         default=str)
    return hashlib.sha1(payload.encode()).hexdigest()[:12]


def profile_store_digest(profiles) -> str:
    """Identity of a ``profiles.store.ProfileStore``'s pricing-relevant
    content: per-(type, tp, bs) total layer time plus the attention stamp
    and layer count.  Two stores that would price every candidate
    identically digest identically; "" when the store is not digestable."""
    try:
        return artifact_digest({
            "configs": {
                f"{t}/tp{tp}/bs{bs}": round(
                    profiles.get(t, tp, bs).total_time_ms, 6)
                for (t, tp, bs) in profiles.configs()},
            "attn": getattr(profiles, "attn", None),
            "num_layers": profiles.model.num_layers,
        })
    except Exception:
        return ""


def fingerprint_plan_dict(d: dict) -> str:
    """Plan fingerprint of a serialized plan dict (a ``dump_ranked_plans``
    entry or ``RankedPlan.to_json_dict()``): reuses an embedded
    ``plan_fingerprint`` when present, recomputes from the structural
    fields otherwise, and returns "" when neither is possible."""
    from metis_tpu_torch.obs.ledger import plan_fingerprint as _fp

    if d.get("plan_fingerprint"):
        return d["plan_fingerprint"]
    if "layer_partition" in d and "strategies" in d:
        return _fp(
            layer_partition=d.get("layer_partition", ()),
            strategies=d.get("strategies", ()),
            gbs=d.get("gbs", 0),
            microbatches=d.get("batches", 0),
            node_sequence=d.get("node_sequence", ()),
            device_groups=d.get("device_groups", ()),
            schedule=d.get("schedule", "gpipe"),
            virtual_stages=d.get("virtual_stages", 1),
        )
    return ""


def planner_decision_fields(result) -> dict:
    """DecisionRecord fields extracted from a ``planner.api``
    PlannerResult: best plan fingerprint + breakdown, the runner-up and
    margin, and the exact-backend certificate when one was attached.
    Returns {} for an infeasible result (no best plan)."""
    from metis_tpu_torch.obs.ledger import fingerprint_ranked_plan

    best = result.best
    if best is None:
        return {}
    fields: dict = {"plan_fingerprint": fingerprint_ranked_plan(best),
                    "total_ms": best.cost.total_ms}
    if best.breakdown is not None:
        fields["breakdown"] = best.breakdown.to_json_dict()
    if len(result.plans) > 1:
        ru = result.plans[1]
        fields["runner_up"] = {
            "plan_fingerprint": fingerprint_ranked_plan(ru),
            "total_ms": ru.cost.total_ms,
        }
        fields["margin_ms"] = ru.cost.total_ms - best.cost.total_ms
    if result.certificate is not None:
        fields["certificate"] = result.certificate.to_json_dict()
    return fields


def record_planner_decision(decisions: "DecisionLog | None", result,
                            kind: str = "cold_search",
                            **fields: Any) -> DecisionRecord | None:
    """Record one planner-search decision into ``decisions`` (None or an
    infeasible result record nothing): the :func:`planner_decision_fields`
    extraction plus any caller fields (cause, parent_seq, trace_id,
    tenant, digests, detail...).  The one call the offline entry points
    (``planner.api.plan_hetero``, ``planner.replan``) thread through."""
    if decisions is None:
        return None
    extracted = planner_decision_fields(result)
    if not extracted:
        return None
    fp = extracted.pop("plan_fingerprint", "")
    return decisions.record(kind, plan_fingerprint=fp,
                            **{**extracted, **fields})


# ---------------------------------------------------------------------------
# plan diff engine
# ---------------------------------------------------------------------------

# The decision axes a diff reports: what structurally changed between two
# plans, independent of the cost attribution.
DIFF_AXES = ("stages", "dp", "tp", "cp", "placement", "layer_cut",
             "schedule", "virtual_stages", "batches", "gbs")


def _plan_dict(obj) -> dict:
    """Normalize a diffable object to a plan JSON dict: accepts a live
    ``RankedPlan``, a ``RankedPlan.to_json_dict()`` / ``dump_ranked_plans``
    entry, or a ``DecisionRecord`` (whose breakdown carries the cost but
    no structural axes — those stay empty)."""
    if isinstance(obj, DecisionRecord):
        d: dict = {"plan_fingerprint": obj.plan_fingerprint}
        if obj.breakdown is not None:
            d["breakdown"] = obj.breakdown
        if obj.total_ms is not None:
            d["cost_ms"] = obj.total_ms
        return d
    if isinstance(obj, dict):
        return obj
    if hasattr(obj, "to_json_dict"):  # RankedPlan
        return obj.to_json_dict()
    raise TypeError(f"cannot diff a {type(obj).__name__}")


def plan_axes(plan: dict) -> dict:
    """Decision-axis view of one plan dict (missing axes omitted)."""
    axes: dict = {}
    if "device_groups" in plan or "num_stages" in plan:
        axes["stages"] = plan.get("num_stages",
                                  len(plan.get("device_groups", ())))
    strategies = plan.get("strategies")
    if strategies:
        axes["dp"] = [int(s.get("dp", 1)) for s in strategies]
        axes["tp"] = [int(s.get("tp", 1)) for s in strategies]
        axes["cp"] = [int(s.get("cp", 1)) for s in strategies]
    if "node_sequence" in plan:
        axes["placement"] = list(plan["node_sequence"])
    if "layer_partition" in plan:
        axes["layer_cut"] = list(plan["layer_partition"])
    for key in ("schedule", "virtual_stages", "batches", "gbs"):
        if key in plan:
            axes[key] = plan[key]
    return axes


@dataclass(frozen=True)
class PlanDiff:
    """Attributed difference between two plans (b relative to a).

    ``component_deltas`` decompose ``total_delta_ms`` exactly — the
    additive contract ``CostBreakdown`` pins (components sum to total_ms
    on each side, so their per-component differences sum to the total
    difference).  ``axis_changes`` lists every decision axis whose value
    moved; ``decisive`` names the component carrying the largest share
    of the delta."""

    fingerprint_a: str
    fingerprint_b: str
    total_a_ms: float | None
    total_b_ms: float | None
    total_delta_ms: float | None
    component_deltas: dict[str, float]
    decisive: tuple[str, float] | None
    axis_changes: dict[str, dict]
    axes_a: dict
    axes_b: dict

    @property
    def component_delta_sum_ms(self) -> float:
        return sum(self.component_deltas.values())

    def to_json_dict(self) -> dict:
        return {
            "fingerprint_a": self.fingerprint_a,
            "fingerprint_b": self.fingerprint_b,
            "total_a_ms": self.total_a_ms,
            "total_b_ms": self.total_b_ms,
            "total_delta_ms": self.total_delta_ms,
            "component_deltas": dict(self.component_deltas),
            "decisive": ({"component": self.decisive[0],
                          "delta_ms": self.decisive[1]}
                         if self.decisive else None),
            "axis_changes": {k: dict(v)
                             for k, v in self.axis_changes.items()},
        }

    def render(self) -> str:
        """Human table: per-component attribution + axis changes."""
        lines: list[str] = []
        if self.component_deltas:
            keys = [k for k in COST_COMPONENTS
                    if abs(self.component_deltas.get(k, 0.0)) > 1e-12]
            keys += [k for k in self.component_deltas
                     if k not in keys
                     and abs(self.component_deltas[k]) > 1e-12]
            width = max([len("component")] + [len(k) for k in keys])
            lines.append(f"{'component'.ljust(width)}  delta (b-a) ms")
            lines.append(f"{'-' * width}  --------------")
            for k in keys:
                lines.append(
                    f"{k.ljust(width)}  {self.component_deltas[k]:+.3f}")
            if self.total_delta_ms is not None:
                lines.append(
                    f"{'total'.ljust(width)}  {self.total_delta_ms:+.3f}")
            if self.decisive is not None:
                name, d = self.decisive
                lines.append("")
                lines.append(f"decisive: {name} ({d:+.3f} ms)")
        if self.axis_changes:
            lines.append("")
            lines.append("axis changes:")
            for axis, ch in self.axis_changes.items():
                lines.append(f"  {axis}: {ch['a']!r} -> {ch['b']!r}")
        elif self.axes_a and self.axes_b:
            lines.append("")
            lines.append("axis changes: none (identical decision axes)")
        return "\n".join(lines)


def diff_plans(a, b) -> PlanDiff:
    """Attribute the decision change from plan ``a`` to plan ``b``.

    Accepts live ``RankedPlan``s, serialized plan dicts
    (``dump_ranked_plans`` entries), or ``DecisionRecord``s in any
    combination.  Component deltas are computed through
    ``CostBreakdown.delta`` (b − a), so they sum exactly to the
    breakdown total delta by additivity; when either side lacks a
    breakdown the cost attribution is empty and only axis changes are
    reported."""
    da, db = _plan_dict(a), _plan_dict(b)
    fp_of = fingerprint_plan_dict
    bd_a = (CostBreakdown.from_json_dict(da["breakdown"])
            if da.get("breakdown") else None)
    bd_b = (CostBreakdown.from_json_dict(db["breakdown"])
            if db.get("breakdown") else None)
    component_deltas: dict[str, float] = {}
    decisive = None
    total_a = bd_a.total_ms if bd_a else da.get("cost_ms")
    total_b = bd_b.total_ms if bd_b else db.get("cost_ms")
    if bd_a is not None and bd_b is not None:
        component_deltas = bd_a.delta(bd_b)
        decisive = bd_a.decisive_component(bd_b)
    total_delta = (total_b - total_a
                   if total_a is not None and total_b is not None else None)
    axes_a, axes_b = plan_axes(da), plan_axes(db)
    axis_changes = {
        axis: {"a": axes_a[axis], "b": axes_b[axis]}
        for axis in DIFF_AXES
        if axis in axes_a and axis in axes_b and axes_a[axis] != axes_b[axis]
    }
    return PlanDiff(
        fingerprint_a=fp_of(da), fingerprint_b=fp_of(db),
        total_a_ms=total_a, total_b_ms=total_b, total_delta_ms=total_delta,
        component_deltas=component_deltas, decisive=decisive,
        axis_changes=axis_changes, axes_a=axes_a, axes_b=axes_b)


# ---------------------------------------------------------------------------
# causal chain reconstruction
# ---------------------------------------------------------------------------


def causal_chain(records: Sequence[DecisionRecord],
                 leaf: DecisionRecord | int) -> list[DecisionRecord]:
    """Walk ``parent_seq`` edges from ``leaf`` back to the causal root;
    returns root..leaf order.  A dangling parent reference ends the walk
    (the schema checker flags it); a cycle cannot occur because parents
    always have smaller seqs, but the walk guards anyway."""
    by_seq = {r.seq: r for r in records}
    rec = by_seq.get(leaf) if isinstance(leaf, int) else leaf
    if rec is None:
        return []
    chain = [rec]
    seen = {rec.seq}
    while rec.parent_seq is not None:
        parent = by_seq.get(rec.parent_seq)
        if parent is None or parent.seq in seen:
            break
        chain.append(parent)
        seen.add(parent.seq)
        rec = parent
    chain.reverse()
    return chain


def render_chain(chain: Sequence[DecisionRecord],
                 with_diffs: bool = True) -> str:
    """Render a causal chain root-first, one hop per block, with the
    attributed plan diff at every hop whose adjacent decisions both carry
    a breakdown."""
    if not chain:
        return "no matching decision"
    lines: list[str] = []
    prev: DecisionRecord | None = None
    for depth, rec in enumerate(chain):
        head = f"[seq {rec.seq}] {rec.kind}"
        if rec.cause:
            head += f" (cause: {rec.cause})"
        if rec.tenant:
            head += f" tenant={rec.tenant}"
        if rec.plan_fingerprint:
            head += f" plan={rec.plan_fingerprint}"
        if rec.total_ms is not None:
            head += f" {rec.total_ms:.3f} ms"
        lines.append(("  " * depth) + ("-> " if depth else "") + head)
        # risk posture (uncertainty layer): how this plan was ranked —
        # point (default, unannotated), tail-quantile, or CVaR — and
        # whether it was priced off transferred (unprofiled) profiles
        detail = rec.detail or {}
        ranking = detail.get("ranking")
        transferred = detail.get("transferred_profiles")
        if ranking or transferred:
            bits = []
            if ranking == "quantile":
                bits.append("quantile-ranked "
                            f"(q={detail.get('risk_quantile')})")
            elif ranking == "cvar":
                bits.append(f"CVaR-ranked (alpha={detail.get('cvar_alpha')})")
            elif ranking == "point" and detail.get("risk_requested"):
                bits.append("point-ranked (risk requested; ledger too "
                            "thin to fit)")
            elif ranking:
                bits.append(f"{ranking}-ranked")
            if transferred:
                bits.append("transferred profiles: "
                            + ", ".join(transferred))
            lines.append(("  " * depth) + "   risk: " + "; ".join(bits))
        if rec.margin_ms is not None and rec.runner_up is not None:
            conf = ""
            if rec.confidence:
                worst = max(
                    ((k, v.get("p95_abs_ms")) for k, v in
                     rec.confidence.items()
                     if isinstance(v, dict)
                     and v.get("p95_abs_ms") is not None),
                    key=lambda kv: kv[1], default=None)
                if worst is not None:
                    conf = (f"; p95 {worst[0]} residual alone is "
                            f"{worst[1]:.1f} ms")
            lines.append(
                ("  " * depth) + f"   runner-up "
                f"{rec.runner_up.get('plan_fingerprint', '?')} was "
                f"{rec.margin_ms:.1f} ms away{conf}")
        if rec.trace_id:
            lines.append(("  " * depth) + f"   trace={rec.trace_id}")
        if (with_diffs and prev is not None
                and prev.breakdown and rec.breakdown
                and prev.plan_fingerprint != rec.plan_fingerprint):
            diff = diff_plans(prev, rec)
            for dl in diff.render().splitlines():
                lines.append(("  " * depth) + "   | " + dl)
        prev = rec
    return "\n".join(lines)


def chain_json(chain: Sequence[DecisionRecord]) -> dict:
    """Machine-readable chain (``why --json``): the records
    root..leaf plus the attributed diff at each breakdown-carrying hop."""
    hops: list[dict] = []
    prev: DecisionRecord | None = None
    for rec in chain:
        hop: dict = {"record": rec.to_json_dict()}
        if (prev is not None and prev.breakdown and rec.breakdown
                and prev.plan_fingerprint != rec.plan_fingerprint):
            hop["diff"] = diff_plans(prev, rec).to_json_dict()
        hops.append(hop)
        prev = rec
    return {"depth": len(chain), "hops": hops,
            "root_cause": chain[0].cause or chain[0].kind if chain else None}
