"""Exact branch-and-bound planning backend (``SearchConfig.backend="exact"``).

The port's copy of ``metis_tpu/search/exact.py``.

ROADMAP item 1: the beam/prune search (search/prune.py) is fast but
documented INEXACT once ``beam_patience`` is set — at 1024+ devices it
ships "best we found" instead of "within x% of optimal".  This module
closes that gap with a best-first branch-and-bound over the SAME candidate
space the beam backend walks:

- **Branch nodes** are the (stage count, composition, microbatch count)
  classes of ``search/inter_stage.stage_compositions`` — exactly the
  classes the composition-level pruned walk filters, so the two backends
  cover one space by construction.
- **Admissible lower bounds** (``RelaxationBound``) come from the cost
  model's own tables: the ``ExecutionFloor`` W-tables SearchPruner prunes
  with (built over the estimator's post-affine profile view), plus
  per-term minima of the additive ``cost/batch.py`` formula — fb-sync,
  optimizer, and batch-generator floors, the step-overhead intercept
  adjustment, and the EXACT spot multiplier (constant per search: device
  groups always sum to the cluster total, so every candidate carries the
  full-cluster hazard).  dp/pp/migration floor at 0.  Reusing the
  estimator's tables means bound math and costed math can never drift.
- **Leaves** are fully expanded and costed through the shared
  ``CandidateEvaluator`` — the identical code path (and identical floats)
  the beam backend prices with.
- **Certificate.**  The search terminates with a proven lower bound on
  every candidate in the space: run-to-exhaustion proves gap 0; a
  ``SearchConfig.exact_deadline_s`` stop keeps the incumbent and certifies
  the remaining gap (min of the incumbent and the best unexplored node's
  bound).  The certificate is attached to the ``PlannerResult`` and
  emitted as a ``certificate`` event.

Honest contract: the certificate is relative to the candidate space this
config searches (families, max_tp/max_bs, variance, inter_filter) under
this cost model — not a claim about placements outside that space.  With
symmetry collapse live, only canonical type permutations are expanded;
images are cost-identical by construction, so the bound still covers them
(the returned ranking carries one representative per class).

The same ``RelaxationBound`` doubles as the default beam search's
``bound_fn`` (SearchPruner ``prune.bound.tight``): admissible means a
candidate it prunes provably cannot enter the top K, so the beam ranking
stays byte-identical while pricing strictly fewer candidates — gated by
tools/check_search_regression.py like the symmetry collapse was.
"""
from __future__ import annotations

import heapq
import time
from itertools import permutations

from metis_tpu_torch.core.events import EventLog, NULL_LOG
from metis_tpu_torch.core.trace import Tracer
from metis_tpu_torch.core.types import Certificate, RankedPlan, divisors
from metis_tpu_torch.search.inter_stage import stage_compositions
from metis_tpu_torch.search.prune import ExecutionFloor

# The base (cp=1 ring, ep=1, zero=0, sp=False) family signature — when the
# evaluator's grid is exactly this and no schedule families are live, every
# candidate is priced by the additive gpipe formula (cost/batch.py `_fast`
# or its scalar twin) and the per-term floors below are sound.  Richer
# grids (ZeRO shards the optimizer, cp reshapes fb-sync) fall back to the
# execution floor alone.
_BASE_FAMILIES = [((1, "ring"), 1, 0, False)]


class _NullPruner:
    """Pruner protocol stub for ``CandidateEvaluator.evaluate_batch``: the
    branch-and-bound does its own bounding at the node level, so leaves are
    costed unconditionally — record/begin/end are no-ops, exactly like a
    ``SearchPruner`` with ``top_k=None`` (costs stay bit-identical to the
    beam path because the evaluator never branches on the pruner)."""

    def begin_candidate(self) -> None:
        pass

    def record(self, total_ms: float, inter=None) -> None:
        pass

    def end_candidate(self, inter) -> None:
        pass


class RelaxationBound:
    """Admissible per-(composition, stages, batches) lower bound on
    ``PlanCost.total_ms`` over every candidate of the class.

    Callable as ``bound(g_max, num_stages, batches) -> ms`` — the same
    signature as ``SearchPruner._exec_lower_bound``, so the beam path can
    consult it as its ``bound_fn`` after the stock floor passes.

    Term-by-term over the additive formula (cost/batch.py ``_fast``; the
    scalar path is bit-identical):

    - **feasibility cap** — a stage's axes multiply to its group size
      (``dp * tp * cp == g``, search/intra_stage.initial_strategies +
      escalation), ``mbs >= 1`` caps ``dp <= gbs // batches`` and the
      escalation dooms at ``tp > max_tp``, so a class whose largest group
      exceeds ``(gbs // batches) * max_tp * max_cp`` contains NO valid
      plan in any family.  The bound returns +inf for it — vacuously
      admissible over an empty class, and it skips the whole doomed
      dp->tp escalation walk the beam path would otherwise grind through.
    - ``execution``  >= ExecutionFloor.bound(...) + the step-overhead
      floor: the charge is ``max`` over the plan's (type, tp) pairs, once
      for uniform plans and ``max(0, .) * batches`` otherwise, so
      ``min over profiled pairs of so.get(pair, 0.0)`` lower-bounds both
      branches (a negative affine intercept is charged at most once, so
      clamping the floor at zero would be UNSOUND).
    - ``fb_sync``    >= (min profiled fb_sync_ms) * batches   [base only]
    - ``max_opt``    >= (min optimizer rate / max_tp) * ceil(L/S)/L — some
      stage holds at least ceil(L/S) layers                   [base only]
    - ``batch_gen``  == per-batch cost * batches under strict_compat
      (constant across candidates); >= min per-type cost native [base only]
    - ``dp/pp/migration`` >= 0.
    - spot multiplier is EXACT: device groups always sum to the cluster
      total, so every candidate's hazard is the full-cluster hazard.
    """

    def __init__(self, floor: ExecutionFloor, *, base_only: bool,
                 strict: bool, overhead_adjust: float, fb_min: float,
                 opt_floor_rate: float, num_layers: int,
                 bg_strict_per_batch: float, bg_native_min: float,
                 spot_scale: float, gbs: int = 0, max_tp: int = 1,
                 max_cp: int = 1):
        self._floor = floor
        self._base_only = base_only
        self._strict = strict
        self._overhead_adjust = overhead_adjust
        self._fb_min = fb_min
        self._opt_floor_rate = opt_floor_rate
        self._L = num_layers
        self._bg_strict = bg_strict_per_batch
        self._bg_native = bg_native_min
        self._spot_mult = 1.0 + spot_scale
        self._gbs = gbs
        self._axes_cap = max_tp * max_cp

    @classmethod
    def from_evaluator(cls, ctx) -> "RelaxationBound":
        """Build from a ``CandidateEvaluator``'s own estimator tables — the
        floors price with exactly the view (post-affine profiles, optimizer
        factor, spot options) candidates are costed with."""
        config, cluster, model = ctx.config, ctx.cluster, ctx.model
        scalar = ctx.estimator
        profiles = scalar.profiles  # post affine-view when mb_affine is on
        floor = ExecutionFloor(config, cluster, profiles, model)
        base_only = (not ctx.sched_families
                     and ctx.families == _BASE_FAMILIES)
        strict = bool(config.strict_compat)
        so = scalar._step_overhead
        fb_min = float("inf")
        overhead_adjust = float("inf")
        for t in cluster.device_types:
            for (_, tp, bs) in profiles.configs(t):
                if tp <= config.max_profiled_tp:
                    fb = profiles.get(t, tp, bs).fb_sync_ms
                    if fb < fb_min:
                        fb_min = fb
                    oh = so.get((t, tp), 0.0)
                    if oh < overhead_adjust:
                        overhead_adjust = oh
        if fb_min == float("inf"):
            fb_min = 0.0
        if not so or overhead_adjust == float("inf"):
            overhead_adjust = 0.0
        opt_types = (None,) if strict else tuple(cluster.device_types)
        opt_ms = []
        for t in opt_types:
            try:
                opt_ms.append(scalar._optimizer_ms(t))
            except KeyError:
                opt_ms = []
                break
        opt_floor_rate = (min(opt_ms) / config.max_profiled_tp
                          if opt_ms else 0.0)
        bg_strict = profiles.model.batch_generator_ms
        bg_vals = []
        for t in cluster.device_types:
            try:
                bg_vals.append(profiles.type_meta[t].batch_generator_ms)
            except (KeyError, AttributeError):
                bg_vals = []
                break
        bg_native = min(bg_vals) if bg_vals else 0.0
        spot_scale = 0.0
        if scalar.options.spot_active:
            hazard = sum(
                node.num_devices
                * cluster.devices[node.device_type].hazard_per_hr
                for node in cluster.nodes)
            spot_scale = scalar._spot_scale_of(hazard)
        # largest context-parallel degree any family can put on a stage —
        # the same eligibility gate ExecutionFloor's cp divisor uses
        max_cp = (config.max_cp_degree
                  if (config.enable_cp and not config.strict_compat
                      and model.num_experts == 0) else 1)
        return cls(floor, base_only=base_only, strict=strict,
                   overhead_adjust=overhead_adjust, fb_min=fb_min,
                   opt_floor_rate=opt_floor_rate,
                   num_layers=model.num_layers,
                   bg_strict_per_batch=bg_strict, bg_native_min=bg_native,
                   spot_scale=spot_scale, gbs=config.gbs,
                   max_tp=config.max_profiled_tp, max_cp=max_cp)

    def __call__(self, g_max: int, num_stages: int, batches: int) -> float:
        # empty class: no (dp, tp, cp) factorization of g_max can keep
        # mbs >= 1 within the profiled tp range — every candidate's
        # escalation walk is provably fruitless
        if g_max > (self._gbs // batches) * self._axes_cap:
            return float("inf")
        lb = self._floor.bound(g_max, num_stages, batches)
        lb += self._overhead_adjust
        if self._base_only:
            lb += self._fb_min * batches
            L = self._L
            max_layers = -(-L // num_stages)  # ceil: the fullest stage
            lb += self._opt_floor_rate * max_layers / L
            lb += (self._bg_strict * batches if self._strict
                   else self._bg_native)
        return lb * self._spot_mult


def _canonical_type_perms(device_types, symmetry):
    """Type permutations to expand: all of them, or — with a live symmetry
    map — one representative per cost-equivalence class (images are
    bit-identical to their canonical, so skipping them loses nothing the
    certificate covers)."""
    perms = list(permutations(sorted(set(device_types))))
    if symmetry is None:
        return perms
    seen: set[tuple] = set()
    out = []
    for p in perms:
        key = tuple(symmetry.get(t, t) for t in p)
        if key not in seen:
            seen.add(key)
            out.append(p)
    return out


def exact_plan_hetero(
    cluster,
    profiles,
    model,
    config,
    bandwidth_factory=None,
    top_k: int | None = None,
    events: EventLog = NULL_LOG,
    inter_filter=None,
    search_state=None,
    residual_model=None,
):
    """Branch-and-bound heterogeneous search with an optimality certificate.

    Same signature and return shape as ``planner.api.plan_hetero`` (which
    dispatches here on ``config.backend == "exact"``); runs serially —
    ``config.workers`` is ignored.  The returned ``PlannerResult`` carries
    a :class:`~metis_tpu_torch.core.types.Certificate` (None only when the space
    yields no costable plan at all).

    ``residual_model`` (cost/uncertainty.ResidualModel, optional): prices
    each candidate's residual distribution.  With the config's
    ``risk_quantile``/``cvar_alpha`` knobs set, incumbents and the final
    ranking live in SCORE space (point total x tail factor, >= the point
    total, so the point-cost relaxation bounds stay admissible and the
    bound-stop only prunes provably score-worse frontiers).  With a model
    — knobs or not — the Certificate carries ``confidence_p``: the
    probability the incumbent is truly optimal given the residual sigma.
    None keeps everything byte-identical to the point-mode backend."""
    from metis_tpu_torch.core.types import InterStagePlan
    from metis_tpu_torch.planner.api import (
        DEFAULT_EXPLAIN_K,
        PlannerResult,
        make_search_state,
    )
    from metis_tpu_torch.cost.uncertainty import (
        certificate_confidence,
        make_risk_scorer,
    )
    from metis_tpu_torch.search.device_groups import arrangements_of_composition

    scorer = make_risk_scorer(config, residual_model)
    tracer = Tracer(events)
    root = tracer.span("plan_exact", mode="hetero", model=model.name,
                       devices=cluster.total_devices)
    root.__enter__()
    t0 = time.perf_counter()
    with tracer.span("setup"):
        ctx = search_state if search_state is not None else make_search_state(
            cluster, profiles, model, config,
            bandwidth_factory=bandwidth_factory,
            counters=tracer.counters if tracer.enabled else None)
        bound = RelaxationBound.from_evaluator(ctx)
    events.emit(
        "search_started", mode="hetero", devices=cluster.total_devices,
        device_types=list(cluster.device_types), gbs=config.gbs,
        num_families=len(ctx.families), model=model.name, backend="exact")

    # enumerate branch nodes: one per (stage count, composition, batches)
    # class, doom-filtered exactly like the beam walk (a smallest-group
    # microbatch over max_bs stays over under every dp escalation)
    batch_options = list(divisors(config.gbs))
    heap: list[tuple] = []  # (lower bound, enum idx, S, comp, batches)
    idx = 0
    num_doomed = 0
    with tracer.span("enumeration"):
        for num_stage, comp in stage_compositions(
                cluster.total_devices, model.num_layers,
                variance=config.min_group_scale_variance):
            g_min, g_max = comp[0], comp[-1]
            for batches in batch_options:
                if (config.gbs // g_min) // batches > config.max_profiled_bs:
                    num_doomed += 1
                    tracer.inc("prune.doom")
                    continue
                node_lb = bound(g_max, num_stage, batches)
                if node_lb == float("inf"):
                    # provably empty class (feasibility cap): doom-style
                    # exactness prune, no node to explore
                    num_doomed += 1
                    tracer.inc("prune.doom")
                    continue
                heapq.heappush(
                    heap, (node_lb, idx, num_stage, comp, batches))
                idx += 1

    type_perms = _canonical_type_perms(cluster.device_types, ctx._symmetry)
    pruner = _NullPruner()
    ctx.intra_acc = None
    ctx.cost_acc = tracer.accum("costing")
    results: list[RankedPlan] = []
    order: list[tuple] = []  # (total_ms, node idx, yield seq) sort keys
    pruned = 0
    incumbent = float("inf")
    nodes_explored = 0
    nodes_bounded = 0
    complete = True
    proven_lb = float("inf")
    deadline = config.exact_deadline_s

    while heap:
        node_lb, node_idx, num_stage, comp, batches = heapq.heappop(heap)
        if node_lb > incumbent:
            # best-first: every remaining node's bound is >= this one, so
            # the whole frontier is provably outside the incumbent
            nodes_bounded += 1 + len(heap)
            heap.clear()
            break
        if (deadline is not None
                and time.perf_counter() - t0 > deadline):
            complete = False
            proven_lb = min(incumbent, node_lb)
            heap.clear()
            break
        seq = 0
        for node_sequence in type_perms:
            for groups in arrangements_of_composition(
                    comp, config.max_permute_len):
                inter = InterStagePlan(
                    node_sequence=node_sequence, device_groups=groups,
                    batches=batches, gbs=config.gbs)
                if inter_filter is not None and not inter_filter(inter):
                    pruned += 1
                    tracer.inc("pruned_inter_filter")
                    continue
                for _inter, evs in ctx.evaluate_batch([inter], pruner):
                    for kind, item in evs:
                        if kind == "plan":
                            score = (scorer.score(item.cost.total_ms,
                                                  node_sequence)
                                     if scorer is not None
                                     else item.cost.total_ms)
                            if score < incumbent:
                                incumbent = score
                            results.append(item)
                            order.append((score, node_idx, seq))
                            seq += 1
                        else:
                            pruned += 1
        nodes_explored += 1
        if events.enabled:
            events.emit(
                "bnb_progress", nodes_explored=nodes_explored,
                nodes_bounded=nodes_bounded,
                best_ms=incumbent if incumbent != float("inf") else None,
                bound_ms=round(node_lb, 4), frontier=len(heap))

    ctx.cost_acc.close()
    if complete:
        proven_lb = incumbent
    num_costed = len(results)
    with tracer.span("ranking", num_plans=num_costed):
        ranked = [p for _, p in sorted(
            zip(order, results), key=lambda rec: rec[0])]
    best_cost = ranked[0].cost.total_ms if ranked else None
    if top_k is not None:
        ranked = ranked[:top_k]
    elapsed = time.perf_counter() - t0

    certificate = None
    if best_cost is not None:
        # with a scorer the incumbent/proven_lb pair lives in score
        # space, so the whole certificate (best_ms, bound, gap) is
        # certified there too — best_ms >= lower_bound always holds in
        # one space; point mode is unchanged (score == total then,
        # float-identical)
        skeys = sorted(k[0] for k in order)
        best_score = skeys[0]
        gap = ((best_score - proven_lb) / best_score
               if best_score > 0 else 0.0)
        confidence_p = None
        if residual_model is not None and residual_model:
            best_plan = ranked[0]
            sigma = residual_model.sigma_ms(
                best_cost, best_plan.inter.node_sequence)
            margin = skeys[1] - best_score if len(skeys) > 1 else float("inf")
            if not complete:
                # unexplored frontier could hold a plan as low as the
                # proven bound — that hypothetical is the competitor
                margin = min(margin, proven_lb - best_score)
            confidence_p = round(certificate_confidence(
                margin, sigma, scorer.z_q if scorer is not None else 0.0), 6)
        certificate = Certificate(
            best_ms=best_score,
            lower_bound_ms=proven_lb,
            gap_frac=max(0.0, gap),
            nodes_explored=nodes_explored,
            nodes_bounded=nodes_bounded + num_doomed,
            wall_s=elapsed,
            complete=complete,
            confidence_p=confidence_p,
        )
        events.emit("certificate", **certificate.to_json_dict())

    # plan explainability, same contract as the beam path: re-price the
    # top-k through the SAME estimator for per-component breakdowns
    import dataclasses

    from metis_tpu_torch.obs.ledger import fingerprint_ranked_plan

    explain_k = min(len(ranked),
                    top_k if top_k is not None else DEFAULT_EXPLAIN_K)
    if explain_k:
        with tracer.span("explain", num_plans=explain_k):
            for i in range(explain_k):
                rp = ranked[i]
                try:
                    _, bd = ctx.estimator.get_breakdown(
                        rp.inter, rp.intra.strategies,
                        rp.intra.layer_partition,
                        schedule=rp.intra.schedule,
                        virtual_stages=rp.intra.virtual_stages)
                except KeyError:  # pragma: no cover - costed once already
                    continue
                if residual_model is not None and residual_model:
                    from metis_tpu_torch.cost.uncertainty import annotate_breakdown

                    bd = annotate_breakdown(bd, residual_model,
                                            rp.inter.node_sequence)
                ranked[i] = dataclasses.replace(rp, breakdown=bd)
                events.emit(
                    "plan_explain", rank=i + 1,
                    fingerprint=fingerprint_ranked_plan(rp),
                    total_ms=round(bd.total_ms, 4),
                    components={k: round(v, 4)
                                for k, v in bd.components.items()},
                    schedule=rp.intra.schedule)
    tracer.emit_counters(scope="plan_exact")
    events.emit(
        "search_finished", mode="hetero", num_costed=num_costed,
        num_pruned=pruned, seconds=round(elapsed, 4),
        best_cost_ms=best_cost,
        num_bound_pruned=num_doomed + nodes_bounded, backend="exact")
    root.__exit__(None, None, None)
    return PlannerResult(
        plans=tuple(ranked),
        num_costed=num_costed,
        num_pruned=pruned,
        search_seconds=elapsed,
        num_bound_pruned=num_doomed + nodes_bounded,
        certificate=certificate,
    )
