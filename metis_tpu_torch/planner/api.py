"""Planner entry points — the library API over search + balance + cost.

The port's copy of ``metis_tpu/planner/api.py``: ``plan_hetero``,
``plan_uniform``, ``make_search_state`` and the TPU entry ``plan_tpu`` (the
ICI/DCN torus model of ``cost/ici.py``).  The searches run on the host, as
the reference's do; with ``SearchConfig.cost_backend="torch"`` the batched
costing runs its cost kernel on ``cost_device`` (the card unless the caller
asks for the CPU).  The numpy path imports no torch.

≅ reference orchestration layer (``cost_het_cluster.py:20-49``,
``cost_homo_cluster.py:21-37``) with structured results instead of stdout
rankings.

Fault contract preserved from the reference: any profile miss while costing a
candidate prunes that candidate (KeyError family, ``cost_het_cluster.py:46-47``)
— but unlike the reference, misses inside stage-performance evaluation prune
instead of crashing the whole search.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

from metis_tpu_torch.cluster.spec import ClusterSpec
from metis_tpu_torch.cluster.tpu import TpuClusterSpec
from metis_tpu_torch.core.config import ModelSpec, SearchConfig
from metis_tpu_torch.core.errors import MetisError
from metis_tpu_torch.core.events import EventLog, NULL_LOG
from metis_tpu_torch.core.trace import Heartbeat, Tracer, timed_iter
from metis_tpu_torch.core.types import (
    Certificate,
    CostBreakdown,
    PlanCost,
    RankedPlan,
    UniformPlan,
)
from metis_tpu_torch.obs.ledger import (
    fingerprint_ranked_plan,
    fingerprint_uniform_plan,
)
from metis_tpu_torch.profiles.store import ProfileStore
from metis_tpu_torch.cost.estimator import EstimatorOptions, UniformCostEstimator
from metis_tpu_torch.cost.ici import IciDcnBandwidth
from metis_tpu_torch.cost.volume import TransformerVolume
from metis_tpu_torch.search.inter_stage import (
    inter_stage_plans,
    sequence_symmetry_stats,
)
from metis_tpu_torch.search.parallel import CandidateEvaluator
from metis_tpu_torch.search.prune import SearchPruner, pruned_inter_stage_plans
from metis_tpu_torch.search.uniform import uniform_plans


@dataclass(frozen=True)
class PlannerResult:
    """Ranked plans plus search accounting (the north-star search-time metric
    lives here, BASELINE.md).

    ``num_bound_pruned`` counts inter-stage candidates skipped by the
    scalability prunes (search/prune.py): the always-on doom fast-path
    (observably identical results) plus, when ``SearchConfig.prune_to_top_k``
    / ``beam_patience`` are set, the lower-bound and beam filters (top-K
    ranking exact under the bound's monotonicity assumption; beam inexact).

    ``certificate`` is attached only by the exact branch-and-bound backend
    (``SearchConfig.backend="exact"``, search/exact.py): the proven lower
    bound and optimality gap of this search's best plan.  None from the
    beam backend.
    """

    plans: tuple[RankedPlan, ...]  # sorted by total cost, best first
    num_costed: int
    num_pruned: int
    search_seconds: float
    num_bound_pruned: int = 0
    certificate: "Certificate | None" = None

    @property
    def best(self) -> RankedPlan | None:
        return self.plans[0] if self.plans else None


@dataclass(frozen=True)
class RankedUniformPlan:
    plan: UniformPlan
    cost: PlanCost
    device_type: str
    # attached post-ranking to the top-k plans only (plan explainability)
    breakdown: CostBreakdown | None = None


# How many top plans get a CostBreakdown attached (and a ``plan_explain``
# event emitted) when the caller passes no explicit top_k — breakdown
# recomputation is per-plan work the search hot path must never pay for.
DEFAULT_EXPLAIN_K = 5


@dataclass(frozen=True)
class UniformPlannerResult:
    plans: tuple[RankedUniformPlan, ...]
    num_costed: int          # successfully costed (whether or not OOM-excluded)
    num_pruned: int          # profile misses — could not be costed at all
    num_oom_excluded: int    # costed but dropped for predicted OOM
    search_seconds: float

    @property
    def best(self) -> RankedUniformPlan | None:
        return self.plans[0] if self.plans else None


def _finite(x: float) -> float | None:
    """inf -> None for JSON-friendly best-cost-so-far heartbeat fields."""
    return x if x != float("inf") else None


def _check_profile_attn(profiles: ProfileStore, model: ModelSpec) -> None:
    """A profile dir stamped with an attention impl must match the model
    being planned — measured dense milliseconds must never silently price a
    flash execution (or vice versa; the profile-describes-what-runs
    contract, reference README.md:41-59).  Unstamped
    stores (legacy dirs, synthetic fixtures) skip the check."""
    attn = getattr(profiles, "attn", None)
    if attn is not None and attn != model.attn:
        raise MetisError(
            f"profiles were measured with attn={attn!r} but the model "
            f"plans attn={model.attn!r} — re-profile with the matching "
            "--attn or change the model spec")


def make_search_state(
    cluster: ClusterSpec,
    profiles: ProfileStore,
    model: ModelSpec,
    config: SearchConfig,
    bandwidth_factory=None,
    counters=None,
    node_ids=None,
    cost_device: str = "cuda",
) -> CandidateEvaluator:
    """Build the search state ``plan_hetero`` otherwise constructs in its
    setup span: the cost estimator, stage-performance model, layer
    balancer, family grids, and (when enabled) the batched-costing tables.

    A long-lived caller — the serve daemon (``serve/daemon.py``) — builds
    this once per query shape and passes it back via
    ``plan_hetero(search_state=...)`` so repeat searches start with every
    memo table warm instead of rebuilding them per invocation.

    Contract: the state is valid only for searches over exactly the
    ``(cluster, profiles, model, config, bandwidth_factory)`` it was built
    with (key on :func:`metis_tpu_torch.obs.ledger.query_fingerprint`), and it is
    NOT reentrant — one search at a time per state.

    ``node_ids``: the owner's stable identity for each cluster node, in
    ``cluster.nodes`` order — the daemon passes fleet-level ids for a
    tenant carve so the state's ``touched_nodes`` tags live in the fleet
    namespace and a ``ClusterDelta`` can re-cost only intersecting states.

    ``cost_device``: where ``cost_backend="torch"`` runs its cost kernel.
    """
    _check_profile_attn(profiles, model)
    return CandidateEvaluator(
        cluster, profiles, model, config,
        bandwidth_factory=bandwidth_factory, counters=counters,
        node_ids=node_ids, cost_device=cost_device)


def plan_hetero(
    cluster: ClusterSpec,
    profiles: ProfileStore,
    model: ModelSpec,
    config: SearchConfig,
    bandwidth_factory=None,
    top_k: int | None = None,
    events: EventLog = NULL_LOG,
    inter_filter=None,
    search_state: CandidateEvaluator | None = None,
    metrics=None,
    decisions=None,
    decision_meta: dict | None = None,
    residual_model=None,
    cost_device: str = "cuda",
) -> PlannerResult:
    """Full heterogeneous search: inter-stage × intra-stage candidates,
    costed and ranked (≅ ``cost_het_cluster``).

    ``residual_model``: an optional ``cost.uncertainty.ResidualModel``
    (fit from the accuracy ledger).  Together with the config's
    ``risk_quantile``/``cvar_alpha`` knobs it switches ranking from the
    point estimate to the configured tail quantile or CVaR of each
    candidate's residual cost distribution, and annotates the top-k
    breakdowns with per-component variances.  None (the default) — or
    both knobs at 0 — is the point mode, byte-identical to the
    pre-uncertainty planner.

    ``inter_filter``: optional predicate on InterStagePlan applied before
    intra-stage expansion — topology validity filters (e.g. the TPU
    sub-torus alignment check of ``plan_tpu``) plug in here.

    Observability (core/trace.py): with an enabled ``events`` log the run
    records a span tree (setup / enumeration / intra_stage / costing /
    ranking under a ``plan_hetero`` root), a ``search_progress`` heartbeat
    every ``config.progress_every`` intra candidates, and a ``counters``
    event whose accounting reconciles with the returned result:
    ``costed == num_costed``, ``pruned_profile_miss + pruned_inter_filter
    == num_pruned``, and the ``prune.*`` family == ``num_bound_pruned``.

    With ``config.workers > 1`` the search runs sharded across worker
    processes (search/parallel.py) — same ranking, byte-for-byte — falling
    back to this serial loop (and emitting a ``parallel_fallback`` event)
    when multiprocessing is unavailable or the inputs don't pickle.

    ``search_state``: a warm :func:`make_search_state` evaluator to reuse
    instead of rebuilding estimator/balancer/grid tables — must have been
    built for this exact (cluster, profiles, model, config,
    bandwidth_factory); ranking is byte-identical either way because the
    memo tables cache the same floats the cold path computes.  Ignored by
    the ``workers > 1`` parallel path (workers build their own shards).

    ``metrics``: an optional ``obs.metrics.MetricsRegistry`` — the serve
    daemon passes its own so every search feeds the
    ``metis_search_phase_seconds{phase}`` histograms /metrics exposes
    (phase timings come from the tracer's accum spans, so they require an
    enabled ``events`` log; setup and ranking are timed directly).

    ``decisions``: an optional ``obs.provenance.DecisionLog`` — the search
    outcome is appended as one decision record (kind ``cold_search``
    unless ``decision_meta`` overrides it).  ``decision_meta``: extra
    DecisionRecord fields (``kind``, ``cause``, ``parent_seq``,
    ``trace_id``, ``query_fingerprint``, ...).

    ``cost_device``: where ``config.cost_backend="torch"`` runs its cost
    kernel — the card by default; it raises without one (pass ``"cpu"`` to
    price on the host with the kernel's plain version).  A keyword, not a
    ``SearchConfig`` field: the config's fields are the reference's."""
    _check_profile_attn(profiles, model)
    from metis_tpu_torch.cost.uncertainty import make_risk_scorer

    scorer = make_risk_scorer(config, residual_model)

    def _record(result: PlannerResult) -> PlannerResult:
        if decisions is not None:
            from metis_tpu_torch.obs.provenance import record_planner_decision

            meta = dict(decision_meta or {})
            # the risk posture `why` renders: point-, quantile- or
            # CVaR-ranked, and whether transferred profiles priced it
            posture: dict = (scorer.describe() if scorer is not None
                             else {})
            transferred = getattr(profiles, "transferred", None)
            if transferred:
                posture["transferred_profiles"] = sorted(transferred)
            if posture:
                detail = dict(meta.get("detail") or {})
                detail.update(posture)
                meta["detail"] = detail
            record_planner_decision(
                decisions, result, kind=meta.pop("kind", "cold_search"),
                **meta)
        return result

    if getattr(config, "backend", "beam") == "exact":
        # branch-and-bound backend (search/exact.py): same candidate space
        # and cost path, plus an optimality certificate; runs serially
        from metis_tpu_torch.search.exact import exact_plan_hetero

        return _record(exact_plan_hetero(
            cluster, profiles, model, config,
            bandwidth_factory=bandwidth_factory, top_k=top_k,
            events=events, inter_filter=inter_filter,
            search_state=search_state, residual_model=residual_model,
            cost_device=cost_device))
    if config.workers > 1 and scorer is None:
        # risk-ranked searches take the serial loop below — the sharded
        # workers don't carry a residual model across the process boundary
        from metis_tpu_torch.search.parallel import try_parallel_plan_hetero

        parallel_result = try_parallel_plan_hetero(
            cluster, profiles, model, config,
            bandwidth_factory=bandwidth_factory, top_k=top_k,
            events=events, inter_filter=inter_filter,
            cost_device=cost_device)
        if parallel_result is not None:
            return _record(parallel_result)
    tracer = Tracer(events)
    heartbeat = Heartbeat(events, every=config.progress_every)
    root = tracer.span("plan_hetero", mode="hetero", model=model.name,
                       devices=cluster.total_devices)
    root.__enter__()
    t0 = time.perf_counter()
    setup_span = tracer.span("setup")
    setup_span.__enter__()
    # The per-candidate cost loop (estimator, stage evaluator, balancer,
    # cp/ep/zero/sp + schedule family grids, and the evaluate() generator)
    # lives in search/parallel.CandidateEvaluator so this serial loop and
    # the sharded workers run literally the same code.
    if search_state is not None:
        ctx = search_state
    else:
        ctx = CandidateEvaluator(
            cluster, profiles, model, config,
            bandwidth_factory=bandwidth_factory,
            counters=tracer.counters if tracer.enabled else None,
            cost_device=cost_device)
    setup_span.__exit__(None, None, None)
    setup_s = time.perf_counter() - t0
    events.emit(
        "search_started", mode="hetero", devices=cluster.total_devices,
        device_types=list(cluster.device_types), gbs=config.gbs,
        num_families=len(ctx.families), model=model.name)

    results: list[RankedPlan] = []
    pruned = 0
    best_ms = float("inf")
    enum_acc = tracer.accum("enumeration")
    intra_acc = tracer.accum("intra_stage")
    cost_acc = tracer.accum("costing")

    def _tick() -> None:
        # one intra candidate processed (costed or pruned); Heartbeat emits
        # every config.progress_every of these with the running accounting
        if events.enabled:
            heartbeat.tick(best_cost_ms=_finite(best_ms),
                           num_costed=len(results), num_pruned=pruned)

    # Tight relaxation bound (search/exact.RelaxationBound): the exact
    # backend's admissible per-class lower bound, consulted by the pruner
    # after its stock execution floor passes.  Admissible means the top-K
    # ranking stays byte-identical — it only skips candidates that provably
    # cannot enter the top K (prune.bound.tight counter; gated by
    # tools/check_search_regression.py).
    bound_fn = None
    if (getattr(config, "tight_bound", True)
            and config.prune_to_top_k is not None
            and not config.strict_compat):
        from metis_tpu_torch.search.exact import RelaxationBound

        bound_fn = RelaxationBound.from_evaluator(ctx)
    pruner = SearchPruner(config, cluster, profiles, model,
                          counters=tracer.counters if tracer.enabled
                          else None,
                          bound_fn=bound_fn, scorer=scorer)
    # per-search symmetry accounting: the evaluator's hit/miss totals are
    # lifetime (warm states span searches), so the event reports deltas
    sym_h0, sym_m0 = ctx.sym_hits, ctx.sym_misses
    if pruner.active:
        # composition-level pruning: doom/bound filters run once per
        # (composition, batches) class and beam-dead classes skip
        # arrangement expansion — the flat walk's iteration cost alone
        # breaks the budget at 256 devices (search/prune.py)
        inter_iter = pruned_inter_stage_plans(
            cluster.device_types,
            cluster.total_devices,
            config.gbs,
            model.num_layers,
            pruner,
            variance=config.min_group_scale_variance,
            max_permute_len=config.max_permute_len,
            counters=tracer.counters if tracer.enabled else None,
        )
    else:
        inter_iter = inter_stage_plans(
            cluster.device_types,
            cluster.total_devices,
            config.gbs,
            model.num_layers,
            variance=config.min_group_scale_variance,
            max_permute_len=config.max_permute_len,
            counters=tracer.counters if tracer.enabled else None,
        )
    if tracer.enabled:
        inter_iter = timed_iter(inter_iter, enum_acc)
    # (Re)assign per-run accum hooks unconditionally: a reused search_state
    # would otherwise carry a closed accum span from its previous run.
    ctx.intra_acc = intra_acc if tracer.enabled else None
    ctx.cost_acc = cost_acc
    # Admitted inters are buffered and priced through evaluate_batch —
    # the batched table-driven costing path (cost/batch.py) when the
    # config's family grid allows it, the per-candidate scalar loop
    # otherwise.  With the bound/beam prunes active, admit() must see each
    # candidate's recorded costs before judging the next, so the buffer
    # degenerates to one inter — every mode stays byte-identical to the
    # historical one-at-a-time loop (evaluate_batch handles
    # begin_candidate/end_candidate; this loop keeps the pruned tally,
    # the results list, and the heartbeat — a family-level miss does not
    # tick, matching the historical accounting).
    batch: list = []
    bsize = 1 if pruner.active else 64

    def _drain() -> None:
        nonlocal best_ms, pruned
        for _inter, batch_events in ctx.evaluate_batch(batch, pruner):
            for kind, item in batch_events:
                if kind == "plan":
                    best_ms = min(best_ms, item.cost.total_ms)
                    results.append(item)
                    _tick()
                else:
                    pruned += 1
                    if item:
                        _tick()
        batch.clear()

    for inter in inter_iter:
        if inter_filter is not None and not inter_filter(inter):
            pruned += 1
            tracer.inc("pruned_inter_filter")
            continue
        if not pruner.admit(inter):
            continue
        batch.append(inter)
        if len(batch) >= bsize:
            _drain()
    if batch:
        _drain()

    enum_acc.close()
    intra_acc.close()
    cost_acc.close()
    t_rank = time.perf_counter()
    with tracer.span("ranking", num_plans=len(results)):
        if scorer is not None:
            # tail-risk ranking: the configured quantile/CVaR of each
            # candidate's residual distribution.  With equal per-type
            # variance the factor is constant, so this is a monotone
            # transform of the point total and the order is unchanged.
            results.sort(key=lambda r: scorer.score(
                r.cost.total_ms, r.inter.node_sequence))
        else:
            results.sort(key=lambda r: r.cost.total_ms)
    if metrics is not None:
        phase_obs = [("setup", setup_s),
                     ("ranking", time.perf_counter() - t_rank)]
        if tracer.enabled:
            # accum spans are NULL_SPAN (no totals) without a tracer
            phase_obs += [("enumeration", enum_acc.total_s),
                          ("intra_stage", intra_acc.total_s),
                          ("costing", cost_acc.total_s)]
        for phase, secs in phase_obs:
            metrics.histogram("metis_search_phase_seconds",
                              phase=phase).observe(secs)
    num_costed = len(results)
    best_cost = results[0].cost.total_ms if results else None
    if top_k is not None:
        results = results[:top_k]
    elapsed = time.perf_counter() - t0
    # plan explainability: re-price the top-k through the SAME estimator to
    # attach per-component breakdowns (components sum to the ranked scalar)
    # and emit one plan_explain event per plan.  After the elapsed stamp so
    # search_seconds stays the pure search-time north-star metric.
    explain_k = min(len(results),
                    top_k if top_k is not None else DEFAULT_EXPLAIN_K)
    if explain_k:
        with tracer.span("explain", num_plans=explain_k):
            for i in range(explain_k):
                rp = results[i]
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
                results[i] = dataclasses.replace(rp, breakdown=bd)
                events.emit(
                    "plan_explain", rank=i + 1,
                    fingerprint=fingerprint_ranked_plan(rp),
                    total_ms=round(bd.total_ms, 4),
                    components={k: round(v, 4)
                                for k, v in bd.components.items()},
                    schedule=rp.intra.schedule)
    if ctx._symmetry is not None:
        total_seqs, distinct_seqs = sequence_symmetry_stats(
            cluster.device_types, ctx._symmetry)
        hits = ctx.sym_hits - sym_h0
        misses = ctx.sym_misses - sym_m0
        events.emit(
            "symmetry_collapse",
            classes={t: rep for t, rep in sorted(ctx._symmetry.items())},
            total_sequences=total_seqs,
            distinct_sequences=distinct_seqs,
            collapse_frac=round(1.0 - distinct_seqs / total_seqs, 4)
            if total_seqs else 0.0,
            replayed=hits, costed_fresh=misses)
    if getattr(config, "cost_backend", "numpy") != "numpy":
        events.emit("cost_backend", backend=config.cost_backend,
                    batch_fast=ctx._batch_fast)
    tracer.emit_counters(scope="plan_hetero")
    events.emit(
        "search_finished", mode="hetero", num_costed=num_costed,
        num_pruned=pruned, seconds=round(elapsed, 4),
        best_cost_ms=best_cost, num_bound_pruned=pruner.num_pruned)
    root.__exit__(None, None, None)
    return _record(PlannerResult(
        plans=tuple(results),
        num_costed=num_costed,
        num_pruned=pruned,
        search_seconds=elapsed,
        num_bound_pruned=pruner.num_pruned,
    ))


def plan_uniform(
    cluster: ClusterSpec,
    profiles: ProfileStore,
    model: ModelSpec,
    config: SearchConfig,
    device_type: str | None = None,
    include_oom: bool = False,
    top_k: int | None = None,
    events: EventLog = NULL_LOG,
) -> UniformPlannerResult:
    """Homogeneous Megatron-grid sweep at the configured gbs
    (≅ ``cost_homo_cluster``)."""
    _check_profile_attn(profiles, model)
    tracer = Tracer(events)
    heartbeat = Heartbeat(events, every=config.progress_every)
    root = tracer.span("plan_uniform", mode="uniform", model=model.name,
                       devices=cluster.total_devices)
    root.__enter__()
    t0 = time.perf_counter()
    dtype = device_type or cluster.device_types[0]
    events.emit(
        "search_started", mode="uniform", devices=cluster.total_devices,
        device_types=[dtype], gbs=config.gbs, model=model.name)
    volume = TransformerVolume(model, profiles.model.params_per_layer_bytes)
    estimator = UniformCostEstimator(
        cluster, profiles, volume, EstimatorOptions.from_config(config),
        counters=tracer.counters if tracer.enabled else None)

    ranked: list[RankedUniformPlan] = []
    pruned = 0
    oom_excluded = 0
    num_costed = 0
    best_ms = float("inf")
    cost_acc = tracer.accum("costing")
    for plan in uniform_plans(
        num_devices=cluster.total_devices,
        max_tp=config.max_profiled_tp,
        gbs=config.gbs,
    ):
        if plan.mbs > config.max_profiled_bs:
            continue
        try:
            with cost_acc:
                cost = estimator.get_cost(plan, dtype)
        except KeyError:
            pruned += 1
            tracer.inc("pruned_profile_miss")
            heartbeat.tick(best_cost_ms=_finite(best_ms),
                           num_costed=num_costed, num_pruned=pruned)
            continue
        num_costed += 1
        best_ms = min(best_ms, cost.total_ms)
        tracer.inc("costed")
        heartbeat.tick(best_cost_ms=_finite(best_ms),
                       num_costed=num_costed, num_pruned=pruned)
        if cost.oom and not include_oom:
            oom_excluded += 1
            tracer.inc("oom_excluded")
            continue
        ranked.append(RankedUniformPlan(plan=plan, cost=cost, device_type=dtype))

    cost_acc.close()
    with tracer.span("ranking", num_plans=len(ranked)):
        ranked.sort(key=lambda r: r.cost.total_ms)
    best_cost = ranked[0].cost.total_ms if ranked else None
    if top_k is not None:
        ranked = ranked[:top_k]
    elapsed = time.perf_counter() - t0
    explain_k = min(len(ranked),
                    top_k if top_k is not None else DEFAULT_EXPLAIN_K)
    if explain_k:
        with tracer.span("explain", num_plans=explain_k):
            for i in range(explain_k):
                r = ranked[i]
                try:
                    _, bd = estimator.get_breakdown(r.plan, r.device_type)
                except KeyError:  # pragma: no cover - costed once already
                    continue
                ranked[i] = dataclasses.replace(r, breakdown=bd)
                events.emit(
                    "plan_explain", rank=i + 1,
                    fingerprint=fingerprint_uniform_plan(r.plan),
                    total_ms=round(bd.total_ms, 4),
                    components={k: round(v, 4)
                                for k, v in bd.components.items()},
                    schedule="gpipe")
    tracer.emit_counters(scope="plan_uniform")
    events.emit(
        "search_finished", mode="uniform", num_costed=num_costed,
        num_pruned=pruned, seconds=round(elapsed, 4),
        best_cost_ms=best_cost)
    root.__exit__(None, None, None)
    return UniformPlannerResult(
        plans=tuple(ranked),
        num_costed=num_costed,
        num_pruned=pruned,
        num_oom_excluded=oom_excluded,
        search_seconds=elapsed,
    )


def plan_tpu(
    tpu_cluster: TpuClusterSpec,
    profiles: ProfileStore,
    model: ModelSpec,
    config: SearchConfig,
    chips_per_node: int = 4,
    top_k: int | None = None,
    events: EventLog = NULL_LOG,
    calibration=None,
    aligned_groups: bool = True,
    device: str = "cuda",
    cost_device: str = "cuda",
) -> PlannerResult:
    """Heterogeneous search over TPU slices with the ICI/DCN-aware bandwidth
    model (the BASELINE.md north-star path: e.g. v4-32 + v5e-16 over DCN).

    ``calibration``: an optional ``cost.CollectiveCalibration`` from
    ``microbenchmark_collectives`` — measured wire constants override the
    published per-generation link bandwidths for matching slices.

    ``aligned_groups``: prune inter-stage plans whose stage rank ranges
    cannot map to contiguous sub-toruses / whole slices (SURVEY.md §7 hard
    part #4 — arbitrary GPU-style rank sets are not valid TPU device
    groups); disable to reproduce the unconstrained GPU-style search.

    ``device``: the device type planned for, handed to ``IciDcnBandwidth``
    (the reference reads JAX's default backend): a ``"cpu"`` calibration
    applies only with ``device="cpu"``.  ``cost_device``: as for
    ``plan_hetero``.  The bandwidth factory is a closure, which does not
    pickle, so ``config.workers > 1`` falls back to the serial loop."""
    from metis_tpu_torch.cluster.tpu import stage_groups_torus_aligned

    cluster = tpu_cluster.as_cluster_spec(chips_per_node)
    inter_filter = None
    if aligned_groups:
        inter_filter = lambda inter: stage_groups_torus_aligned(  # noqa: E731
            tpu_cluster, inter.node_sequence, inter.device_groups)
    return plan_hetero(
        cluster, profiles, model, config,
        bandwidth_factory=lambda plan: IciDcnBandwidth(
            tpu_cluster, plan, calibration=calibration, device=device),
        top_k=top_k,
        events=events,
        inter_filter=inter_filter,
        cost_device=cost_device,
    )
