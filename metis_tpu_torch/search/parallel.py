"""Sharded parallel plan search — the multiprocess executor behind
``SearchConfig.workers``.

The port's copy of ``metis_tpu/search/parallel.py``.

The search hot loop (``planner/api.plan_hetero``) is a single-process pure
Python walk, exactly like the reference it reproduces — and "planner search
time" is a north-star metric (BASELINE.md).  This module makes it scale with
cores without changing a single answer:

- **Index-stride sharding.**  Every worker enumerates the SAME flat
  inter-stage candidate stream (``search/inter_stage.inter_stage_plans``)
  and processes only candidates whose global index ``idx`` satisfies
  ``idx % num_workers == worker_id``.  The shard assignment depends only on
  the enumeration order — which is deterministic — so the union of shards
  is exactly the serial candidate set for ANY worker count, including 1.
- **Stable tie-break merge.**  The serial path appends costed plans in
  (global candidate index, per-candidate yield sequence) order and then
  STABLE-sorts by ``cost.total_ms`` — so its final order is exactly the
  order of the key ``(total_ms, idx, seq)``.  Workers tag each plan with
  that key; the parent sorts the concatenation by it, reproducing the
  serial ranking byte-for-byte (``dump_ranked_plans`` equality is asserted
  in-bench and in tests/test_parallel_search.py).
- **Counter reconciliation.**  Each worker runs its own ``Counters`` and
  ``SearchPruner``; the parent folds the dicts together
  (``Counters.merge``) and sums ``num_costed``/``num_pruned``/
  ``num_bound_pruned``.  The doom fast-path is stateless per candidate, so
  with the bound/beam prunes off (``prune_to_top_k`` unset — always the
  case under ``strict_compat``) every merged count equals the serial run's.
  With ``prune_to_top_k`` set the workers keep their exactness guarantee
  (a worker-local kth-best is never better than the global one, so a
  bound-pruned candidate is provably outside the global top-K) but prune
  *later* than the serial composition-level walk — the top-K set matches
  serial, while prune counters and the tail beyond K may not.  Per-worker
  cache-utilization counters (``bw_cache_*``) naturally differ from a
  one-process run.
- **Graceful fallback.**  ``try_parallel_plan_hetero`` returns None — and
  emits a ``parallel_fallback`` event with the reason — when no
  multiprocessing start method is available or the search inputs don't
  pickle (e.g. ``plan_tpu``'s closure-based bandwidth factory under
  spawn-only platforms); ``plan_hetero`` then runs its serial loop.

``CandidateEvaluator`` is the factored-out per-candidate cost loop itself,
shared verbatim by the serial path and the workers — one implementation,
two search loops.
"""
from __future__ import annotations

import dataclasses
import math
import multiprocessing as mp
import pickle
import queue as _queue
import time
from itertools import product

from metis_tpu_torch.core.events import EventLog, NULL_LOG
from metis_tpu_torch.core.trace import NULL_SPAN, Counters, Tracer, timed_iter
from metis_tpu_torch.core.types import RankedPlan
from metis_tpu_torch.balance.layers import LayerBalancer
from metis_tpu_torch.balance.stage_perf import StagePerformanceModel, rank_device_types
from metis_tpu_torch.cost.batch import BatchCostEstimator
from metis_tpu_torch.cost.context_parallel import cp_candidates
from metis_tpu_torch.cost.estimator import EstimatorOptions, HeteroCostEstimator
from metis_tpu_torch.cost.expert_parallel import ep_candidates
from metis_tpu_torch.cost.volume import TransformerVolume
from metis_tpu_torch.cost.zero import zero_candidates
from metis_tpu_torch.search.device_groups import type_equivalence_classes
from metis_tpu_torch.search.inter_stage import inter_stage_plans
from metis_tpu_torch.search.intra_stage import intra_stage_plans, schedule_intra_plans
from metis_tpu_torch.search.prune import SearchPruner

# Symmetry-class event memo: one entry per canonical (sequence class,
# device_groups, batches) candidate.  Node-tag memo: one entry per
# (node_sequence, device_groups) layout.  Both are bounded like the costing memos —
# wholesale clear past the cap, traffic observable via
# ``memo.{symmetry,node_tags}.{hit,miss,evict}``.
_SYM_MEMO_MAX = 16384
_NODE_TAG_MEMO_MAX = 8192


class CandidateEvaluator:
    """The per-candidate cost loop of ``plan_hetero``, factored out so the
    serial path and the sharded workers run literally the same code.

    Construction mirrors ``plan_hetero``'s setup span: estimator, stage
    evaluator, layer balancer, and the cp/ep/zero/sp and pipeline-schedule
    family grids.  ``evaluate(inter, pruner)`` is a generator yielding, in
    the exact serial insertion order::

        ("plan", RankedPlan)   # costed candidate; ``pruner.record`` and the
                               # ``costed`` counter already applied
        ("miss", True)         # per-intra profile miss (counts as a
                               # heartbeat tick, like the serial loop)
        ("miss", False)        # family-level profile miss (no tick)

    so search loops only do bookkeeping: pruned tallies, heartbeats, and result
    collection.  ``inter_filter``/``pruner.admit``/``begin_candidate``/
    ``end_candidate`` remain the search loop's job.
    """

    def __init__(self, cluster, profiles, model, config,
                 bandwidth_factory=None, counters=None, node_ids=None):
        self.cluster = cluster
        self.model = model
        self.config = config
        self.counters = counters
        # Stable node identities for incremental replanning: position i of
        # ``cluster.nodes`` is known to the OWNER of this evaluator (the
        # serving daemon) as ``node_ids[i]`` in some enclosing topology —
        # a tenant carve's nodes keep their full-fleet ids.  Every costed
        # candidate gets tagged with the ids its placement touches
        # (``touched_nodes``) so a ClusterDelta can re-cost only the
        # intersecting warm state.
        if node_ids is None:
            node_ids = tuple(range(len(cluster.nodes)))
        else:
            node_ids = tuple(node_ids)
            if len(node_ids) != len(cluster.nodes):
                raise ValueError(
                    f"node_ids has {len(node_ids)} entries for "
                    f"{len(cluster.nodes)} cluster nodes")
        self.node_ids = node_ids
        self.touched_nodes: set = set()
        self.tagged_candidates = 0
        self._node_tags: dict[tuple, frozenset] = {}
        # Symmetry collapse (AMP-style, arXiv 2210.07297): when two device
        # types are cost-indistinguishable (see ``type_equivalence_classes``)
        # every candidate whose node_sequence canonicalizes to an
        # already-costed one is REPLAYED from the memo instead of re-priced —
        # bit-identical by construction, since nothing the cost model reads
        # differs.  Gated off when a bandwidth_factory is live (plan_tpu's
        # ICI/DCN topology model reads link structure the DeviceSpec
        # signature cannot see, so the collapse would be unsound there).
        self._symmetry = None
        if (getattr(config, "symmetry_collapse", True)
                and bandwidth_factory is None):
            cmap = type_equivalence_classes(cluster, profiles)
            if any(rep != t for t, rep in cmap.items()):
                self._symmetry = cmap
        self._sym_memo: dict[tuple, list] = {}
        self.sym_hits = 0
        self.sym_misses = 0
        volume = TransformerVolume(model, profiles.model.params_per_layer_bytes)
        options = EstimatorOptions.from_config(config)
        self.estimator = HeteroCostEstimator(
            cluster, profiles, volume, options, bandwidth_factory,
            counters=counters)
        self.evaluator = StagePerformanceModel(cluster, profiles,
                                               counters=counters)
        self.balancer = LayerBalancer(cluster, profiles, config, model=model,
                                      counters=counters)
        # GQA: the a2a head split must divide BOTH head counts — their gcd
        self.a2a_head_limit = math.gcd(
            model.num_heads, model.num_kv_heads or model.num_heads)
        # cp composes with the DENSE families only (execution/hetero.py has
        # no cp+MoE path); every degree > 1 searches ring K/V rotation plus
        # the Ulysses a2a mode where the head count splits evenly.
        cp_families: list[tuple[int, str]] = [(1, "ring")]
        if (config.enable_cp and not config.strict_compat
                and model.num_experts == 0):
            for d in cp_candidates(config.max_cp_degree,
                                   model.sequence_length):
                cp_families.append((d, "ring"))
                if self.a2a_head_limit % d == 0:
                    cp_families.append((d, "a2a"))
        self.cp_families = cp_families
        ep_degrees: list[int] = [1]
        if config.enable_ep and not config.strict_compat:
            ep_degrees += ep_candidates(config.max_ep_degree,
                                        model.num_experts)
        zero_stages = zero_candidates(
            config.enable_zero and not config.strict_compat)
        sp_variants = ((False, True)
                       if config.enable_sp and not config.strict_compat
                       else (False,))
        self.families = list(
            product(cp_families, ep_degrees, zero_stages, sp_variants))
        # 1f1b/interleaved run on the shard_map pipeline executor — dense
        # GPT only (execution/builder.py routing), so MoE models skip them.
        sched_families: list[tuple[str, int]] = []
        if (config.enable_schedule_search and not config.strict_compat
                and model.num_experts == 0):
            sched_families.append(("1f1b", 1))
            for vs in config.virtual_stage_candidates:
                sched_families.append(("interleaved", vs))
        self.sched_families = sched_families
        # Batched table-driven costing (cost/batch.py) prices whole intra
        # candidate lists per inter plan.  It takes over whenever the family
        # grid is exactly the base (cp=1, ep=1, zero=0, sp=False, gpipe)
        # family — the parity and scale workloads, and every strict_compat
        # search; richer family grids keep the per-family scalar loop.
        self._batch_fast = bool(
            getattr(config, "use_batch_eval", True)
            and not sched_families
            and self.families == [((1, "ring"), 1, 0, False)])
        self.batch_estimator = (
            BatchCostEstimator(self.estimator, counters=counters)
            if self._batch_fast else None)
        # serial-path tracing hooks: plan_hetero routes the intra generators
        # through its intra_stage accum span and costing through cost_acc;
        # workers leave them dark (no EventLog crosses the process boundary)
        self.intra_acc = None
        self.cost_acc = NULL_SPAN

    def _inc(self, name: str) -> None:
        if self.counters is not None:
            self.counters.inc(name)

    def evaluate(self, inter, pruner):
        config = self.config
        cp_eligible = None
        types_uniform = True
        if len(self.cp_families) > 1 or self.sched_families:
            # Ring attention needs uniform block timing: only homogeneous
            # stages take the cp axis; the shard_map pipeline (schedule
            # families) needs ONE device type everywhere.  One placement
            # resolve per inter plan, shared by both uses.
            ranks = rank_device_types(self.cluster, inter.node_sequence)
            cp_eligible = [
                len(set(ranks[slice(*inter.stage_rank_range(s))])) == 1
                for s in range(inter.num_stages)
            ]
            types_uniform = len(set(ranks)) == 1
        for sched, vs in self.sched_families:
            try:
                intra_gen = schedule_intra_plans(
                    inter, self.evaluator, self.balancer,
                    max_tp=config.max_profiled_tp,
                    max_bs=config.max_profiled_bs,
                    schedule=sched, virtual_stages=vs,
                    num_blocks=self.model.num_layers - 2,
                    types_uniform=types_uniform,
                )
                if self.intra_acc is not None:
                    intra_gen = timed_iter(intra_gen, self.intra_acc)
                for intra in intra_gen:
                    try:
                        with self.cost_acc:
                            cost = self.estimator.get_cost(
                                inter, intra.strategies,
                                intra.layer_partition,
                                schedule=sched, virtual_stages=vs)
                    except KeyError:
                        self._inc("pruned_profile_miss")
                        yield "miss", True
                        continue
                    pruner.record(cost.total_ms, inter)
                    self._inc("costed")
                    yield "plan", RankedPlan(inter=inter, intra=intra,
                                             cost=cost)
            except KeyError:
                self._inc("pruned_profile_miss")
                yield "miss", False
        # one try-block per (cp, ep, zero, sp) family: a profile miss
        # mid-generation prunes only that family, not its siblings
        for (cp, cp_mode), ep, zero, sp in self.families:
            try:
                intra_gen = intra_stage_plans(
                    inter, self.evaluator, self.balancer,
                    max_tp=config.max_profiled_tp,
                    max_bs=config.max_profiled_bs,
                    cp_degrees=(cp,), cp_eligible=cp_eligible,
                    ep_degrees=(ep,), zero_stages=(zero,),
                    sp_variants=(sp,), cp_modes=(cp_mode,),
                    num_heads=self.a2a_head_limit,
                )
                if self.intra_acc is not None:
                    intra_gen = timed_iter(intra_gen, self.intra_acc)
                for intra in intra_gen:
                    try:
                        with self.cost_acc:
                            cost = self.estimator.get_cost(
                                inter, intra.strategies,
                                intra.layer_partition)
                    except KeyError:
                        self._inc("pruned_profile_miss")
                        yield "miss", True
                        continue
                    pruner.record(cost.total_ms, inter)
                    self._inc("costed")
                    yield "plan", RankedPlan(inter=inter, intra=intra,
                                             cost=cost)
            except KeyError:
                self._inc("pruned_profile_miss")
                yield "miss", False

    def evaluate_batch(self, inters, pruner):
        """Price a buffered run of ADMITTED inter plans, batched.

        Yields ``(inter, events)`` per input in order, where ``events`` is
        the exact ``evaluate`` stream for that inter; ``begin_candidate``/
        ``end_candidate`` are handled here (begin before generation, end
        after the caller consumed the events — generator resumption
        guarantees end(i) runs before begin(i+1), so pruner state evolves
        exactly as in the one-at-a-time loop).  Search loops buffer ONE inter
        when the bound/beam prunes are active — ``pruner.admit`` must see
        each candidate's results before judging the next — and a real batch
        otherwise.

        The fast path collects each inter's intra candidates first (their
        generation never consults costing or the pruner, so collect-then-
        cost reorders nothing), prices them in one ``cost_many`` call, and
        replays the event stream: per-candidate misses tick like the serial
        loop, and a family-level miss lands last — exactly where generation
        aborted.  An empty events list is a valid yield (admitted inter
        with no candidates).

        When symmetry collapse is live, candidates whose canonicalized
        ``node_sequence`` was already costed are replayed from the memo —
        each stored event re-runs ``pruner.record`` and the counters, and
        each plan is re-wrapped with THIS inter — so the pruner state,
        counter totals, and the final stable-sort ranking are byte-identical
        to pricing every permutation from scratch.
        """
        for inter in inters:
            pruner.begin_candidate()
            events = self._candidate_events(inter, pruner)
            n_plans = sum(1 for kind, _ in events if kind == "plan")
            if n_plans:
                self.touched_nodes |= self._tag_nodes(inter)
                self.tagged_candidates += n_plans
            yield inter, events
            pruner.end_candidate(inter)

    def _candidate_events(self, inter, pruner):
        """Events for one admitted inter plan: memo replay when its symmetry
        class was already costed, fresh generation (then memoized) otherwise."""
        sym = self._symmetry
        if sym is None:
            return self._generate_events(inter, pruner)
        key = (tuple(sym[t] for t in inter.node_sequence),
               inter.device_groups, inter.batches)
        cached = self._sym_memo.get(key)
        if cached is not None:
            self.sym_hits += 1
            self._inc("memo.symmetry.hit")
            return self._replay(cached, inter, pruner)
        self.sym_misses += 1
        self._inc("memo.symmetry.miss")
        events = self._generate_events(inter, pruner)
        if len(self._sym_memo) > _SYM_MEMO_MAX:
            self._sym_memo.clear()
            self._inc("memo.symmetry.evict")
        self._sym_memo[key] = events
        return events

    def _replay(self, cached, inter, pruner):
        """Re-emit a memoized event stream for an equivalent inter plan.

        Costs are reused verbatim (bit-identical across the class by
        construction); the pruner heap and the ``costed``/
        ``pruned_profile_miss`` counters are re-driven per event so every
        observable downstream of the evaluator matches a from-scratch run.
        """
        events = []
        for kind, item in cached:
            if kind == "plan":
                pruner.record(item.cost.total_ms, inter)
                self._inc("costed")
                events.append(
                    ("plan", dataclasses.replace(item, inter=inter)))
            else:
                self._inc("pruned_profile_miss")
                events.append((kind, item))
        return events

    def _generate_events(self, inter, pruner):
        if not self._batch_fast:
            return list(self.evaluate(inter, pruner))
        config = self.config
        intras = []
        fam_miss = False
        try:
            intra_gen = intra_stage_plans(
                inter, self.evaluator, self.balancer,
                max_tp=config.max_profiled_tp,
                max_bs=config.max_profiled_bs,
                cp_degrees=(1,), cp_eligible=None,
                ep_degrees=(1,), zero_stages=(0,),
                sp_variants=(False,), cp_modes=("ring",),
                num_heads=self.a2a_head_limit,
            )
            if self.intra_acc is not None:
                intra_gen = timed_iter(intra_gen, self.intra_acc)
            for intra in intra_gen:
                intras.append(intra)
        except KeyError:
            fam_miss = True
        with self.cost_acc:
            costs = self.batch_estimator.cost_many(inter, intras)
        events = []
        for intra, cost in zip(intras, costs):
            if cost is None:
                self._inc("pruned_profile_miss")
                events.append(("miss", True))
            else:
                pruner.record(cost.total_ms, inter)
                self._inc("costed")
                events.append(
                    ("plan", RankedPlan(inter=inter, intra=intra,
                                        cost=cost)))
        if fam_miss:
            self._inc("pruned_profile_miss")
            events.append(("miss", False))
        return events

    def _tag_nodes(self, inter) -> frozenset:
        """Node ids (in the owner's namespace) the placement touches.

        Ranks are laid out over nodes in ``node_sequence`` type order;
        every stage's rank range maps back to the nodes it spans.  Device
        groups always sum to the cluster total, so for a single-job search
        the union covers every node — the granularity that makes
        incremental replanning selective comes from the daemon searching
        per-tenant carves, each tagged with its own slice of fleet ids.
        """
        key = (inter.node_sequence, inter.device_groups)
        cached = self._node_tags.get(key)
        if cached is not None:
            self._inc("memo.node_tags.hit")
            return cached
        self._inc("memo.node_tags.miss")
        # rank spans per node, in sequence order
        spans = []  # (start_rank, end_rank, node_id)
        rank = 0
        for t in inter.node_sequence:
            for i, node in enumerate(self.cluster.nodes):
                if node.device_type != t:
                    continue
                spans.append((rank, rank + node.num_devices,
                              self.node_ids[i]))
                rank += node.num_devices
        touched = set()
        for s in range(inter.num_stages):
            lo, hi = inter.stage_rank_range(s)
            for start, end, nid in spans:
                if start < hi and lo < end:
                    touched.add(nid)
        out = frozenset(touched)
        if len(self._node_tags) > _NODE_TAG_MEMO_MAX:
            self._node_tags.clear()
            self._inc("memo.node_tags.evict")
        self._node_tags[key] = out
        return out


def build_shard_pruner(ctx, profiles):
    """A fresh :class:`SearchPruner` for one shard run of ``ctx`` — the
    same construction the serial loop and every worker use, including
    the tight relaxation bound when the config calls for it (built from
    the evaluator's own tables, so the bound floats match the serial
    run's exactly: pure functions of the shared profiles/config)."""
    config = ctx.config
    bound_fn = None
    if (getattr(config, "tight_bound", True)
            and config.prune_to_top_k is not None
            and not config.strict_compat):
        from metis_tpu_torch.search.exact import RelaxationBound

        bound_fn = RelaxationBound.from_evaluator(ctx)
    return SearchPruner(config, ctx.cluster, profiles, ctx.model,
                        counters=ctx.counters, bound_fn=bound_fn)


def run_worker_shard(ctx, pruner, worker_id, num_workers,
                     inter_filter=None, top_k=None, progress=None):
    """One index-stride shard of the search, in the calling process.

    Enumerates the FULL flat candidate stream (bumping ``inter_enumerated``
    only for owned candidates, so worker sums equal the serial total) and
    runs the shared cost loop on every ``idx % num_workers == worker_id``
    candidate.  ``progress(ticks, elapsed_s, best_ms, n_plans, n_pruned)``
    fires every ``config.progress_every`` heartbeat ticks when given.
    Returns ``(plans, num_costed, pruned, num_bound_pruned)`` where
    ``plans`` is the locally sorted, optionally top-k truncated list of
    ``(total_ms, global_idx, seq, RankedPlan)`` merge tuples.

    Shared verbatim by the one-shot fork-per-search workers here and the
    daemon's persistent pre-warmed pool (``serve/pool.py``) — one
    implementation, so the byte-identical-ranking guarantee cannot drift
    between them.
    """
    config = ctx.config
    counters = ctx.counters
    plans: list[tuple] = []  # (total_ms, global_idx, seq, RankedPlan)
    pruned = 0
    ticks = 0
    best_ms = float("inf")
    t0 = time.perf_counter()
    every = max(int(config.progress_every), 1)
    next_emit = every
    stream = inter_stage_plans(
        ctx.cluster.device_types, ctx.cluster.total_devices, config.gbs,
        ctx.model.num_layers, variance=config.min_group_scale_variance,
        max_permute_len=config.max_permute_len)
    # With the bound/beam prunes active, admit() must see each
    # candidate's recorded costs before judging the next — batching
    # would admit with stale bounds and change the prune counters.
    # Batch size 1 keeps every mode byte-identical to the serial loop.
    batch: list[tuple[int, object]] = []
    bsize = 1 if pruner.active else 64

    def _drain():
        nonlocal ticks, pruned, best_ms, next_emit
        pos = 0
        for _inter, events in ctx.evaluate_batch(
                [rec[1] for rec in batch], pruner):
            idx = batch[pos][0]
            pos += 1
            seq = 0
            for kind, item in events:
                if kind == "plan":
                    if item.cost.total_ms < best_ms:
                        best_ms = item.cost.total_ms
                    plans.append((item.cost.total_ms, idx, seq, item))
                    seq += 1
                    ticks += 1
                else:
                    pruned += 1
                    if item:
                        ticks += 1
                if progress is not None and ticks >= next_emit:
                    next_emit = ticks + every
                    progress(ticks, time.perf_counter() - t0,
                             best_ms if best_ms != float("inf") else None,
                             len(plans), pruned)
        batch.clear()

    for idx, inter in enumerate(stream):
        if idx % num_workers != worker_id:
            continue
        if counters is not None:
            counters.inc("inter_enumerated")
        if inter_filter is not None and not inter_filter(inter):
            pruned += 1
            if counters is not None:
                counters.inc("pruned_inter_filter")
            continue
        if not pruner.admit(inter):
            continue
        batch.append((idx, inter))
        if len(batch) >= bsize:
            _drain()
    if batch:
        _drain()
    num_costed = len(plans)
    # local sort by the global stable-tie-break key; with a top_k the
    # merged top-k is a subset of the union of local top-ks, so the
    # tail never needs to cross the process boundary
    plans.sort(key=lambda rec: rec[:3])
    if top_k is not None:
        plans = plans[:top_k]
    return plans, num_costed, pruned, pruner.num_pruned


def _worker_main(worker_id, num_workers, out_queue, cluster, profiles,
                 model, config, bandwidth_factory, inter_filter, top_k,
                 want_counters):
    """One shard of the search, in a one-shot child process: build the
    evaluator + pruner, run :func:`run_worker_shard`, report
    ``("progress", ...)`` heartbeats and one final ``("result", ...)``
    carrying the tagged plans plus the accounting."""
    try:
        counters = Counters() if want_counters else None
        ctx = CandidateEvaluator(
            cluster, profiles, model, config,
            bandwidth_factory=bandwidth_factory, counters=counters)
        pruner = build_shard_pruner(ctx, profiles)

        def _progress(ticks, elapsed, best, n_plans, n_pruned):
            out_queue.put(("progress", worker_id, ticks, elapsed, best,
                           n_plans, n_pruned))

        plans, num_costed, pruned, bound_pruned = run_worker_shard(
            ctx, pruner, worker_id, num_workers,
            inter_filter=inter_filter, top_k=top_k, progress=_progress)
        out_queue.put((
            "result", worker_id, plans,
            counters.as_dict() if counters is not None else None,
            num_costed, pruned, bound_pruned))
    except BaseException as e:  # noqa: BLE001 — report; parent falls back
        out_queue.put(("error", worker_id, f"{type(e).__name__}: {e}"))


def _mp_context():
    """A usable multiprocessing context, spawn preferred: the port's
    processes hold torch's worker threads (and a CUDA context on the card),
    which a forked child inherits in an unknown state.  None when no start
    method works."""
    for method in ("spawn", "fork"):
        try:
            return mp.get_context(method)
        except (ValueError, RuntimeError):
            continue
    return None


def try_parallel_plan_hetero(
    cluster, profiles, model, config,
    bandwidth_factory=None,
    top_k: int | None = None,
    events: EventLog = NULL_LOG,
    inter_filter=None,
):
    """Run ``plan_hetero``'s search sharded over ``config.workers``
    processes.  Returns the merged PlannerResult — byte-identical ranking
    to the serial loop — or None when parallel execution is unavailable
    (the caller then runs the serial path); every None is preceded by a
    ``parallel_fallback`` event naming the reason."""
    from metis_tpu_torch.planner.api import DEFAULT_EXPLAIN_K, PlannerResult

    workers = int(config.workers)
    if workers <= 1:
        return None
    try:
        pickle.dumps((cluster, profiles, model, config, bandwidth_factory,
                      inter_filter, top_k))
    except Exception as e:
        events.emit("parallel_fallback",
                    reason=f"unpicklable search inputs ({type(e).__name__})")
        return None
    mp_ctx = _mp_context()
    if mp_ctx is None:
        events.emit("parallel_fallback",
                    reason="no multiprocessing start method available")
        return None

    tracer = Tracer(events)
    root = tracer.span("plan_hetero", mode="hetero", model=model.name,
                       devices=cluster.total_devices, workers=workers)
    root.__enter__()
    t0 = time.perf_counter()
    setup_span = tracer.span("setup")
    setup_span.__enter__()
    # parent-side evaluator: family count for search_started + the
    # estimator for the post-ranking explain breakdowns
    ctx = CandidateEvaluator(
        cluster, profiles, model, config,
        bandwidth_factory=bandwidth_factory,
        counters=tracer.counters if tracer.enabled else None)
    setup_span.__exit__(None, None, None)
    events.emit(
        "search_started", mode="hetero", devices=cluster.total_devices,
        device_types=list(cluster.device_types), gbs=config.gbs,
        num_families=len(ctx.families), model=model.name, workers=workers)

    out_queue = mp_ctx.Queue()
    procs = []
    try:
        for wid in range(workers):
            p = mp_ctx.Process(
                target=_worker_main,
                args=(wid, workers, out_queue, cluster, profiles, model,
                      config, bandwidth_factory, inter_filter, top_k,
                      events.enabled),
                daemon=True)
            p.start()
            procs.append(p)
    except OSError as e:
        for p in procs:
            if p.is_alive():
                p.terminate()
        root.__exit__(None, None, None)
        events.emit("parallel_fallback",
                    reason=f"worker start failed ({type(e).__name__})")
        return None

    results_by_wid: dict[int, tuple] = {}
    failed: str | None = None
    strikes = 0
    workers_span = tracer.span("workers", workers=workers)
    workers_span.__enter__()
    # drain while the workers run — the result payloads exceed the pipe
    # buffer, so a put-then-join worker would deadlock against a
    # join-then-get parent
    while len(results_by_wid) < workers and failed is None:
        try:
            msg = out_queue.get(timeout=1.0)
        except _queue.Empty:
            for wid, p in enumerate(procs):
                if (wid not in results_by_wid and not p.is_alive()
                        and p.exitcode not in (0, None)):
                    failed = f"worker {wid} exited with code {p.exitcode}"
                    break
            if failed is None and all(not p.is_alive() for p in procs):
                strikes += 1  # all dead, queue quiet: give the feeder
                if strikes >= 5:  # threads a few grace periods to flush
                    failed = "workers exited without reporting results"
            continue
        kind = msg[0]
        if kind == "progress":
            _, wid, n, elapsed, best, n_costed, n_pruned = msg
            events.emit(
                "search_progress", n=n, elapsed_s=round(elapsed, 3),
                per_s=round(n / elapsed, 1) if elapsed > 0 else None,
                worker=wid, best_cost_ms=best, num_costed=n_costed,
                num_pruned=n_pruned)
        elif kind == "error":
            failed = f"worker {msg[1]} raised: {msg[2]}"
        else:
            results_by_wid[msg[1]] = msg[2:]
    if failed is not None:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=5.0)
        workers_span.__exit__(None, None, None)
        root.__exit__(None, None, None)
        events.emit("parallel_fallback", reason=failed)
        return None
    for p in procs:
        p.join()
    workers_span.__exit__(None, None, None)

    merged: list[tuple] = []
    num_costed = 0
    pruned = 0
    bound_pruned = 0
    for wid in range(workers):
        w_plans, w_counters, w_costed, w_pruned, w_bound = results_by_wid[wid]
        merged.extend(w_plans)
        num_costed += w_costed
        pruned += w_pruned
        bound_pruned += w_bound
        if w_counters:
            tracer.counters.merge(w_counters)
    with tracer.span("ranking", num_plans=len(merged)):
        # (total_ms, global candidate idx, per-candidate yield seq): the
        # serial path's stable sort over its insertion order is exactly a
        # sort by this key, so the merge reproduces it byte-for-byte
        merged.sort(key=lambda rec: rec[:3])
    results = [rec[3] for rec in merged]
    best_cost = results[0].cost.total_ms if results else None
    if top_k is not None:
        results = results[:top_k]
    elapsed = time.perf_counter() - t0

    import dataclasses

    from metis_tpu_torch.obs.ledger import fingerprint_ranked_plan

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
                results[i] = dataclasses.replace(rp, breakdown=bd)
                events.emit(
                    "plan_explain", rank=i + 1,
                    fingerprint=fingerprint_ranked_plan(rp),
                    total_ms=round(bd.total_ms, 4),
                    components={k: round(v, 4)
                                for k, v in bd.components.items()},
                    schedule=rp.intra.schedule)
    tracer.emit_counters(scope="plan_hetero")
    events.emit(
        "search_finished", mode="hetero", num_costed=num_costed,
        num_pruned=pruned, seconds=round(elapsed, 4),
        best_cost_ms=best_cost, num_bound_pruned=bound_pruned,
        workers=workers)
    root.__exit__(None, None, None)
    return PlannerResult(
        plans=tuple(results),
        num_costed=num_costed,
        num_pruned=pruned,
        search_seconds=elapsed,
        num_bound_pruned=bound_pruned,
    )
