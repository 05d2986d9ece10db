"""Layer->stage partitioning: optimal DP replacing the reference's heuristic.

The port's copy of ``metis_tpu/balance/layers.py``.

The reference's ``LayerComputeBalancer`` (``model/load_balancer.py:182-372``)
splits each layer into 7 "hallucination" slices, greedily fills stages in five
passes, then runs <=3 boundary-shift refinements; a repair loop
(``partition_layer``, ``load_balancer.py:121-144``) re-weights stage capacity
when the result exceeds memory.  We replace the whole construction with exact
dynamic programming over contiguous partitions (SURVEY.md §7 step 5):

    minimize  max_s  load(i_s, j_s) / perf_s
    s.t.      demand_s(i_s, j_s) <= capacity_s   (memory-constrained pass)

O(S·L²) with prefix sums — microseconds at planner scale, provably at least
as balanced as the greedy under the identical objective and memory model.

The *memory-demand model* keeps reference semantics (mem_coef fudge factor,
power-of-two decomposition of hetero batches).  Two reference bugs are
reproduced only under ``strict_compat`` (both in ``load_balancer.py:29-55``):
memory profiles are always read from the cluster's first device type
(``device_types[0]`` — even for stages of another type), and the hetero batch
split is computed over the full cluster device list instead of the stage's.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from metis_tpu_torch.cluster.spec import ClusterSpec
from metis_tpu_torch.core.config import ModelSpec, SearchConfig
from metis_tpu_torch.core.errors import ProfileMissError
from metis_tpu_torch.core.types import InterStagePlan, Strategy
from metis_tpu_torch.profiles.store import ProfileStore
from metis_tpu_torch.balance.data import DataBalancer, power_of_two_chunks, replica_chunks
from metis_tpu_torch.balance.stage_perf import rank_device_types
from metis_tpu_torch.cost.context_parallel import ActivationSplitModel
from metis_tpu_torch.cost.expert_parallel import (
    expert_param_fraction,
    expert_static_scale,
)
from metis_tpu_torch.cost.sequence_parallel import SequenceParallelModel
from metis_tpu_torch.cost.zero import zero_static_reduction_mb
from metis_tpu_torch.native import minmax_partition_native, native_available
from metis_tpu_torch.search.intra_stage import PartitionResult


# Cross-candidate memo bound (entries) — see LayerBalancer.__init__.
_MEMO_MAX = 200_000

# Negative-cache sentinel for the stage-prefix memo: a ProfileMissError on
# the rows walk is cached and replayed as the same infeasible result.
_MISS = object()


def _strategy_key(strategies: Sequence[Strategy]) -> tuple:
    """Hashable memo key over every strategy axis the memory/partition
    models read (dp, tp, cp, ep, zero, sp; cp_mode rides along for safety)."""
    return tuple((s.dp, s.tp, s.cp, s.ep, s.zero, s.sp, s.cp_mode)
                 for s in strategies)


def minmax_partition(
    weights: Sequence[float],
    performance: Sequence[float],
    feasible: Callable[[int, int, int], bool] | np.ndarray | None = None,
) -> tuple[int, ...] | None:
    """Optimal contiguous partition of ``weights`` into ``len(performance)``
    non-empty stages minimizing the max of stage-weight / stage-performance.

    ``feasible`` may veto assigning layers [i, j) to stage s — either a
    callable ``(s, i, j) -> bool`` or a precomputed boolean array
    ``[S, L+1, L+1]`` (the hot path: the balancer passes capacity masks built
    from prefix sums, keeping the whole DP in numpy).
    Returns S+1 cumulative boundaries, or None if no feasible partition exists.
    """
    num_layers = len(weights)
    num_stages = len(performance)
    if num_stages > num_layers:
        return None
    prefix = np.concatenate(
        ([0.0], np.cumsum(np.asarray(weights, dtype=np.float64))))
    span = prefix[None, :] - prefix[:, None]        # span[i, j] = w[i:j)
    jgrid = np.arange(num_layers + 1)
    empty = jgrid[None, :] <= jgrid[:, None]        # j <= i: no layers

    if callable(feasible):
        F = np.ones((num_stages, num_layers + 1, num_layers + 1), bool)
        for s in range(num_stages):
            for i in range(num_layers):
                for j in range(i + 1, num_layers + 1):
                    F[s, i, j] = feasible(s, i, j)
    else:
        F = feasible

    INF = np.inf
    choice = np.full((num_stages, num_layers + 1), -1, np.int64)
    # best[j]: minimal bottleneck for layers [0, j) on stages [0, s]
    perf0 = performance[0]
    best = span[0] / perf0 if perf0 > 0 else np.full(num_layers + 1, INF)
    best = np.where(jgrid >= 1, best, INF)
    if F is not None:
        best = np.where(F[0, 0], best, INF)
    choice[0] = np.where(np.isfinite(best), 0, -1)

    for s in range(1, num_stages):
        perf = performance[s]
        cost = span / perf if perf > 0 else np.full_like(span, INF)
        cand = np.maximum(best[:, None], cost)      # cand[i, j]
        cand = np.where(empty, INF, cand)
        if F is not None:
            cand = np.where(F[s], cand, INF)
        idx = np.argmin(cand, axis=0)               # first minimal i, like
        best = cand[idx, jgrid]                     # the scalar DP's < test
        choice[s] = np.where(np.isfinite(best), idx, -1)

    if not np.isfinite(best[num_layers]):
        return None
    bounds = [num_layers]
    j = num_layers
    for s in range(num_stages - 1, -1, -1):
        i = int(choice[s, j])
        bounds.append(i)
        j = i
    return tuple(reversed(bounds))


class LayerBalancer:
    """Implements the search layer's LayerPartitioner protocol."""

    def __init__(
        self,
        cluster: ClusterSpec,
        profiles: ProfileStore,
        config: SearchConfig,
        model: ModelSpec | None = None,
        counters=None,
    ):
        self.cluster = cluster
        self.profiles = profiles
        self.config = config
        # ModelSpec is only needed for expert-parallel memory relief
        # (expert fraction is analytic); without it ep plans get no relief.
        self.model = model
        # optional core.trace.Counters for memo hit/miss/evict accounting
        self._counters = counters
        self.data_balancer = DataBalancer(profiles)
        self.act_split = ActivationSplitModel(profiles)
        self.sp_model = SequenceParallelModel(self.act_split)
        # Stage-prefix memo: keyed on the cheap strategy/type/batch facts the
        # rows depend on (not the rows themselves — hashing O(L) float tuples
        # per stage per candidate used to dominate the partition hot path).
        self._prefix_cache: dict[tuple, object] = {}
        # (node_sequence, device_groups) -> (ranks, per-stage type tuples)
        self._types_cache: dict[tuple, tuple] = {}
        # Cross-candidate partition memos: the DP answer depends only on
        # (placement, groups, microbatch total, strategy axes, performance,
        # capacity) — and the enumeration revisits those combinations once
        # per batch count and type permutation.  PartitionResult is frozen,
        # so cached values are shared safely.  Bounded like the estimator's
        # bandwidth cache (cost/estimator.py) against pathological searches.
        self._part_cache: dict[tuple, PartitionResult] = {}
        self._sched_cache: dict[tuple, PartitionResult] = {}
        # Normalized per-layer durations from the tp1_bs1 profile of the first
        # device type (≅ load_balancer.py:22-27, made deterministic).  When
        # the sweep starts above bs=1, the smallest profiled bs at tp=1
        # substitutes — the weights are normalized per-layer shares, which
        # are stable in bs, so any single profile anchors them.
        t0 = profiles.device_types[0]
        from metis_tpu_torch.core.errors import ProfileMissError

        try:
            base = profiles.get(t0, 1, 1)
        except ProfileMissError:
            bss = sorted(bs for (_, tp, bs) in profiles.configs(t0)
                         if tp == 1)
            if not bss:
                raise
            base = profiles.get(t0, 1, bss[0])
        total = base.total_time_ms
        self.layer_weights = tuple(t / total for t in base.layer_times_ms)
        self._wprefix = np.concatenate(
            ([0.0], np.cumsum(np.asarray(self.layer_weights, np.float64))))

    # -- memory model ------------------------------------------------------
    def _stage_memory_rows(
        self,
        plan: InterStagePlan,
        strategy: Strategy,
        stage_types: Sequence[str],
        all_types: Sequence[str],
    ) -> list[tuple[float, ...]]:
        """Per-layer memory rows whose sums give this stage's demand (homo:
        one row at the stage batch; hetero: one per replica power-of-two batch
        chunk).  Depends only on the stage, not on the layer range — resolved
        once and reused across all O(L²) DP probes.  Context parallelism
        (strategy.cp > 1, homo stages only) divides the activation component
        of the row via the profile-fit split model."""
        compat = self.config.strict_compat
        if len(set(stage_types)) == 1:
            bs = plan.gbs // plan.batches // strategy.dp
            mem_type = all_types[0] if compat else stage_types[0]
            sharded = (strategy.cp > 1 or strategy.ep > 1
                       or strategy.zero > 0
                       or (strategy.sp and strategy.tp > 1))
            if sharded and not compat:
                return [self._sharded_memory_row(mem_type, bs, strategy)]
            return [self.profiles.get(mem_type, strategy.tp, bs).layer_memory_mb]
        split_types = list(all_types) if compat else list(stage_types)
        split = self.data_balancer.partition(
            split_types, strategy.dp, strategy.tp, plan.gbs // plan.batches)
        chunks = replica_chunks(stage_types, strategy.dp)
        rows = []
        for replica_id, h_bs in enumerate(split):
            mem_type = all_types[0] if compat else chunks[replica_id][0]
            for c in power_of_two_chunks(h_bs):
                rows.append(self.profiles.get(mem_type, strategy.tp, c).layer_memory_mb)
        return rows

    def _sharded_memory_row(
        self, mem_type: str, bs: int, strategy: Strategy
    ) -> tuple[float, ...]:
        """One homo-stage memory row composing every sharded-state relief:
        cp divides activations, ep scales the expert share of static memory,
        ZeRO subtracts sharded optimizer/grad/param state (cost modules own
        the per-axis math; the split model owns the fit/clamp mechanics)."""
        n = self.profiles.model.num_layers
        static_scale = None
        expert_frac = 0.0
        if strategy.ep > 1 and self.model is not None:
            static_scale = expert_static_scale(self.model, n, strategy.ep)
            if static_scale is not None:
                expert_frac = expert_param_fraction(self.model)
        reduction = zero_static_reduction_mb(
            self.profiles.model.params_per_layer_bytes,
            strategy.zero, strategy.data_ranks, tp=strategy.tp,
            dtype_bytes=self.model.dtype_bytes if self.model else 2,
            expert_frac=expert_frac, ep=strategy.ep)
        act_scale = (self.sp_model.act_scale(mem_type, strategy.tp)
                     if strategy.sp else None)
        return self.act_split.layer_memory(
            mem_type, strategy.tp, bs, act_divisor=strategy.cp,
            static_scale=static_scale, static_reduction_mb=reduction,
            act_scale=act_scale)

    def _count(self, name: str) -> None:
        if self._counters is not None:
            self._counters.inc(name)

    def _stage_structure(self, plan: InterStagePlan) -> tuple:
        """(rank types, per-stage type tuples, per-stage homo flags) of a
        placement — sliced once per (node_sequence, device_groups) instead
        of per partition call."""
        key = (plan.node_sequence, plan.device_groups)
        ent = self._types_cache.get(key)
        if ent is None:
            ranks = rank_device_types(self.cluster, plan.node_sequence)
            stage_types = tuple(
                ranks[slice(*plan.stage_rank_range(s))]
                for s in range(plan.num_stages))
            homos = tuple(len(set(t)) == 1 for t in stage_types)
            ent = (ranks, stage_types, homos)
            if len(self._types_cache) > _MEMO_MAX:
                self._types_cache.clear()
                self._count("memo.layer_types.evict")
            self._types_cache[key] = ent
        return ent

    def _build_prefix(
        self,
        key: tuple,
        plan: InterStagePlan,
        strategy: Strategy,
        stage_types: Sequence[str],
        all_types: Sequence[str],
    ):
        """Miss path of the stage-prefix memo (the hit path is inlined in
        ``_partition_uncached`` — the hottest loop in the search): resolve
        the stage's memory rows and collapse them to one combined prefix
        array whose element j is the total MB of layers [0, j) summed across
        all replica-chunk rows.  Caches ``_MISS`` when the rows walk raised
        ProfileMissError (the uncached walk would raise the identical error
        every time, so the replay is exact)."""
        self._count("memo.layer_prefix.miss")
        try:
            rows = self._stage_memory_rows(
                plan, strategy, stage_types, all_types)
        except ProfileMissError:
            cached = _MISS
        else:
            combined = np.sum(np.asarray(rows, dtype=np.float64), axis=0)
            cached = np.concatenate(([0.0], np.cumsum(combined)))
        if len(self._prefix_cache) > _MEMO_MAX:
            self._prefix_cache.clear()
            self._count("memo.layer_prefix.evict")
        self._prefix_cache[key] = cached
        return cached

    def stage_memory_demand(
        self,
        plan: InterStagePlan,
        strategy: Strategy,
        stage_types: Sequence[str],
        all_types: Sequence[str],
        start: int,
        end: int,
    ) -> float:
        """Projected stage memory (MB) for layers [start, end)
        (≅ ``_get_stage_memory_demand``, mem_coef included)."""
        rows = self._stage_memory_rows(plan, strategy, stage_types, all_types)
        return 0.001 + self.config.mem_coef * sum(
            sum(row[start:end]) for row in rows)

    # -- schedule-aware feasibility (pipeline-schedule plan families) ------
    def schedule_partition(
        self,
        plan: InterStagePlan,
        strategies: Sequence[Strategy],
        memory_capacity: Sequence[float],
        schedule: str,
        virtual_stages: int,
    ) -> PartitionResult:
        """Even-split partition + schedule-aware memory feasibility for the
        pipeline-schedule families (cost/schedule.py).

        The shard_map pipeline executor requires the canonical even block
        split (``execution/builder.py _uniform_block_split``), so these
        families don't run the minmax DP — they take the canonical split and
        check it against the schedule's TRUE activation peak:

            demand = mem_coef * static + act_factor * act + boundary_bufs

        where (static, act) come from the profile store's batch-size-sweep
        fit (``ActivationSplitModel``), ``act_factor`` is the schedule's
        in-flight microbatch count (gpipe: M, 1f1b: 1, interleaved: 1/vs),
        and ``boundary_bufs`` are the remat schedules' saved boundary
        inputs.  ``mem_coef`` (the reference's 5.0 fudge,
        ``load_balancer.py:31``) multiplies only the static component here —
        it stands in for grad/optimizer state, which scales with params; the
        activation term is charged at its actual in-flight count instead.
        Falls back to the legacy schedule-blind demand when the store has
        too few batch points to identify the split (conservative for the
        remat schedules — never optimistic about relief).

        Memoized across candidates (profile misses propagate uncached, so
        the caller's prune accounting replays identically)."""
        key = (plan.node_sequence, plan.device_groups, plan.batches,
               plan.gbs // plan.batches, _strategy_key(strategies),
               schedule, virtual_stages, tuple(memory_capacity))
        cached = self._sched_cache.get(key)
        if cached is not None:
            return cached
        out = self._schedule_partition_uncached(
            plan, strategies, memory_capacity, schedule, virtual_stages)
        if len(self._sched_cache) > _MEMO_MAX:
            self._sched_cache.clear()
            self._count("memo.layer_sched.evict")
        self._sched_cache[key] = out
        return out

    def _schedule_partition_uncached(
        self,
        plan: InterStagePlan,
        strategies: Sequence[Strategy],
        memory_capacity: Sequence[float],
        schedule: str,
        virtual_stages: int,
    ) -> PartitionResult:
        from metis_tpu_torch.cost.estimator import uniform_layer_split
        from metis_tpu_torch.cost.schedule import (
            boundary_buffer_mb,
            schedule_activation_factor,
            schedule_boundary_buffers,
        )

        S = plan.num_stages
        L = len(self.layer_weights)
        if S > L:
            return PartitionResult(None, -1, None)
        counts = uniform_layer_split(L, S)
        bounds = [0]
        for c in counts:
            bounds.append(bounds[-1] + c)
        ranks = rank_device_types(self.cluster, plan.node_sequence)
        act_factor = schedule_activation_factor(
            schedule, plan.batches, virtual_stages)
        nbuf = schedule_boundary_buffers(
            schedule, S, plan.batches, virtual_stages)
        demands: list[float] = []
        for s, strat in enumerate(strategies):
            stage_types = ranks[slice(*plan.stage_rank_range(s))]
            mem_type = stage_types[0]
            bs = plan.gbs // plan.batches // strat.dp
            base = self.profiles.get(mem_type, strat.tp, bs).layer_memory_mb
            start, end = bounds[s], bounds[s + 1]
            fitted = self.act_split.split(mem_type, strat.tp)
            if fitted is None:
                demands.append(
                    0.001 + self.config.mem_coef * sum(base[start:end]))
                continue
            static, slope = fitted
            stat_mb = sum(static[start:end])
            act_mb = sum(sl * bs for sl in slope[start:end])
            bnd_mb = 0.0
            if nbuf and self.model is not None:
                bnd_mb = nbuf * boundary_buffer_mb(
                    bs, self.model.sequence_length, self.model.hidden_size,
                    self.model.dtype_bytes)
            demands.append(0.001 + self.config.mem_coef * stat_mb
                           + act_factor * act_mb + bnd_mb)
        state = tuple(c - d for c, d in zip(memory_capacity, demands))
        if min(state) >= 0:
            return PartitionResult(tuple(bounds), 1, state)
        return PartitionResult(None, -1, state)

    # -- partitioning ------------------------------------------------------
    def partition(
        self,
        plan: InterStagePlan,
        strategies: Sequence[Strategy],
        compute_performance: Sequence[float],
        memory_capacity: Sequence[float],
    ) -> PartitionResult:
        # the internal ProfileMissError path returns a normal infeasible
        # result, so it caches like any other answer.  Strategy is frozen
        # (hashable, all-field equality), so the tuple itself keys the memo
        # with the same semantics as an explicit per-axis key at a fraction
        # of the construction cost.
        key = (plan.node_sequence, plan.device_groups,
               plan.gbs // plan.batches, tuple(strategies),
               tuple(compute_performance), tuple(memory_capacity))
        cached = self._part_cache.get(key)
        if cached is not None:
            self._count("memo.layer_part.hit")
            return cached
        self._count("memo.layer_part.miss")
        out = self._partition_uncached(
            plan, strategies, compute_performance, memory_capacity)
        if len(self._part_cache) > _MEMO_MAX:
            self._part_cache.clear()
            self._count("memo.layer_part.evict")
        self._part_cache[key] = out
        return out

    def _partition_uncached(
        self,
        plan: InterStagePlan,
        strategies: Sequence[Strategy],
        compute_performance: Sequence[float],
        memory_capacity: Sequence[float],
    ) -> PartitionResult:
        ranks, stage_types, homos = self._stage_structure(plan)

        # Resolve each stage's memory-profile set once, collapsed to a single
        # combined prefix array: demand(s, i, j) is one subtraction, and the
        # whole feasibility mask for the DP is a numpy broadcast.  A miss on
        # any stage makes the whole candidate infeasible (the uncached walk
        # raised out of the stack build at the same stage).
        S = plan.num_stages
        g2 = plan.gbs // plan.batches
        stage_prefix = np.empty((S, self._wprefix.shape[0]))  # [S, L+1]
        compat = self.config.strict_compat
        pc = self._prefix_cache
        counters = self._counters
        for s in range(S):
            strat = strategies[s]
            st = stage_types[s]
            # Memo keys name what _stage_memory_rows actually reads — device
            # types, the strategy's memory axes, and the per-replica batch —
            # so distinct placements sharing a stage shape share the array.
            # "m"/compat keys carry all ranks: strict mode splits over the
            # full cluster device list, not just this stage's slice.
            if homos[s]:
                mem_type = ranks[0] if compat else st[0]
                if not compat and (strat.cp > 1 or strat.ep > 1
                                   or strat.zero > 0
                                   or (strat.sp and strat.tp > 1)):
                    key = ("s", mem_type, g2 // strat.dp, strat.dp, strat.tp,
                           strat.cp, strat.ep, strat.zero, strat.sp)
                else:
                    key = ("h", mem_type, strat.tp, g2 // strat.dp)
            elif compat:
                key = ("m", ranks, st, strat.dp, strat.tp, g2)
            else:
                key = ("m", None, st, strat.dp, strat.tp, g2)
            pref = pc.get(key)
            if pref is None:
                pref = self._build_prefix(key, plan, strat, st, ranks)
            elif counters is not None:
                counters.inc("memo.layer_prefix.hit")
            if pref is _MISS:
                return PartitionResult(None, -1, None)
            stage_prefix[s] = pref

        coef = self.config.mem_coef
        sgrid = np.arange(plan.num_stages)

        def stage_demands(bounds: Sequence[int]) -> np.ndarray:
            lo = stage_prefix[sgrid, bounds[:-1]]
            hi = stage_prefix[sgrid, bounds[1:]]
            return 0.001 + coef * (hi - lo)

        cap = np.asarray(memory_capacity, dtype=np.float64)
        use_native = native_available()

        # Pass 1: compute-optimal, ignore memory.
        if use_native:
            unconstrained = minmax_partition_native(
                self._wprefix, compute_performance)
        else:
            unconstrained = minmax_partition(
                self.layer_weights, compute_performance)
        if unconstrained is None:
            return PartitionResult(None, -1, None)
        state = tuple((cap - stage_demands(np.asarray(unconstrained))).tolist())
        if min(state) >= 0:
            return PartitionResult(unconstrained, 1, state)

        # Pass 2: memory-constrained DP (replaces the reference's iterative
        # capacity-reweighting repair, load_balancer.py:71-107).
        if use_native:
            constrained = minmax_partition_native(
                self._wprefix, compute_performance, stage_prefix, cap,
                coef=coef)
        else:
            # demand D[s, i, j] = 0.001 + coef * (prefix[s, j] - prefix[s, i])
            demand_mat = 0.001 + coef * (
                stage_prefix[:, None, :] - stage_prefix[:, :, None])
            constrained = minmax_partition(
                self.layer_weights, compute_performance,
                demand_mat <= cap[:, None, None])
        if constrained is None:
            return PartitionResult(None, -1, state)
        state = tuple((cap - stage_demands(np.asarray(constrained))).tolist())
        return PartitionResult(constrained, 2, state)
