"""Search-scalability pruning: exact lower bounds + anytime beam.

The port's copy of ``metis_tpu/search/prune.py``.

Enumeration at 256 devices with small-group
variance grows to tens of millions of (placement x groups x batches)
candidates; costing each takes minutes-to-hours.  Four prunes, layered:

1. **Doom fast-path (always on, exact).**  A stage's microbatch size only
   GROWS under dp->tp escalation (``mbs = gbs/(dp*B)``, dp only halves), so
   an inter plan whose smallest group already forces ``mbs > max_bs`` at
   full dp can never produce a valid strategy — the intra generator would
   classify every escalation DOOMED.  One integer compare replaces that
   whole walk; observably identical output.

2. **Execution lower bound vs the running top-K (exact given monotone
   profiles, opt-in via ``SearchConfig.prune_to_top_k``).**  Any plan's
   cost >= its GPipe execution term >= ``(B-1)*max_lens + sum_lens``, and
   every partition processes all L layers exactly once, so
   ``sum_lens >= W_min`` (the fastest possible one-microbatch full-model
   time) and ``max_lens >= W_min/S``.  Candidates whose bound already
   exceeds the K-th best cost seen cannot enter the top K and are skipped.
   Exactness assumption: per-layer profile times are non-decreasing in
   batch size (``W_min`` is taken at the smallest profiled bs) — true of
   real measurements and the synthesizer; the returned TOP-K ranking then
   matches exhaustive search, only the tail beyond K is dropped.

3. **Tightened relaxation bound (default on via
   ``SearchConfig.tight_bound``, exact).**  After the stock bound (2)
   passes, the pruner consults the exact backend's admissible
   ``RelaxationBound`` (search/exact.py) — the execution floor plus
   step-overhead / fb-sync / optimizer floors and the mbs-feasibility
   cap — through the ``bound_fn`` hook.  Admissibility gives the same
   top-K guarantee as (2) while skipping strictly more classes
   (``prune.bound.tight`` counter); disabled under ``strict_compat``
   like the stock bound.

4. **Beam patience (opt-in via ``SearchConfig.beam_patience``, INEXACT).**
   Each (node_sequence, stage_count) class stops after N consecutive
   candidates that failed to enter the running top K — an anytime beam
   for scales where even the bounded walk is too slow.  Patience is
   keyed on the RAW (node_sequence, stage_count) pair even under
   symmetry collapse, so collapsed and uncollapsed searches stay
   byte-identical.
"""
from __future__ import annotations

import heapq
from typing import Iterator, Sequence

from metis_tpu_torch.cluster.spec import ClusterSpec
from metis_tpu_torch.core.config import ModelSpec, SearchConfig
from metis_tpu_torch.profiles.store import ProfileStore


def fastest_full_model_ms(
    profiles: ProfileStore,
    device_types: Sequence[str],
    max_tp: int,
    cp_divisor: int = 1,
) -> float:
    """``W_min``: lower bound on one microbatch's full-model fwd+bwd time —
    per layer, the fastest profiled (type, tp) at the smallest profiled
    batch, divided by the largest context-parallel degree in the search."""
    per_layer: list[float] | None = None
    for t in device_types:
        by_tp: dict[int, int] = {}
        for (_, tp, bs) in profiles.configs(t):
            if tp <= max_tp:
                by_tp[tp] = min(by_tp.get(tp, bs), bs)
        for tp, bs in by_tp.items():
            times = profiles.get(t, tp, bs).layer_times_ms
            if per_layer is None:
                per_layer = list(times)
            else:
                per_layer = [min(a, b) for a, b in zip(per_layer, times)]
    if per_layer is None:
        return 0.0
    return sum(per_layer) / max(cp_divisor, 1)


def fastest_full_model_by_bs(
    profiles: ProfileStore,
    device_types: Sequence[str],
    max_tp: int,
    cp_divisor: int = 1,
) -> dict[int, float]:
    """``W[bs]`` per profiled batch size: the fastest one-microbatch
    full-model time when every stage's microbatch is >= ``bs`` — a much
    tighter execution bound than W[1] for plans whose group sizes force
    large microbatches."""
    by_bs: dict[int, list[float]] = {}
    for t in device_types:
        for (_, tp, bs) in profiles.configs(t):
            if tp > max_tp:
                continue
            times = profiles.get(t, tp, bs).layer_times_ms
            cur = by_bs.get(bs)
            if cur is None:
                by_bs[bs] = list(times)
            else:
                by_bs[bs] = [min(a, b) for a, b in zip(cur, times)]
    return {bs: sum(v) / max(cp_divisor, 1) for bs, v in by_bs.items()}


class ExecutionFloor:
    """W tables + the all-schedules execution lower bound, factored out of
    ``SearchPruner`` so the exact backend's relaxation bound
    (search/exact.RelaxationBound) provably shares the same floor
    arithmetic — bound math and prune math can never drift.

    ``profiles`` decides which view the tables read: SearchPruner passes
    the raw store it was built with (its historical behavior);
    RelaxationBound passes the estimator's post-affine view so the floor
    matches what candidates are actually priced with."""

    def __init__(self, config: SearchConfig, cluster: ClusterSpec,
                 profiles: ProfileStore, model: ModelSpec):
        self.gbs = config.gbs
        # schedule search admits interleaved plans whose execution can
        # undercut the gpipe fill-drain — the bound must floor at the
        # interleaved schedule's own minimum or it would prune true top-K
        # members (cost/schedule.py)
        self._schedule_search = (config.enable_schedule_search
                                 and not config.strict_compat
                                 and model.num_experts == 0)
        from metis_tpu_torch.cost.schedule import REMAT_FWD_FRACTION

        # the interleaved-floor bound must use the SAME remat fraction the
        # estimator prices with, or a calibrated r < 1/3 would let true
        # top-K members be pruned
        self._remat = (config.remat_fwd_fraction
                       if config.remat_fwd_fraction is not None
                       else REMAT_FWD_FRACTION)
        cp_div = (config.max_cp_degree
                  if (config.enable_cp and not config.strict_compat
                      and model.num_experts == 0) else 1)
        self.w_min = fastest_full_model_ms(
            profiles, cluster.device_types, config.max_profiled_tp, cp_div)
        self._w_by_bs = fastest_full_model_by_bs(
            profiles, cluster.device_types, config.max_profiled_tp, cp_div)
        self._w_bs_sorted = sorted(self._w_by_bs)

    def w_at(self, mbs: int) -> float:
        """W at the largest profiled bs <= mbs (monotone-time assumption).

        Below the sweep, W[smallest] would be an OVER-estimate (time is
        increasing in bs) and could prune true top-K members; scale it by
        mbs/smallest instead — per-sample time only grows as bs shrinks
        (fixed per-launch overhead), so time(mbs) >= time(smallest) *
        mbs/smallest is a genuine lower bound and the exactness guarantee
        of prune_to_top_k holds even when the sweep starts above bs=1."""
        import bisect

        if not self._w_bs_sorted:
            return self.w_min
        smallest = self._w_bs_sorted[0]
        if mbs < smallest:
            return self._w_by_bs[smallest] * (mbs / smallest)
        i = bisect.bisect_right(self._w_bs_sorted, mbs) - 1
        return self._w_by_bs[self._w_bs_sorted[i]]

    def bound(self, g_max: int, num_stages: int, batches: int) -> float:
        """Execution >= (B-1)*max_lens + sum_lens; every stage's microbatch
        is >= gbs/(group*B) (dp only shrinks under escalation), so the
        full-model pass costs >= W[mbs_floor] where mbs_floor comes from
        the LARGEST group (smallest per-stage microbatch).

        With schedule search on, the interleaved schedule's execution
        (``schedule_execution_ms``) can undercut the gpipe fill-drain —
        its own floor is ``exec > (1+r) * B * max_lens`` (ticks exceed
        vs*S per group, each >= max_lens/vs), so the all-schedules bound
        is the minimum of the two."""
        mbs_floor = max(1, (self.gbs // g_max) // batches)
        # w_at covers every case: w_min when the by-bs table is empty,
        # the scaled-down bound below the sweep, the table lookup above it
        # (w_min <= W[bs] for all bs, so a separate max() floor is dead).
        w = self.w_at(mbs_floor)
        gpipe_lb = (batches - 1) * w / num_stages + w
        if not self._schedule_search:
            return gpipe_lb
        interleaved_floor = (
            (1 + self._remat) * batches * w / num_stages)
        return min(gpipe_lb, interleaved_floor)


class SearchPruner:
    """Running top-K tracker + the candidate filters.

    ``admit(inter)`` is called per inter-stage candidate BEFORE the (much
    more expensive) intra expansion; ``record(total_ms)`` after each costed
    plan; ``composition_batches``/``class_dead`` let the pruned generator
    (``pruned_inter_stage_plans``) filter whole (composition, batches)
    classes before arrangements are even expanded.  The doom fast-path runs
    unconditionally; the bound and beam filters only when configured."""

    def __init__(self, config: SearchConfig, cluster: ClusterSpec,
                 profiles: ProfileStore, model: ModelSpec,
                 counters=None, bound_fn=None, scorer=None):
        # optional core.trace.Counters: prune-family accounting for the
        # flight recorder (``prune.doom``/``prune.bound``/``prune.beam``
        # mirror num_doomed/num_bounded/num_beamed; ``prune.bound.tight``
        # counts the bound_fn's extra catches within num_bounded); None =
        # tracing off, not even a dict add in the hot filters
        self._counters = counters
        # optional tighter admissible lower bound ``(g_max, num_stages,
        # batches) -> ms`` (search/exact.RelaxationBound): consulted AFTER
        # the stock execution bound passes, so it only ever prunes more.
        # Must be admissible — a true lower bound on every plan in the
        # (composition ceiling, stage count, batches) class — or the
        # prune_to_top_k exactness guarantee breaks.
        self._bound_fn = bound_fn
        # optional cost/uncertainty.RiskScorer: when set, ``record``
        # keeps the top-K heap in SCORE space (total * tail factor for
        # the candidate's device types) instead of point space.  Scores
        # are >= the point total by construction (factors clamped at
        # 1.0), so the point-cost lower bounds compared against the
        # score-space kth best prune strictly less than in point mode —
        # never wrongly.  None (the default) is byte-identical to the
        # pre-uncertainty pruner.
        self._scorer = scorer
        self.max_bs = config.max_profiled_bs
        self.gbs = config.gbs
        self.top_k = (config.prune_to_top_k
                      if not config.strict_compat else None)
        self.beam_patience = (config.beam_patience
                              if self.top_k is not None else None)
        self.num_doomed = 0
        self.num_bounded = 0
        self.num_beamed = 0
        self._heap: list[float] = []  # negated costs; [0] = -(kth best)
        self._patience: dict[tuple, int] = {}
        self._improved = False
        self._floor: ExecutionFloor | None = None
        self.w_min = 0.0
        if self.top_k is not None:
            self._floor = ExecutionFloor(config, cluster, profiles, model)
            self.w_min = self._floor.w_min

    def _w_at(self, mbs: int) -> float:
        return self._floor.w_at(mbs) if self._floor is not None else 0.0

    def _exec_lower_bound(self, g_max: int, num_stages: int,
                          batches: int) -> float:
        return self._floor.bound(g_max, num_stages, batches)

    def composition_batches(
        self, composition: Sequence[int], num_stages: int,
        batch_options: Sequence[int],
    ) -> list[int]:
        """Feasible microbatch counts for one (non-decreasing) composition:
        doom-filtered (exact), then bound-filtered against the running kth
        best.  Composition-level — shared by every arrangement and type
        permutation, so the filter runs once per composition, not once per
        candidate."""
        g_min, g_max = composition[0], composition[-1]
        kth = self._kth_best()
        out = []
        for batches in batch_options:
            if (self.gbs // g_min) // batches > self.max_bs:
                # doom: smallest-group stage over max_bs forever
                self.num_doomed += 1  # counts (composition, B) classes
                if self._counters is not None:
                    self._counters.inc("prune.doom")
                continue
            if self.top_k is not None and kth != float("inf"):
                if self._exec_lower_bound(
                        g_max, num_stages, batches) > kth:
                    self.num_bounded += 1  # counts (composition, B) classes
                    if self._counters is not None:
                        self._counters.inc("prune.bound")
                    continue
                if (self._bound_fn is not None
                        and self._bound_fn(
                            g_max, num_stages, batches) > kth):
                    self.num_bounded += 1
                    if self._counters is not None:
                        self._counters.inc("prune.bound.tight")
                    continue
            out.append(batches)
        return out

    def _class_key(self, node_sequence, num_stages: int) -> tuple:
        # keyed on the RAW sequence: symmetry replay drives record() with
        # bit-identical costs per permutation, so per-sequence budgets make
        # the collapsed beam walk byte-identical to the uncollapsed one.
        # (A canonicalized shared budget — tried first — kills classes
        # earlier under collapse and changes the ranking.)
        return (node_sequence, num_stages)

    def class_dead(self, node_sequence, num_stages: int) -> bool:
        """Beam: whether a (placement, stage-count) class exhausted its
        patience (checked inside the pruned generator so dead classes skip
        arrangement expansion entirely)."""
        if self.beam_patience is None:
            return False
        return (self._patience.get(
            self._class_key(node_sequence, num_stages), 0)
            > self.beam_patience)

    @property
    def active(self) -> bool:
        """Whether the opt-in (bound/beam) pruning is on — selects the
        composition-level generator in plan_hetero."""
        return self.top_k is not None

    def _kth_best(self) -> float:
        if self.top_k is None or len(self._heap) < self.top_k:
            return float("inf")
        return -self._heap[0]

    def admit(self, inter) -> bool:
        groups = inter.device_groups
        g_min, g_max = min(groups), max(groups)
        # 1. doom fast-path: smallest-group stage over max_bs at full dp
        #    stays over under every escalation (same floor-division
        #    arithmetic as classify_strategies — dp only shrinks, so this
        #    stage's mbs only grows)
        if (inter.gbs // g_min) // inter.batches > self.max_bs:
            self.num_doomed += 1
            if self._counters is not None:
                self._counters.inc("prune.doom")
            return False
        if self.top_k is None or self.w_min <= 0:
            return True
        # 2. execution lower bound vs the running kth best, then the
        #    optional tighter relaxation bound (only when the cheap stock
        #    bound failed to prune — it strictly adds catches)
        kth = self._kth_best()
        if kth != float("inf"):
            if self._exec_lower_bound(
                    g_max, inter.num_stages, inter.batches) > kth:
                self.num_bounded += 1
                if self._counters is not None:
                    self._counters.inc("prune.bound")
                return False
            if (self._bound_fn is not None
                    and self._bound_fn(
                        g_max, inter.num_stages, inter.batches) > kth):
                self.num_bounded += 1
                if self._counters is not None:
                    self._counters.inc("prune.bound.tight")
                return False
        # 3. anytime beam: stop a (placement, stage-count) class after
        #    beam_patience consecutive non-improving candidates
        if self.beam_patience is not None:
            key = self._class_key(inter.node_sequence, inter.num_stages)
            if self._patience.get(key, 0) > self.beam_patience:
                self.num_beamed += 1
                if self._counters is not None:
                    self._counters.inc("prune.beam")
                return False
        return True

    def begin_candidate(self) -> None:
        self._improved = False

    def record(self, total_ms: float, inter=None) -> None:
        if self.top_k is None:
            return
        if self._scorer is not None and inter is not None:
            total_ms = self._scorer.score(total_ms, inter.node_sequence)
        if len(self._heap) < self.top_k:
            heapq.heappush(self._heap, -total_ms)
            self._improved = True
        elif total_ms < -self._heap[0]:
            heapq.heapreplace(self._heap, -total_ms)
            self._improved = True

    def end_candidate(self, inter) -> None:
        if self.beam_patience is None:
            return
        key = self._class_key(inter.node_sequence, inter.num_stages)
        if self._improved:
            self._patience[key] = 0
        else:
            self._patience[key] = self._patience.get(key, 0) + 1

    @property
    def num_pruned(self) -> int:
        return self.num_doomed + self.num_bounded + self.num_beamed


def pruned_inter_stage_plans(
    device_types: Sequence[str],
    num_devices: int,
    gbs: int,
    num_layers: int,
    pruner: SearchPruner,
    variance: float = 1.0,
    max_permute_len: int = 6,
    counters=None,
) -> Iterator:
    """Inter-stage enumeration with COMPOSITION-level pruning — the flat
    walk (``inter_stage_plans``) materializes placement x arrangement x
    batches candidates before any filter can run (tens of millions at 256
    devices with small-group variance; iteration alone blows the budget).
    Here doom + bound filters run per (composition, batches) — shared by
    every arrangement and type permutation — and beam-dead classes skip
    arrangement expansion entirely.  Same candidate SET as the flat walk
    minus pruner-filtered entries; order differs (stage count outer,
    batches ascending), which is invisible behind the final cost sort."""
    from itertools import permutations as _perms

    from metis_tpu_torch.core.types import InterStagePlan, divisors
    from metis_tpu_torch.search.device_groups import arrangements_of_composition
    from metis_tpu_torch.search.inter_stage import stage_compositions

    batch_options = list(divisors(gbs))  # ascending: low-bubble plans first
    type_perms = list(_perms(sorted(set(device_types))))
    for num_stage, comp in stage_compositions(
            num_devices, num_layers, variance=variance):
        feasible = pruner.composition_batches(
            comp, num_stage, batch_options)
        if not feasible:
            continue
        arrangements = None  # expand lazily, reuse across type perms
        for node_sequence in type_perms:
            if pruner.class_dead(node_sequence, num_stage):
                continue
            if arrangements is None:
                arrangements = list(
                    arrangements_of_composition(comp, max_permute_len))
            for groups in arrangements:
                for batches in feasible:
                    if counters is not None:
                        counters.inc("inter_enumerated")
                    yield InterStagePlan(
                        node_sequence=node_sequence,
                        device_groups=groups,
                        batches=batches,
                        gbs=gbs,
                    )
