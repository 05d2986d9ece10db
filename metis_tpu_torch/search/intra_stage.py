"""Intra-stage strategy search: per-stage (dp, tp) under memory pressure.

The port's copy of ``metis_tpu/search/intra_stage.py``.

The reference's most intricate control flow (``search_space/plan.py:178-268``,
SURVEY.md §3.3): start every stage fully data-parallel, and when the layer
balancer reports memory pressure, convert the most-pressured stage's dp to tp
(halve dp, double tp) and retry.  Search and feasibility-repair interleave —
escalation order keys on the per-stage memory headroom from the previous
(possibly failed) partition attempt.

Policy parity notes (each mirrors a reference behavior):
- a strategy set is valid iff every stage's microbatch is >= 1, within the
  profiled batch range, and tp within the profiled tp range (``plan.py:238-249``);
- after a partition that succeeded on the first attempt (num_repartition == 1)
  the search stops — good enough, no need to trade dp for tp (``plan.py:193-194``);
- a successful-but-repaired partition (num_repartition > 1) keeps escalating
  in search of a strategy that doesn't need repair (``plan.py:192-226``);
- with no memory feedback yet, stages escalate largest-dp-first
  (default pressure 1/dp, ``plan.py:255``).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from itertools import product
from typing import Iterator, Protocol, Sequence

from metis_tpu_torch.core.types import InterStagePlan, IntraStagePlan, Strategy


@dataclass(frozen=True)
class PartitionResult:
    """Outcome of one layer-partition attempt."""

    partition: tuple[int, ...] | None  # None => infeasible
    attempts: int                      # 1 = feasible without repair
    memory_state: tuple[float, ...] | None  # per-stage capacity - demand (MB)


class StageEvaluator(Protocol):
    """Per-stage memory capacity and normalized compute performance
    (implemented by metis_tpu_torch.balance.StagePerformanceModel)."""

    def memory_capacity(self, plan: InterStagePlan) -> list[float]: ...

    def compute_performance(
        self, plan: InterStagePlan, strategies: Sequence[Strategy]
    ) -> list[float]: ...


class LayerPartitioner(Protocol):
    """Layer->stage partitioning with memory repair
    (implemented by metis_tpu_torch.balance.LayerBalancer)."""

    def partition(
        self,
        plan: InterStagePlan,
        strategies: Sequence[Strategy],
        compute_performance: Sequence[float],
        memory_capacity: Sequence[float],
    ) -> PartitionResult: ...


def initial_strategies(
    plan: InterStagePlan,
    cp: int = 1,
    cp_eligible: Sequence[bool] | None = None,
    ep: int = 1,
    zero: int = 0,
    sp: bool = False,
    cp_mode: str = "ring",
) -> tuple[Strategy, ...] | None:
    """Every stage starts fully data-parallel (``plan.py:231-236``).

    With ``cp > 1`` each eligible stage dedicates a cp-sized sub-axis to ring
    attention (dp = group/cp, tp = 1); ineligible stages (heterogeneous device
    mix — ring attention needs uniform block timing) stay cp=1.  With
    ``ep > 1`` each stage whose dp divides evenly shards experts over ep-sized
    sub-groups of its data ranks (Strategy docstring: ep rides inside dp).
    Returns None when no stage can actually take the requested axis
    (degenerate family — identical to a lower-degree search).
    """
    # search-hot: the result depends only on the group sizes + axis degrees,
    # which repeat across the thousands of inter-stage plans sharing a
    # device-group composition — memoize on exactly those
    return _initial_strategies(
        plan.device_groups, cp,
        None if cp_eligible is None else tuple(cp_eligible), ep, zero, sp,
        cp_mode)


@lru_cache(maxsize=65536)
def _initial_strategies(
    device_groups: tuple[int, ...],
    cp: int,
    cp_eligible: tuple[bool, ...] | None,
    ep: int,
    zero: int,
    sp: bool,
    cp_mode: str = "ring",
) -> tuple[Strategy, ...] | None:
    out = []
    any_cp, any_ep, any_zero = False, False, False
    for stage_id, g in enumerate(device_groups):
        eligible = cp_eligible is None or cp_eligible[stage_id]
        stage_cp = cp if (cp > 1 and eligible and g % cp == 0) else 1
        any_cp |= stage_cp > 1
        dp = g // stage_cp
        stage_ep = ep if (ep > 1 and dp % ep == 0) else 1
        any_ep |= stage_ep > 1
        # ZeRO needs >1 data rank to shard over
        stage_zero = zero if dp * stage_cp > 1 else 0
        any_zero |= stage_zero > 0
        out.append(Strategy(dp=dp, tp=1, sp=sp, cp=stage_cp, ep=stage_ep,
                            zero=stage_zero,
                            cp_mode=cp_mode if stage_cp > 1 else "ring"))
    if cp > 1 and not any_cp:
        return None
    if ep > 1 and not any_ep:
        return None
    if zero > 0 and not any_zero:
        return None
    return tuple(out)


VALID, RETRY, DOOMED = "valid", "retry", "doomed"


class SchedulePartitioner(Protocol):
    """Even-split + schedule-aware memory feasibility
    (implemented by metis_tpu_torch.balance.LayerBalancer.schedule_partition)."""

    def schedule_partition(
        self,
        plan: InterStagePlan,
        strategies: Sequence[Strategy],
        memory_capacity: Sequence[float],
        schedule: str,
        virtual_stages: int,
    ) -> PartitionResult: ...


def schedule_intra_plans(
    plan: InterStagePlan,
    evaluator: StageEvaluator,
    partitioner: SchedulePartitioner,
    max_tp: int,
    max_bs: int,
    schedule: str,
    virtual_stages: int = 1,
    num_blocks: int | None = None,
    types_uniform: bool = True,
) -> Iterator[IntraStagePlan]:
    """Yield intra plans for one pipeline-SCHEDULE family (1f1b /
    interleaved) of an inter-stage candidate — a searched axis beyond the
    reference's GPipe-only pricing (cost/schedule.py).

    These schedules run on the shard_map pipeline executor
    (``execution/builder.py``), which demands a rectangular plan: equal
    device groups, ONE strategy shape, the canonical even block split, and
    a single device type (SPMD lockstep — mixed chip speeds would idle the
    faster type every tick, and the mesh admits no per-stage profiles).
    Escalation is therefore uniform: all stages trade dp for tp together.
    Memory feasibility uses the schedule's true activation peak
    (``LayerBalancer.schedule_partition``) — the whole point of the 1f1b
    family is admitting memory-tight plans the gpipe footprint rejects.
    """
    from metis_tpu_torch.cost.schedule import schedule_valid

    if len(set(plan.device_groups)) != 1 or not types_uniform:
        return
    if not schedule_valid(schedule, plan.num_stages, plan.batches,
                          virtual_stages, num_blocks):
        return
    group = plan.device_groups[0]
    strategies: tuple[Strategy, ...] | None = tuple(
        Strategy(dp=group, tp=1) for _ in plan.device_groups)
    capacity: list[float] | None = None
    while strategies is not None:
        verdict = classify_strategies(plan, strategies, max_tp, max_bs)
        if verdict is DOOMED:
            break
        if verdict is VALID:
            if capacity is None:
                capacity = evaluator.memory_capacity(plan)
            result = partitioner.schedule_partition(
                plan, strategies, capacity, schedule, virtual_stages)
            if result.partition is not None:
                yield IntraStagePlan(
                    strategies=strategies,
                    layer_partition=result.partition,
                    memory_state=result.memory_state or (),
                    num_repartition=result.attempts,
                    schedule=schedule,
                    virtual_stages=virtual_stages,
                )
                break  # feasible at this dp — higher tp never cheaper here
        s0 = strategies[0]
        strategies = (
            tuple(Strategy(dp=s0.dp // 2, tp=s0.tp * 2) for _ in strategies)
            if s0.dp > 1 else None)


def classify_strategies(
    plan: InterStagePlan,
    strategies: Sequence[Strategy],
    max_tp: int,
    max_bs: int,
    num_heads: int | None = None,
) -> str:
    """One scan, three outcomes for the search-hot escalation loop:

    - ``VALID`` — every stage's microbatch is in [1, max_bs] and tp within
      the profiled range (the reference validity rule, ``plan.py:238-249``);
    - ``DOOMED`` — NO amount of further dp->tp escalation can reach
      validity, so the family can stop early (observably identical to
      escalating to exhaustion — the reference loop grinds on regardless,
      ``plan.py:192-226``, but yields nothing on the way).  Escalation only
      shrinks a stage's dp (growing its microbatch) and only grows its tp,
      so a stage whose mbs already exceeds ``max_bs`` or whose tp exceeds
      ``max_tp`` is unrecoverable.  With ``num_heads`` given (callers pass
      the binding head count — for GQA the gcd of Q and KV heads, since the
      a2a split must divide both), an a2a cp stage whose heads don't split
      evenly over ``tp * cp`` is also doom: both factors are powers of two,
      so once ``2^k`` stops dividing the head count no further doubling
      recovers — and the a2a cost/execution path assumes even head splits
      (no padding term, ``ops/ulysses.py``);
    - ``RETRY`` — invalid but recoverable (some stage's mbs == 0: halving
      its dp grows the microbatch).
    """
    verdict = VALID
    for s in strategies:
        mbs = plan.gbs // s.dp // plan.batches
        if mbs > max_bs or s.tp > max_tp:
            return DOOMED
        if (num_heads is not None and s.cp > 1 and s.cp_mode == "a2a"
                and num_heads % (s.tp * s.cp) != 0):
            return DOOMED
        if mbs == 0:
            verdict = RETRY
    return verdict


def strategies_valid(
    plan: InterStagePlan,
    strategies: Sequence[Strategy],
    max_tp: int,
    max_bs: int,
) -> bool:
    return classify_strategies(plan, strategies, max_tp, max_bs) == VALID


def escalate_dp_to_tp(
    strategies: Sequence[Strategy],
    memory_state: Sequence[float] | None,
) -> tuple[Strategy, ...] | None:
    """Halve dp / double tp on the most memory-pressured stage that still has
    dp to give.  Returns None when no stage can escalate (search exhausted)."""
    # search-hot (~1M calls/search): the full pressure ordering is only used
    # to take the FIRST escalatable stage, so an O(n) stable argmin over the
    # escalatable stages replaces the sort (+ its list allocations).
    # Truthiness (not `is not None`): an empty memory_state means "no per-stage
    # feedback", same as None — matches the reference guard (plan.py:252-255).
    best_id, best_p = -1, None
    for stage_id, s in enumerate(strategies):
        # ep must keep dividing dp after the halving (ep rides inside dp)
        if s.dp == 1 or (s.ep > 1 and (s.dp // 2) % s.ep != 0):
            continue
        p = memory_state[stage_id] if memory_state else 1.0 / s.dp
        if best_p is None or p < best_p:  # strict <: stable ties by index
            best_id, best_p = stage_id, p
    if best_id < 0:
        return None
    out = list(strategies)
    s = out[best_id]
    # zero degenerates to 0 when no data ranks remain to shard over
    new_zero = s.zero if (s.dp // 2) * s.cp > 1 else 0
    out[best_id] = Strategy(dp=s.dp // 2, tp=s.tp * 2, sp=s.sp,
                            cp=s.cp, ep=s.ep, zero=new_zero,
                            cp_mode=s.cp_mode)
    return tuple(out)


# Escalation-prefix memo for the base (cp=1, ep=1, zero=0, sp=False) family:
# until the first non-RETRY verdict no partition has run, so memory_state is
# None and the walk — classify, escalate on 1/dp pressure, repeat — is a pure
# function of (device_groups, gbs, batches, max_tp, max_bs).  Thousands of
# inter plans share the same few compositions, so the leading RETRY
# iterations (mbs == 0 shapes) collapse to one dict hit.  The cached tuple
# is exactly what the uncached walk would hold when it first leaves RETRY
# (or None if it exhausts first), so downstream behavior is identical.
_BASE_WALK_MEMO: dict[tuple, tuple[Strategy, ...] | None] = {}
_BASE_WALK_MAX = 200_000


def intra_stage_plans(
    plan: InterStagePlan,
    evaluator: StageEvaluator,
    partitioner: LayerPartitioner,
    max_tp: int,
    max_bs: int,
    cp_degrees: Sequence[int] = (1,),
    cp_eligible: Sequence[bool] | None = None,
    ep_degrees: Sequence[int] = (1,),
    zero_stages: Sequence[int] = (0,),
    sp_variants: Sequence[bool] = (False,),
    cp_modes: Sequence[str] = ("ring",),
    num_heads: int | None = None,
) -> Iterator[IntraStagePlan]:
    """Yield feasible intra-stage plans for one inter-stage candidate.

    ``cp_degrees`` x ``ep_degrees`` x ``zero_stages`` x ``sp_variants``
    extend the reference's (dp, tp) space with context-parallel,
    expert-parallel, ZeRO, and sequence-parallel families (net-new,
    SURVEY.md §5): for each combination the same escalation runs with the
    extra axes carved out of every eligible stage.  The cost estimator ranks
    the families against each other.  sp is a no-op at tp=1, so the sp=True
    family suppresses tp=1 yields (duplicates of the sp=False family) and
    keeps escalating toward tp>1 shapes where sp actually pays.
    """
    capacity: list[float] | None = None  # strategy-independent; resolve once
    for cp, ep, zero, sp, cp_mode in product(cp_degrees, ep_degrees,
                                             zero_stages, sp_variants,
                                             cp_modes):
        if cp == 1 and cp_mode != "ring":
            continue  # mode is meaningless without a cp axis; skip duplicates
        strategies = initial_strategies(plan, cp, cp_eligible, ep, zero, sp,
                                        cp_mode)
        memory_state: tuple[float, ...] | None = None
        if cp == 1 and ep == 1 and zero == 0 and not sp:
            # fast-forward the deterministic RETRY prefix (see _BASE_WALK_MEMO;
            # cp_eligible and num_heads are no-ops at cp == 1)
            wkey = (plan.device_groups, plan.gbs, plan.batches, max_tp, max_bs)
            walked = _BASE_WALK_MEMO.get(wkey, _BASE_WALK_MEMO)
            if walked is _BASE_WALK_MEMO:
                walked = strategies
                while walked is not None and classify_strategies(
                        plan, walked, max_tp, max_bs) is RETRY:
                    walked = escalate_dp_to_tp(walked, None)
                if len(_BASE_WALK_MEMO) > _BASE_WALK_MAX:
                    _BASE_WALK_MEMO.clear()
                _BASE_WALK_MEMO[wkey] = walked
            strategies = walked

        while strategies is not None:
            verdict = classify_strategies(plan, strategies, max_tp, max_bs,
                                          num_heads)
            if verdict is DOOMED:
                break
            if verdict is VALID:
                if capacity is None:
                    capacity = evaluator.memory_capacity(plan)
                performance = evaluator.compute_performance(plan, strategies)
                result = partitioner.partition(plan, strategies, performance, capacity)
                memory_state = result.memory_state
                degenerate_sp = sp and all(s.tp == 1 for s in strategies)
                if result.partition is not None and not degenerate_sp:
                    yield IntraStagePlan(
                        strategies=strategies,
                        layer_partition=result.partition,
                        memory_state=result.memory_state or (),
                        num_repartition=result.attempts,
                    )
                    if result.attempts == 1:
                        break  # this family is satisfied; next
            strategies = escalate_dp_to_tp(strategies, memory_state)
