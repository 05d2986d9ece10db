"""Plan types — the lingua franca between search, cost model, and execution.

The port's copy of ``metis_tpu/core/types.py``.

These are the leaf dataclasses every other layer imports, deliberately placed in
a dependency-free module (the reference resolves the same need with
TYPE_CHECKING-guarded cycles between ``search_space/plan.py:8-9`` and
``model/load_balancer.py:10-11``; we break the cycle structurally instead).

Reference parity: ``UniformPlan`` ≅ reference ``search_space/plan.py:12-18``,
``InterStagePlan`` ≅ ``plan.py:21-29``, ``IntraStagePlan`` ≅ ``plan.py:32-37``.
Extensions beyond the reference: a per-stage ``Strategy`` carries optional
sequence-parallel (``sp``) and expert-parallel (``ep``) degrees for the TPU
plan space (absent from the reference — SURVEY.md §2.2).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, asdict
from functools import lru_cache
from typing import Iterator, Sequence


@lru_cache(maxsize=8192)
def _group_prefix(groups: tuple) -> tuple:
    out = [0]
    for g in groups:
        out.append(out[-1] + g)
    return tuple(out)


@dataclass(frozen=True)
class Strategy:
    """Intra-stage parallelization of one pipeline stage.

    ``dp * tp * cp`` must equal the stage's device-group size.  ``sp`` is
    Megatron-style sequence parallelism riding the tp axis (degree shared with
    tp); ``cp`` is context parallelism (ring attention) over a dedicated mesh
    axis; ``ep`` is Megatron-style expert parallelism riding *inside* the data
    ranks — experts shard over ep-sized sub-groups of the dp*cp axis, so ep
    must divide dp and consumes no extra devices.  The reference plans only
    (dp, tp) tuples (``plan.py:34``).
    """

    dp: int
    tp: int
    sp: bool = False
    cp: int = 1
    ep: int = 1
    # ZeRO stage (0 = replicated state, 1 = sharded optimizer, 2 = +grads,
    # 3 = +params/FSDP); state shards over the dp*cp data ranks (cost/zero.py)
    zero: int = 0
    # context-parallel mode when cp > 1: "ring" (K/V rotation, ops/
    # ring_attention) or "a2a" (Ulysses all-to-all head re-shard,
    # ops/ulysses) — searched as separate families, priced by
    # cost/context_parallel.cp_comm_ms
    cp_mode: str = "ring"

    @property
    def devices(self) -> int:
        return self.dp * self.tp * self.cp

    @property
    def data_ranks(self) -> int:
        """Ranks holding a full data shard — the gradient-sync group and the
        ZeRO sharding degree."""
        return self.dp * self.cp

    def as_tuple(self) -> tuple[int, int]:
        return (self.dp, self.tp)


@dataclass(frozen=True)
class UniformPlan:
    """One homogeneous Megatron-style plan: dp×pp×tp grid + batch split."""

    dp: int
    pp: int
    tp: int
    mbs: int
    gbs: int

    @property
    def num_microbatches(self) -> int:
        return self.gbs // self.mbs // self.dp

    def valid_for(self, num_devices: int) -> bool:
        return (
            self.dp * self.pp * self.tp == num_devices
            and self.gbs % (self.mbs * self.dp) == 0
        )


@dataclass(frozen=True)
class InterStagePlan:
    """Pipeline-level plan: device placement order, per-stage group sizes,
    number of microbatches.

    ``node_sequence`` orders device *types* (placement: all devices of
    ``node_sequence[0]`` get the lowest ranks, and so on);
    ``device_groups[s]`` is the device count of pipeline stage ``s``;
    ``batches`` is the number of microbatches per step.
    """

    node_sequence: tuple[str, ...]
    device_groups: tuple[int, ...]
    batches: int
    gbs: int

    @property
    def num_stages(self) -> int:
        return len(self.device_groups)

    def stage_rank_range(self, stage_id: int) -> tuple[int, int]:
        # search-hot: called millions of times per search; prefix sums are
        # memoized on the (hashable) group tuple
        p = _group_prefix(self.device_groups)
        return p[stage_id], p[stage_id + 1]


@dataclass(frozen=True)
class IntraStagePlan:
    """Per-stage strategies + layer partition for a given InterStagePlan.

    ``layer_partition`` holds S+1 cumulative boundaries (``partition[s] ..
    partition[s+1]`` are stage s's layers).  ``num_repartition`` mirrors the
    reference's repair-attempt counter (``plan.py:37``): 1 means the
    compute-optimal partition was memory-feasible as-is; >1 means the memory
    repair path ran.

    ``schedule``/``virtual_stages`` record the pipeline schedule this plan
    was priced (and must be executed) with — a searched axis beyond the
    reference, which prices only the GPipe fill-drain
    (``cost_estimator.py:129``; see cost/schedule.py).
    """

    strategies: tuple[Strategy, ...]
    layer_partition: tuple[int, ...]
    memory_state: tuple[float, ...]
    num_repartition: int
    schedule: str = "gpipe"
    virtual_stages: int = 1


@dataclass(frozen=True)
class PlanCost:
    """Cost-model breakdown for one candidate (all milliseconds)."""

    total_ms: float
    execution_ms: float = 0.0
    fb_sync_ms: float = 0.0
    optimizer_ms: float = 0.0
    dp_comm_ms: float = 0.0
    pp_comm_ms: float = 0.0
    batch_gen_ms: float = 0.0
    cp_comm_ms: float = 0.0  # ring-attention K/V rotation (inside execution_ms)
    ep_comm_ms: float = 0.0  # MoE all-to-all dispatch/combine (inside execution_ms)
    # expected preemption-recovery charge (SearchConfig.use_spot_model):
    # step time x the plan's spot hazard x measured time-to-recover;
    # exactly 0.0 on reserved-only fleets or with the spot model off
    expected_recovery_ms: float = 0.0
    # amortized plan-switch charge (SearchConfig.use_migration_model): the
    # parameter bytes a candidate must reshard away from the incumbent
    # layout (``migrate_from``), spread over migration_amortize_steps;
    # exactly 0.0 for fresh searches or with the migration model off
    migration_ms: float = 0.0
    oom: bool = False


# Canonical additive component order for a CostBreakdown: every key the
# estimators emit, rendered in this order by ``metis-tpu explain``.
# ``pp_comm``/``dp_comm`` are the serial (fully exposed) pricing;
# ``pp_comm_exposed``/``dp_comm_exposed`` replace them when the overlap
# model is on (SearchConfig.use_overlap_model) — only the exposed share
# rides the additive total, the hidden remainder lives in
# ``CostBreakdown.hidden``.
COST_COMPONENTS = (
    "compute", "imbalance", "cp_comm", "ep_comm", "step_overhead",
    "pp_comm", "pp_comm_exposed", "dp_comm", "dp_comm_exposed",
    "fb_sync", "optimizer", "batch_gen", "expected_recovery", "migration",
)


@dataclass(frozen=True)
class CostBreakdown:
    """Per-component decomposition of one plan's ranked scalar (all ms).

    The explainability contract (PAPER.md §0 — Metis *is* its cost model):
    ``components`` is an ADDITIVE decomposition, ``sum(components.values())
    == total_ms`` up to float association, so a ranking can always be traced
    to the term that decided it.  ``compute`` is the schedule's execution
    time with every stage leveled at the mean (perfectly balanced, comm
    free); ``imbalance`` is what the actual stage skew adds on top;
    ``cp_comm``/``ep_comm`` are the in-schedule collective shares;
    ``step_overhead`` the fitted per-program fixed cost — together these
    four plus ``compute`` reconstitute ``PlanCost.execution_ms`` exactly.
    The remaining keys mirror their PlanCost fields.

    Per-stage vectors carry the priced per-microbatch stage times (as the
    schedule charged them — leveled for uneven 1f1b), the cp+ep comm share,
    the gradient-sync and optimizer candidates (the cost model takes the max
    over stages for those two).

    ``hidden`` (overlap model only) records the comm milliseconds the
    estimator priced as overlapped with compute — NOT part of the additive
    ``components`` sum; ``hidden["pp_comm"] + components["pp_comm_exposed"]``
    is the full serial pp send cost (likewise dp).

    ``component_variance`` (uncertainty layer only — cost/uncertainty.py)
    carries the residual variance (ms^2) of each component, so each entry
    of ``components`` reads as a (mean, variance) pair; empty — and
    omitted from JSON — in point-estimate mode, keeping pre-uncertainty
    dumps byte-identical.
    """

    total_ms: float
    components: dict[str, float]
    stage_execution_ms: tuple[float, ...] = ()
    stage_comm_ms: tuple[float, ...] = ()
    stage_dp_comm_ms: tuple[float, ...] = ()
    stage_optimizer_ms: tuple[float, ...] = ()
    schedule: str = "gpipe"
    hidden: dict[str, float] = field(default_factory=dict)
    component_variance: dict[str, float] = field(default_factory=dict)

    @property
    def component_sum_ms(self) -> float:
        return sum(self.components.values())

    def delta(self, other: "CostBreakdown") -> dict[str, float]:
        """Per-component ``other - self`` (positive = other costs more)."""
        keys = [k for k in COST_COMPONENTS
                if k in self.components or k in other.components]
        keys += [k for k in self.components if k not in keys]
        keys += [k for k in other.components if k not in keys]
        return {k: other.components.get(k, 0.0) - self.components.get(k, 0.0)
                for k in keys}

    def decisive_component(self, other: "CostBreakdown") -> tuple[str, float]:
        """The term that moved the ranking most: (name, other-minus-self ms)."""
        d = self.delta(other)
        name = max(d, key=lambda k: abs(d[k]))
        return name, d[name]

    def to_json_dict(self) -> dict:
        d = {
            "total_ms": self.total_ms,
            "components": dict(self.components),
            "stage_execution_ms": list(self.stage_execution_ms),
            "stage_comm_ms": list(self.stage_comm_ms),
            "stage_dp_comm_ms": list(self.stage_dp_comm_ms),
            "stage_optimizer_ms": list(self.stage_optimizer_ms),
            "schedule": self.schedule,
        }
        if self.hidden:
            d["hidden"] = dict(self.hidden)
        if self.component_variance:
            d["component_variance"] = dict(self.component_variance)
        return d

    @staticmethod
    def from_json_dict(d: dict) -> "CostBreakdown":
        return CostBreakdown(
            total_ms=d["total_ms"],
            components=dict(d["components"]),
            stage_execution_ms=tuple(d.get("stage_execution_ms", ())),
            stage_comm_ms=tuple(d.get("stage_comm_ms", ())),
            stage_dp_comm_ms=tuple(d.get("stage_dp_comm_ms", ())),
            stage_optimizer_ms=tuple(d.get("stage_optimizer_ms", ())),
            schedule=d.get("schedule", "gpipe"),
            hidden=dict(d.get("hidden", {})),
            component_variance=dict(d.get("component_variance", {})),
        )


# Canonical additive component order for an InferenceCostBreakdown
# (``metis-tpu explain --workload inference``).  The TTFT keys sum to
# ``ttft_p99_ms`` and the TPOT keys to ``tpot_p99_ms`` — same additive
# contract CostBreakdown pins for training plans.
TTFT_COMPONENTS = ("queueing", "prefill_compute", "prefill_pp_comm",
                   "kv_handoff")
TPOT_COMPONENTS = ("decode_compute", "kv_read", "decode_pp_comm")
INFERENCE_COST_COMPONENTS = TTFT_COMPONENTS + TPOT_COMPONENTS


@dataclass(frozen=True)
class InferenceCostBreakdown:
    """Per-component decomposition of one serving plan's SLO metrics.

    Unlike a training CostBreakdown there are TWO additive scalars:
    ``components[TTFT_COMPONENTS]`` sums to ``ttft_p99_ms`` (queue wait at
    the arrival rate + prefill pipeline latency + prefill boundary sends +
    prefill->decode KV handoff) and ``components[TPOT_COMPONENTS]`` sums to
    ``tpot_p99_ms`` (decode compute + the HBM-bound KV/weight-read excess +
    decode boundary sends).  ``throughput_rps`` is the max request rate the
    plan sustains with both p99 SLOs met; ``slo_ok`` says whether that
    covers the workload's offered arrival rate."""

    ttft_p99_ms: float
    tpot_p99_ms: float
    throughput_rps: float
    slo_ok: bool
    components: dict[str, float]
    max_concurrency: int = 0

    @property
    def ttft_component_sum_ms(self) -> float:
        return sum(self.components.get(k, 0.0) for k in TTFT_COMPONENTS)

    @property
    def tpot_component_sum_ms(self) -> float:
        return sum(self.components.get(k, 0.0) for k in TPOT_COMPONENTS)

    def delta(self, other: "InferenceCostBreakdown") -> dict[str, float]:
        """Per-component ``other - self`` (positive = other costs more)."""
        keys = [k for k in INFERENCE_COST_COMPONENTS
                if k in self.components or k in other.components]
        keys += [k for k in self.components if k not in keys]
        keys += [k for k in other.components if k not in keys]
        return {k: other.components.get(k, 0.0) - self.components.get(k, 0.0)
                for k in keys}

    def decisive_component(self, other: "InferenceCostBreakdown") -> tuple[str, float]:
        d = self.delta(other)
        name = max(d, key=lambda k: abs(d[k]))
        return name, d[name]

    def to_json_dict(self) -> dict:
        return {
            "ttft_p99_ms": self.ttft_p99_ms,
            "tpot_p99_ms": self.tpot_p99_ms,
            "throughput_rps": self.throughput_rps,
            "slo_ok": self.slo_ok,
            "components": dict(self.components),
            "max_concurrency": self.max_concurrency,
        }

    @staticmethod
    def from_json_dict(d: dict) -> "InferenceCostBreakdown":
        return InferenceCostBreakdown(
            ttft_p99_ms=d["ttft_p99_ms"],
            tpot_p99_ms=d["tpot_p99_ms"],
            throughput_rps=d["throughput_rps"],
            slo_ok=bool(d["slo_ok"]),
            components=dict(d["components"]),
            max_concurrency=int(d.get("max_concurrency", 0)),
        )


@dataclass(frozen=True)
class RankedPlan:
    """One fully-specified, costed candidate — the planner's output unit.

    ``breakdown`` is attached post-ranking to the top-k plans only (the
    search hot path never pays for it); None elsewhere."""

    inter: InterStagePlan
    intra: IntraStagePlan
    cost: PlanCost
    breakdown: CostBreakdown | None = None

    def to_json_dict(self) -> dict:
        cb = asdict(self.cost)
        # keep reserved-only dumps byte-identical to the pre-spot-model
        # goldens: the field only appears when the charge is real (same
        # omission contract as CostBreakdown's empty ``hidden``)
        if cb.get("expected_recovery_ms") == 0.0:
            del cb["expected_recovery_ms"]
        if cb.get("migration_ms") == 0.0:
            del cb["migration_ms"]
        d = {
            "cost_ms": self.cost.total_ms,
            "cost_breakdown": cb,
            "node_sequence": list(self.inter.node_sequence),
            "device_groups": list(self.inter.device_groups),
            "num_stages": self.inter.num_stages,
            "batches": self.inter.batches,
            "gbs": self.inter.gbs,
            "strategies": [asdict(s) for s in self.intra.strategies],
            "layer_partition": list(self.intra.layer_partition),
            "num_repartition": self.intra.num_repartition,
            "schedule": self.intra.schedule,
            "virtual_stages": self.intra.virtual_stages,
        }
        if self.breakdown is not None:
            d["breakdown"] = self.breakdown.to_json_dict()
        return d


@dataclass(frozen=True)
class Certificate:
    """Optimality certificate of one exact (branch-and-bound) search.

    ``lower_bound_ms`` is a PROVEN lower bound on every candidate in the
    searched space (the same inter x intra space the beam backend walks,
    under the same cost model and config); ``best_ms`` is the incumbent's
    cost, so ``gap_frac = (best - bound) / best`` bounds how far the
    returned plan can be from the true optimum.  ``complete`` means the
    branch-and-bound ran to exhaustion (every node expanded or provably
    bounded) — then the bound equals the best cost and the gap is 0.0;
    a deadline stop (``SearchConfig.exact_deadline_s``) keeps the
    incumbent and certifies the remaining gap instead.

    ``confidence_p`` (uncertainty layer, cost/uncertainty.py) upgrades
    the point certificate to "optimal at confidence p": the probability
    the incumbent is truly best given the ledger-fit residual variance.
    None — and omitted from JSON — in point mode (no residual model),
    keeping pre-uncertainty certificates byte-identical."""

    best_ms: float
    lower_bound_ms: float
    gap_frac: float
    nodes_explored: int
    nodes_bounded: int
    wall_s: float
    complete: bool = True
    confidence_p: float | None = None

    def to_json_dict(self) -> dict:
        d = {
            "best_ms": self.best_ms,
            "lower_bound_ms": self.lower_bound_ms,
            "gap_frac": self.gap_frac,
            "nodes_explored": self.nodes_explored,
            "nodes_bounded": self.nodes_bounded,
            "wall_s": self.wall_s,
            "complete": self.complete,
        }
        if self.confidence_p is not None:
            d["confidence_p"] = self.confidence_p
        return d

    @staticmethod
    def from_json_dict(d: dict) -> "Certificate":
        return Certificate(
            best_ms=d["best_ms"],
            lower_bound_ms=d["lower_bound_ms"],
            gap_frac=d["gap_frac"],
            nodes_explored=int(d["nodes_explored"]),
            nodes_bounded=int(d["nodes_bounded"]),
            wall_s=d["wall_s"],
            complete=bool(d.get("complete", True)),
            confidence_p=d.get("confidence_p"),
        )


def dump_ranked_plans(plans: Sequence[RankedPlan], limit: int | None = None) -> str:
    """Serialize a ranked plan list to JSON (the machine-readable analogue of
    the reference's stdout ranking, ``cost_het_cluster.py:73-77``)."""
    out = [p.to_json_dict() for p in (plans if limit is None else plans[:limit])]
    for rank, d in enumerate(out, start=1):
        d["rank"] = rank
    return json.dumps(out, indent=2)


@lru_cache(maxsize=8192)
def _divisors_ascending(n: int) -> tuple[int, ...]:
    # search-hot: the enumeration loop asks for the same gbs's divisors once
    # per stage count per search; trial division to n is O(n) per call —
    # factor-pair walk to sqrt(n) plus the cache makes repeats free
    small: list[int] = []
    large: list[int] = []
    i = 1
    while i * i <= n:
        if n % i == 0:
            small.append(i)
            if i * i != n:
                large.append(n // i)
        i += 1
    return tuple(small + large[::-1])


def divisors(n: int, descending: bool = False) -> Iterator[int]:
    """All divisors of n (ascending by default)."""
    ds = _divisors_ascending(n)
    return iter(reversed(ds)) if descending else iter(ds)
