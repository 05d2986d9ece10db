"""Per-stage performance and memory-capacity evaluation.

The port's copy of ``metis_tpu/balance/stage_perf.py``.

≅ reference ``StagePerformance`` (``model/device_group.py:13-101``): maps an
inter-stage plan's node sequence to a rank->device-type placement, then scores
each stage's normalized compute throughput (1/exec-time, with hetero groups
split by the data balancer) and aggregate memory capacity.
"""
from __future__ import annotations

from typing import Sequence

from metis_tpu_torch.cluster.spec import ClusterSpec
from metis_tpu_torch.core.errors import KvCacheOomError, ProfileMissError
from metis_tpu_torch.core.types import InterStagePlan, Strategy
from metis_tpu_torch.profiles.store import ProfileStore
from metis_tpu_torch.balance.data import DataBalancer, power_of_two_chunks, replica_chunks


def rank_device_types(
    cluster: ClusterSpec, node_sequence: Sequence[str]
) -> tuple[str, ...]:
    """Device type of each rank under a node-sequence placement: all devices
    of ``node_sequence[0]`` take the lowest ranks, and so on
    (≅ ``device_group.py:22-32``).  Memoized per cluster — the planner
    resolves the same few node sequences millions of times in the hot loop;
    the cached value is an immutable tuple so no caller can poison it."""
    cache = cluster.__dict__.setdefault("_rank_types_cache", {})
    key = tuple(node_sequence)
    out = cache.get(key)
    if out is None:
        ranks: list[str] = []
        for device_type in node_sequence:
            ranks.extend(
                [device_type] * cluster.num_devices_by_type(device_type))
        out = tuple(ranks)
        cache[key] = out
    return out


def node_device_types(cluster: ClusterSpec, node_sequence: Sequence[str]) -> list[str]:
    """Device type of each *node* under the same placement
    (≅ ``cluster_bandwidth.py:158-167``)."""
    out: list[str] = []
    for device_type in node_sequence:
        n_nodes = sum(1 for n in cluster.nodes if n.device_type == device_type)
        out.extend([device_type] * n_nodes)
    return out


def max_kv_concurrency(
    capacity_mb: float,
    weights_bytes: float,
    kv_bytes_per_seq: float,
    *,
    stage: int = 0,
    shared_bytes: float = 0.0,
) -> int:
    """Max sequences a stage can hold KV for after its weights are resident.

    ``capacity_mb`` uses the profile-store MB convention (×1024² to bytes,
    matching ``DeviceSpec.memory_mb``).  Weights that already meet or exceed
    capacity raise :class:`KvCacheOomError` — the placement can never serve,
    and a silent 0 would be indistinguishable from "free memory fits no
    sequence yet", which IS reported as 0 and prunes the candidate.

    ``shared_bytes`` is the paged model's once-per-lane shared-prefix page
    set (``cost.estimator.shared_prefix_stage_bytes``): it comes off the free
    pool before per-sequence division, but a prefix that alone overflows the
    headroom reports 0 (prune) rather than OOM — the weights still fit."""
    capacity_bytes = capacity_mb * 1024 * 1024
    free = capacity_bytes - weights_bytes
    if free <= 0:
        raise KvCacheOomError(stage, weights_bytes / (1024 * 1024),
                              capacity_mb)
    free -= shared_bytes
    if kv_bytes_per_seq <= 0:
        # A stage holding only the embed/head pseudo-layers caches no KV —
        # concurrency is unbounded by THIS stage; callers min() across stages.
        return 1 << 30
    if free <= 0:
        return 0
    return int(free // kv_bytes_per_seq)


# Cross-candidate memo bound (entries, not bytes): thousands of inter-stage
# candidates share the same (placement, groups) sub-problems, so these caches
# hit constantly — but a pathological search must not grow them unboundedly.
_MEMO_MAX = 200_000


class _Miss:
    """Negative-cache sentinel: replays the exact ProfileMissError the
    uncached evaluation raised, so miss-driven pruning repeats identically."""

    __slots__ = ("args",)

    def __init__(self, args):
        self.args = args


class StagePerformanceModel:
    """Implements the search layer's StageEvaluator protocol.

    Memoization is by SUB-PROBLEM, not whole result: a whole-result cache
    keyed on (placement, groups, strategies) almost never hits at scale —
    escalation makes strategy tuples nearly unique per candidate — so
    ``compute_performance`` instead composes three caches that do hit:
    the per-placement stage structure, the per-(type, tp, bs) profile total
    time, and the per-(types, dp, tp, mb_total) hetero-split evaluation.
    Every cached float is the scalar evaluation's value verbatim, so the
    normalized tuples are bit-identical to the uncached walk.
    """

    def __init__(self, cluster: ClusterSpec, profiles: ProfileStore,
                 counters=None):
        self.cluster = cluster
        self.profiles = profiles
        self.data_balancer = DataBalancer(profiles)
        # optional core.trace.Counters for memo hit/miss/evict accounting;
        # None (tracing off) costs one attribute test per lookup
        self._counters = counters
        self._cap_cache: dict[tuple, tuple[float, ...]] = {}
        # (node_sequence, device_groups) -> per-stage (is_homo, types)
        self._struct_cache: dict[tuple, tuple] = {}
        # (type, tp, bs) -> LayerProfile.total_time_ms | _Miss
        self._tt_cache: dict[tuple, float | _Miss] = {}
        # (types, dp, tp, mb_total) -> raw hetero stage value | _Miss
        self._mixed_cache: dict[tuple, float | _Miss] = {}

    def _count(self, name: str) -> None:
        if self._counters is not None:
            self._counters.inc(name)

    def stage_types(self, plan: InterStagePlan, stage_id: int) -> list[str]:
        ranks = rank_device_types(self.cluster, plan.node_sequence)
        start, end = plan.stage_rank_range(stage_id)
        return ranks[start:end]

    def memory_capacity(self, plan: InterStagePlan) -> Sequence[float]:
        """Aggregate HBM per stage, MB (≅ ``device_group.py:87-101``)."""
        key = (plan.node_sequence, plan.device_groups)
        out = self._cap_cache.get(key)
        if out is None:
            self._count("memo.stage_cap.miss")
            ranks = rank_device_types(self.cluster, plan.node_sequence)
            vals = []
            for stage_id in range(plan.num_stages):
                start, end = plan.stage_rank_range(stage_id)
                vals.append(
                    sum(self.cluster.memory_mb(t) for t in ranks[start:end]))
            out = tuple(vals)
            if len(self._cap_cache) > _MEMO_MAX:
                self._cap_cache.clear()
                self._count("memo.stage_cap.evict")
            self._cap_cache[key] = out
        else:
            self._count("memo.stage_cap.hit")
        return out

    def stage_min_device_memory_mb(self, plan: InterStagePlan,
                                   stage_id: int) -> float:
        """Smallest per-device HBM among a stage's members, MB.  The serving
        KV check is per-RANK (each rank holds its tp shard of weights + KV),
        so a mixed stage is bounded by its most memory-poor device."""
        start, end = plan.stage_rank_range(stage_id)
        ranks = rank_device_types(self.cluster, plan.node_sequence)
        return min(self.cluster.memory_mb(t) for t in ranks[start:end])

    def _stage_structure(self, plan: InterStagePlan) -> tuple:
        """Per-stage (is_homo, device types) of a placement — resolved once
        per (node_sequence, device_groups), shared by every strategy set."""
        key = (plan.node_sequence, plan.device_groups)
        struct = self._struct_cache.get(key)
        if struct is None:
            self._count("memo.stage_struct.miss")
            ranks = rank_device_types(self.cluster, plan.node_sequence)
            entries = []
            for stage_id in range(plan.num_stages):
                start, end = plan.stage_rank_range(stage_id)
                types = ranks[start:end]
                entries.append((len(set(types)) == 1, types))
            struct = tuple(entries)
            if len(self._struct_cache) > _MEMO_MAX:
                self._struct_cache.clear()
                self._count("memo.stage_struct.evict")
            self._struct_cache[key] = struct
        else:
            self._count("memo.stage_struct.hit")
        return struct

    def _total_time(self, key: tuple) -> float | _Miss:
        try:
            v: float | _Miss = self.profiles.get(*key).total_time_ms
        except ProfileMissError as e:
            v = _Miss((e.device_type, e.tp, e.bs))
        if len(self._tt_cache) > _MEMO_MAX:
            self._tt_cache.clear()
            self._count("memo.stage_tt.evict")
        self._tt_cache[key] = v
        return v

    def _mixed_raw(self, key: tuple) -> float | _Miss:
        """Raw (pre-normalization) throughput of one heterogeneous stage —
        the data-balancer split + power-of-two chunk walk of the uncached
        path, verbatim.  Depends only on (types, dp, tp, mb_total)."""
        types, dp, tp, mb_total = key
        try:
            split = self.data_balancer.partition(types, dp, tp, mb_total)
            chunks = replica_chunks(types, dp)
            times = []
            for replica_id, h_bs in enumerate(split):
                rep_type = chunks[replica_id][0]
                times.append(sum(
                    self.profiles.get(rep_type, tp, c).total_time_ms
                    for c in power_of_two_chunks(h_bs)))
            worst = max(times) if times else 0.0
            v: float | _Miss = 1.0 / worst if worst else 0.0
        except ProfileMissError as e:
            v = _Miss((e.device_type, e.tp, e.bs))
        if len(self._mixed_cache) > _MEMO_MAX:
            self._mixed_cache.clear()
            self._count("memo.stage_mixed.evict")
        self._mixed_cache[key] = v
        return v

    def compute_performance(
        self, plan: InterStagePlan, strategies: Sequence[Strategy]
    ) -> Sequence[float]:
        """Normalized per-stage throughput (sums to 1;
        ≅ ``device_group.py:54-85``)."""
        # per-stage bs is gbs // batches // dp, so the per-candidate batch
        # count enters only through the microbatch total (two-step floor
        # division is exact for positive ints) — plans sharing it hit
        mb_total = plan.gbs // plan.batches
        struct = self._stage_structure(plan)
        tt = self._tt_cache
        mixed = self._mixed_cache
        raw: list[float] = []
        for stage_id, strat in enumerate(strategies):
            homo, types = struct[stage_id]
            if homo:
                key = (types[0], strat.tp, mb_total // strat.dp)
                v = tt.get(key)
                if v is None:
                    v = self._total_time(key)
                if v.__class__ is _Miss:
                    raise ProfileMissError(*v.args)
                # Context parallelism shards the sequence: per-device compute
                # scales ~1/cp (metis_tpu_torch.cost.context_parallel docstring).
                raw.append(1.0 / (v / strat.cp))
            else:
                key = (types, strat.dp, strat.tp, mb_total)
                v = mixed.get(key)
                if v is None:
                    v = self._mixed_raw(key)
                if v.__class__ is _Miss:
                    raise ProfileMissError(*v.args)
                raw.append(v)
        total = sum(raw)
        return tuple(r / total for r in raw) if total else tuple(raw)
