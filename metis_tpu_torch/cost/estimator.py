"""Step-time cost estimators for uniform and heterogeneous plans.

The port's copy of ``metis_tpu/cost/estimator.py``.

≅ reference ``model/cost_estimator.py`` (C12 in SURVEY.md §2.1), with every
formula preserved under ``strict_compat`` and differential-tested against the
upstream implementation:

- GPipe fill-drain: ``(num_microbatches - 1) * max_stage + sum(stages)``
- ring all-reduce DP gradient cost ``2(d-1)/(d*B) * stage_params``
- point-to-point PP cost ``activation / B``
- fb_sync looked up at the stage microbatch, maxed over member device types
- optimizer cost scaled by profiled time / tp (and layer share for hetero),
  **max** over stages; DP cost likewise max over stages (hetero)

Unit quirks reproduced only under strict_compat (SURVEY.md §2.3):
bandwidth GB/s -> bytes/ms via 1024*1024 (≈2.4% off), activation volumes in
element counts.  Native mode uses bytes and decimal GB/s, real inter-node
bandwidth, and per-device-type optimizer/batch-generator timings.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from metis_tpu_torch.cluster.spec import ClusterSpec
from metis_tpu_torch.core.config import SearchConfig
from metis_tpu_torch.core.errors import ProfileMissError
from metis_tpu_torch.core.types import (
    CostBreakdown,
    InterStagePlan,
    PlanCost,
    Strategy,
    UniformPlan,
)
from metis_tpu_torch.profiles.store import ProfileStore
from metis_tpu_torch.balance.data import DataBalancer, power_of_two_chunks, replica_chunks
from metis_tpu_torch.balance.stage_perf import rank_device_types
from metis_tpu_torch.cost.bandwidth import (
    HeteroScalarBandwidth,
    HomoScalarBandwidth,
    StageBandwidthModel,
)
from metis_tpu_torch.cost.context_parallel import attention_layer_range, cp_comm_ms
from metis_tpu_torch.cost.expert_parallel import (
    ep_a2a_ms,
    expert_param_fraction,
    moe_layer_range,
)
from metis_tpu_torch.cost.schedule import (
    schedule_execution_ms,
    schedule_pp_send_factor,
)
from metis_tpu_torch.cost.zero import zero_dp_factor
from metis_tpu_torch.cost.volume import TransformerVolume


@dataclass(frozen=True)
class EstimatorOptions:
    strict_compat: bool = False
    # None = auto: 2.0 strict_compat (ref data_loader.py:19), 1.0 native
    # (the executors run the adamw update once per step — see
    # SearchConfig.optimizer_factor)
    optimizer_factor: float | None = None
    max_profiled_bs: int = 16       # ref cost_estimator.py:166 cap
    dp_over_pp_rows: bool = True    # homo: whole pp-row treated as one dp group
    # Measured fraction of the dp gradient all-reduce hidden under backward
    # compute (cost/calibration.measure_dp_overlap).  0.0 = fully serial —
    # the reference's model (cost_estimator.py:37-43 charged on the critical
    # path) and the only behavior under strict_compat.  Native mode charges
    # only the exposed (1 - fraction) share; the latency floor stays fully
    # charged (a ring's alpha cost cannot be hidden by more compute).
    dp_overlap_fraction: float = 0.0
    # measured fwd share of a fwd+bwd stage time for remat-schedule pricing
    # (cost/schedule.schedule_execution_ms); None = analytic default
    remat_fwd_fraction: float | None = None
    # Overlap-aware comm pricing (SearchConfig.use_overlap_model): charge
    # only the exposed share of each collective — per pp boundary
    # ``max(0, send - sender stage compute)``, per stage
    # ``max(0, dp sync - optimizer)`` — matching the executor's
    # double-buffered ppermute and chunked gradient all-reduce
    # (execution/pipeline.py).  Never active under strict_compat: the
    # reference prices every collective fully exposed.
    use_overlap_model: bool = True
    # Native mode: affine-smooth the profile's bs axis and charge the fitted
    # per-program fixed cost once per step instead of once per microbatch
    # (ProfileStore.affine_view — the executors scan microbatches inside one
    # jit).  Ignored under strict_compat (the reference charges the raw
    # profiled time per microbatch).
    mb_affine: bool = True
    # Availability-aware pricing (SearchConfig.use_spot_model): charge the
    # expected preemption-recovery cost per step — step time x the plan's
    # summed spot hazard (DeviceSpec.hazard_per_hr) x measured recover
    # seconds / 3600 — as an additive ``expected_recovery`` term.  Never
    # active under strict_compat; a reserved-only fleet prices a hazard of
    # exactly 0 and every cost stays bit-identical to the flag being off.
    use_spot_model: bool = True
    spot_recover_s: float = 30.0
    # Migration-aware pricing (SearchConfig.use_migration_model): when a
    # replan carries the incumbent plan's layout (``migrate_from`` — a tuple
    # of (tp, layer_start, layer_end) per old stage), charge each candidate
    # the parameter bytes it must reshard away from that layout, amortized
    # over ``migration_amortize_steps`` — so the planner can trade a
    # slightly worse plan for a much cheaper live switch
    # (execution/reshard.py prices the same delta for the actual transfer).
    # An empty ``migrate_from`` prices exactly 0.0; never active under
    # strict_compat.
    use_migration_model: bool = True
    migrate_from: tuple = ()
    migration_bw_gbps: float = 100.0
    migration_amortize_steps: int = 1000
    # Batched cost-tensor backend (SearchConfig.cost_backend): "numpy" is
    # the scalar-float oracle, "torch" the CUDA cost kernel
    # (cost/torch_backend.py); the reference's "jax" backend makes the
    # batch estimator raise.
    cost_backend: str = "numpy"

    @staticmethod
    def from_config(cfg: SearchConfig) -> "EstimatorOptions":
        return EstimatorOptions(
            strict_compat=cfg.strict_compat,
            optimizer_factor=cfg.optimizer_factor,
            max_profiled_bs=cfg.max_profiled_bs,
            dp_overlap_fraction=cfg.dp_overlap_fraction,
            remat_fwd_fraction=cfg.remat_fwd_fraction,
            use_overlap_model=cfg.use_overlap_model,
            use_spot_model=cfg.use_spot_model,
            spot_recover_s=cfg.spot_recover_s,
            use_migration_model=cfg.use_migration_model,
            migrate_from=tuple(
                tuple(int(x) for x in t) for t in cfg.migrate_from),
            migration_bw_gbps=cfg.migration_bw_gbps,
            migration_amortize_steps=cfg.migration_amortize_steps,
            cost_backend=getattr(cfg, "cost_backend", "numpy"),
        )

    @property
    def overlap_active(self) -> bool:
        """Whether the exposed-vs-hidden comm split applies."""
        return self.use_overlap_model and not self.strict_compat

    @property
    def spot_active(self) -> bool:
        """Whether the expected-recovery availability term applies."""
        return self.use_spot_model and not self.strict_compat

    @property
    def migration_active(self) -> bool:
        """Whether the amortized plan-switch term applies."""
        return (self.use_migration_model and not self.strict_compat
                and bool(self.migrate_from))

    @property
    def dp_exposed_share(self) -> float:
        """Share of dp gradient-sync volume charged on the critical path."""
        if self.strict_compat:
            return 1.0
        return 1.0 - min(max(self.dp_overlap_fraction, 0.0), 1.0)

    def bw_to_bytes_per_ms(self, bw_gbps: float) -> float:
        # Reference converts GB/s with 1024*1024 (cost_estimator.py:40,46);
        # natively GB/s = 1e6 bytes/ms.
        return bw_gbps * (1024 * 1024 if self.strict_compat else 1e6)


def kv_bytes_per_token(model, kv_dtype_bytes: int = 2, tp: int = 1) -> float:
    """KV-cache bytes one sequence adds per token per transformer block.

    ``2 ×`` is K and V; GQA/MQA shrink the footprint through
    ``num_kv_heads`` (0 on the spec means full multi-head attention).
    Tensor parallelism shards heads, so a tp-way stage holds ``1/tp`` of the
    cache per rank — the per-rank figure is what the HBM check needs."""
    kv_heads = model.num_kv_heads or model.num_heads
    return 2.0 * kv_heads * model.head_dim * kv_dtype_bytes / tp


def kv_stage_bytes(
    model,
    batch: int,
    context_len: int,
    start: int,
    end: int,
    kv_dtype_bytes: int = 2,
    tp: int = 1,
) -> float:
    """Per-rank KV footprint for ``batch`` sequences of ``context_len`` tokens
    on a stage holding layers ``[start, end)``.

    Only transformer blocks hold KV — the embed (layer 0) and head (layer
    ``num_layers-1``) pseudo-layers the partition convention carries are
    clamped out, so a stage that owns only those prices to zero."""
    blocks = max(0, min(end, model.num_layers - 1) - max(start, 1))
    return batch * context_len * blocks * kv_bytes_per_token(
        model, kv_dtype_bytes=kv_dtype_bytes, tp=tp)


def paged_tokens(tokens: int, page_tokens: int) -> int:
    """Token count rounded UP to whole KV pages (``page_tokens`` tokens per
    page per layer, vLLM-style block allocation).  ``page_tokens <= 0`` means
    exact (unpaged) accounting — the original serving model."""
    if page_tokens <= 0 or tokens <= 0:
        return max(tokens, 0)
    return -(-tokens // page_tokens) * page_tokens


def paged_kv_seq_bytes(
    model,
    context_len: int,
    start: int,
    end: int,
    kv_dtype_bytes: int = 2,
    tp: int = 1,
    *,
    page_tokens: int = 0,
    prefix_len: int = 0,
    prefix_share_frac: float = 0.0,
) -> float:
    """Expected per-rank KV bytes ONE sequence uniquely holds on a stage
    under paged prefix sharing.

    ``prefix_share_frac`` of sequences share one common prompt prefix of
    ``prefix_len`` tokens whose pages are stored once per lane (see
    :func:`shared_prefix_stage_bytes`), so a sharing sequence only allocates
    pages for its ``context_len - prefix_len`` unique tail.  The remaining
    ``1 - prefix_share_frac`` carry their full context.  With sharing off and
    paging off this is EXACTLY ``kv_stage_bytes(model, 1, context_len, ...)``
    — the short-circuit keeps the frozen serving golden byte-identical."""
    if prefix_share_frac <= 0.0 or prefix_len <= 0:
        return kv_stage_bytes(model, 1, paged_tokens(context_len, page_tokens),
                              start, end, kv_dtype_bytes, tp)
    pfx = min(prefix_len, context_len)
    full = kv_stage_bytes(model, 1, paged_tokens(context_len, page_tokens),
                          start, end, kv_dtype_bytes, tp)
    uniq = kv_stage_bytes(model, 1,
                          paged_tokens(context_len - pfx, page_tokens),
                          start, end, kv_dtype_bytes, tp)
    return prefix_share_frac * uniq + (1.0 - prefix_share_frac) * full


def shared_prefix_stage_bytes(
    model,
    prefix_len: int,
    context_len: int,
    start: int,
    end: int,
    kv_dtype_bytes: int = 2,
    tp: int = 1,
    *,
    page_tokens: int = 0,
    prefix_share_frac: float = 0.0,
) -> float:
    """Per-rank bytes of the ONE shared-prefix page set a stage keeps
    resident (counted once per lane, not once per sequence).  Zero when
    sharing is off."""
    if prefix_share_frac <= 0.0 or prefix_len <= 0:
        return 0.0
    pfx = min(prefix_len, context_len)
    return kv_stage_bytes(model, 1, paged_tokens(pfx, page_tokens),
                          start, end, kv_dtype_bytes, tp)


# Memo bounds (entries) for the costing caches: wholesale clear beyond
# these, so a long-lived daemon sweeping many clusters cannot grow them
# unboundedly.  Evictions are visible as ``memo.*.evict`` counters.
_BW_CACHE_MAX = 200_000
_STAGE_MS_CACHE_MAX = 200_000


def uniform_layer_split(total_layers: int, num_stages: int) -> list[int]:
    """Even layer counts per stage; first/last get +1 for embed/head
    (≅ ``model/utils.py:5-31``)."""
    base = (total_layers - 2) // num_stages
    rem = (total_layers - 2) % num_stages
    counts = [base] * num_stages
    for i in range(1, rem + 1):
        counts[i % num_stages] += 1
    counts[0] += 1
    counts[-1] += 1
    return counts


class _EstimatorBase:
    def __init__(
        self,
        cluster: ClusterSpec,
        profiles: ProfileStore,
        volume: TransformerVolume,
        options: EstimatorOptions,
        counters=None,
    ):
        self.cluster = cluster
        self.volume = volume
        self.options = options
        # optional core.trace.Counters — estimator-level accounting for the
        # flight recorder: ``profile_miss`` (ProfileMissError raised while
        # pricing a stage) and the bandwidth-model cache hits/misses below.
        # None (tracing off) skips even the dict adds.
        self.counters = counters
        self._step_overhead: dict[tuple[str, int], float] = {}
        if options.mb_affine and not options.strict_compat:
            profiles, self._step_overhead = profiles.affine_view()
        self.profiles = profiles
        # migration term memo: a pure function of (per-stage tp tuple,
        # layer partition) given frozen options — shared verbatim by the
        # batch path so both stay bit-identical
        self._migration_cache: dict = {}
        self._migrate_from_tp: dict[int, int] | None = None

    def _step_overhead_ms(
            self, pairs: Sequence[tuple[str, int]]) -> float:
        """The fitted per-program fixed cost, charged once per step, maxed
        over the (device_type, tp) configurations the plan ACTUALLY runs
        (the slowest participant bounds the critical path).  May be
        negative: a superlinear-in-bs profile fits a negative intercept,
        and the affine extrapolation — not the \"fixed overhead\" story —
        is the contract (it is what makes the predicted step flat in the
        microbatch count, matching the on-chip measurement)."""
        if not self._step_overhead:
            return 0.0
        return max((self._step_overhead.get(p, 0.0) for p in set(pairs)),
                   default=0.0)

    def _dp_cost_ms(self, param_bytes: float, bw_gbps: float, dp: int) -> float:
        if dp <= 1:
            return 0.0
        return 2 * (dp - 1) / (dp * self.options.bw_to_bytes_per_ms(bw_gbps)) * param_bytes

    def _pp_cost_ms(self, activation: float, bw_gbps: float) -> float:
        return activation / self.options.bw_to_bytes_per_ms(bw_gbps)

    def _activation(self, boundary: int, mbs: int, tp: int) -> float:
        return self.volume.boundary_activation(
            boundary, mbs, tp, elements=self.options.strict_compat)

    def _fb_sync_ms(self, device_types: Sequence[str], tp: int, bs: int) -> float:
        return max(
            self.profiles.get(t, tp, bs).fb_sync_ms for t in set(device_types))

    def _optimizer_ms(self, device_type: str | None = None) -> float:
        if self.options.strict_compat or device_type is None:
            raw = self.profiles.model.optimizer_time_ms
        else:
            raw = self.profiles.type_meta[device_type].optimizer_time_ms
        factor = self.options.optimizer_factor
        if factor is None:
            factor = 2.0 if self.options.strict_compat else 1.0
        return raw * factor

    def _spot_scale_of(self, hazard_per_hr: float) -> float:
        """Dimensionless expected-recovery multiplier for a device set with
        the given summed preemption hazard: a step of T ms sees
        ``hazard * T / 3.6e6`` expected evictions, each costing
        ``spot_recover_s * 1000`` ms of recovery, so the charge is
        ``T * hazard * spot_recover_s / 3600`` — exactly 0.0 when the spot
        model is inactive or the fleet is reserved-only."""
        if not self.options.spot_active or hazard_per_hr == 0.0:
            return 0.0
        return hazard_per_hr * self.options.spot_recover_s / 3600.0

    def _migration_ms(self, tps: tuple, partition: tuple) -> float:
        """Amortized cost of resharding the incumbent layout
        (``options.migrate_from``) into a candidate's (per-stage tp,
        layer partition): every layer NOT already held at the candidate's
        tp by some old stage must move its parameter bytes over the
        migration fabric, spread over ``migration_amortize_steps`` so the
        one-time transfer is comparable to per-step terms.  Depends only
        on (tps, partition) + the frozen options — placement-free, so the
        batch path calls this same memoized helper and stays
        bit-identical.  Exactly 0.0 when the model is inactive."""
        if not self.options.migration_active:
            return 0.0
        key = (tps, partition)
        cached = self._migration_cache.get(key)
        if cached is not None:
            return cached
        old_tp = self._migrate_from_tp
        if old_tp is None:
            old_tp = {}
            for tp, start, end in self.options.migrate_from:
                for layer in range(start, end):
                    old_tp[layer] = tp
            self._migrate_from_tp = old_tp
        moved = 0.0
        for s, tp in enumerate(tps):
            per = self.volume.parameter_bytes_per_layer(tp)
            for layer in range(partition[s], partition[s + 1]):
                if old_tp.get(layer) != tp:
                    moved += per[layer]
        ms = (moved
              / self.options.bw_to_bytes_per_ms(self.options.migration_bw_gbps)
              / self.options.migration_amortize_steps)
        if len(self._migration_cache) > _STAGE_MS_CACHE_MAX:
            self._migration_cache.clear()
        self._migration_cache[key] = ms
        return ms

    def _batch_gen_ms(self, count: int, device_type: str | None = None) -> float:
        """Input-pipeline cost; native mode reads the feeding stage's device
        type (the host attached to stage 0's chips generates batches).

        Strict-compat charges it per microbatch (``count``x), matching the
        reference (``cost_estimator.py:34-35``).  Native mode charges it ONCE
        per step: our executors build the global batch on host and
        microbatch-split on device (``execution.microbatch_split`` feeding a
        ``lax.scan``), so the pipeline does not re-run per microbatch.  The
        on-chip validation sweep pinned this: measured step time is flat in
        the microbatch count while per-microbatch charging bent predictions
        up at small mbs (calibration/tpu_validation_sweep.json)."""
        if self.options.strict_compat or device_type is None:
            per = self.profiles.model.batch_generator_ms
            return per * count
        return self.profiles.type_meta[device_type].batch_generator_ms


def _assemble_breakdown(
    cost: PlanCost,
    detail: dict,
    schedule: str,
    batches: int,
    virtual_stages: int,
    remat_fraction: float | None,
) -> CostBreakdown:
    """CostBreakdown from a PlanCost plus the estimator's ``_detail`` dump.

    Parity-preserving by construction: ``compute`` is the schedule priced
    with every stage leveled at the comm-free mean, ``imbalance`` the delta
    to the comm-free actual lens, and cp/ep/overhead are the exact terms
    ``get_cost`` added — so compute + imbalance + cp + ep + overhead ==
    ``PlanCost.execution_ms`` and the component sum == ``total_ms`` up to
    float association.
    """
    lens_nocomm = detail["lens_nocomm"]
    mean_l = sum(lens_nocomm) / len(lens_nocomm)
    balanced = schedule_execution_ms(
        schedule, [mean_l] * len(lens_nocomm), batches, virtual_stages,
        remat_fraction=remat_fraction)
    actual = schedule_execution_ms(
        schedule, lens_nocomm, batches, virtual_stages,
        remat_fraction=remat_fraction)
    # Overlap model: the PlanCost comm fields carry the EXPOSED (charged)
    # values, so the additive component keys switch to *_exposed and the
    # hidden remainder rides the side-channel ``hidden`` dict.
    hidden = detail.get("overlap_hidden")
    pp_key, dp_key = (
        ("pp_comm_exposed", "dp_comm_exposed") if hidden is not None
        else ("pp_comm", "dp_comm"))
    components = {
        "compute": balanced,
        "imbalance": actual - balanced,
        "cp_comm": cost.cp_comm_ms,
        "ep_comm": cost.ep_comm_ms,
        "step_overhead": detail["overhead_ms"],
        pp_key: cost.pp_comm_ms,
        dp_key: cost.dp_comm_ms,
        "fb_sync": cost.fb_sync_ms,
        "optimizer": cost.optimizer_ms,
        "batch_gen": cost.batch_gen_ms,
    }
    # spot model: the expected-recovery charge joins the additive sum only
    # when it is real (reserved-only breakdowns stay byte-identical)
    if detail.get("spot_recovery") is not None:
        components["expected_recovery"] = cost.expected_recovery_ms
    # migration model: same omission contract — fresh searches stay
    # byte-identical to pre-migration breakdowns
    if detail.get("migration") is not None:
        components["migration"] = cost.migration_ms
    return CostBreakdown(
        total_ms=cost.total_ms,
        components=components,
        stage_execution_ms=detail["sched_lens"],
        stage_comm_ms=detail.get("comm_by_stage", ()),
        stage_dp_comm_ms=detail.get("dp_costs", ()),
        stage_optimizer_ms=detail.get("opt_costs", ()),
        schedule=schedule,
        hidden=dict(hidden) if hidden else {},
    )


class UniformCostEstimator(_EstimatorBase):
    """Cost of a uniform Megatron-grid plan on a (nominally) homogeneous
    cluster (≅ ``HomoCostEstimator.get_cost``, ``cost_estimator.py:98-138``)."""

    def __init__(self, cluster, profiles, volume, options, counters=None):
        super().__init__(cluster, profiles, volume, options, counters)
        self.bandwidth = HomoScalarBandwidth(cluster, options.strict_compat)

    def get_breakdown(
        self, plan: UniformPlan, device_type: str,
    ) -> tuple[PlanCost, CostBreakdown]:
        """(cost, per-component breakdown) — same math path as ``get_cost``,
        so the scalar is bit-identical; run post-ranking on top-k plans."""
        detail: dict = {}
        cost = self.get_cost(plan, device_type, _detail=detail)
        num_mbs = plan.gbs // plan.mbs // plan.dp
        return cost, _assemble_breakdown(
            cost, detail, "gpipe", num_mbs, 1, None)

    def get_cost(self, plan: UniformPlan, device_type: str,
                 _detail: dict | None = None) -> PlanCost:
        L = self.volume.num_layers
        counts = uniform_layer_split(L, plan.pp)
        prof = self.profiles.get(device_type, plan.tp, plan.mbs)
        params = self.volume.parameter_bytes_per_layer(plan.tp)
        num_mbs = plan.gbs // plan.mbs // plan.dp

        overlap = self.options.overlap_active
        lens: list[float] = []
        stage_params: list[float] = []
        stage_memory: list[float] = []
        fb_sync = pp_cost = pp_exposed = 0.0
        for s in range(plan.pp):
            start = sum(counts[:s])
            end = start + counts[s]
            lens.append(prof.time_slice(start, end))
            stage_params.append(sum(params[start:end]))
            stage_memory.append(prof.memory_slice(start, end))
            if s == plan.pp - 1:
                fb_sync = self._fb_sync_ms([device_type], plan.tp, plan.mbs) * num_mbs
            else:
                bw = self.bandwidth.pp_bandwidth(plan.pp, plan.tp, s)
                t_pp = self._pp_cost_ms(
                    self._activation(end, plan.mbs, plan.tp), bw)
                pp_cost += t_pp
                if overlap:
                    # double-buffered send: only what outlasts the sender
                    # stage's per-microbatch compute stays exposed
                    pp_exposed += max(0.0, t_pp - lens[-1])

        # Per-device capacity of the profiled type (the reference reads node
        # 0's memory regardless of the device type being costed,
        # cost_estimator.py:31-32 — that's only right when they coincide).
        cap_type = (
            self.cluster.nodes[0].device_type if self.options.strict_compat
            else device_type)
        oom = self.cluster.memory_mb(cap_type) < max(stage_memory)
        overhead = self._step_overhead_ms([(device_type, plan.tp)])
        execution = (num_mbs - 1) * max(lens) + sum(lens) + overhead
        optimizer = self._optimizer_ms(device_type) / plan.pp / plan.tp
        # only the measured exposed share of the gradient sync rides the
        # critical path (overlap calibration; serial under strict_compat)
        dp_cost = self._dp_cost_ms(
            max(stage_params), self.bandwidth.dp_bandwidth(plan.pp, plan.tp),
            plan.dp) * self.options.dp_exposed_share
        batch_gen = self._batch_gen_ms(num_mbs, device_type)

        # Overlap model: the chunked gradient all-reduce hides under the
        # optimizer step, the double-buffered send under stage compute —
        # PlanCost charges the exposed remainders (additivity preserved).
        if overlap:
            dp_charge = max(0.0, dp_cost - optimizer)
            pp_charge = pp_exposed
        else:
            dp_charge = dp_cost
            pp_charge = pp_cost

        total = execution + fb_sync + optimizer + dp_charge + pp_charge + batch_gen
        recovery = 0.0
        spot_scale = self._spot_scale_of(
            plan.dp * plan.pp * plan.tp
            * self.cluster.devices[device_type].hazard_per_hr)
        if spot_scale:
            recovery = total * spot_scale
            total = total + recovery
        migration = 0.0
        if self.options.migration_active:
            bounds = [0]
            for c in counts:
                bounds.append(bounds[-1] + c)
            migration = self._migration_ms(
                (plan.tp,) * plan.pp, tuple(bounds))
            if migration:
                total = total + migration

        if _detail is not None:
            _detail.update(
                sched_lens=tuple(lens), lens_nocomm=tuple(lens),
                comm_by_stage=(0.0,) * plan.pp, overhead_ms=overhead)
            if overlap:
                _detail["overlap_hidden"] = {
                    "pp_comm": pp_cost - pp_charge,
                    "dp_comm": dp_cost - dp_charge,
                }
            if recovery:
                _detail["spot_recovery"] = recovery
            if migration:
                _detail["migration"] = migration
        return PlanCost(
            total_ms=total,
            execution_ms=execution,
            fb_sync_ms=fb_sync,
            optimizer_ms=optimizer,
            dp_comm_ms=dp_charge,
            pp_comm_ms=pp_charge,
            batch_gen_ms=batch_gen,
            expected_recovery_ms=recovery,
            migration_ms=migration,
            oom=oom,
        )


BandwidthFactory = Callable[[InterStagePlan], StageBandwidthModel]


class HeteroCostEstimator(_EstimatorBase):
    """Cost of a heterogeneous inter+intra stage plan
    (≅ ``HeteroCostEstimator.get_cost``, ``cost_estimator.py:199-244``)."""

    def __init__(self, cluster, profiles, volume, options,
                 bandwidth_factory: BandwidthFactory | None = None,
                 counters=None):
        super().__init__(cluster, profiles, volume, options, counters)
        self.data_balancer = DataBalancer(profiles)
        # CONTRACT: factories must depend on the plan's placement only
        # (node_sequence + device_groups) — the memo below reuses one model
        # across plans that share a placement but differ in batches/gbs.
        # Both in-repo models (HeteroScalarBandwidth, IciDcnBandwidth)
        # satisfy this; a batches-sensitive custom factory must not be
        # passed here.
        self.bandwidth_factory = bandwidth_factory or (
            lambda plan: HeteroScalarBandwidth(cluster, plan, options.strict_compat))
        # search-hot: bandwidth depends on the plan's *placement* only —
        # (node_sequence, device_groups) — which the enumeration shares
        # across every microbatch count and intra candidate; memoize the
        # model and its per-stage scans on that key (pure functions of it)
        self._bw_key = None
        self._bw_model = None
        self._bw_cache: dict = {}
        # Cross-candidate stage-time memo: many (inter, intra) candidates
        # share (stage composition, layer range, strategy) sub-problems.
        # Values are the SCALAR path's floats verbatim, so cached pricing is
        # bit-identical to uncached (tests/test_ledger.py pins exact
        # re-price equality).  Bounded like _bw_cache.
        self._stage_ms_cache: dict = {}
        # stage_time_grid prefix matrices per (device_type, tp)
        self._time_grid_cache: dict = {}
        # spot-hazard scale per placement — a pure function of
        # (node_sequence, device_groups); the batch path stores the SAME
        # float in its placement tables so both paths stay bit-identical
        self._spot_cache: dict = {}

    def _bandwidth_for(self, plan: InterStagePlan):
        key = (plan.node_sequence, plan.device_groups)
        if key != self._bw_key:
            self._bw_key = key
            self._bw_model = self.bandwidth_factory(plan)
            if self.counters is not None:
                self.counters.inc("bw_model_built")
            if len(self._bw_cache) > _BW_CACHE_MAX:
                self._bw_cache.clear()
                if self.counters is not None:
                    self.counters.inc("memo.bw.evict")
        return self._bw_model

    def _cache_key(self, kind: str, stage_id: int, *rest):
        return (kind, self._bw_key, stage_id, *rest)

    def _count_cache(self, hit: bool) -> None:
        if self.counters is not None:
            self.counters.inc("bw_cache_hit" if hit else "bw_cache_miss")

    def _profile_miss(self, t: str, tp: int, c: int) -> ProfileMissError:
        if self.counters is not None:
            self.counters.inc("profile_miss")
        return ProfileMissError(t, tp, c)

    def _dp_bw(self, bandwidth, stage_id: int, strat: Strategy) -> float:
        key = self._cache_key("dp", stage_id, strat.dp, strat.cp, strat.tp)
        if key not in self._bw_cache:
            self._bw_cache[key] = bandwidth.dp_bandwidth(stage_id, strat)
            self._count_cache(hit=False)
        else:
            self._count_cache(hit=True)
        return self._bw_cache[key]

    def _pp_bw(self, bandwidth, stage_id: int) -> float:
        key = self._cache_key("pp", stage_id)
        if key not in self._bw_cache:
            self._bw_cache[key] = bandwidth.pp_bandwidth(stage_id)
            self._count_cache(hit=False)
        else:
            self._count_cache(hit=True)
        return self._bw_cache[key]

    def _cp_bw(self, bandwidth, stage_id: int, strat: Strategy) -> float:
        key = self._cache_key("cp", stage_id, strat.dp, strat.cp, strat.tp)
        if key not in self._bw_cache:
            cp_bw_fn = getattr(bandwidth, "cp_bandwidth", None)
            self._bw_cache[key] = (
                cp_bw_fn(stage_id, strat) if cp_bw_fn is not None
                else bandwidth.dp_bandwidth(stage_id, strat))
            self._count_cache(hit=False)
        else:
            self._count_cache(hit=True)
        return self._bw_cache[key]

    def _spot_scale(self, plan: InterStagePlan) -> float:
        """The plan's expected-recovery multiplier (``_spot_scale_of`` over
        the per-rank hazards of the placement's device set), memoized per
        (node_sequence, device_groups)."""
        if not self.options.spot_active:
            return 0.0
        key = (plan.node_sequence, plan.device_groups)
        scale = self._spot_cache.get(key)
        if scale is None:
            ranks = rank_device_types(self.cluster, plan.node_sequence)
            hazard = 0.0
            for t in ranks[:sum(plan.device_groups)]:
                hazard += self.cluster.devices[t].hazard_per_hr
            scale = self._spot_scale_of(hazard)
            if len(self._spot_cache) > _BW_CACHE_MAX:
                self._spot_cache.clear()
            self._spot_cache[key] = scale
        return scale

    def stage_time_grid(
        self, device_type: str, tp: int, start: int, end: int,
    ) -> tuple[tuple[int, ...], np.ndarray]:
        """Vectorized batch costing of one stage's intra-strategy grid:
        ``(batch_sizes, times_ms)`` pricing layers ``[start, end)`` at EVERY
        profiled batch size of the ``(device_type, tp)`` configuration in one
        numpy subtraction of cached per-layer prefix sums.

        The scalar ``get_cost`` path and its ``CostBreakdown`` decomposition
        stay the oracle — prefix-sum association differs from the sequential
        ``time_slice`` sum at the last ulp, so this grid is for batch
        consumers (sweeps, regression tooling) and is oracle-tested against
        the scalar path at rtol 1e-9 (tools/check_search_regression.py)."""
        key = (device_type, tp)
        entry = self._time_grid_cache.get(key)
        if entry is None:
            bss = sorted(b for (_, t, b) in self.profiles.configs(device_type)
                         if t == tp)
            if not bss:
                raise ProfileMissError(device_type, tp, 1)
            mat = np.stack([
                np.asarray(self.profiles.get(device_type, tp, b).layer_times_ms,
                           dtype=np.float64)
                for b in bss])
            prefix = np.concatenate(
                [np.zeros((len(bss), 1)), np.cumsum(mat, axis=1)], axis=1)
            entry = (tuple(bss), prefix)
            self._time_grid_cache[key] = entry
        bss, prefix = entry
        return bss, prefix[:, end] - prefix[:, start]

    def _stage_execution_ms(
        self,
        plan: InterStagePlan,
        strategy: Strategy,
        stage_types: Sequence[str],
        start: int,
        end: int,
    ) -> float:
        # homo stages collapse dp/batches into the microbatch size, so plans
        # differing only in that split hit one entry; mixed stages key on the
        # microbatch total (two-step floor division is exact).  Successes
        # only: a profile miss re-runs so the raise and its ``profile_miss``
        # accounting replay identically on every repeat.
        if len(set(stage_types)) == 1:
            key = ("h", stage_types[0], strategy.tp,
                   plan.gbs // strategy.dp // plan.batches, strategy.cp,
                   start, end)
        else:
            key = ("m", tuple(stage_types), strategy.dp, strategy.tp,
                   strategy.cp, strategy.ep, strategy.zero,
                   plan.gbs // plan.batches, start, end)
        cached = self._stage_ms_cache.get(key)
        if cached is not None:
            if self.counters is not None:
                self.counters.inc("memo.stage_ms.hit")
            return cached
        if self.counters is not None:
            self.counters.inc("memo.stage_ms.miss")
        out = self._stage_execution_ms_uncached(
            plan, strategy, stage_types, start, end)
        if len(self._stage_ms_cache) > _STAGE_MS_CACHE_MAX:
            self._stage_ms_cache.clear()
            if self.counters is not None:
                self.counters.inc("memo.stage_ms.evict")
        self._stage_ms_cache[key] = out
        return out

    def _stage_execution_ms_uncached(
        self,
        plan: InterStagePlan,
        strategy: Strategy,
        stage_types: Sequence[str],
        start: int,
        end: int,
    ) -> float:
        dp, tp = strategy.dp, strategy.tp
        if len(set(stage_types)) == 1:
            bs = plan.gbs // dp // plan.batches
            # cp shards the sequence: per-device compute scales ~1/cp (ring
            # comm is charged separately in get_cost).
            return (self.profiles.get(stage_types[0], tp, bs)
                    .time_slice(start, end) / strategy.cp)
        if (self.volume.model.num_experts > 0
                and (strategy.ep > 1 or strategy.zero > 0
                     or strategy.cp > 1)):
            # MoE mixed-type stages carrying ep/zero/cp run the pad/mask
            # SINGLE program (the per-type group split supports none of
            # those axes — execution.hetero.plan_replica_groups), where
            # capacity-shaped expert compute pays the PADDED batch on
            # every replica: price the slowest type at max(split).
            split = self.data_balancer.partition(
                stage_types, dp, tp, plan.gbs // plan.batches)
            bs = max(split)
            slowest = 0.0
            for t in set(stage_types):
                total = 0.0
                for c in power_of_two_chunks(bs):
                    if c > self.options.max_profiled_bs:
                        raise self._profile_miss(t, tp, c)
                    total += self.profiles.get(t, tp, c).time_slice(start, end)
                slowest = max(slowest, total)
            return slowest / strategy.cp
        # Mixed-type stages (dense AND MoE without ep/zero/cp) execute as
        # per-type sub-mesh groups, each computing only its data-balancer
        # share — no padded rows, and an MoE group's expert capacity
        # derives from its own token count
        # (execution.hetero.StageSpec.replica_groups).  Price each replica
        # at its own type and real batch; the stage finishes with its
        # slowest replica.  (MoE stages once priced the PADDED
        # batch on every replica — sound for the pad/mask executor but
        # structurally erasing the uneven-split advantage.)
        split = self.data_balancer.partition(
            stage_types, dp, tp, plan.gbs // plan.batches)
        chunks = replica_chunks(stage_types, dp)
        costs = []
        for replica_id, h_bs in enumerate(split):
            if h_bs == 0:
                continue
            rep_type = chunks[replica_id][0]
            total = 0.0
            for c in power_of_two_chunks(h_bs):
                if c > self.options.max_profiled_bs:
                    raise self._profile_miss(rep_type, tp, c)
                total += self.profiles.get(rep_type, tp, c).time_slice(start, end)
            costs.append(total)
        return max(costs)

    def get_breakdown(
        self,
        plan: InterStagePlan,
        strategies: Sequence[Strategy],
        layer_partition: Sequence[int],
        rank_types: Sequence[str] | None = None,
        schedule: str = "gpipe",
        virtual_stages: int = 1,
    ) -> tuple[PlanCost, CostBreakdown]:
        """(cost, per-component breakdown) — same math path as ``get_cost``,
        so the ranked scalar is bit-identical and the components sum to it;
        run post-ranking on top-k plans, never in the search hot loop."""
        detail: dict = {}
        cost = self.get_cost(plan, strategies, layer_partition, rank_types,
                             schedule, virtual_stages, _detail=detail)
        return cost, _assemble_breakdown(
            cost, detail, schedule, plan.batches, virtual_stages,
            self.options.remat_fwd_fraction)

    def get_cost(
        self,
        plan: InterStagePlan,
        strategies: Sequence[Strategy],
        layer_partition: Sequence[int],
        rank_types: Sequence[str] | None = None,
        schedule: str = "gpipe",
        virtual_stages: int = 1,
        _detail: dict | None = None,
    ) -> PlanCost:
        ranks = (
            list(rank_types) if rank_types is not None
            else rank_device_types(self.cluster, plan.node_sequence)
        )
        bandwidth = self._bandwidth_for(plan)
        L = self.volume.num_layers

        overlap = self.options.overlap_active
        lens: list[float] = []
        comm_by_stage: list[float] = []  # cp + ep, for breakdown reconcile
        cp_total = a2a_total = 0.0
        dp_costs: list[float] = []
        dp_exposed_costs: list[float] = []  # overlap model: max(0, dp - opt)
        opt_costs: list[float] = []
        fb_sync = pp_cost = pp_exposed = 0.0
        for stage_id, strat in enumerate(strategies):
            start_l, end_l = layer_partition[stage_id], layer_partition[stage_id + 1]
            r0, r1 = plan.stage_rank_range(stage_id)
            stage_types = ranks[r0:r1]

            stage_ms = self._stage_execution_ms(
                plan, strat, stage_types, start_l, end_l)
            # overlap window for the double-buffered boundary send: the
            # sender's compute-only per-microbatch time (cp/ep comm extends
            # the critical path and cannot hide another collective)
            compute_window = stage_ms
            mbs = plan.gbs // strat.dp // plan.batches
            cp_bw = None
            cp_ms = a2a_ms = 0.0
            if strat.cp > 1:
                # Context-parallel comm extends the stage's critical path
                # (un-overlapped model, cost/context_parallel.py): the ring
                # K/V rotation, or the Ulysses all-to-alls when the
                # strategy's cp_mode is "a2a" — cp_ms is mode-neutral, it is
                # whatever the priced cp_mode's traffic costs.
                cp_bw = self._cp_bw(bandwidth, stage_id, strat)
                cp_ms = cp_comm_ms(
                    self.volume.model, mbs, strat.cp, strat.tp,
                    attention_layer_range(self.volume.model, start_l, end_l),
                    cp_bw, mode=strat.cp_mode)
                stage_ms += cp_ms
            if strat.ep > 1:
                # MoE token all-to-all rides the links of the dp sub-group
                # the ep axis is carved from (un-overlapped model,
                # cost/expert_parallel.py).
                a2a_ms = ep_a2a_ms(
                    self.volume.model, mbs, strat.ep,
                    moe_layer_range(self.volume.model, start_l, end_l),
                    self._dp_bw(bandwidth, stage_id, strat), cp=strat.cp)
                stage_ms += a2a_ms
            comm_by_stage.append(cp_ms + a2a_ms)
            cp_total += cp_ms
            a2a_total += a2a_ms
            lens.append(stage_ms)

            if stage_id == plan.num_stages - 1:
                fb_sync = self._fb_sync_ms(stage_types, strat.tp, mbs) * plan.batches
            else:
                # cp shards the boundary activation by sequence; Megatron sp
                # additionally sequence-shards it over the tp group, so each
                # rank's p2p volume divides by tp too.
                sp_div = strat.tp if strat.sp else 1
                t_pp = self._pp_cost_ms(
                    self._activation(end_l, mbs, strat.tp) / strat.cp / sp_div,
                    self._pp_bw(bandwidth, stage_id))
                pp_cost += t_pp
                if overlap:
                    pp_exposed += max(0.0, t_pp - compute_window)

            stage_params = self.volume.stage_parameter_bytes(strat.tp, start_l, end_l)
            # Weights are replicated across cp (ring attention shards only the
            # sequence), so the gradient all-reduce spans dp*cp ranks; its ring
            # crosses both the dp and cp group links.
            sync_degree = strat.dp * strat.cp
            dp_bw = self._dp_bw(bandwidth, stage_id, strat)
            if cp_bw is not None:
                dp_bw = min(dp_bw, cp_bw)
            # Measured latency floor (calibrated bandwidth models only):
            # additive per gradient-sync ring, rescaled to this ring's steps.
            lat_fn = getattr(bandwidth, "collective_latency_ms", None)
            dp_latency = (lat_fn("all_reduce", sync_degree)
                          if lat_fn is not None else 0.0)
            # ZeRO-3 adds the backward parameter all-gather to the gradient
            # sync volume (cost/zero.py).
            zfac = zero_dp_factor(strat.zero)
            if strat.ep > 1:
                # Expert weights shard 1/ep: each shard all-reduces over the
                # dp*cp/ep replicas that hold it; dense weights over dp*cp.
                block_params = self.volume.stage_parameter_bytes(
                    strat.tp, max(start_l, 1), min(end_l, L - 1))
                expert_bytes = (block_params
                                * expert_param_fraction(self.volume.model)
                                / strat.ep)
                # two rings, two latency floors: the dense ring over all
                # sync_degree ranks, the expert ring over its 1/ep subgroup.
                # Volume terms charge only the measured exposed share
                # (overlap calibration); the alpha/latency floors stay fully
                # charged — a ring's startup cost cannot hide under compute.
                ep_latency = (lat_fn("all_reduce", sync_degree // strat.ep)
                              if lat_fn is not None else 0.0)
                dp_costs.append(zfac * (
                    self._dp_cost_ms(stage_params - expert_bytes * strat.ep,
                                     dp_bw, sync_degree)
                    + self._dp_cost_ms(expert_bytes, dp_bw,
                                       sync_degree // strat.ep))
                    * self.options.dp_exposed_share
                    + dp_latency + ep_latency)
            else:
                dp_costs.append(
                    zfac * self._dp_cost_ms(stage_params, dp_bw, sync_degree)
                    * self.options.dp_exposed_share
                    + dp_latency)

            opt_type = None if self.options.strict_compat else stage_types[0]
            # ZeRO >=1 shards the optimizer step itself over the data ranks.
            opt_shard = strat.data_ranks if strat.zero >= 1 else 1
            opt_costs.append(
                self._optimizer_ms(opt_type) / strat.tp / opt_shard
                * (end_l - start_l) / L)
            if overlap:
                # chunked gradient all-reduce overlaps the optimizer step:
                # only what outlasts this stage's optimizer stays exposed
                # (the latency floors inside dp_costs are charged within it)
                dp_exposed_costs.append(
                    max(0.0, dp_costs[-1] - opt_costs[-1]))

        # the schedule is a plan axis (cost/schedule.py): gpipe reproduces
        # the reference fill-drain verbatim; 1f1b adds the remat factor;
        # interleaved prices the implemented group-drain bubble and its
        # vs-times-more pp boundary crossings.
        # UNEVEN 1f1b partitions run on the LOCKSTEP shard_map executor
        # with every stage padded to the largest stage's block count
        # (execution.pipeline) — each ppermute-barriered tick costs the max
        # stage's time on EVERY device, so pricing must level the lens to
        # max(lens) or uneven plans come out systematically under-priced
        # (for even splits leveling is an identity: the fill-drain formula
        # already reduces to ticks * max).
        sched_lens = lens
        if schedule == "1f1b" and len(set(lens)) > 1:
            sched_lens = [max(lens)] * len(lens)
        execution = schedule_execution_ms(
            schedule, sched_lens, plan.batches, virtual_stages,
            remat_fraction=self.options.remat_fwd_fraction)
        send_factor = schedule_pp_send_factor(
            schedule, plan.num_stages, virtual_stages)
        pp_cost *= send_factor
        if overlap:
            pp_exposed *= send_factor
        # cp_comm_ms / ep_comm_ms report exactly the cp (ring or a2a) /
        # MoE all-to-all traffic's contribution to the schedule's execution
        # total (the with-comm minus without-comm delta, split pro rata), so
        # the breakdown fields reconcile for the validator.
        lens_nocomm = [l - c for l, c in zip(sched_lens, comm_by_stage)]
        comm_delta = execution - schedule_execution_ms(
            schedule, lens_nocomm, plan.batches, virtual_stages,
            remat_fraction=self.options.remat_fwd_fraction)
        comm_total = cp_total + a2a_total
        cp_cost = comm_delta * cp_total / comm_total if comm_total else 0.0
        ep_cost = comm_delta * a2a_total / comm_total if comm_total else 0.0
        # fitted per-program fixed cost (after comm_delta so the cp/ep
        # breakdown split excludes it); pairs limited to the (type, tp)
        # configurations the stages actually run.  Charged once per step
        # for RECTANGULAR plans (build_executable routes them to the gspmd /
        # shard_map-pipeline executors, which scan microbatches inside one
        # jit) but once per MICROBATCH for non-rectangular plans — the
        # multi-mesh executor dispatches each stage's program per
        # microbatch from a Python loop (execution/hetero.py), so its
        # per-program cost recurs plan.batches times.
        overhead_pairs: list[tuple[str, int]] = []
        for stage_id, strat in enumerate(strategies):
            r0, r1 = plan.stage_rank_range(stage_id)
            overhead_pairs.extend((t, strat.tp) for t in set(ranks[r0:r1]))
        rectangular = (
            len({(s.dp, s.tp, s.cp, s.ep) for s in strategies}) == 1
            and len(set(ranks)) <= 1)
        overhead = self._step_overhead_ms(overhead_pairs)
        if rectangular:
            overhead_term = overhead  # signed: the affine extrapolation
        else:
            # a real dispatch cannot cost negative time — a noise-negative
            # intercept must not get amplified by the microbatch count
            overhead_term = max(overhead, 0.0) * plan.batches
        execution += overhead_term
        first_stage_type = ranks[0] if ranks else None
        batch_gen = self._batch_gen_ms(plan.batches, first_stage_type)

        # Overlap model: charge only the exposed remainders — the per-stage
        # max of the dp sync that outlasts its optimizer, and the boundary
        # sends that outlast their sender's compute.  PlanCost stays
        # additive; the hidden share is reported through ``_detail``.
        if overlap:
            dp_charge = max(dp_exposed_costs)
            pp_charge = pp_exposed
        else:
            dp_charge = max(dp_costs)
            pp_charge = pp_cost

        total = (execution + fb_sync + max(opt_costs) + dp_charge
                 + pp_charge + batch_gen)
        recovery = 0.0
        spot_scale = self._spot_scale(plan)
        if spot_scale:
            recovery = total * spot_scale
            total = total + recovery
        migration = self._migration_ms(
            tuple(s.tp for s in strategies), tuple(layer_partition))
        if migration:
            total = total + migration

        if _detail is not None:
            # explainability dump (get_breakdown): the exact intermediates
            # the total was assembled from, so the component decomposition
            # reconciles with the ranked scalar by construction
            _detail.update(
                sched_lens=tuple(sched_lens),
                lens_nocomm=tuple(lens_nocomm),
                comm_by_stage=tuple(comm_by_stage),
                dp_costs=tuple(dp_exposed_costs if overlap else dp_costs),
                opt_costs=tuple(opt_costs),
                overhead_ms=overhead_term)
            if overlap:
                _detail["overlap_hidden"] = {
                    "pp_comm": pp_cost - pp_charge,
                    "dp_comm": max(dp_costs) - dp_charge,
                }
            if recovery:
                _detail["spot_recovery"] = recovery
            if migration:
                _detail["migration"] = migration

        return PlanCost(
            total_ms=total,
            execution_ms=execution,
            fb_sync_ms=fb_sync,
            optimizer_ms=max(opt_costs),
            dp_comm_ms=dp_charge,
            pp_comm_ms=pp_charge,
            batch_gen_ms=batch_gen,
            cp_comm_ms=cp_cost,
            ep_comm_ms=ep_cost,
            expected_recovery_ms=recovery,
            migration_ms=migration,
        )
