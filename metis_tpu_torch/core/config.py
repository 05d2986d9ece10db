"""Typed configuration — one source of truth for model shape and search knobs.

The port's copy of ``metis_tpu/core/config.py``.

Replaces the reference's three-tier config (bash env vars → flat argparse with
no defaults → two cluster files; SURVEY.md §5 "Config / flag system",
``arguments.py:5-49``) with validated dataclasses.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from metis_tpu_torch.core.errors import MetisError


@dataclass(frozen=True)
class ModelSpec:
    """Transformer model shape (≅ reference ``utils.py:72-79`` ModelConfig).

    ``num_layers`` counts *profiled* layers including the embedding (first) and
    LM-head (last) pseudo-layers, matching the reference profile contract
    (``profile_data_samples``: 10 entries = embed + 8 blocks + head).
    """

    name: str
    num_layers: int
    hidden_size: int
    sequence_length: int
    vocab_size: int
    num_heads: int
    ffn_multiplier: int = 4
    dtype_bytes: int = 2  # bf16 activations — the TPU-native default
    # MoE shape (0 experts = dense model; no reference counterpart —
    # SURVEY.md §2.2 "EP — Absent"):
    num_experts: int = 0
    expert_top_k: int = 1
    # model family: "gpt" (learned positions, GELU MLP) or "llama"
    # (RMSNorm/RoPE/GQA/SwiGLU — models.llama); the reference knows only the
    # GPT shape (``arguments.py:23-28``)
    family: str = "gpt"
    num_kv_heads: int = 0  # GQA KV heads for family="llama"; 0 -> num_heads
    # attention implementation the executors AND the profiler use: "dense"
    # (materialized scores) or "flash" (pallas blockwise kernel).  Part of the
    # model spec, not a runtime flag, so profiles/plans/validation all
    # describe the execution that actually runs (the reference's profile
    # contract intent, ``README.md:41-59``).
    attn: str = "dense"

    def __post_init__(self) -> None:
        if self.num_layers < 3:
            raise ValueError("num_layers must include embed + >=1 block + head")
        if self.hidden_size % self.num_heads != 0:
            raise ValueError("num_heads must divide hidden_size evenly")
        if self.num_experts < 0 or self.expert_top_k < 1:
            raise ValueError("invalid MoE shape")
        if self.num_experts > 0 and self.expert_top_k > self.num_experts:
            raise ValueError("expert_top_k cannot exceed num_experts")
        if self.family not in ("gpt", "llama"):
            raise ValueError(f"unknown model family {self.family!r}")
        if self.num_kv_heads and self.num_heads % self.num_kv_heads != 0:
            raise ValueError("num_kv_heads must divide num_heads")
        if self.attn not in ("dense", "flash"):
            raise ValueError(f"unknown attention impl {self.attn!r}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_blocks(self) -> int:
        """Transformer blocks proper (excluding embed/head pseudo-layers)."""
        return self.num_layers - 2


@dataclass(frozen=True)
class SearchConfig:
    """Search-space knobs (≅ reference "hetspeed" args, ``arguments.py:42-49``).

    ``strict_compat`` reproduces the reference cost model's unit conventions
    and documented quirks bit-for-bit so golden-parity tests can check our
    estimator against ``results/hetero_cost_model`` (SURVEY.md §7 "Reference
    quirk triage").  Native mode (default) fixes them:

    - activation volumes in bytes (dtype-aware), not element counts
      (ref ``activation_parameter.py:29-32``)
    - inter-node bandwidth actually reads the inter field
      (ref ``gpu_cluster.py:52-58`` returns intra for both)
    - hetero-stage memory lookups use each replica's own device type
      (ref ``load_balancer.py:51`` always reads ``device_types[0]``)
    """

    gbs: int
    max_profiled_tp: int = 4
    max_profiled_bs: int = 16
    min_group_scale_variance: float = 1.0
    max_permute_len: int = 6
    mem_coef: float = 5.0  # ref load_balancer.py:31 fudge factor
    # Optimizer-time multiplier.  None = auto: 2.0 under strict_compat (the
    # reference doubles the profiled time at load, data_loader.py:19), 1.0
    # native (the executors run the profiled adamw update exactly once per
    # step inside the same jit — the on-chip sweep pins the doubling as a
    # +5% bias, calibration/tpu_validation_sweep.json).
    optimizer_factor: float | None = None
    max_partition_attempts: int = 3  # ref load_balancer.py:123
    strict_compat: bool = False
    # TPU extensions (no reference counterpart):
    enable_sp: bool = False  # add sequence-parallel variants to the plan space
    enable_cp: bool = False  # add context-parallel (ring attention) variants
    max_cp_degree: int = 1
    enable_ep: bool = False  # add expert-parallel (MoE) variants
    max_ep_degree: int = 1
    enable_zero: bool = False  # add ZeRO-1/2/3 sharded-state variants
    # add 1f1b/interleaved pipeline-SCHEDULE variants to the plan space
    # (cost/schedule.py; gpipe is always searched — it is the reference
    # baseline formula, cost_estimator.py:129)
    enable_schedule_search: bool = False
    virtual_stage_candidates: tuple[int, ...] = (2,)
    # measured fraction of dp gradient sync hidden under backward compute
    # (cost/calibration.measure_dp_overlap); 0.0 = serial, the reference's
    # model and the only strict_compat behavior
    dp_overlap_fraction: float = 0.0
    # measured fwd share of a profiled fwd+bwd layer time
    # (profiles.profiler.measure_remat_fraction) — the work a
    # rematerializing schedule (1f1b/interleaved) runs twice; None uses
    # the analytic 1/3 (cost/schedule.REMAT_FWD_FRACTION)
    remat_fwd_fraction: float | None = None
    # Search-scalability pruning (search/prune.py).
    # ``prune_to_top_k=K`` enables the EXACT execution-lower-bound prune:
    # candidates that provably cannot enter the best K are skipped (the
    # returned top-K ranking is identical to exhaustive, assuming per-layer
    # profile times are non-decreasing in batch size; the tail beyond K is
    # dropped).  ``beam_patience=N`` additionally stops each
    # (placement, stage-count) class after N consecutive candidates that
    # failed to enter the top K — INEXACT (anytime beam), requires
    # prune_to_top_k.  Both are off by default and under strict_compat.
    prune_to_top_k: int | None = None
    beam_patience: int | None = None
    # Emit a ``search_progress`` heartbeat event every N processed intra
    # candidates when an EventLog is attached (core/trace.Heartbeat):
    # candidates/sec, best-cost-so-far, elapsed — a long search is
    # observable while running (``tail -f`` the events file)
    progress_every: int = 1000
    # Shard the inter-stage candidate stream across N multiprocessing
    # workers (search/parallel.py).  1 = the serial loop; >1 is transparent:
    # the merged ranking is byte-identical to serial (index-stride sharding
    # + stable tie-break) and the planner falls back to serial — emitting a
    # ``parallel_fallback`` event — when no start method is available or the
    # search inputs cannot be pickled.
    workers: int = 1
    # Batched table-driven costing (cost/batch.BatchCostEstimator): the
    # search loops collect each inter plan's intra candidates and price
    # them against precomputed stage-time/placement tables instead of
    # walking the scalar estimator per candidate.  Bit-identical results by
    # construction (the scalar path is the parity oracle —
    # tools/check_search_regression.py); False forces the scalar loop.
    use_batch_eval: bool = True
    # Overlap-aware comm pricing (cost/estimator.py): charge only the
    # EXPOSED share of each collective — per pp boundary
    # ``max(0, send - sender stage compute)`` (the executor double-buffers
    # the ppermute under the next tick's compute) and per stage
    # ``max(0, dp sync - optimizer)`` (the chunked gradient all-reduce
    # overlaps the optimizer step).  The hidden remainder is reported in
    # ``CostBreakdown.hidden``.  Inert under strict_compat (the reference
    # prices every collective fully exposed); False restores the serial
    # pricing in native mode too.
    use_overlap_model: bool = True
    # Availability-aware pricing (cost/estimator.py): add an additive
    # ``expected_recovery`` term — the plan's preemption hazard (sum of
    # per-rank ``DeviceSpec.hazard_per_hr`` over the device set) times the
    # measured time-to-recover — so the planner ranks by availability-
    # adjusted goodput on spot-tier fleets.  Reserved-only fleets price a
    # hazard of exactly 0, leaving every cost bit-identical to the model
    # with the flag off.  Inert under strict_compat (the reference knows
    # no availability tiers); False disables it in native mode too.
    use_spot_model: bool = True
    # Expected seconds to recover from one preemption (shrink -> replan ->
    # restore).  Seeded from the bench ``resilience_recover_s`` headline
    # (the chaos drill's measured time-to-recover); refit from observed
    # recoveries via ``cost/calibration.fit_recovery_seconds``.
    spot_recover_s: float = 30.0
    # Migration-aware pricing (cost/estimator.py): when a replan searches
    # with ``migrate_from`` set — the incumbent plan's per-stage layout as a
    # tuple of (tp, layer_start, layer_end) triples — add an additive
    # ``migration`` term: the parameter bytes the candidate must move off
    # their current shards (execution/reshard.py computes the same delta
    # for the live transfer), amortized over ``migration_amortize_steps``.
    # An empty ``migrate_from`` (the default, and every fresh search)
    # prices exactly 0.0 and stays byte-identical to the model being off.
    # Inert under strict_compat.
    use_migration_model: bool = True
    migrate_from: tuple = ()
    migration_bw_gbps: float = 100.0
    migration_amortize_steps: int = 1000
    # Cost-tensor backend for the batched costing path (cost/batch.py):
    # "numpy" is the table-driven scalar-float path — the default and the
    # parity oracle.  The reference's "jax" backend (a jit-compiled f64
    # kernel) is not ported: asking for it raises MetisError here, so no
    # search ever prices with numpy under the jax name.
    cost_backend: str = "numpy"
    # Symmetry-collapsed search (AMP-style, arXiv 2210.07297): placements
    # that differ only by a permutation of cost-interchangeable device
    # types (identical DeviceSpec cost fields, profiles, and type meta —
    # search/device_groups.type_equivalence_classes) are costed once and
    # the cached result stream replayed for the equivalent candidates
    # (search/parallel.py).  Byte-identical rankings by construction —
    # the replay re-runs every counter and pruner hook; clusters with no
    # equivalent types skip the memo entirely.  False disables it.
    symmetry_collapse: bool = True
    # Search backend (planner/api.plan_hetero dispatch): "beam" is the
    # prune/beam walk above — fast, anytime, INEXACT once beam_patience is
    # set; "exact" is the branch-and-bound backend (search/exact.py) that
    # explores the same candidate space under admissible relaxation bounds
    # and terminates with an optimality Certificate (proven lower bound +
    # gap) attached to the PlannerResult and emitted as a ``certificate``
    # event.  Exact runs serially (workers is ignored).
    backend: str = "beam"
    # Consult the exact backend's tighter relaxation bound (stage-time
    # floors + per-term minima from the estimator's own tables,
    # search/exact.RelaxationBound) as an ADDITIONAL admit-time filter in
    # the default beam search (prune.bound.tight counter).  Admissible by
    # construction, so the returned top-K ranking stays byte-identical to
    # the stock bound — gated by tools/check_search_regression.py the same
    # way symmetry collapse is.  Inert unless prune_to_top_k is set.
    tight_bound: bool = True
    # Wall-clock budget for the exact backend's branch-and-bound loop in
    # seconds (None = run to proven optimality).  On expiry the search
    # keeps its incumbent and certifies the REMAINING gap — the
    # Certificate reports complete=False and the proven bound at stop.
    exact_deadline_s: float | None = None
    # Risk-aware ranking knobs (cost/uncertainty.py).  risk_quantile
    # ranks candidates by the given tail quantile of their residual
    # cost distribution (fit from the accuracy ledger); cvar_alpha
    # ranks by CVaR-alpha (expected cost in the worst 1-alpha tail).
    # Both default to 0.0 = point mode, which is byte-identical to the
    # pre-uncertainty behavior; when set they must lie in [0.5, 1) —
    # the >= 0.5 floor keeps every risk score >= the point estimate,
    # so the point-cost pruning bounds stay admissible.  Mutually
    # exclusive; a fitted ResidualModel must be supplied at plan time
    # or the knobs are inert.  Both are fingerprint-significant, so the
    # serve daemon caches per-quantile automatically.
    risk_quantile: float = 0.0
    cvar_alpha: float = 0.0

    def __post_init__(self) -> None:
        if self.gbs < 1:
            raise ValueError("gbs must be positive")
        if self.spot_recover_s < 0:
            raise ValueError("spot_recover_s must be >= 0")
        if self.migration_bw_gbps <= 0:
            raise ValueError("migration_bw_gbps must be > 0")
        if self.migration_amortize_steps < 1:
            raise ValueError("migration_amortize_steps must be >= 1")
        if self.max_permute_len < 1:
            raise ValueError("max_permute_len must be >= 1")
        if any(v < 2 for v in self.virtual_stage_candidates):
            raise ValueError("virtual_stage_candidates must all be >= 2")
        if self.progress_every < 1:
            raise ValueError("progress_every must be >= 1")
        if self.workers < 1:
            raise ValueError("workers must be >= 1")
        if self.cost_backend not in ("numpy", "jax"):
            raise ValueError(
                f"cost_backend must be 'numpy' or 'jax', "
                f"got {self.cost_backend!r}")
        if self.cost_backend == "jax":
            raise MetisError(
                "cost_backend='jax' is not available in the PyTorch port; "
                "use cost_backend='numpy'")
        if self.backend not in ("beam", "exact"):
            raise ValueError(
                f"backend must be 'beam' or 'exact', got {self.backend!r}")
        if self.exact_deadline_s is not None and self.exact_deadline_s < 0:
            raise ValueError("exact_deadline_s must be >= 0")
        for name, v in (("risk_quantile", self.risk_quantile),
                        ("cvar_alpha", self.cvar_alpha)):
            if v and not 0.5 <= v < 1.0:
                raise ValueError(
                    f"{name} must be 0 (off) or in [0.5, 1), got {v!r}")
        if self.risk_quantile and self.cvar_alpha:
            raise ValueError(
                "risk_quantile and cvar_alpha are mutually exclusive")


@dataclass(frozen=True)
class ResilienceConfig:
    """Fault-tolerance knobs for the training supervisor
    (``resilience/supervisor.py``) — how often to checkpoint, how hard to
    retry transient IO, and how to judge/answer loss anomalies."""

    # checkpoint cadence in steps (0 = final checkpoint only — a device
    # loss then has nothing to restore, so drills want >= 1)
    checkpoint_every: int = 1
    # retained previous checkpoint: the corruption-fallback generation
    keep_prev: bool = True
    # transient-IO retry shape (resilience/retry.RetryPolicy)
    retry_attempts: int = 3
    retry_base_delay_s: float = 0.05
    retry_max_delay_s: float = 2.0
    # loss anomaly guard (execution/train.LossAnomalyDetector): a step
    # loss > spike_factor x the rolling mean of the last spike_window
    # healthy losses is a spike; NaN/inf is always an anomaly
    spike_factor: float = 10.0
    spike_window: int = 8
    # roll back to the latest valid checkpoint on NaN/inf loss (spikes are
    # reported but never rolled back — they are usually survivable)
    restore_on_anomaly: bool = True
    # give up after this many recoveries (device loss + anomaly rollbacks
    # combined) — a persistently failing run must fail, not loop
    max_recoveries: int = 8
    # prefer live in-memory resharding over checkpoint-restore on replan
    # when the old and new device sets intersect and the priced transfer
    # beats the measured restore time (resilience/supervisor.py migration
    # decision layer; any migration fault falls back to checkpoint-restore)
    live_migration: bool = True

    def __post_init__(self) -> None:
        if self.checkpoint_every < 0:
            raise ValueError("checkpoint_every must be >= 0")
        if self.retry_attempts < 1:
            raise ValueError("retry_attempts must be >= 1")
        if self.spike_factor <= 1.0:
            raise ValueError("spike_factor must exceed 1.0")
        if self.spike_window < 1:
            raise ValueError("spike_window must be >= 1")
        if self.max_recoveries < 0:
            raise ValueError("max_recoveries must be >= 0")
