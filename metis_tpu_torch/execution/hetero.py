"""Non-uniform hetero plan execution — the port of
``metis_tpu/execution/hetero.py``.

The planner's flagship output — non-uniform layer partitions, per-stage
strategies and the data balancer's uneven per-replica microbatch rows
(reference ``load_balancer.py:155-179``) — runs as one process per device:
stage s on its own range of ranks, laid out as the reference lays out its
stage mesh (``mesh.StageGrid``), each rank a Megatron shard of the stage's
blocks (``execution/stages.py`` has the runtime both multi-stage executors
share).  Every stage strategy the reference's hetero executor runs runs
here:

- ``(dp, tp)``, the data balancer's uneven replica rows, and a stage of
  several device-type groups (``StageSpec.replica_groups``): each replica
  runs only its rows, so a dense stage needs no padding and no sub-meshes,
  and a group given 0 rows computes nothing;
- ZeRO 1, 2 and 3 over the stage's dp group (``zero``);
- context parallelism over a stage-local sp group (``cp``), ring attention
  or Ulysses by ``cp_mode``, each rank at its absolute positions;
- expert parallelism inside dp (``ep``: the rows over the stage's ``(dp /
  ep, ep)`` ranks, the experts over ep);
- MoE: the aux loss threaded through the stages with the reference's
  per-stage weight ``num_blocks / total_blocks``, ``valid_mask`` over the
  padded rows of an uneven stage, and each device-type group of a mixed
  stage routing its own tokens.

As in the reference, a stage with zero, cp or ep runs its device-type
groups as one program, and ``sp`` is not read: a hetero plan with Megatron
sequence parallelism trains without it.

As in the reference the schedule is a fill and a drain: every microbatch
forward (each stage stores only its boundary inputs), then every backward
in reverse microbatch order, each stage recomputing its forward inside its
backward (stage-level remat, the GPipe activation footprint the planner's
memory model charges); the last stage runs its forward and backward back
to back.  Gradients are the mean over the microbatches (each replica's
loss carries 1 / M) before one AdamW step per stage.

The GPT, LLaMA and MoE families run here (their stage pieces come from
``models.family_ops``, as in the reference).  The refusals are the
reference's (``stage_specs_from_plan``): cp on an MoE stage, a cp that
does not divide the sequence, ep on a dense config or an ep that does not
divide dp and the experts.  MoE routing groups that straddle the
replicas of a stage are shared by them (``execution/stages.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Sequence

from metis_tpu_torch.core.device import resolve_device
from metis_tpu_torch.execution.mesh import SP, StageGrid, stage_meshes
from metis_tpu_torch.execution.stages import (
    StageRunner,
    Unit,
    fill_drain_ticks,
    replica_counts,
)
from metis_tpu_torch.execution.train import build_optimizer
from metis_tpu_torch.models import family_ops, resolve_attention
from metis_tpu_torch.models.gpt import GPTConfig


@dataclass(frozen=True)
class StageSpec:
    """One pipeline stage of a hetero plan, execution-ready.

    ``blocks`` is the [lo, hi) transformer-block range (converted from the
    planner's profile-layer boundaries — profile layer 0 is the embedding
    pseudo-layer, layer ``num_blocks + 1`` the LM head, matching
    ``GPTConfig.num_profile_layers``).  ``replica_rows`` carries the uneven
    per-replica microbatch rows from the data balancer (None = even split).
    ``replica_groups`` (sizes in replicas, summing to ``dp``) marks the
    device-type groups of a mixed-type stage; without ``replica_rows`` each
    group runs ``rows * dp_g / dp`` rows, as in the reference, and an MoE
    group routes its own tokens.  ``zero`` (0-3), ``ep`` (inside dp, MoE
    only) and ``cp`` with its ``cp_mode`` (``"ring"`` or ``"a2a"``) are the
    stage's axes (module doc)."""

    blocks: tuple[int, int]
    has_embed: bool
    has_head: bool
    dp: int
    tp: int
    zero: int = 0
    ep: int = 1
    cp: int = 1
    cp_mode: str = "ring"
    replica_rows: tuple[int, ...] | None = None
    replica_groups: tuple[int, ...] | None = None

    @property
    def devices(self) -> int:
        return self.dp * self.cp * self.tp

    @property
    def num_blocks(self) -> int:
        return self.blocks[1] - self.blocks[0]


def stage_specs_from_plan(
    layer_partition: Sequence[int],
    strategies: Sequence,
    cfg: GPTConfig,
    stage_replica_rows: Sequence[Sequence[int] | None] | None = None,
    stage_replica_groups: Sequence[Sequence[int] | None] | None = None,
) -> tuple[StageSpec, ...]:
    """Convert planner output (profile-layer boundaries + per-stage
    strategies) into executable StageSpecs.

    ``strategies`` entries may be ``core.types.Strategy`` objects or the
    dicts a ``PlanArtifact`` stores."""
    bounds = list(layer_partition)
    n_profile = cfg.num_profile_layers
    if bounds[0] != 0 or bounds[-1] != n_profile:
        raise ValueError(
            f"layer_partition {bounds} must span [0, {n_profile}] "
            f"(= num_blocks + embed + head profile layers)")
    if len(bounds) != len(strategies) + 1:
        raise ValueError(
            f"{len(strategies)} strategies need {len(strategies) + 1} "
            f"partition boundaries, got {len(bounds)}")

    out = []
    for s, strat in enumerate(strategies):
        if isinstance(strat, dict):
            dp, tp = strat["dp"], strat["tp"]
            zero = strat.get("zero", 0)
            cp, ep = strat.get("cp", 1), strat.get("ep", 1)
            cp_mode = strat.get("cp_mode", "ring")
        else:
            dp, tp, zero = strat.dp, strat.tp, strat.zero
            cp, ep = strat.cp, strat.ep
            cp_mode = strat.cp_mode
        _check_axes(s, cfg, dp, cp, ep)
        lo, hi = bounds[s], bounds[s + 1]
        rows = None
        if stage_replica_rows is not None and stage_replica_rows[s] is not None:
            rows = tuple(stage_replica_rows[s])
            if len(rows) != dp:
                raise ValueError(
                    f"stage {s}: {len(rows)} replica rows for dp={dp}")
        groups = None
        if (stage_replica_groups is not None
                and stage_replica_groups[s] is not None):
            groups = tuple(stage_replica_groups[s])
            if sum(groups) != dp:
                raise ValueError(
                    f"stage {s}: replica_groups {groups} must sum to dp={dp}")
        out.append(StageSpec(
            blocks=(max(lo - 1, 0), min(hi - 1, cfg.num_blocks)),
            has_embed=lo == 0,
            has_head=hi == n_profile,
            dp=dp, tp=tp, zero=zero, ep=ep, cp=cp, cp_mode=cp_mode,
            replica_rows=rows, replica_groups=groups))
    return tuple(out)


def _check_axes(s: int, cfg: GPTConfig, dp: int, cp: int, ep: int) -> None:
    """The reference's refusals of a stage's axes, in its words."""
    is_moe = family_ops(cfg).moe
    if cp > 1 and is_moe:
        raise NotImplementedError(
            f"stage {s}: cp+MoE stages have no execution path "
            "(ring attention composes with dense families)")
    if cp > 1 and cfg.seq_len % cp:
        raise ValueError(
            f"stage {s}: cp={cp} must divide seq_len={cfg.seq_len}")
    if ep > 1 and not is_moe:
        raise ValueError(f"stage {s}: ep={ep} needs an MoE config")
    if ep > 1 and (dp % ep or cfg.num_experts % ep):
        raise ValueError(
            f"stage {s}: ep={ep} must divide dp={dp} and "
            f"num_experts={cfg.num_experts}")


def check_stage_axes(cfg: GPTConfig, stages: Sequence[StageSpec]) -> None:
    """Refuse what the reference refuses of explicit ``StageSpec``s
    (``stage_specs_from_plan`` checks the planner's), and values no
    executor knows."""
    for s, spec in enumerate(stages):
        _check_axes(s, cfg, spec.dp, spec.cp, spec.ep)
        if spec.zero not in (0, 1, 2, 3):
            raise ValueError(f"stage {s}: zero={spec.zero}: expected 0-3")
        if spec.cp_mode not in ("ring", "a2a"):
            raise ValueError(f"stage {s}: unknown cp_mode {spec.cp_mode!r}")


def _grouped(spec: StageSpec) -> bool:
    """Whether a stage runs its device-type groups as programs of their own
    (the reference's per-type sub-meshes: never with zero, cp or ep)."""
    return (spec.replica_groups is not None and len(spec.replica_groups) > 1
            and spec.zero == 0 and spec.cp == 1 and spec.ep == 1)


def hetero_runner(cfg: GPTConfig, stages: Sequence[StageSpec],
                  device="cuda", optimizer=None, attn_impl=None) -> StageRunner:
    """This rank's part of the multi-stage executor for a non-uniform hetero
    plan, inside a process group of the plan's size (a one-device plan also
    runs outside one).  Boundary sends are waited for two exchanges late
    (``StageRunner``'s overlap); the dp reduction is one collective per
    leaf.  ``attn_impl`` replaces the attention of stages without cp."""
    stages = tuple(s if _grouped(s) else dataclasses.replace(s, replica_groups=None)
                   for s in stages)
    check_stage_axes(cfg, stages)
    dev = resolve_device(device)
    grids = [StageGrid(s.dp, s.tp, s.cp, s.ep) for s in stages]
    mesh = stage_meshes(grids)
    s = mesh.index("pp")
    spec, S = stages[s], len(stages)
    unit = Unit(0, spec.num_blocks, spec.has_embed, spec.has_head,
                s - 1 if s > 0 else None, s + 1 if s < S - 1 else None)
    if spec.cp > 1:
        attn = resolve_attention(cfg, mesh.group(SP), spec.cp_mode)
    else:
        attn = attn_impl or resolve_attention(cfg)

    def counts(rows):
        return [replica_counts(rows, st.dp, st.replica_rows, st.replica_groups)
                for st in stages]

    return StageRunner(
        cfg, mesh, grids, counts, [unit], range(*spec.blocks),
        partial(fill_drain_ticks, S, s), remat=True, device=dev,
        optimizer=optimizer or build_optimizer(), attn=attn, overlap=True,
        chunked_dp=False, zero=spec.zero, programs=spec.replica_groups,
        aux_weight=spec.num_blocks / max(cfg.num_blocks, 1))


def make_hetero_train_step(cfg: GPTConfig, stages: Sequence[StageSpec],
                           device="cuda", optimizer=None, attn_impl=None):
    """Build the multi-stage executor for a non-uniform hetero plan.

    Returns ``(init_fn, step_fn)``: ``init_fn(seed_or_params)`` gives this
    rank's ``TrainState`` (its stage's leaves, sliced from one full
    ``init_params`` draw so they equal the single-device model's);
    ``step_fn(state, tokens_mbs, targets_mbs) -> (state, loss)`` takes
    microbatch-major ``[M, rows, seq]`` tokens and targets, whole on every
    rank, and returns the global loss on every rank."""
    runner = hetero_runner(cfg, stages, device, optimizer, attn_impl)
    return runner.init, runner.step


def plan_replica_groups(
    inter,
    strategies: Sequence,
    cluster,
) -> list[tuple[int, ...] | None]:
    """Per-stage device-TYPE group sizes (in replicas) of mixed-type stages
    (``StageSpec.replica_groups``).  Homogeneous stages — and mixed stages
    carrying zero/cp/ep axes — return None."""
    from metis_tpu_torch.balance.data import replica_chunks
    from metis_tpu_torch.balance.stage_perf import rank_device_types

    ranks = rank_device_types(cluster, inter.node_sequence)
    out: list[tuple[int, ...] | None] = []
    for stage_id, strat in enumerate(strategies):
        start, end = inter.stage_rank_range(stage_id)
        types = ranks[start:end]
        zero = getattr(strat, "zero", 0)
        cp = getattr(strat, "cp", 1)
        ep = getattr(strat, "ep", 1)
        if len(set(types)) == 1 or zero or cp > 1 or ep > 1:
            out.append(None)
            continue
        rep_types = [c[0] for c in replica_chunks(types, strat.dp)]
        groups: list[int] = []
        prev = None
        for t in rep_types:
            if t == prev:
                groups[-1] += 1
            else:
                groups.append(1)
                prev = t
        out.append(tuple(groups) if len(groups) > 1 else None)
    return out


def plan_replica_rows(
    inter,
    strategies: Sequence,
    cluster,
    profiles,
) -> list[tuple[int, ...] | None]:
    """Per-stage uneven replica row counts from the data balancer — the
    execution-side consumer of Metis's signature feature (reference
    ``partition_data``, ``load_balancer.py:155-179``).  Homogeneous stages
    return None (an even split)."""
    from metis_tpu_torch.balance.data import DataBalancer
    from metis_tpu_torch.balance.stage_perf import rank_device_types

    balancer = DataBalancer(profiles)
    ranks = rank_device_types(cluster, inter.node_sequence)
    mb = inter.gbs // inter.batches
    out: list[tuple[int, ...] | None] = []
    for stage_id, strat in enumerate(strategies):
        start, end = inter.stage_rank_range(stage_id)
        types = ranks[start:end]
        if len(set(types)) == 1:
            out.append(None)
        else:
            out.append(tuple(balancer.partition(types, strat.dp, strat.tp, mb)))
    return out


def make_hetero_train_step_from_artifact(
    cfg: GPTConfig,
    artifact,
    device="cuda",
    optimizer=None,
    stage_replica_rows: Sequence[Sequence[int] | None] | None = None,
):
    """PlanArtifact -> executable hetero step (the plan-to-execution bridge
    for non-rectangular plans)."""
    stages = stage_specs_from_plan(
        artifact.layer_partition, artifact.strategies, cfg,
        stage_replica_rows=stage_replica_rows)
    groups = tuple(artifact.device_groups)
    if groups and groups != tuple(s.devices for s in stages):
        raise ValueError(
            f"device_groups {groups} disagree with strategies "
            f"{tuple(s.devices for s in stages)}")
    return make_hetero_train_step(cfg, stages, device=device,
                                  optimizer=optimizer)

