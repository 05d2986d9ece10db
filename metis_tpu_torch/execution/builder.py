"""PlanArtifact -> executable training step — the port of
``metis_tpu/execution/builder.py``.

``build_executable`` routes a plan as the reference does
(``plan_route``):

- **gspmd** for rectangular pp = 1 plans: one device outside a process
  group (``kind="single_device"``), or one rank per device of a process
  group of the plan's size — Megatron tensor parallelism plus data-parallel
  gradient means, context parallelism (``cp``, ring or Ulysses by
  ``cp_mode``), Megatron sequence parallelism (``sp``) and ZeRO 1-3
  (``zero``) (``execution/train.py``);
- **pipeline** (``execution/pipeline.py``) for rectangular pp > 1 plans
  with one (dp, tp) strategy, zero = 0, cp = ep = 1 and sp off, whose
  blocks split evenly over the stages, or unevenly under 1f1b — the
  schedules gpipe, 1f1b and interleaved;
- **hetero** (``execution/hetero.py``) for every other multi-stage plan:
  non-uniform layer partitions, per-stage (dp, tp), the data balancer's
  uneven replica rows, and per-stage ZeRO 1-3, context parallelism (ring or
  Ulysses) and expert parallelism; Megatron sp is not read there, as in
  the reference.

A multi-device plan runs one rank per device, started by
``execution.dist.spawn``, and is built on every rank.  Expert parallelism
runs for MoE configs (dp x ep x tp, the rows over ``(dp, ep)``) on the
gspmd and hetero routes; ep on a dense config raises ``ValueError`` as in
the reference.  The refusals are the reference's (on the hetero route: cp
on an MoE stage, a cp that does not divide the sequence, an ep that does
not divide dp and the experts).  MoE routes in the reference's groups on
both routes, whatever rows and block of the sequence a rank holds
(``models.moe.SharedGroups``).  The pipeline route
runs the GPT family only, as the reference's; the hetero and gspmd routes
run GPT, LLaMA and MoE.

Every path is normalized to ``(init, step)`` as in the reference:
``init(source) -> state`` from a seed, or from the full parameter tree of
which the rank keeps its piece, and ``step(state, tokens, targets) ->
(state, loss)`` on full-batch ``[gbs, seq]`` token tensors (each rank runs
its rows; the multi-stage routes split them into the plan's microbatches).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist

from metis_tpu_torch.core.device import resolve_device
from metis_tpu_torch.core.errors import MetisError
from metis_tpu_torch.core.events import NULL_LOG
from metis_tpu_torch.core.sharding import slice_leaf
from metis_tpu_torch.execution.hetero import (
    hetero_runner,
    plan_replica_groups,
    plan_replica_rows,
    stage_specs_from_plan,
)
from metis_tpu_torch.execution.mesh import (
    DP,
    EP,
    PP,
    SP,
    TP,
    ONE_DEVICE,
    PlanArtifact,
    ProcessMesh,
)
from metis_tpu_torch.execution.pipeline import (
    check_family,
    microbatch_split,
    pipeline_runner,
    traced_steps,
)
from metis_tpu_torch.execution.train import (
    TrainState,
    make_forward,
    make_train_step,
    param_specs_for,
    params_from,
    train_state_from_params,
)
from metis_tpu_torch.models import family_ops
from metis_tpu_torch.models.gpt import GPTConfig


@dataclass(frozen=True)
class Executable:
    """A plan realized: which path runs it, plus the normalized step API.
    ``mesh`` is this rank's; ``block_ids`` the global ids of the blocks its
    stacked block leaves hold, in order (None: all of them); ``forward``
    (pp = 1 routes) ``(state, tokens) -> logits`` of the rank's part of a
    full batch (``train.make_forward``)."""

    kind: str  # "single_device", "gspmd", "pipeline" or "hetero"
    init: Callable
    step: Callable
    mesh: ProcessMesh | None = None
    block_ids: tuple[int, ...] | None = None
    forward: Callable | None = None


def pipeline_block_counts(artifact: PlanArtifact, cfg: GPTConfig,
                          pp: int) -> tuple[int, ...] | None:
    """Per-stage transformer-BLOCK counts implied by the artifact's
    layer partition (profile layers include the embed/head pseudo-layers on
    the first/last stages), or None when no partition is recorded (implicit
    even split)."""
    bounds = artifact.layer_partition
    if not bounds:
        return None
    blocks = []
    for i in range(len(bounds) - 1):
        lo, hi = bounds[i], bounds[i + 1]
        blocks.append(min(hi - 1, cfg.num_blocks) - max(lo - 1, 0))
    return tuple(blocks)


def _uniform_block_split(artifact: PlanArtifact, cfg: GPTConfig,
                         pp: int) -> bool:
    """True when the layer partition gives every stage the same BLOCK count
    (counted in transformer blocks, not profile layers: the canonical even
    split gives the first/last stages +1 profile layer for the embed/head
    pseudo-layers while their block counts stay equal)."""
    blocks = pipeline_block_counts(artifact, cfg, pp)
    if blocks is None:
        return cfg.num_blocks % max(pp, 1) == 0
    return (len(set(blocks)) == 1 and blocks[0] > 0
            and cfg.num_blocks % len(blocks) == 0)


def _uneven_1f1b_split(artifact: PlanArtifact, cfg: GPTConfig, pp: int,
                       schedule: str) -> tuple[int, ...] | None:
    """An uneven block partition the pipeline route realizes under 1f1b
    (each stage holds its own blocks); None when the plan must route
    elsewhere."""
    if schedule != "1f1b":
        return None
    blocks = pipeline_block_counts(artifact, cfg, pp)
    if (blocks is not None and len(blocks) == pp
            and len(set(blocks)) > 1
            and min(blocks) >= 1 and sum(blocks) == cfg.num_blocks):
        return blocks
    return None


def resolve_schedule(
    artifact: PlanArtifact,
    schedule: str | None = None,
    virtual_stages: int | None = None,
) -> tuple[str, int]:
    """The (schedule, virtual_stages) a plan runs with: explicit arguments
    win, else the artifact's priced values (2 chunks when an explicit
    interleaved request meets an artifact that never recorded a vs)."""
    if schedule is None:
        schedule = artifact.schedule
    if virtual_stages is None:
        virtual_stages = (artifact.virtual_stages
                          if artifact.virtual_stages > 1 else 2)
    return schedule, virtual_stages


def exec_state_to_train_state(kind: str, state, step: int) -> TrainState:
    """Adapt an executable's state to the checkpointable ``TrainState``
    with ``step``: the port's gspmd, single-device and pipeline states are
    ``TrainState``s already (the reference's pipeline state is a
    ``(params, opt_state)`` pair).  Hetero states checkpoint through
    ``save_hetero_checkpoint``, as in the reference."""
    if kind == "hetero":
        raise ValueError(
            "hetero state lists checkpoint via save_hetero_checkpoint, "
            "not TrainState")
    state.step = int(step)
    return state


def train_state_to_exec_state(kind: str, ts: TrainState):
    """Inverse of ``exec_state_to_train_state`` — the (restored)
    ``TrainState`` in the shape ``Executable.step`` consumes."""
    if kind == "hetero":
        raise ValueError("hetero state lists do not adapt to TrainState")
    return ts


def checkpoint_block_layout(
    artifact: PlanArtifact,
    cfg: GPTConfig,
    exe_kind: str,
    schedule: str,
    virtual_stages: int,
) -> str:
    """The ``CheckpointMeta.block_layout`` string of the reference for this
    (plan, executable, schedule): how its pipeline route orders the stacked
    block axis (interleaved: by ``interleave_block_order``; uneven 1f1b: the
    padded layout of ``pad_blocks_for_partition``)."""
    if exe_kind != "pipeline":
        return "canonical"
    if artifact.mesh_shape and PP in artifact.mesh_axes:
        pp = artifact.mesh_shape[artifact.mesh_axes.index(PP)]
    else:
        pp = 1
    if schedule == "interleaved":
        return f"interleaved:{pp}x{virtual_stages}"
    counts = _uneven_1f1b_split(artifact, cfg, pp, schedule)
    if counts is not None:
        return f"uneven:{pp}x" + "-".join(str(c) for c in counts)
    return "canonical"


def _normalized(artifact: PlanArtifact) -> tuple[list[dict], int]:
    """Per-stage strategies with the reference's defaults, and pp."""
    strategies = [dict(s) for s in artifact.strategies]
    for s in strategies:
        s.setdefault("cp", 1)
        s.setdefault("ep", 1)
        s.setdefault("zero", 0)
        s.setdefault("sp", False)
        s.setdefault("cp_mode", "ring")
    # uniform artifacts carry ONE strategy with pp encoded in the mesh shape
    # (PlanArtifact.from_uniform_plan); hetero artifacts carry one per stage
    if artifact.mesh_shape and PP in artifact.mesh_axes:
        pp = artifact.mesh_shape[artifact.mesh_axes.index(PP)]
    else:
        pp = len(strategies)
    if len(strategies) == 1 and pp > 1:
        strategies = strategies * pp
    return strategies, pp


def plan_route(cfg: GPTConfig, artifact: PlanArtifact,
               schedule: str | None = None,
               virtual_stages: int | None = None) -> str:
    """The route of a plan, "gspmd", "pipeline" or "hetero", by the
    reference's rule (``metis_tpu/execution/builder.py``)."""
    schedule, _ = resolve_schedule(artifact, schedule, virtual_stages)
    strategies, pp = _normalized(artifact)
    uniform = len({(s["dp"], s["tp"], s["cp"], s["ep"], s["zero"], s["sp"])
                   for s in strategies}) == 1
    s0 = strategies[0]
    if artifact.mesh_shape and pp == 1:
        return "gspmd"
    if (artifact.mesh_shape and uniform and s0["zero"] == 0
            and not s0["sp"] and s0["cp"] == 1 and s0["ep"] == 1):
        if (_uniform_block_split(artifact, cfg, pp)
                or _uneven_1f1b_split(artifact, cfg, pp, schedule) is not None):
            return "pipeline"
    return "hetero"


def _check_strategies(strategies: list[dict], cfg) -> None:
    """Values no executor knows, and ep on a dense config.  The hetero
    route's own refusals are the reference's
    (``hetero.stage_specs_from_plan``)."""
    for s, st in enumerate(strategies):
        if st["ep"] != 1 and not family_ops(cfg).moe:
            raise ValueError(f"stage {s}: ep={st['ep']} needs an MoE config")
        if st["zero"] not in (0, 1, 2, 3):
            raise ValueError(f"stage {s}: zero={st['zero']}: expected 0-3")
        if st["cp_mode"] not in ("ring", "a2a"):
            raise ValueError(f"stage {s}: unknown cp_mode {st['cp_mode']!r}")


def build_executable(cfg: GPTConfig, artifact: PlanArtifact,
                     device: str | torch.device = "cuda",
                     optimizer=None, cluster=None, profiles=None,
                     schedule: str | None = None,
                     virtual_stages: int | None = None,
                     events=None, overlap: bool = True) -> Executable:
    """Route ``artifact`` to the execution path that realizes it.

    ``cluster`` + ``profiles`` (optional) give mixed-type hetero stages the
    data balancer's uneven per-replica rows.  ``schedule`` /
    ``virtual_stages`` override the artifact's priced schedule on the
    pipeline route (``resolve_schedule``); the hetero route is a fill and
    drain with stage remat whatever the schedule.  ``events`` and
    ``overlap`` (pipeline route) as in ``make_pipeline_train_step``."""
    dev = resolve_device(device)
    schedule, virtual_stages = resolve_schedule(artifact, schedule,
                                                virtual_stages)
    if schedule not in ("gpipe", "1f1b", "interleaved"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    if schedule == "interleaved" and virtual_stages < 1:
        raise ValueError(f"virtual_stages={virtual_stages} must be >= 1")
    strategies, pp = _normalized(artifact)
    route = plan_route(cfg, artifact, schedule, virtual_stages)
    _check_strategies(strategies, cfg)
    if route == "gspmd":
        if dist.is_initialized():
            return _gspmd_executable(cfg, artifact, strategies[0], dev,
                                     optimizer)
        if artifact.num_devices != 1:
            raise MetisError(
                f"mesh {dict(zip(artifact.mesh_axes, artifact.mesh_shape))} "
                f"needs {artifact.num_devices} ranks; run it through the "
                "launcher (metis_tpu_torch.execution.dist.spawn), one rank "
                "per device, and build it on every rank")
        return _single_device_executable(cfg, dev, optimizer)
    if route == "pipeline":
        check_family(cfg)
        counts = (None if _uniform_block_split(artifact, cfg, pp)
                  else _uneven_1f1b_split(artifact, cfg, pp, schedule))
        runner = pipeline_runner(
            cfg, artifact.build_mesh(), artifact.microbatches, dev, optimizer,
            schedule, virtual_stages, counts, overlap)
        init, raw_step = traced_steps(
            runner, schedule, artifact.microbatches,
            events if events is not None else NULL_LOG, overlap)
        return Executable("pipeline", init,
                          _split_steps(raw_step, artifact.microbatches),
                          runner.mesh, runner.block_ids)
    return _hetero_executable(cfg, artifact, strategies, dev, optimizer,
                              cluster, profiles)


def _split_steps(raw_step, microbatches: int) -> Callable:
    def step(state, tokens, targets):
        return raw_step(state, microbatch_split(tokens, microbatches),
                        microbatch_split(targets, microbatches))

    return step


def _single_device_executable(cfg, device, optimizer) -> Executable:
    def init(source):
        return train_state_from_params(
            params_from(source, cfg, device), optimizer)

    return Executable(kind="single_device", init=init,
                      step=make_train_step(cfg), mesh=ONE_DEVICE,
                      forward=make_forward(cfg))


def _gspmd_executable(cfg, artifact, s0, device, optimizer) -> Executable:
    """The reference's ``_gspmd_executable``: the plan's mesh with the
    sequence over ``SP`` when cp > 1, Megatron sp and ZeRO from its
    strategy."""
    mesh = artifact.build_mesh()
    dp, ep, tp, cp = (mesh.size(DP), mesh.size(EP), mesh.size(TP),
                      mesh.size(SP))
    if artifact.gbs % (dp * ep):
        raise ValueError(f"gbs {artifact.gbs} does not split over dp x ep = "
                         f"{dp * ep}")
    sp = bool(s0["sp"]) and tp > 1
    splits = [("heads", cfg.num_heads, TP), ("vocab rows", cfg.vocab_size, TP),
              ("ffn units", cfg.ffn_dim, TP),
              ("sequence positions", cfg.seq_len, (SP, TP) if sp else SP)]
    if cp > 1 and s0["cp_mode"] == "a2a":
        splits.append(("heads", cfg.num_heads, (TP, SP)))
    if family_ops(cfg).moe:
        splits.append(("experts", cfg.num_experts, EP))
    for what, n, axes in splits:
        size = math.prod(mesh.size(a) for a in
                         (axes if isinstance(axes, tuple) else (axes,)))
        if n % size:
            raise ValueError(f"{n} {what} do not split over {axes} = {size}")
    specs, slots = param_specs_for(cfg, tp), mesh.slots()

    def cut(group, name, leaf):
        return slice_leaf(leaf, specs[group][name], slots).contiguous()

    def init(source):
        return train_state_from_params(
            params_from(source, cfg, device, cut), optimizer, s0["zero"],
            mesh, cfg)

    seq = dict(seq_axis=SP if cp > 1 else None, megatron_sp=sp,
               cp_mode=s0["cp_mode"])
    return Executable(kind="gspmd", init=init,
                      step=make_train_step(cfg, mesh=mesh, **seq), mesh=mesh,
                      forward=make_forward(cfg, mesh=mesh, **seq))


def _hetero_executable(cfg, artifact, strategies, device, optimizer, cluster,
                       profiles) -> Executable:
    pp = len(strategies)
    rows = groups = None
    if (cluster is not None and profiles is not None
            and artifact.node_sequence):
        # mixed-type stages: the data balancer's per-replica rows
        from metis_tpu_torch.core.types import InterStagePlan, Strategy

        inter = InterStagePlan(
            node_sequence=tuple(artifact.node_sequence),
            device_groups=tuple(artifact.device_groups),
            batches=artifact.microbatches, gbs=artifact.gbs)
        strats = [Strategy(dp=s["dp"], tp=s["tp"]) for s in strategies]
        rows = plan_replica_rows(inter, strats, cluster, profiles)
        groups = plan_replica_groups(inter, strats, cluster)
    bounds = artifact.layer_partition
    if not bounds:
        # rectangular artifacts drop the canonical even split; rebuild it
        per = cfg.num_profile_layers // pp
        bounds = tuple(per * i for i in range(pp)) + (cfg.num_profile_layers,)
    stages = stage_specs_from_plan(
        bounds, strategies, cfg, stage_replica_rows=rows,
        stage_replica_groups=groups)
    return hetero_executable(cfg, stages, artifact.microbatches, device,
                             optimizer)


def hetero_executable(cfg: GPTConfig, stages, microbatches: int,
                      device: str | torch.device = "cuda",
                      optimizer=None) -> Executable:
    """The hetero route for explicit ``StageSpec``s (``execution.hetero``),
    splitting full batches into ``microbatches``."""
    runner = hetero_runner(cfg, stages, resolve_device(device), optimizer)

    return Executable("hetero", runner.init,
                      _split_steps(runner.step, microbatches), runner.mesh,
                      runner.block_ids)
