"""Pipeline-parallel training over a (pp, dp, tp) grid of ranks — the port
of ``metis_tpu/execution/pipeline.py``.

The reference runs one ``shard_map`` program on every device: the stacked
blocks sharded over "pp", activations rotating with ``ppermute`` each tick,
uneven splits padded with masked identity layers.  Here each rank runs its
own stage (``execution/stages.py``): it holds only its blocks (an uneven
1F1B split needs no pad layers) and exchanges boundary activations and
their gradients point to point, at the ticks of the reference's schedules:

- **gpipe**: every microbatch forward, keeping each microbatch's autograd
  graph until its backward, then every backward in reverse order — the
  fill-drain ``(M - 1) * max + sum`` the planner prices;
- **1f1b**: forward of microbatch m at tick m + s, its backward at tick
  m + 2(S - 1) - s; a stage stores only its boundary inputs and recomputes
  its forward inside its backward (stage-level remat), so at most
  ``min(M, 2(S-1)+1)`` inputs are live;
- **interleaved**: each rank holds ``virtual_stages`` chunks in the
  device-major layout (``interleave_block_order``); microbatches run in
  groups of pp, a forward fill over every chunk unit then a reversed
  drain, remat per unit.

The route runs the GPT family only (``check_family``), as the reference's.
Loss and gradients equal the one-device model's: the loss is the mean over
microbatches of the microbatch mean, and so are the gradients (each
microbatch's loss carries the factor 1 / M).  ``overlap`` (default on) waits for a boundary
send only two exchanges after posting it and chunks the dp gradient
all-reduce of the manual-backward schedules (``train.chunked_all_reduce``);
values stay those of lockstep.  The default optimizer is the reference's
``optax.adamw(1e-4)``, whose weight decay is 1e-4 (the gspmd and hetero
routes decay by 0.01, ``train.build_optimizer``).
"""
from __future__ import annotations

from functools import partial
from typing import Sequence

import numpy as np
import torch

from metis_tpu_torch.core.device import resolve_device
from metis_tpu_torch.core.events import NULL_LOG, EventLog
from metis_tpu_torch.core.trace import Tracer
from metis_tpu_torch.execution import train as _train
from metis_tpu_torch.execution.mesh import DP, PP, TP, ProcessMesh, StageGrid
from metis_tpu_torch.execution.stages import (
    StageRunner,
    Unit,
    fill_drain_ticks,
    interleaved_ticks,
    one_f_one_b_ticks,
    replica_counts,
)
from metis_tpu_torch.models import family_ops, resolve_attention
from metis_tpu_torch.models.gpt import GPTConfig


def uneven_pad_indices(block_counts) -> list[int]:
    """Padded stacked-axis layout of the reference's uneven layer partition:
    stage ``s`` owns slots ``[s*per_stage, (s+1)*per_stage)`` with its
    ``counts[s]`` real blocks first (global block order preserved) and
    ``-1`` pad slots after.  The port holds no pad slots; this maps the
    reference's padded leaves to canonical order
    (``unpad_blocks_for_partition``)."""
    per_stage = max(block_counts)
    idx: list[int] = []
    off = 0
    for c in block_counts:
        idx += list(range(off, off + c)) + [-1] * (per_stage - c)
        off += c
    return idx


def _take_rows(a, idx: Sequence[int]):
    """Rows ``idx`` of ``a`` (tensor or numpy array), zeros where < 0."""
    if isinstance(a, torch.Tensor):
        z = torch.zeros_like(a[:1])
        return torch.cat([a[i:i + 1] if i >= 0 else z for i in idx])
    z = np.zeros_like(a[:1])
    return np.concatenate([a[i:i + 1] if i >= 0 else z for i in idx])


def pad_blocks_for_partition(blocks: dict, block_counts) -> dict:
    """Reorder + zero-pad the stacked block leaves per
    ``uneven_pad_indices`` (the reference's padded layout)."""
    idx = uneven_pad_indices(block_counts)
    return {n: _take_rows(a, idx) for n, a in blocks.items()}


def unpad_blocks_for_partition(blocks: dict, block_counts) -> dict:
    """Inverse of ``pad_blocks_for_partition``: drop pad slots and restore
    the canonical global block order."""
    keep = [i for i, b in enumerate(uneven_pad_indices(block_counts)) if b >= 0]
    return {n: _take_rows(a, keep) for n, a in blocks.items()}


def interleave_block_order(num_blocks: int, pp: int, vs: int) -> list[int]:
    """Block permutation for the interleaved schedule: device ``s`` owns
    virtual chunks ``v`` covering global blocks ``(v*pp + s)*K .. +K`` with
    ``K = num_blocks // (pp * vs)``; the stacked block axis is ordered
    device-major (s, v, k), so rank s holds entries ``s*vs*K .. +vs*K``."""
    K = num_blocks // (pp * vs)
    return [(v * pp + s) * K + k
            for s in range(pp) for v in range(vs) for k in range(K)]


def _check_pipeline(cfg, pp: int, num_microbatches: int, schedule: str,
                    virtual_stages: int, block_counts):
    """The reference's input checks, word for word; returns the uneven
    block counts (None for the even split)."""
    counts = None
    if block_counts is not None:
        counts = tuple(int(c) for c in block_counts)
        if (len(counts) != pp or sum(counts) != cfg.num_blocks
                or min(counts) < 1):
            raise ValueError(
                f"block_counts={counts} must have one entry >= 1 per "
                f"pp={pp} stage summing to num_blocks={cfg.num_blocks}")
        if len(set(counts)) == 1:
            counts = None  # even: the unpadded fast path
    if counts is None:
        if cfg.num_blocks % pp:
            raise ValueError(
                f"num_blocks={cfg.num_blocks} must divide evenly into "
                f"pp={pp} stages for the uniform pipeline (pass "
                "block_counts for an uneven gpipe/1f1b split)")
    elif schedule == "interleaved":
        raise ValueError(
            "interleaved schedule requires an even block split "
            f"(got block_counts={counts})")
    if schedule not in ("gpipe", "1f1b", "interleaved"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    if schedule == "interleaved":
        if virtual_stages < 1:
            raise ValueError(
                f"virtual_stages={virtual_stages} must be >= 1")
        if cfg.num_blocks % (pp * virtual_stages):
            raise ValueError(
                f"interleaved schedule needs num_blocks={cfg.num_blocks} "
                f"divisible by pp*virtual_stages={pp * virtual_stages}")
        if num_microbatches % pp:
            raise ValueError(
                f"interleaved schedule runs microbatches in groups of "
                f"pp={pp}; {num_microbatches} microbatches don't divide")
    return counts


def _units(cfg, pp: int, s: int, schedule: str, vs: int, counts):
    """This stage's units and the global ids of its stacked blocks."""
    if schedule == "interleaved":
        K = cfg.num_blocks // (pp * vs)
        ids = interleave_block_order(cfg.num_blocks, pp, vs)[s * vs * K:(s + 1) * vs * K]
        last = vs * pp - 1
        units = []
        for v in range(vs):
            c = v * pp + s  # global chunk
            units.append(Unit(v * K, (v + 1) * K, c == 0, c == last,
                              (c - 1) % pp if c > 0 else None,
                              (c + 1) % pp if c < last else None))
        return units, ids
    per = counts or (cfg.num_blocks // pp,) * pp
    off = sum(per[:s])
    unit = Unit(0, per[s], s == 0, s == pp - 1,
                s - 1 if s > 0 else None, s + 1 if s < pp - 1 else None)
    return [unit], list(range(off, off + per[s]))


def check_family(cfg) -> None:
    """The pipeline route runs the GPT family only, as the reference's
    (its shard_map pipeline runs GPT blocks)."""
    if family_ops(cfg).name != "gpt":
        raise NotImplementedError(
            f"{type(cfg).__name__} on the pipeline route: the reference's "
            "pipeline runs GPT blocks only (ROADMAP §A.3); LLaMA runs on the "
            "hetero and gspmd routes, MoE on the gspmd route")


def pipeline_runner(cfg: GPTConfig, mesh: ProcessMesh, num_microbatches: int,
                    device="cuda", optimizer=None, schedule: str = "gpipe",
                    virtual_stages: int = 2, block_counts=None,
                    overlap: bool = True, attn_impl=None) -> StageRunner:
    """This rank's part of the pipeline executor on ``mesh`` (a (pp, dp,
    tp) grid, ``PlanArtifact.build_mesh``)."""
    check_family(cfg)
    pp, dp, tp = mesh.size(PP), mesh.size(DP), mesh.size(TP)
    counts = _check_pipeline(cfg, pp, num_microbatches, schedule,
                             virtual_stages, block_counts)
    s = mesh.index(PP)
    units, ids = _units(cfg, pp, s, schedule, virtual_stages, counts)
    ticks = {"gpipe": partial(fill_drain_ticks, pp, s),
             "1f1b": partial(one_f_one_b_ticks, pp, s),
             "interleaved": partial(interleaved_ticks, pp, s,
                                    vs=virtual_stages)}[schedule]
    return StageRunner(
        cfg, mesh, [StageGrid(dp, tp)] * pp,
        lambda rows: [replica_counts(rows, dp)] * pp, units, ids, ticks,
        remat=schedule != "gpipe", device=resolve_device(device),
        optimizer=optimizer or _train.build_optimizer(1e-4, weight_decay=1e-4),
        attn=attn_impl or resolve_attention(cfg), overlap=overlap,
        chunked_dp=overlap and schedule != "gpipe")


def make_pipeline_train_step(
    cfg: GPTConfig,
    mesh: ProcessMesh,
    num_microbatches: int,
    device="cuda",
    optimizer=None,
    schedule: str = "gpipe",
    virtual_stages: int = 2,
    block_counts=None,
    events: EventLog = NULL_LOG,
    overlap: bool = True,
):
    """Pipeline train step of this rank of a (pp, dp, tp) grid.

    ``schedule`` picks "gpipe", "1f1b" or "interleaved" (``virtual_stages``
    chunks per rank), all with identical losses and gradients.
    ``block_counts`` (len == pp, sum == ``cfg.num_blocks``): an uneven
    per-stage block split, each stage holding just its own blocks; without
    it ``cfg.num_blocks % pp == 0`` is required (the interleaved schedule
    always requires the even split).  ``overlap`` (default on) emits one
    ``pipeline_overlap`` event; ``events`` also gets the ``pipeline_init``
    and ``pipeline_first_step`` spans.

    Returns ``(init_fn, step_fn)``: ``init_fn(seed_or_params) -> state``
    (this rank's ``TrainState``; the interleaved layout orders its blocks
    by ``interleave_block_order``); ``step_fn(state, tokens_mbs,
    targets_mbs) -> (state, loss)`` with microbatch-major ``[M, batch,
    seq]`` tokens and targets (``microbatch_split``), whole on every rank."""
    runner = pipeline_runner(cfg, mesh, num_microbatches, device, optimizer,
                             schedule, virtual_stages, block_counts, overlap)
    return traced_steps(runner, schedule, num_microbatches, events, overlap)


def traced_steps(runner: StageRunner, schedule: str, num_microbatches: int,
                 events: EventLog = NULL_LOG, overlap: bool = True):
    """``(init_fn, step_fn)`` of a pipeline runner, with the reference's
    ``pipeline_overlap`` event and ``pipeline_init`` /
    ``pipeline_first_step`` spans."""
    if overlap:
        events.emit(
            "pipeline_overlap", schedule=schedule,
            dp_chunk_elems=(0 if schedule == "gpipe"
                            else _train.DP_CHUNK_ELEMS))
    tracer = Tracer(events)
    pp = runner.mesh.size(PP)

    def init_fn(source):
        with tracer.span("pipeline_init", schedule=schedule, pp=pp,
                         microbatches=num_microbatches):
            return runner.init(source)

    first_step = [True]

    def step_fn(state, tokens_mbs, targets_mbs):
        if tokens_mbs.shape[0] != num_microbatches:
            raise ValueError(
                f"expected {num_microbatches} microbatches, got "
                f"{tokens_mbs.shape[0]} (use microbatch_split)")
        if not first_step[0]:
            return runner.step(state, tokens_mbs, targets_mbs)
        first_step[0] = False
        with tracer.span("pipeline_first_step", schedule=schedule, pp=pp,
                         microbatches=num_microbatches):
            state, loss = runner.step(state, tokens_mbs, targets_mbs)
            if tracer.enabled:
                loss.item()  # bound the span by the step's end
        return state, loss

    return init_fn, step_fn


def microbatch_split(tokens: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """[gbs, seq] -> [M, gbs/M, seq] (microbatch-major layout the pipeline
    step consumes)."""
    gbs, seq = tokens.shape
    if gbs % num_microbatches:
        raise ValueError(f"gbs={gbs} not divisible into {num_microbatches} microbatches")
    return tokens.reshape(num_microbatches, gbs // num_microbatches, seq)
