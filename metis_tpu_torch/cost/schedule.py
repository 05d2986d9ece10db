"""Pipeline-schedule pricing: GPipe vs 1F1B vs interleaved as a PLAN axis.

The port's copy of ``metis_tpu/cost/schedule.py``.

The reference prices exactly one schedule — the GPipe fill-drain
``(M - 1) * max_stage + sum(stages)`` (``model/cost_estimator.py:129``) — and
has no schedule concept in its plan space.  Our execution layer ships three
schedules (``execution/pipeline.py``); this module makes the *planner* choose
between them by pricing what each implemented schedule actually does:

- **gpipe** — forward scan + autodiff backward.  No recomputation (XLA stores
  every microbatch's residuals), so step time is the reference formula
  unchanged, but peak activation memory grows with the microbatch count M.
- **1f1b** — memory-bounded one-forward-one-backward with stage-granular
  rematerialization.  The fill-drain shape is identical, but every
  microbatch-stage recomputes its forward from the saved boundary input, so
  stage times scale by ``1 + REMAT_FWD_FRACTION``.  Peak activation memory is
  one microbatch's residuals plus ``min(M, 2(S-1)+1)`` boundary buffers —
  independent of M.  1F1B therefore never wins on predicted time; it wins by
  making memory-tight plans *feasible* (exactly how the executor behaves).
- **interleaved** — ``vs`` virtual chunks per device, microbatches in groups
  of S with drain between groups (the implemented schedule —
  ``_pipeline_interleaved_local`` — not Megatron's steady-state overlap; the
  model prices the implementation).  Per group the
  pipeline exposes chunk units (1/vs of a stage), so the bubble term shrinks
  by ~vs while the same remat factor applies, and each microbatch crosses
  ``vs*S - 1`` chunk boundaries instead of ``S - 1`` (more, smaller sends on
  the same pp links).

All formulas use per-microbatch whole-stage times ``lens`` (profiled fwd+bwd
ms, as the reference's) so gpipe reproduces the reference exactly.
"""
from __future__ import annotations

from typing import Sequence

PIPELINE_SCHEDULES = ("gpipe", "1f1b", "interleaved")

# Fraction of a profiled fwd+bwd stage time that is the forward pass — the
# work a rematerializing schedule (1f1b, interleaved) runs twice.  The
# canonical 1:2 fwd:bwd FLOP ratio for transformer training is the default;
# ``profiles.profiler.measure_remat_fraction`` measures the real split on a
# backend (XLA's fused backward rarely hits the exact FLOP ratio) and feeds
# it here via ``SearchConfig.remat_fwd_fraction``.
REMAT_FWD_FRACTION = 1.0 / 3.0


def schedule_valid(schedule: str, num_stages: int, batches: int,
                   virtual_stages: int, num_blocks: int | None = None) -> bool:
    """Whether the schedule can run this plan shape on the shard_map pipeline
    executor (mirrors ``make_pipeline_train_step``'s checks so the planner
    never emits a schedule ``build_executable`` would reject)."""
    if schedule not in PIPELINE_SCHEDULES:
        return False
    if schedule == "gpipe":
        return True
    if num_stages < 2:
        return False  # no pipeline; 1f1b/interleaved degenerate to gpipe
    if schedule == "1f1b":
        # uneven chunking is fine — the executor pads stages to the largest
        # stage's block count with masked identity layers
        # (execution.pipeline.pad_blocks_for_partition); each stage just
        # needs at least one block
        return num_blocks is None or num_blocks >= num_stages
    if num_blocks is not None and num_blocks % num_stages:
        return False  # interleaved: the chunk permutation needs even stages
    if virtual_stages < 2:
        return False  # vs=1 is plain 1f1b-shaped; search it as such
    if batches % num_stages:
        return False  # microbatches run in groups of S
    if num_blocks is not None and num_blocks % (num_stages * virtual_stages):
        return False
    return True


def schedule_execution_ms(
    schedule: str,
    lens: Sequence[float],
    batches: int,
    virtual_stages: int = 1,
    remat_fraction: float | None = None,
) -> float:
    """Pipeline execution time (ms) for per-microbatch stage times ``lens``
    under ``schedule``.

    gpipe: the reference fill-drain ``(M-1)*max + sum`` verbatim.
    1f1b: same shape with every stage time scaled by the remat factor.
    interleaved: ``G * (vs*S + S - 1) * (1+r) * max(lens) / vs`` — G = M/S
    groups, each running ``vs*S + S - 1`` lockstep ticks (ppermute barriers)
    of one chunk-unit (``max(lens)/vs`` compute) per device, forward and
    backward phases together costing ``(1+r)`` of the combined fwd+bwd time.

    ``remat_fraction``: measured fwd share of a profiled fwd+bwd stage time
    (``measure_remat_fraction``); None uses the analytic default.
    """
    M = batches
    S = len(lens)
    if schedule == "gpipe":
        return (M - 1) * max(lens) + sum(lens)
    r = REMAT_FWD_FRACTION if remat_fraction is None else remat_fraction
    if schedule == "1f1b":
        return (1 + r) * ((M - 1) * max(lens) + sum(lens))
    if schedule == "interleaved":
        vs = virtual_stages
        groups = M // S
        ticks = vs * S + S - 1
        return groups * ticks * (1 + r) * max(lens) / vs
    raise ValueError(f"unknown schedule {schedule!r}")


def schedule_pp_send_factor(schedule: str, num_stages: int,
                            virtual_stages: int = 1) -> float:
    """Multiplier on the plan's pp boundary-transfer cost: the interleaved
    schedule crosses ``vs*S - 1`` chunk boundaries per microbatch (including
    ring wraps) where gpipe/1f1b cross ``S - 1``."""
    if schedule != "interleaved" or num_stages < 2:
        return 1.0
    return (virtual_stages * num_stages - 1) / (num_stages - 1)


def schedule_activation_factor(schedule: str, batches: int,
                               virtual_stages: int = 1) -> float:
    """How many microbatches' worth of per-stage residual activations are
    live at the schedule's peak, as a multiple of one profiled microbatch:

    - gpipe stores every microbatch's residuals until its backward: M;
    - 1f1b rematerializes — only the one unit under vjp holds residuals: 1;
    - interleaved rematerializes per chunk unit (1/vs of the stage): 1/vs.
    """
    if schedule == "gpipe":
        return float(batches)
    if schedule == "1f1b":
        return 1.0
    if schedule == "interleaved":
        return 1.0 / virtual_stages
    raise ValueError(f"unknown schedule {schedule!r}")


def schedule_boundary_buffers(schedule: str, num_stages: int, batches: int,
                              virtual_stages: int = 1) -> int:
    """Saved boundary-input buffers ([mbs, seq, hidden] each) the schedule
    keeps per device at peak (the remat schedules' rings; gpipe's boundaries
    are part of its stored residuals)."""
    if schedule == "1f1b":
        return min(batches, 2 * (num_stages - 1) + 1)
    if schedule == "interleaved":
        return virtual_stages * num_stages
    return 0


def boundary_buffer_mb(mbs: int, sequence_length: int, hidden_size: int,
                       dtype_bytes: int) -> float:
    """MB of one saved boundary activation (per device: the full hidden, the
    stage's per-replica microbatch)."""
    return mbs * sequence_length * hidden_size * dtype_bytes / 1e6
