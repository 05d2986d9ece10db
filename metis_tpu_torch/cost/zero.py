"""ZeRO / FSDP sharded-state planning model — net-new TPU capability.

The port's copy of ``metis_tpu/cost/zero.py``.

The reference has no sharded-optimizer support (SURVEY.md §2.2 "ZeRO/FSDP —
Absent"; its optimizer cost just divides profiled time, ``cost_estimator.py:
88-89``).  This module adds a ZeRO stage to the plan space:

- **stage 1** shards optimizer state (fp32 master + Adam moments) over the
  stage's data ranks;
- **stage 2** additionally shards gradients;
- **stage 3** (FSDP) additionally shards parameters.

Execution counterpart: on TPU, ZeRO-3 is just a ``NamedSharding`` that puts
parameters (and therefore optax state, which mirrors the param pytree) on the
dp axis — GSPMD inserts the forward/backward all-gathers over ICI
(``execution.train.fsdp_wrap_specs``).

Cost model:

- **Memory**: per-layer static relief = shardable bytes x (1 - 1/d), where d
  is the stage's data-rank count (dp*cp).  Shardable bytes are analytic from
  the profile's per-layer parameter bytes: grads mirror the param dtype, Adam
  fp32 state is master + 2 moments (12 bytes per parameter).  The relief is
  subtracted from the *fitted static component* (never below zero, never
  above the measured row — same conservative stance as the cp/ep models).
- **Gradient comm**: stages 1-2 replace the ring all-reduce (volume
  ``2(d-1)/d x P``) with reduce-scatter + all-gather of the same total volume
  — cost unchanged.  Stage 3 adds the backward parameter all-gather:
  ``3(d-1)/d x P`` total, a 1.5x factor on the dp term.  (The forward
  all-gather overlaps with layer compute on real hardware and profiles would
  absorb it; we charge only the exposed backward gather — calibrate via the
  validator.)
- **Optimizer step**: with state sharded, each rank updates 1/d of the
  parameters — profiled optimizer time divides by d.
"""
from __future__ import annotations

_MB = 1024 * 1024
# Adam fp32 state bytes per parameter: master copy + first + second moment.
_ADAM_BYTES_PER_PARAM = 12


def zero_candidates(enabled: bool) -> list[int]:
    return [0, 1, 2, 3] if enabled else [0]


def zero_dp_factor(zero_stage: int) -> float:
    """Multiplier on the ring all-reduce gradient cost: stage 3 adds the
    backward parameter all-gather (2(d-1)/d -> 3(d-1)/d)."""
    return 1.5 if zero_stage >= 3 else 1.0


def shardable_bytes_per_param_byte(dtype_bytes: int, zero_stage: int) -> float:
    """How many bytes of per-rank state become shardable per byte of stored
    parameters, by ZeRO stage (``dtype_bytes`` is the stored-parameter
    width)."""
    if zero_stage < 1:
        return 0.0
    params_per_byte = 1.0 / dtype_bytes
    out = _ADAM_BYTES_PER_PARAM * params_per_byte      # stage 1: optimizer
    if zero_stage >= 2:
        out += 1.0                                     # stage 2: + gradients
    if zero_stage >= 3:
        out += 1.0                                     # stage 3: + parameters
    return out


def zero_static_reduction_mb(
    params_per_layer_bytes: tuple[int, ...],
    zero_stage: int,
    data_ranks: int,
    tp: int = 1,
    dtype_bytes: int = 2,
    expert_frac: float = 0.0,
    ep: int = 1,
) -> tuple[float, ...] | None:
    """Per-layer static-memory reduction (MB) from sharding ZeRO state over
    ``data_ranks``, or None when nothing shards.  ``params_per_layer_bytes``
    is the profile's whole-model figure; each rank stores 1/tp of it.

    With expert parallelism (``expert_frac`` of block-layer parameters
    sharded ``ep``-ways), each expert shard is replicated over only
    ``data_ranks/ep`` ranks, so ZeRO recovers ``1 - ep/data_ranks`` of the
    per-rank expert state (zero when data_ranks == ep), not ``1 - 1/d`` —
    never credit relief the sharding cannot deliver."""
    if zero_stage < 1 or data_ranks <= 1:
        return None
    per_byte = shardable_bytes_per_param_byte(dtype_bytes, zero_stage)
    dense_f = 1.0 - 1.0 / data_ranks
    n = len(params_per_layer_bytes)
    out = []
    for layer, p in enumerate(params_per_layer_bytes):
        stored_mb = p / tp * per_byte / _MB
        is_block = 1 <= layer < n - 1
        if ep > 1 and is_block and expert_frac > 0.0:
            expert_ranks = data_ranks // ep
            exp_f = (1.0 - 1.0 / expert_ranks) if expert_ranks > 1 else 0.0
            out.append(stored_mb * ((1 - expert_frac) * dense_f
                                    + expert_frac / ep * exp_f))
        else:
            out.append(stored_mb * dense_f)
    return tuple(out)
