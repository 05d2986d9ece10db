"""Context-parallel (ring attention) planning model — net-new TPU capability.

The port's copy of ``metis_tpu/cost/context_parallel.py``.

The reference has **no** long-context support: sequence length is a scalar in
its activation math and no CP/ring/Ulysses variant exists anywhere
(SURVEY.md §5 "Long-context / sequence parallelism").  This module adds the
cost and memory model for a context-parallel plan axis: each stage may shard
the *sequence* dimension over ``Strategy.cp`` devices running ring attention
(execution counterpart: :mod:`metis_tpu_torch.ops.ring_attention`).

Modeling assumptions (validated against the execution layer, documented here
because the planner must predict what the executed plan does):

- **Compute** scales ~1/cp.  FFN/projection FLOPs are linear in local sequence
  length; ring attention computes the full causal attention in ``cp`` block
  steps of (S/cp x S/cp) scores, so per-device attention FLOPs are also S²/cp.
- **Ring traffic**: each device rotates its K/V block (2 tensors of
  ``mbs x S/cp x hidden/tp``) ``cp-1`` times forward; backward re-runs the ring
  carrying K/V plus accumulated dK/dV — 2 rotations' worth.  Total per layer
  per microbatch = ``(cp-1) * 3 * kv_block_bytes``.  We charge it un-overlapped
  (conservative; on real slices XLA/pallas overlap most of it with the block
  matmuls — the validator's predicted-vs-measured loop is where this constant
  gets calibrated).
- **GQA**: the RING path carries grouped K/V natively (``make_ring_attention
  .supports_gqa``; models/llama passes unexpanded [b, kv_heads, s, d]), so
  ring K/V rotation bytes scale by ``num_kv_heads / num_heads``.  The
  Ulysses path still expands K/V to the query head count before its
  all-to-alls (its head-split logic assumes matched counts), so a2a bytes
  stay at full ``hidden_size`` — each formula prices what its executor
  moves.
- **Memory**: sequence sharding divides *activation* memory by cp but leaves
  weights/optimizer state whole.  Profiles report one per-layer total, so we
  recover the split from the store's batch-size sweep: per-layer memory is
  affine in bs (``mem(bs) ~ static + bs * act_slope``) because activations are
  the only bs-dependent term.  A least-squares fit over the profiled bs points
  gives (static, slope) per layer; cp memory = ``static + bs * slope / cp``.
  With fewer than two bs points the split is unidentifiable and we
  conservatively model **no** memory relief (cp=1 memory), never an optimistic
  guess.
"""
from __future__ import annotations

from typing import Sequence

from metis_tpu_torch.core.config import ModelSpec
from metis_tpu_torch.profiles.store import ProfileStore, affine_fit

# Ring rotations of the K/V block: 1 forward + 1 backward at the model
# dtype, plus the backward's dK/dV accumulator rotation at float32 (the
# ring VJP carries fp32 accumulators — _ring_flash_bwd) — kept as explicit
# terms in ring_comm_bytes_per_layer, not a flat rotation count.
RING_ROTATIONS = 3  # structural count (fwd K/V, bwd K/V, bwd dK/dV)
_GRAD_BYTES = 4     # dK/dV rotate as float32 accumulators


def ring_comm_bytes_per_layer(
    model: ModelSpec, mbs: int, cp: int, tp: int
) -> float:
    """Un-overlapped ring-attention wire bytes one device moves per
    transformer layer per microbatch — priced per rotating tensor: what the
    executor actually moves (``ops/ring_attention.py``)."""
    if cp <= 1:
        return 0.0
    # GQA: the ring rotates grouped K/V (kv_heads/num_heads of the hidden
    # width) — see the module docstring and ops/ring_attention.py
    kv_frac = (model.num_kv_heads / model.num_heads
               if getattr(model, "num_kv_heads", 0) else 1.0)
    kv_elems = (
        2  # K and V
        * mbs
        * (model.sequence_length // cp)
        * (model.hidden_size // tp)
        * kv_frac
    )
    # 2 rotations at the model dtype (fwd K/V + bwd K/V) + 1 at fp32
    # (bwd dK/dV accumulators)
    return (cp - 1) * kv_elems * (2 * model.dtype_bytes + _GRAD_BYTES)


def cp_ring_ms(
    model: ModelSpec,
    mbs: int,
    cp: int,
    tp: int,
    num_attn_layers: int,
    bw_gbps: float,
) -> float:
    """Ring-attention comm time (ms) for one microbatch across a stage's
    attention layers at ``bw_gbps`` per-link ring bandwidth."""
    if cp <= 1 or num_attn_layers <= 0:
        return 0.0
    nbytes = ring_comm_bytes_per_layer(model, mbs, cp, tp) * num_attn_layers
    return nbytes / (bw_gbps * 1e6)


def a2a_comm_bytes_per_layer(
    model: ModelSpec, mbs: int, cp: int, tp: int
) -> float:
    """Un-overlapped Ulysses (all-to-all) wire bytes one device moves per
    transformer layer per microbatch: 4 tensors re-shard each direction of
    the forward (q, k, v in; context out) and their 4 gradients on the
    backward; an all-to-all moves ``(cp-1)/cp`` of each local tensor of
    ``mbs x S/cp x hidden/tp``.  Asymptotically ~cp x less traffic than the
    ring's K/V rotation (``ring_comm_bytes_per_layer``) — the planner prices
    both and picks per stage (``Strategy.cp_mode``)."""
    if cp <= 1:
        return 0.0
    local = (
        mbs
        * (model.sequence_length // cp)
        * (model.hidden_size // tp)
        * model.dtype_bytes
    )
    return 8 * local * (cp - 1) / cp


def cp_comm_ms(
    model: ModelSpec,
    mbs: int,
    cp: int,
    tp: int,
    num_attn_layers: int,
    bw_gbps: float,
    mode: str = "ring",
) -> float:
    """Context-parallel comm time (ms) for one microbatch across a stage's
    attention layers, for either cp mode ("ring" or "a2a")."""
    if cp <= 1 or num_attn_layers <= 0:
        return 0.0
    per_layer = (
        a2a_comm_bytes_per_layer(model, mbs, cp, tp) if mode == "a2a"
        else ring_comm_bytes_per_layer(model, mbs, cp, tp))
    return per_layer * num_attn_layers / (bw_gbps * 1e6)


def attention_layer_range(model: ModelSpec, start: int, end: int) -> int:
    """How many layers in [start, end) are transformer blocks (ring attention
    runs only there; the embed (0) and head (L-1) pseudo-layers carry none)."""
    lo = max(start, 1)
    hi = min(end, model.num_layers - 1)
    return max(0, hi - lo)


class ActivationSplitModel:
    """Per-layer (static, bs-slope) memory decomposition fit from a profile
    store's batch-size sweep, cached per (device_type, tp)."""

    def __init__(self, profiles: ProfileStore):
        self.profiles = profiles
        self._cache: dict[tuple[str, int], tuple[tuple[float, ...], tuple[float, ...]] | None] = {}

    def split(
        self, device_type: str, tp: int
    ) -> tuple[tuple[float, ...], tuple[float, ...]] | None:
        """(static_mb, act_slope_mb_per_bs) per layer, or None when the store
        has <2 batch points for this (type, tp) and the split is
        unidentifiable."""
        key = (device_type, tp)
        if key not in self._cache:
            self._cache[key] = self._fit(device_type, tp)
        return self._cache[key]

    def _fit(self, device_type: str, tp: int):
        points = sorted(
            (bs, self.profiles.get(device_type, tp, bs).layer_memory_mb)
            for (t, p, bs) in self.profiles.configs(device_type)
            if t == device_type and p == tp
        )
        if len(points) < 2:
            return None
        xs = [float(bs) for bs, _ in points]
        if len(set(xs)) < 2:
            return None
        num_layers = len(points[0][1])
        static: list[float] = []
        slope: list[float] = []
        for layer in range(num_layers):
            ys = [mem[layer] for _, mem in points]
            a, b = affine_fit(xs, ys)
            # Physical clamps: activations can't be negative; static memory
            # can't exceed the smallest observed total.
            b = max(b, 0.0)
            a = max(min(a, min(ys)), 0.0)
            static.append(a)
            slope.append(b)
        return tuple(static), tuple(slope)

    def layer_memory(
        self,
        device_type: str,
        tp: int,
        bs: int,
        act_divisor: float = 1.0,
        static_scale: Sequence[float] | None = None,
        static_reduction_mb: Sequence[float] | None = None,
        act_scale: Sequence[float] | None = None,
    ) -> tuple[float, ...]:
        """Per-layer memory row (MB) with the activation component divided by
        ``act_divisor`` (sequence/context sharding) and scaled per layer by
        ``act_scale`` (partial activation sharding, e.g. Megatron sp), the
        static component scaled per layer by ``static_scale`` (weight
        sharding, e.g. expert parallelism), then reduced by
        ``static_reduction_mb`` (absolute sharded-state relief, e.g. ZeRO;
        clamped at zero).  Falls back to the measured full row (no relief)
        when the static/activation split cannot be identified — conservative,
        never optimistic."""
        base = self.profiles.get(device_type, tp, bs).layer_memory_mb
        if (act_divisor <= 1 and static_scale is None
                and static_reduction_mb is None and act_scale is None):
            return base
        fitted = self.split(device_type, tp)
        if fitted is None:
            return base
        n = len(base)
        static, slope = fitted
        scales = static_scale if static_scale is not None else [1.0] * n
        cuts = (static_reduction_mb if static_reduction_mb is not None
                else [0.0] * n)
        ascales = act_scale if act_scale is not None else [1.0] * n
        return tuple(
            min(max(s * sc - cut, 0.0) + bs * m * asc / act_divisor, full)
            for s, m, sc, cut, asc, full
            in zip(static, slope, scales, cuts, ascales, base)
        )

    def layer_memory_with_cp(
        self, device_type: str, tp: int, bs: int, cp: int
    ) -> tuple[float, ...]:
        """Per-layer memory row (MB) under sequence sharding by ``cp``."""
        return self.layer_memory(device_type, tp, bs, act_divisor=cp)


def cp_candidates(max_cp_degree: int, sequence_length: int) -> list[int]:
    """Power-of-two cp degrees to search: cp must divide the sequence."""
    out = []
    cp = 2
    while cp <= max_cp_degree:
        if sequence_length % cp == 0:
            out.append(cp)
        cp *= 2
    return out
