"""Expert-parallel (MoE) planning model — net-new TPU capability.

The port's copy of ``metis_tpu/cost/expert_parallel.py``.

The reference has no MoE/EP support anywhere (SURVEY.md §2.2: "EP — Absent").
This module adds the cost and memory model for an expert-parallel plan axis:
a stage's experts may be sharded over ``Strategy.ep`` devices, with tokens
exchanged by all-to-all over the interconnect (execution counterpart in
the reference: ``metis_tpu/models/moe.py`` + the ``ep`` mesh axis).

Semantics (Megatron-style, encoded in ``core.types.Strategy``): **ep rides
inside dp** — an ep group is a sub-group of the stage's dp*cp data ranks, so
``ep`` must divide ``dp`` and consumes no extra devices.  Consequences the
model captures:

- **Compute** is unchanged by ep: every rank still processes its own
  microbatch; the all-to-all redistributes tokens to expert owners and back,
  and with balanced routing each rank computes the same token count it sent.
  (Imbalance shows up in measured profiles, not the analytic model.)
- **All-to-all traffic**: per MoE layer per microbatch, a rank dispatches
  ``mbs * seq * top_k`` token activations of ``hidden`` features, of which the
  fraction ``(ep-1)/ep`` crosses the wire, twice forward (dispatch + combine)
  and twice backward — 4 passes.  Charged un-overlapped (conservative;
  calibrate via the predicted-vs-measured validator).
- **Memory**: expert weights (and their optimizer state) shard 1/ep while
  everything else replicates.  Profiles report one per-layer total; the
  bs-sweep affine fit (``cost.context_parallel.ActivationSplitModel``) gives
  the static (weights+optimizer) vs activation split, and the analytic
  expert-parameter fraction of a block then scales only the expert share of
  the static part.
- **Gradient sync**: expert parameters all-reduce over ``dp*cp/ep`` ranks
  (the replicas of each expert shard); non-expert parameters over ``dp*cp``.
- **Dispatch/combine activation memory**: ``models.moe`` routes tokens in
  fixed-size groups (``MoEConfig.route_group_size``), so the one-hot
  dispatch/combine tensors are *linear* in tokens — which is exactly the
  affine-in-bs activation model the profile bs-sweep fit
  (``ActivationSplitModel``) assumes.  (With global routing they were
  O(T^2·top_k) and the fit under-predicted large batches.)
"""
from __future__ import annotations

from metis_tpu_torch.core.config import ModelSpec
from metis_tpu_torch.cost.context_parallel import ActivationSplitModel

# All-to-all passes per MoE layer per microbatch: dispatch + combine, forward
# and backward.
A2A_PASSES = 4


def _bytes_per_ms(bw_gbps: float) -> float:
    return bw_gbps * 1e6


def all_to_all_ms(nbytes: float, group_size: int, bw_gbps: float,
                  latency_ms: float = 0.0, wrap: bool = True) -> float:
    """All-to-all on a ring — the port's own copy of
    ``metis_tpu/cost/ici.py:all_to_all_ms`` (the torus model itself is not
    ported).  Each rank sends ``nbytes/n`` to every peer over shortest
    paths; the per-direction link traffic sums to ``n*nbytes/8`` on a
    bidirectional ring (mean hop distance n/4, both directions used), double
    on a line.  Unlike an all-gather it *grows* with n (bisection limited)."""
    if group_size <= 1:
        return 0.0
    factor = 8.0 if wrap else 4.0
    return (group_size * nbytes / factor / _bytes_per_ms(bw_gbps)
            + (group_size - 1) * latency_ms)


def ep_candidates(max_ep_degree: int, num_experts: int) -> list[int]:
    """Power-of-two ep degrees to search: ep must divide the expert count."""
    out = []
    ep = 2
    while ep <= max_ep_degree:
        if num_experts > 0 and num_experts % ep == 0:
            out.append(ep)
        ep *= 2
    return out


def moe_layer_range(model: ModelSpec, start: int, end: int) -> int:
    """How many layers in [start, end) carry experts (all transformer blocks
    of an MoE model; the embed/head pseudo-layers carry none)."""
    if model.num_experts <= 1:
        return 0
    lo = max(start, 1)
    hi = min(end, model.num_layers - 1)
    return max(0, hi - lo)


def a2a_buffer_bytes(model: ModelSpec, mbs: int, cp: int = 1) -> float:
    """One rank's all-to-all send buffer per MoE layer per pass: every
    routed token copy (``top_k`` per token) with ``hidden`` features.  With
    context parallelism each rank holds only seq/cp tokens, so combined
    (cp, ep) families dispatch proportionally less."""
    return (
        mbs
        * (model.sequence_length // cp)
        * model.expert_top_k
        * model.hidden_size
        * model.dtype_bytes
    )


def a2a_bytes_per_layer(model: ModelSpec, mbs: int, ep: int, cp: int = 1) -> float:
    """Un-overlapped all-to-all wire bytes one rank moves per MoE layer per
    microbatch (4 passes, cross-rank fraction (ep-1)/ep) — the *volume*
    view; the *time* model (``ep_a2a_ms``) prices the ring routing of that
    volume via ``all_to_all_ms``."""
    if ep <= 1:
        return 0.0
    return A2A_PASSES * a2a_buffer_bytes(model, mbs, cp) * (ep - 1) / ep


def ep_a2a_ms(
    model: ModelSpec, mbs: int, ep: int, num_moe_layers: int, bw_gbps: float,
    cp: int = 1,
) -> float:
    """All-to-all time (ms) for one microbatch across a stage's MoE layers:
    4 passes (dispatch + combine, forward + backward) of the per-rank send
    buffer through the bidirectional-ring all-to-all model
    (``all_to_all_ms`` — per-link traffic ``n*V/8``, which *grows* with
    ep; the flat (ep-1)/ep volume model under-charged large ep by >2x)."""
    if ep <= 1 or num_moe_layers <= 0:
        return 0.0
    per_pass = all_to_all_ms(a2a_buffer_bytes(model, mbs, cp), ep, bw_gbps)
    return A2A_PASSES * per_pass * num_moe_layers


def expert_param_fraction(model: ModelSpec) -> float:
    """Analytic fraction of a transformer block's parameters that are expert
    weights (the part ep shards).  MoE blocks replace the dense FFN with
    ``num_experts`` expert FFNs plus a router."""
    if model.num_experts <= 1:
        return 0.0
    h = model.hidden_size
    f = h * model.ffn_multiplier
    expert = model.num_experts * 2 * h * f
    router = h * model.num_experts
    attn = 4 * h * h  # qkv + proj
    return expert / (expert + router + attn)


def expert_static_scale(
    model: ModelSpec, n_layers: int, ep: int
) -> list[float] | None:
    """Per-layer multiplier on static memory under ep-way expert sharding
    (None when nothing shards).  Block layers keep the dense fraction plus
    1/ep of the expert fraction; the embed/head pseudo-layers carry no
    experts."""
    if ep <= 1 or model.num_experts <= 1:
        return None
    frac = expert_param_fraction(model)
    block_scale = (1 - frac) + frac / ep
    return [1.0] + [block_scale] * (n_layers - 2) + [1.0]


def layer_memory_with_ep(
    split_model: ActivationSplitModel,
    model: ModelSpec,
    device_type: str,
    tp: int,
    bs: int,
    ep: int,
    cp: int = 1,
) -> tuple[float, ...]:
    """Per-layer memory row (MB) under expert sharding by ``ep`` (and,
    combined, sequence sharding by ``cp``).

    Expert relief applies the analytic expert fraction to the *static*
    component of block layers only (delegating to
    ``ActivationSplitModel.layer_memory`` for the split/fallback/clamp
    mechanics, which the cp path shares).
    """
    n = len(split_model.profiles.get(device_type, tp, bs).layer_memory_mb)
    return split_model.layer_memory(
        device_type, tp, bs, act_divisor=cp,
        static_scale=expert_static_scale(model, n, ep))
