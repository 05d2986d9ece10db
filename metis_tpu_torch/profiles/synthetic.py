"""Synthetic profile generation — analytic roofline stand-ins for measured
profiles: the port's copy of ``metis_tpu/profiles/synthetic.py``.

The reference ships 9 measured A100 fixture files (``profile_data_samples/``)
and documents, but does not implement, profile collection (``README.md:142-186``).
We keep the planner runnable with zero TPUs (SURVEY.md §4) by synthesizing
self-consistent profiles from a roofline model: MXU-bound matmul FLOPs at a
batch-dependent utilization, HBM-bound embedding/softmax terms, Adam-state
memory.  Real measured profiles (``profiles/profiler.py``) use the identical schema
and simply replace these.

The absolute values are not meant to match any real chip; what matters for the
planner is self-consistency and the right monotonicities (time falls with tp,
rises with bs; memory falls with tp, rises with bs).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from metis_tpu_torch.cluster.tpu import TPU_GENERATIONS
from metis_tpu_torch.core.config import ModelSpec
from metis_tpu_torch.profiles.store import (
    DeviceTypeMeta,
    LayerProfile,
    ModelProfileMeta,
    ProfileStore,
)


@dataclass(frozen=True)
class ChipPerf:
    """Roofline inputs for one device type."""

    name: str
    bf16_tflops: float
    hbm_bw_gbps: float
    hbm_gb: float
    base_mfu: float = 0.45  # large-matmul MXU utilization

    def mfu(self, per_device_bs: int, tp: int) -> float:
        # Small local batches / high tp shrink matmul tiles and MXU efficiency.
        shrink = 1.0 - 0.25 / (per_device_bs + 1) - 0.04 * math.log2(max(tp, 1))
        return max(self.base_mfu * shrink, 0.05)


# Rough public-spec rooflines for the GPU types used by reference-shaped tests,
# plus TPU generations pulled from the topology model.
CHIP_PERF: dict[str, ChipPerf] = {
    "A100": ChipPerf("A100", bf16_tflops=312, hbm_bw_gbps=2039, hbm_gb=80),
    "V100": ChipPerf("V100", bf16_tflops=125, hbm_bw_gbps=900, hbm_gb=16),
    "P100": ChipPerf("P100", bf16_tflops=21, hbm_bw_gbps=732, hbm_gb=16),
    "T4": ChipPerf("T4", bf16_tflops=65, hbm_bw_gbps=320, hbm_gb=15),
}
for _g in TPU_GENERATIONS.values():
    CHIP_PERF[_g.name] = ChipPerf(_g.name, _g.bf16_tflops, _g.hbm_bw_gbps, _g.hbm_gb)

_ADAM_STATE_FACTOR = 6.0   # fp32 master + 2 moments over bf16 weights
_BWD_FLOP_FACTOR = 2.0     # backward ≈ 2x forward FLOPs


def _params_per_layer(model: ModelSpec) -> tuple[int, ...]:
    h, v = model.hidden_size, model.vocab_size
    f = h * model.ffn_multiplier
    embed = v * h + model.sequence_length * h          # token + position tables
    attn = 4 * h * h + 13 * h                          # qkv + proj + norms/bias
    if model.num_experts > 0:
        # MoE block: router + num_experts expert FFNs replace the dense FFN
        ffn = h * model.num_experts + model.num_experts * 2 * h * f
    else:
        ffn = 2 * h * f
    block = attn + ffn
    head = v * h                                       # untied LM head
    layers = [embed] + [block] * model.num_blocks + [head]
    return tuple(p * model.dtype_bytes for p in layers)


def _block_flops(model: ModelSpec, bs: int) -> float:
    h, s = model.hidden_size, model.sequence_length
    f = h * model.ffn_multiplier
    attn_mm = 8 * bs * s * h * h       # qkv + proj matmuls
    ffn_mm = 4 * bs * s * h * f        # 2 FFN matmuls
    if model.num_experts > 0:
        # each token runs top_k expert FFNs, plus the router matmul
        ffn_mm = ffn_mm * model.expert_top_k + 2 * bs * s * h * model.num_experts
    attn_sc = 4 * bs * s * s * h       # scores + context
    return (attn_mm + ffn_mm + attn_sc) * (1 + _BWD_FLOP_FACTOR)


def _head_flops(model: ModelSpec, bs: int) -> float:
    return 2 * bs * model.sequence_length * model.hidden_size * model.vocab_size \
        * (1 + _BWD_FLOP_FACTOR)


def synthesize_profiles(
    model: ModelSpec,
    device_types: list[str],
    tps: list[int] | None = None,
    bss: list[int] | None = None,
    chip_perf: dict[str, ChipPerf] | None = None,
    decode_context: int = 0,
) -> ProfileStore:
    """Build a ProfileStore covering ``device_types`` × ``tps`` × ``bss``.

    ``decode_context > 0`` additionally synthesizes a measured-style decode
    table per entry (single-token step with that many KV tokens resident,
    roofline max of GEMV compute vs weight+cache reads) — the zero-TPU
    stand-in for ``profile --decode``.  Off by default so training
    fixtures keep their exact historical bytes."""
    tps = tps or [1, 2, 4]
    bss = bss or [1, 2, 4, 8]
    perf_map = chip_perf or CHIP_PERF

    params = _params_per_layer(model)
    entries: dict[tuple[str, int, int], LayerProfile] = {}
    for dtype in device_types:
        perf = perf_map[dtype]
        for tp in tps:
            for bs in bss:
                prof = _synth_layer_profile(model, perf, tp, bs, params)
                if decode_context > 0:
                    prof = LayerProfile(
                        layer_times_ms=prof.layer_times_ms,
                        layer_memory_mb=prof.layer_memory_mb,
                        fb_sync_ms=prof.fb_sync_ms,
                        decode_layer_times_ms=_synth_decode_times(
                            model, perf, tp, bs, params, decode_context),
                        decode_context_len=decode_context,
                    )
                entries[(dtype, tp, bs)] = prof

    # Optimizer reads/writes all Adam state at each chip type's HBM bandwidth.
    opt_bytes = sum(params) * (1 + _ADAM_STATE_FACTOR)
    type_meta = {
        t: DeviceTypeMeta(
            optimizer_time_ms=opt_bytes / (perf_map[t].hbm_bw_gbps * 1e9) * 1e3,
            batch_generator_ms=0.5,
        )
        for t in device_types
    }
    first = type_meta[device_types[0]]
    meta = ModelProfileMeta(
        num_layers=model.num_layers,
        optimizer_time_ms=first.optimizer_time_ms,
        batch_generator_ms=first.batch_generator_ms,
        params_per_layer_bytes=params,
    )
    return ProfileStore(entries, meta, type_meta)


def _synth_layer_profile(
    model: ModelSpec, perf: ChipPerf, tp: int, bs: int, params: tuple[int, ...]
) -> LayerProfile:
    h, s = model.hidden_size, model.sequence_length
    eff_flops = perf.bf16_tflops * 1e12 * perf.mfu(bs, tp)
    hbm_bps = perf.hbm_bw_gbps * 1e9

    def matmul_ms(flops: float) -> float:
        return flops / tp / eff_flops * 1e3

    # Embedding: gather + position add — HBM bound on the activation volume.
    embed_bytes = 3 * bs * s * h * model.dtype_bytes
    embed_ms = embed_bytes / hbm_bps * 1e3

    block_ms = matmul_ms(_block_flops(model, bs))
    head_ms = matmul_ms(_head_flops(model, bs)) + embed_ms  # matmul + softmax IO

    times = [embed_ms] + [block_ms] * model.num_blocks + [head_ms]

    # Memory: sharded weights + Adam state + activations kept for backward.
    act_bytes_block = 10 * bs * s * h * model.dtype_bytes / tp
    act_bytes_head = bs * s * model.vocab_size * model.dtype_bytes / tp

    def layer_mem_mb(param_bytes: int, act_bytes: float) -> float:
        state = param_bytes / tp * (1 + _ADAM_STATE_FACTOR)
        return (state + act_bytes) / (1024 * 1024)

    mems = (
        [layer_mem_mb(params[0], act_bytes_block)]
        + [layer_mem_mb(params[1], act_bytes_block)] * model.num_blocks
        + [layer_mem_mb(params[-1], act_bytes_head)]
    )

    fb_sync = 0.02 * sum(times) + 0.1  # launch/sync overhead not in layer times
    return LayerProfile(
        layer_times_ms=tuple(times),
        layer_memory_mb=tuple(mems),
        fb_sync_ms=fb_sync,
    )


def _synth_decode_times(
    model: ModelSpec, perf: ChipPerf, tp: int, bs: int,
    params: tuple[int, ...], context: int,
) -> tuple[float, ...]:
    """Per-layer single-token decode step times: roofline max of the GEMV
    compute (forward only, one token per sequence) and the HBM reads the
    step cannot avoid (stage weights once + the batch's KV cache)."""
    h, v = model.hidden_size, model.vocab_size
    f = h * model.ffn_multiplier
    eff_flops = perf.bf16_tflops * 1e12 * perf.mfu(bs, tp)
    hbm_bps = perf.hbm_bw_gbps * 1e9
    kv_heads = model.num_kv_heads or model.num_heads
    head_dim = h // model.num_heads
    kv_bytes = bs * context * 2 * kv_heads * head_dim * model.dtype_bytes / tp

    def step_ms(flops: float, read_bytes: float) -> float:
        return max(flops / tp / eff_flops, read_bytes / hbm_bps) * 1e3

    # embed: one-row gathers, negligible compute, reads bs embedding rows
    embed_ms = step_ms(0.0, bs * h * model.dtype_bytes)
    # block: qkv/proj/FFN GEMVs + attention over the resident cache
    block_flops = (8 * bs * h * h + 4 * bs * h * f
                   + 4 * bs * context * kv_heads * head_dim)
    block_ms = step_ms(block_flops, params[1] / tp + kv_bytes)
    # head: one-token logits GEMV against the full vocab projection
    head_ms = step_ms(2 * bs * h * v, params[-1] / tp)
    return tuple([embed_ms] + [block_ms] * model.num_blocks + [head_ms])


def tiny_test_model(num_layers: int = 10) -> ModelSpec:
    """The GPT-shaped model used across unit tests (mirrors the reference
    fixture scale: 10 profiled layers, hidden 4096, seq 1024)."""
    return ModelSpec(
        name="gpt-test",
        num_layers=num_layers,
        hidden_size=4096,
        sequence_length=1024,
        vocab_size=51200,
        num_heads=32,
    )
