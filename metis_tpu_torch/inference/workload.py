"""Serving workload model: traffic shape + profile-derived phase timings.

The port's copy of ``metis_tpu/inference/workload.py``.

The training profiles measure one fwd+bwd pass over ``sequence_length``
tokens per sample.  Serving reuses them by decomposition rather than by
re-profiling:

- **prefill** is the forward share of the profiled pass, scaled to the
  prompt length (compute-bound, full-sequence) — ``REMAT_FWD_FRACTION`` is
  the same fwd:fwd+bwd split the rematerializing pipeline schedules price
  with, so the two workloads can never disagree about what "forward" costs;
- **decode** is one token per sequence per step: the forward per-token rate
  at the LARGEST profiled batch (continuous batching amortizes dispatch the
  way a big profiled batch does), raced against the HBM roofline of reading
  the stage's weights + KV cache every step (``cluster.DeviceSpec
  .effective_hbm_gbps``).

Nothing here enumerates placements — :mod:`metis_tpu_torch.inference.planner`
sweeps pools/stages and calls these per-stage primitives.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

from metis_tpu_torch.core.config import ModelSpec
from metis_tpu_torch.core.errors import ProfileMissError
from metis_tpu_torch.cost.schedule import REMAT_FWD_FRACTION
from metis_tpu_torch.profiles.store import ProfileStore


@dataclass(frozen=True)
class InferenceWorkload:
    """Traffic description + latency SLOs for one serving deployment.

    Lengths are tokens; the ``*_p99`` fields describe the distribution tail
    the SLO is evaluated at (0 = deterministic lengths, tail == mean).
    ``kv_dtype_bytes`` prices the KV cache separately from activations —
    int8 KV (1) halves the footprint of the bf16 default (2).

    The paged-sharing fields describe production prompt reuse:
    ``prefix_share_frac`` of requests share ONE common prompt prefix of
    ``prefix_len`` tokens (system prompt, few-shot preamble) whose KV pages
    are stored once per lane instead of once per sequence;
    ``page_tokens`` is the KV allocator's page granularity (0 = exact,
    unpaged accounting, the model before paging).  All three default to off, which
    is byte-identical to the pre-paging cost model."""

    arrival_rate_rps: float
    prompt_len: int
    output_len: int
    slo_ttft_p99_ms: float
    slo_tpot_p99_ms: float
    prompt_len_p99: int = 0
    output_len_p99: int = 0
    kv_dtype_bytes: int = 2
    prefix_share_frac: float = 0.0
    prefix_len: int = 0
    page_tokens: int = 0

    def __post_init__(self) -> None:
        if self.arrival_rate_rps <= 0:
            raise ValueError("arrival_rate_rps must be positive")
        if self.prompt_len < 1 or self.output_len < 1:
            raise ValueError("prompt_len and output_len must be >= 1")
        if self.slo_ttft_p99_ms <= 0 or self.slo_tpot_p99_ms <= 0:
            raise ValueError("SLO targets must be positive")
        if self.prompt_len_p99 and self.prompt_len_p99 < self.prompt_len:
            raise ValueError("prompt_len_p99 cannot undercut prompt_len")
        if self.output_len_p99 and self.output_len_p99 < self.output_len:
            raise ValueError("output_len_p99 cannot undercut output_len")
        if self.kv_dtype_bytes < 1:
            raise ValueError("kv_dtype_bytes must be >= 1")
        if not 0.0 <= self.prefix_share_frac <= 1.0:
            raise ValueError("prefix_share_frac must be in [0, 1]")
        if self.prefix_len < 0 or self.page_tokens < 0:
            raise ValueError("prefix_len and page_tokens must be >= 0")

    @property
    def tail_prompt_len(self) -> int:
        return self.prompt_len_p99 or self.prompt_len

    @property
    def tail_output_len(self) -> int:
        return self.output_len_p99 or self.output_len

    @property
    def max_context_len(self) -> int:
        """Worst-case KV residency per sequence (end of tail generation)."""
        return self.tail_prompt_len + self.tail_output_len

    @property
    def shared_prefix_len(self) -> int:
        """Shared-prefix tokens actually creditable: the prefix lives in the
        prompt (generation always diverges), so it clamps to the tail prompt
        length."""
        return min(self.prefix_len, self.tail_prompt_len)

    def to_json_dict(self) -> dict:
        d = asdict(self)
        # Paged-sharing fields at their off defaults are omitted so default
        # workloads serialize exactly as they did pre-paging — the frozen
        # inference golden sha-pins these bytes.
        for f in ("prefix_share_frac", "prefix_len", "page_tokens"):
            if not d[f]:
                del d[f]
        return d


def workload_from_dict(d: dict) -> InferenceWorkload:
    """Build from a parsed workload-spec JSON (CLI ``--workload-spec`` /
    serve daemon request body).  Unknown keys raise — a typoed SLO field
    silently defaulting would rank plans against the wrong target."""
    known = {f for f in InferenceWorkload.__dataclass_fields__}
    extra = set(d) - known
    if extra:
        raise ValueError(f"unknown workload fields: {sorted(extra)}")
    return InferenceWorkload(**d)


def largest_profiled_bs(profiles: ProfileStore, device_type: str, tp: int,
                        cap: int) -> int:
    """Largest profiled batch size <= ``cap`` for (device_type, tp) — the
    per-token decode rate is read there, where per-batch dispatch overhead
    is best amortized (continuous batching runs the same regime)."""
    best = max((bs for (t, p, bs) in profiles.configs(device_type)
                if p == tp and bs <= cap), default=0)
    if not best:
        raise ProfileMissError(device_type, tp, cap)
    return best


def prefill_stage_ms(
    profiles: ProfileStore,
    model: ModelSpec,
    device_type: str,
    tp: int,
    start: int,
    end: int,
    prompt_len: int,
    fwd_fraction: float = REMAT_FWD_FRACTION,
) -> float:
    """Forward time for one prompt across layers ``[start, end)`` on one
    device type: the bs=1 profiled fwd+bwd slice, forward share only,
    rescaled from the profiled sequence length to the prompt length (dense
    attention is ~quadratic in sequence, so linear rescaling flatters long
    prompts slightly — conservative callers pass the p99 prompt)."""
    prof = profiles.get(device_type, tp, 1)
    return (fwd_fraction * prof.time_slice(start, end)
            * prompt_len / model.sequence_length)


def decode_compute_stage_ms(
    profiles: ProfileStore,
    model: ModelSpec,
    device_type: str,
    tp: int,
    start: int,
    end: int,
    batch: int,
    max_profiled_bs: int,
    fwd_fraction: float = REMAT_FWD_FRACTION,
) -> float:
    """Compute-side decode step time for ``batch`` sequences on one stage:
    the best-amortized profiled per-token forward rate × one token per
    sequence."""
    bs = largest_profiled_bs(profiles, device_type, tp, max_profiled_bs)
    prof = profiles.get(device_type, tp, bs)
    per_token_ms = fwd_fraction * prof.time_slice(start, end) / (
        bs * model.sequence_length)
    return per_token_ms * batch


def largest_decode_bs(profiles: ProfileStore, device_type: str, tp: int,
                      cap: int) -> int:
    """Largest DECODE-profiled batch size <= ``cap`` for (device_type, tp),
    or 0 when the store has no measured decode table there — callers fall
    back to the forward-share derivation rather than raising."""
    return max((bs for (t, p, bs) in profiles.decode_configs(device_type)
                if p == tp and bs <= cap), default=0)


def measured_decode_stage_ms(
    profiles: ProfileStore,
    device_type: str,
    tp: int,
    start: int,
    end: int,
    batch: int,
    max_profiled_bs: int,
) -> float | None:
    """Decode step time for ``batch`` sequences across layers [start, end)
    priced from the MEASURED decode table (KV-cache-resident single-token
    microbenchmark), or None when (device_type, tp) has no decode entry —
    the planner then derives from the training forward share instead.

    Read at the largest decode-profiled batch (same amortization argument
    as :func:`largest_profiled_bs`) and scaled linearly to ``batch``."""
    bs = largest_decode_bs(profiles, device_type, tp, max_profiled_bs)
    if not bs:
        return None
    prof = profiles.get(device_type, tp, bs)
    return prof.decode_time_slice(start, end) / bs * batch


def hbm_read_ms(bytes_read: float, hbm_gbps: float) -> float:
    """Time to stream ``bytes_read`` from device memory (GB/s = 1e6
    bytes/ms, the native unit convention of ``EstimatorOptions``)."""
    return bytes_read / (hbm_gbps * 1e6)


def throughput_curve(step_ms_of_batch, batches) -> list[tuple[int, float]]:
    """Continuous-batching throughput curve: (batch, generated tokens/s)
    for each candidate concurrency.  ``step_ms_of_batch`` is the plan's
    decode step-time model (e.g. the planner's TPOT at batch B); the curve
    saturates where the step goes HBM/compute-bound in B."""
    out: list[tuple[int, float]] = []
    for b in batches:
        step = step_ms_of_batch(b)
        out.append((b, b * 1000.0 / step if step > 0 else 0.0))
    return out
