"""Ulysses (all-to-all) context parallelism — the port of
``metis_tpu/ops/ulysses.py``, the second long-context mode beside ring
attention.

Each rank of the context-parallel group holds a block of the sequence for
every head.  ``seq_to_heads`` trades the sequence blocks for head blocks
(one all-to-all each of q, k and v), so that each rank holds the whole
sequence of ``h / cp`` heads and runs unmodified causal attention over it;
``heads_to_seq`` trades the context back.  The reference writes the two
re-shards as sharding constraints and lets XLA insert the all-to-alls.

Heads per rank (after tp) must divide by cp: the search dooms a2a plans
whose heads stop dividing, and ``seq_to_heads`` raises ``ValueError``.  No
``supports_gqa``: grouped K/V are expanded to the query heads before the
trade, as the reference does and as ``cost/context_parallel.py`` prices it.
"""
from __future__ import annotations

from metis_tpu_torch.models.parallel import heads_to_seq, seq_to_heads


def make_ulysses_attention(group):
    """An ``AttnFn`` (q, k, v -> context, ``[b, h, s, d]``) running Ulysses
    over the context-parallel ``group``; the full-sequence attention is the
    flash kernels' for CUDA tensors and dense causal attention on the CPU,
    as the reference picks by platform."""
    def attn(q, k, v):
        if q.is_cuda:
            from metis_tpu_torch.ops.flash_attention import flash_attn_fn
            inner = flash_attn_fn()
        else:
            from metis_tpu_torch.models.gpt import causal_attention
            inner = causal_attention
        ctx = inner(*(seq_to_heads(t, group) for t in (q, k, v)))
        return heads_to_seq(ctx, group)

    return attn
