"""Model shape — the port's copy of ``ModelSpec`` from
``metis_tpu/core/config.py``.  The planner's ``SearchConfig`` comes with the
slice that ports the planner."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelSpec:
    """Transformer model shape.

    ``num_layers`` counts *profiled* layers including the embedding (first) and
    LM-head (last) pseudo-layers, matching the profile contract (10 entries =
    embed + 8 blocks + head).
    """

    name: str
    num_layers: int
    hidden_size: int
    sequence_length: int
    vocab_size: int
    num_heads: int
    ffn_multiplier: int = 4
    dtype_bytes: int = 2  # bf16 activations
    num_experts: int = 0  # MoE shape (0 = dense model)
    expert_top_k: int = 1
    family: str = "gpt"  # "gpt" or "llama"
    num_kv_heads: int = 0  # GQA KV heads for family="llama"; 0 -> num_heads
    # attention implementation the executors AND the profiler use: "dense"
    # (materialized scores) or "flash" (the blockwise kernels); part of the
    # spec so profiles, plans and validation describe the execution that runs
    attn: str = "dense"

    def __post_init__(self) -> None:
        if self.num_layers < 3:
            raise ValueError("num_layers must include embed + >=1 block + head")
        if self.hidden_size % self.num_heads != 0:
            raise ValueError("num_heads must divide hidden_size evenly")
        if self.num_experts < 0 or self.expert_top_k < 1:
            raise ValueError("invalid MoE shape")
        if self.num_experts > 0 and self.expert_top_k > self.num_experts:
            raise ValueError("expert_top_k cannot exceed num_experts")
        if self.family not in ("gpt", "llama"):
            raise ValueError(f"unknown model family {self.family!r}")
        if self.num_kv_heads and self.num_heads % self.num_kv_heads != 0:
            raise ValueError("num_kv_heads must divide num_heads")
        if self.attn not in ("dense", "flash"):
            raise ValueError(f"unknown attention impl {self.attn!r}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_blocks(self) -> int:
        """Transformer blocks proper (excluding embed/head pseudo-layers)."""
        return self.num_layers - 2
