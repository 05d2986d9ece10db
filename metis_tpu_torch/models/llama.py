"""LLaMA-style transformer — the port of ``metis_tpu/models/llama.py``.

The differences from the GPT family (``models/gpt.py``), as in the
reference: RMSNorm in fp32 (no mean, no bias); rotary position embeddings
on q and k (rotate-half convention, fp32 trig, no position table);
grouped-query attention with ``num_kv_heads`` K/V heads; a SwiGLU FFN
``w_down(silu(w_gate y) * w_up y)`` whose gate and up products stay fp32
until after the multiply; no biases anywhere.  The leaves are the
reference's leaf for leaf (``wkv`` is ``(L, 2, h, kvh * hd)``), so a JAX
tree converts with ``models.convert.from_numpy_tree``.

Tensor parallelism (``tp_group``) is Megatron's, as in the GPT port: ``wq``,
``w_gate`` and ``w_up`` column-parallel, ``wo`` and ``w_down`` row-parallel,
the embedding and the head vocab-parallel.  ``wkv`` is column-parallel when
the KV heads split evenly over tp; otherwise every rank holds all of it
(``execution.mesh.llama_param_specs``) and takes the KV heads its query
heads use (``_rank_kv``) — what GSPMD works out by itself in the reference.

The flash kernels take the unexpanded K/V (``supports_gqa``); only the dense
attention repeats the KV heads up to the query heads.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from metis_tpu_torch.core.config import ModelSpec
from metis_tpu_torch.models.gpt import (
    AttnFn,
    GPTConfig,
    _tp_size,
    causal_attention,
    unstack_blocks,
)
from metis_tpu_torch.models.parallel import (
    column_parallel,
    column_parallel_f32,
    copy_to_tp,
    row_parallel,
    vocab_parallel_cross_entropy,
    vocab_parallel_embedding,
)


@dataclass(frozen=True)
class LlamaConfig(GPTConfig):
    num_kv_heads: int = 0  # 0 -> num_heads (plain MHA)
    rope_theta: float = 10000.0

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    def __post_init__(self) -> None:
        if self.num_heads % self.kv_heads != 0:
            raise ValueError(
                f"num_kv_heads {self.kv_heads} must divide num_heads "
                f"{self.num_heads}")

    @staticmethod
    def from_model_spec(spec: ModelSpec, **overrides) -> "LlamaConfig":
        cfg = LlamaConfig(
            vocab_size=spec.vocab_size,
            seq_len=spec.sequence_length,
            hidden=spec.hidden_size,
            num_heads=spec.num_heads,
            num_blocks=spec.num_blocks,
            ffn_multiplier=spec.ffn_multiplier,
            num_kv_heads=spec.num_kv_heads,
            attn=spec.attn,
        )
        return replace(cfg, **overrides) if overrides else cfg


def kv_sharded(cfg: LlamaConfig, tp: int) -> bool:
    """Whether ``wkv`` splits over tp (whole KV heads per rank) or every
    rank holds all of it — the reference's ``kv_t`` rule."""
    return tp <= 1 or cfg.kv_heads % tp == 0


def init_llama_params(gen: torch.Generator, cfg: LlamaConfig,
                      device: str | torch.device = "cuda",
                      shard: Callable | None = None) -> dict:
    """Parameter tree drawn from ``gen``, as ``gpt.init_params`` (same
    ``shard`` contract); the reference's shapes, scales and layout."""
    h, f, v = cfg.hidden, cfg.ffn_dim, cfg.vocab_size
    kvh, hd, L = cfg.kv_heads, cfg.head_dim, cfg.num_blocks
    pd = cfg.param_dtype
    scale = 0.02
    resid_scale = scale / math.sqrt(2 * max(L, 1))

    def normal(shape, std):
        return lambda: (torch.randn(shape, generator=gen, device=device) * std).to(pd)

    def ones(shape):
        return lambda: torch.ones(shape, dtype=pd, device=device)

    leaves = (
        ("embed", "tok", normal((v, h), scale)),
        ("blocks", "attn_norm", ones((L, h))),
        ("blocks", "wq", normal((L, h, h), scale)),
        # (layer, {k,v}, in, kv_heads*head_dim): a tp slice of the last axis
        # holds whole KV heads
        ("blocks", "wkv", normal((L, 2, h, kvh * hd), scale)),
        ("blocks", "wo", normal((L, h, h), resid_scale)),
        ("blocks", "ffn_norm", ones((L, h))),
        ("blocks", "w_gate", normal((L, h, f), scale)),
        ("blocks", "w_up", normal((L, h, f), scale)),
        ("blocks", "w_down", normal((L, f, h), resid_scale)),
        ("head", "norm", ones((h,))),
        ("head", "out", normal((h, v), scale)),
    )
    params: dict = {}
    for group, name, draw in leaves:
        leaf = draw()
        if shard is not None:
            leaf = shard(group, name, leaf)
        if leaf is not None:
            params.setdefault(group, {})[name] = leaf
    return params


# the leaves used only as ``leaf.to(cfg.dtype)`` (gpt.COMPUTE_DTYPE_LEAVES)
COMPUTE_DTYPE_LEAVES = {
    "blocks": ("wq", "wkv", "wo", "w_gate", "w_up", "w_down"),
    "head": ("out",),
}


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32, cast back to ``x``'s dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def rope(x: torch.Tensor, theta: float, offset: int = 0) -> torch.Tensor:
    """Rotary embedding on [b, heads, s, head_dim], rotate-half convention,
    fp32 trig; ``offset`` is the absolute position of the first row."""
    hd = x.shape[-1]
    half = hd // 2
    inv_freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                       device=x.device) * 2.0 / hd)
    pos = torch.arange(x.shape[2], dtype=torch.float32, device=x.device) + offset
    angles = pos[:, None] * inv_freq[None, :]           # [s, half]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _rank_kv(wkv: torch.Tensor, cfg: LlamaConfig, tp_group) -> tuple[torch.Tensor, int]:
    """The K/V projection columns this rank computes, and their head count.

    Sharded ``wkv``: the rank's own KV heads, which serve its query heads
    in groups of ``num_heads / kv_heads``.  Replicated ``wkv`` (the KV heads
    do not split over tp): the heads the rank's query heads use — one
    contiguous run when each serves an equal number of them, else one KV
    head per query head — behind ``copy_to_tp``, since each rank's gradient
    of the shared weight is its query heads' part."""
    tp = _tp_size(tp_group)
    if kv_sharded(cfg, tp):
        return wkv, cfg.kv_heads // tp
    hd, nh = cfg.head_dim, cfg.num_heads // tp
    g = cfg.num_heads // cfg.kv_heads
    first = dist.get_rank(tp_group) * nh
    used = [(first + i) // g for i in range(nh)]   # KV head of each query head
    lo, n_kv = used[0], used[-1] - used[0] + 1
    if nh % n_kv == 0 and used == [lo + i // (nh // n_kv) for i in range(nh)]:
        cols = torch.arange(lo * hd, (lo + n_kv) * hd, device=wkv.device)
    else:
        n_kv = nh
        cols = torch.tensor([u * hd + j for u in used for j in range(hd)],
                            device=wkv.device)
    return copy_to_tp(wkv, tp_group).index_select(-1, cols), n_kv


def llama_block_forward(x: torch.Tensor, layer: dict, cfg: LlamaConfig,
                        attn_impl: AttnFn, tp_group=None,
                        pos_offset: int = 0, sp: bool = False) -> torch.Tensor:
    """One LLaMA block on [batch, seq, hidden] activations; with
    ``tp_group`` the layer holds this rank's shards (module doc).  The
    attention's sequence starts at absolute position ``pos_offset``; with
    ``sp`` the stream ``x`` is this tp rank's block of that sequence
    (``gpt.block_forward``)."""
    dt, hd = cfg.dtype, cfg.head_dim
    nh = cfg.num_heads // _tp_size(tp_group)

    y = rms_norm(x, layer["attn_norm"])
    q = column_parallel(y, layer["wq"].to(dt), tp_group, sp)
    wkv, kvh = _rank_kv(layer["wkv"].to(dt), cfg, tp_group)
    kv = column_parallel(y, wkv, tp_group, sp)

    def heads(t, n):  # [b, s, n*hd] -> [b, n, s, hd]
        b, s, _ = t.shape
        return t.reshape(b, s, n, hd).transpose(1, 2)

    q = rope(heads(q, nh), cfg.rope_theta, pos_offset)
    k = rope(heads(kv[0], kvh), cfg.rope_theta, pos_offset)
    v = heads(kv[1], kvh)
    if kvh != nh and not getattr(attn_impl, "supports_gqa", False):
        # only an attention that cannot take grouped K/V gets them repeated;
        # through fp32, so the backward sums each group's gradients in fp32
        # and rounds once, as the kernels do
        k = k.float().repeat_interleave(nh // kvh, dim=1).to(dt)
        v = v.float().repeat_interleave(nh // kvh, dim=1).to(dt)

    ctx = attn_impl(q, k, v)
    b, _, s, _ = ctx.shape
    ctx = ctx.transpose(1, 2).reshape(b, s, nh * hd)
    x = x + row_parallel(ctx, layer["wo"].to(dt), tp_group, sp).to(dt)

    y = rms_norm(x, layer["ffn_norm"])
    # silu(gate) * up on the fp32 products, rounded once after the multiply
    gate = column_parallel_f32(y, layer["w_gate"].to(dt), tp_group, sp)
    up = column_parallel_f32(y, layer["w_up"].to(dt), tp_group, sp)
    z = (F.silu(gate) * up).to(dt)
    return x + row_parallel(z, layer["w_down"].to(dt), tp_group, sp).to(dt)


def llama_embed(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
                tp_group=None, sp: bool = False) -> torch.Tensor:
    """Embedding pseudo-layer (profile layer 0): the token lookup only
    (positions are rotary, inside the blocks); with ``sp`` this tp rank's
    block of the sequence."""
    return vocab_parallel_embedding(tokens, params["embed"]["tok"], tp_group,
                                    sp).to(cfg.dtype)


def default_llama_attention(cfg: LlamaConfig) -> AttnFn:
    if cfg.attn == "flash":
        from metis_tpu_torch.ops.flash_attention import flash_attn_fn
        return flash_attn_fn()
    if cfg.attn != "dense":
        raise ValueError(f"unknown LlamaConfig.attn: {cfg.attn!r}")
    return causal_attention


def llama_run_blocks(params: dict, x: torch.Tensor, cfg: LlamaConfig,
                     attn_impl: AttnFn | None = None, tp_group=None,
                     pos_offset: int = 0, sp: bool = False) -> torch.Tensor:
    """Run the stacked blocks — ``gpt.run_blocks``' contract."""
    attn = attn_impl or default_llama_attention(cfg)
    for layer in unstack_blocks(params["blocks"]):
        if cfg.remat:
            x = checkpoint(llama_block_forward, x, layer, cfg, attn, tp_group,
                           pos_offset, sp, use_reentrant=False)
        else:
            x = llama_block_forward(x, layer, cfg, attn, tp_group, pos_offset,
                                    sp)
    return x


def llama_head_logits(params: dict, x: torch.Tensor, cfg: LlamaConfig,
                      tp_group=None, sp: bool = False) -> torch.Tensor:
    """LM-head pseudo-layer: final RMSNorm + projection, fp32 logits (this
    rank's block of the vocabulary with ``tp_group``; the sequence gathered
    after the norm with ``sp``)."""
    y = rms_norm(x, params["head"]["norm"])
    return column_parallel_f32(y, params["head"]["out"].to(cfg.dtype), tp_group,
                               sp)


def llama_forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
                  attn_impl: AttnFn | None = None, tp_group=None,
                  sp: bool = False, pos_offset: int = 0) -> torch.Tensor:
    """``gpt.forward``'s contract."""
    x = llama_embed(params, tokens, cfg, tp_group, sp)
    x = llama_run_blocks(params, x, cfg, attn_impl, tp_group, pos_offset, sp)
    return llama_head_logits(params, x, cfg, tp_group, sp)


def llama_next_token_loss(params: dict, tokens: torch.Tensor,
                          targets: torch.Tensor, cfg: LlamaConfig,
                          attn_impl: AttnFn | None = None,
                          tp_group=None, sp: bool = False,
                          pos_offset: int = 0) -> torch.Tensor:
    """Mean cross-entropy of next-token prediction (fp32 scalar)."""
    logits = llama_forward(params, tokens, cfg, attn_impl, tp_group, sp,
                           pos_offset)
    return vocab_parallel_cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                        targets.reshape(-1), tp_group)
