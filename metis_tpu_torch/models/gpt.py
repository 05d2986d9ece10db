"""GPT transformer — the port of ``metis_tpu/models/gpt.py``.

Same parameter layout as the reference, leaf for leaf, so a JAX parameter
tree converts with one ``torch.from_numpy`` per leaf (``models/convert.py``):
block leaves are stacked along a leading layer axis, and ``qkv`` is
``(L, 3, h, h)``.  ``num_layers`` profiled layers = embedding pseudo-layer +
``num_blocks`` transformer blocks + LM-head pseudo-layer.

Numerics follow the reference: activations in ``cfg.dtype`` (bf16), fp32
parameters cast at each use, layer norm with the population variance and eps
1e-5, the tanh GELU, fp32 logits.  One difference is inherent to eager
PyTorch: a bf16 product rounds to bf16 before its bias is added, where XLA
kept the fp32 accumulator — compare the two in fp32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from metis_tpu_torch.core.config import ModelSpec
from metis_tpu_torch.models.parallel import (
    ShardedGroup,
    column_parallel,
    row_parallel,
    vocab_parallel_cross_entropy,
    vocab_parallel_embedding,
)

AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
# (q, k, v) -> context; all [batch, heads, seq, head_dim]


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int
    seq_len: int
    hidden: int
    num_heads: int
    num_blocks: int
    ffn_multiplier: int = 4
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    # "dense" (materialized scores) or "flash" (the blockwise kernels,
    # metis_tpu_torch.ops.flash_attention)
    attn: str = "dense"

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads

    @property
    def ffn_dim(self) -> int:
        return self.hidden * self.ffn_multiplier

    @property
    def num_profile_layers(self) -> int:
        """Profiled layer count (embed + blocks + head)."""
        return self.num_blocks + 2

    @staticmethod
    def from_model_spec(spec: ModelSpec, **overrides) -> "GPTConfig":
        cfg = GPTConfig(
            vocab_size=spec.vocab_size,
            seq_len=spec.sequence_length,
            hidden=spec.hidden_size,
            num_heads=spec.num_heads,
            num_blocks=spec.num_blocks,
            ffn_multiplier=spec.ffn_multiplier,
            attn=spec.attn,
        )
        return replace(cfg, **overrides) if overrides else cfg


def init_params(gen: torch.Generator, cfg: GPTConfig,
                device: str | torch.device = "cuda",
                shard: Callable[[str, str, torch.Tensor], torch.Tensor] | None = None
                ) -> dict:
    """Parameter tree (nested dicts of tensors on ``device``), drawn from
    ``gen`` — a ``torch.Generator`` on the same device.  Same shapes, scales
    and layout as the reference; the random numbers differ from
    ``jax.random``'s.

    ``shard(group, name, leaf)``, when given, replaces each leaf as soon as
    it is drawn (a tensor-parallel rank keeps its slice): every leaf is still
    drawn at full size in the same order, so the slices are those of the
    unsharded tree, and no more than one full leaf is held at a time.  It
    may return None to drop the leaf (a pipeline stage that holds no
    embedding or head); a group left without leaves is absent."""
    h, f, v = cfg.hidden, cfg.ffn_dim, cfg.vocab_size
    L = cfg.num_blocks
    pd = cfg.param_dtype
    scale = 0.02
    resid_scale = scale / math.sqrt(2 * max(L, 1))

    def normal(shape, std):
        return lambda: (torch.randn(shape, generator=gen, device=device) * std).to(pd)

    def const(shape, value):
        return lambda: torch.full(shape, value, dtype=pd, device=device)

    leaves = (
        ("embed", "tok", normal((v, h), scale)),
        ("embed", "pos", normal((cfg.seq_len, h), scale)),
        ("blocks", "ln1_scale", const((L, h), 1.0)),
        ("blocks", "ln1_bias", const((L, h), 0.0)),
        # (layer, {q,k,v}, in, out): q/k/v on their own axis, as in the
        # reference, so a tensor-parallel slice of the last axis holds whole
        # heads (head j is columns [j*hd, (j+1)*hd))
        ("blocks", "qkv", normal((L, 3, h, h), scale)),
        ("blocks", "qkv_bias", const((L, 3, h), 0.0)),
        ("blocks", "proj", normal((L, h, h), resid_scale)),
        ("blocks", "proj_bias", const((L, h), 0.0)),
        ("blocks", "ln2_scale", const((L, h), 1.0)),
        ("blocks", "ln2_bias", const((L, h), 0.0)),
        ("blocks", "mlp_in", normal((L, h, f), scale)),
        ("blocks", "mlp_in_bias", const((L, f), 0.0)),
        ("blocks", "mlp_out", normal((L, f, h), resid_scale)),
        ("blocks", "mlp_out_bias", const((L, h), 0.0)),
        ("head", "ln_scale", const((h,), 1.0)),
        ("head", "ln_bias", const((h,), 0.0)),
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


# The leaves the forward uses only as ``leaf.to(cfg.dtype)`` (the matrices
# of the products): a caller that runs several microbatches on the same
# weights may cast them once (``execution/stages.py``).
COMPUTE_DTYPE_LEAVES = {"blocks": ("qkv", "proj", "mlp_in", "mlp_out"),
                        "head": ("out",)}


def _layer_norm(x: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)  # population variance
    y = (x32 - mean) * torch.rsqrt(var + 1e-5)
    return (y * scale + bias).to(x.dtype)


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Baseline full-materialization causal attention (masked with -inf).
    q,k,v: [batch, heads, seq, head_dim]."""
    seq = q.shape[2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores / math.sqrt(q.shape[-1])
    mask = torch.ones(seq, seq, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(weights, v)


def default_attention(cfg: GPTConfig) -> AttnFn:
    """Resolve ``cfg.attn`` to an AttnFn."""
    if cfg.attn == "flash":
        from metis_tpu_torch.ops.flash_attention import flash_attn_fn
        return flash_attn_fn()
    if cfg.attn != "dense":
        raise ValueError(f"unknown GPTConfig.attn: {cfg.attn!r}")
    return causal_attention


def attention_residual(x: torch.Tensor, layer: dict, cfg: GPTConfig,
                       attn_impl: AttnFn, tp_group=None,
                       sp: bool = False) -> torch.Tensor:
    """The attention half of a block: ``x`` plus the attention of its layer
    norm (the GPT and MoE blocks share it).  ``sp``: ``x`` is this rank's
    block of the sequence (Megatron sequence parallelism over tp)."""
    dt, hd = cfg.dtype, cfg.head_dim
    nh = cfg.num_heads // _tp_size(tp_group)

    y = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"])
    qkv = column_parallel(y, layer["qkv"].to(dt), tp_group, sp)
    qkv = (qkv.float() + layer["qkv_bias"][:, None, None, :]).to(dt)
    q, k, v = qkv[0], qkv[1], qkv[2]

    def heads(t):  # [b, s, nh*hd] -> [b, nh, s, hd]
        b, s, _ = t.shape
        return t.reshape(b, s, nh, hd).transpose(1, 2)

    ctx = attn_impl(heads(q), heads(k), heads(v))
    b, _, s, _ = ctx.shape
    ctx = ctx.transpose(1, 2).reshape(b, s, nh * hd)
    attn_out = row_parallel(ctx, layer["proj"].to(dt), tp_group, sp)
    return x + (attn_out + layer["proj_bias"]).to(dt)


def block_forward(x: torch.Tensor, layer: dict, cfg: GPTConfig,
                  attn_impl: AttnFn, tp_group=None,
                  sp: bool = False) -> torch.Tensor:
    """One transformer block on [batch, seq, hidden] activations.

    With ``tp_group`` the layer holds this rank's Megatron shards (qkv and
    mlp_in column-parallel, proj and mlp_out row-parallel): the rank runs
    ``num_heads / tp`` whole heads and ``ffn / tp`` hidden units, and the
    row-parallel partial sums cross ranks as fp32 accumulators before the
    bias is added (the reference's products accumulate in fp32).  With
    ``sp`` the residual stream ``x`` stays split over tp along the sequence
    (Megatron sequence parallelism): the layer norms and bias adds run on
    the rank's block, the column-parallel products gather the sequence
    first and the row-parallel ones reduce-scatter it."""
    dt = cfg.dtype
    x = attention_residual(x, layer, cfg, attn_impl, tp_group, sp)
    y = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"])
    z = column_parallel(y, layer["mlp_in"].to(dt), tp_group, sp)
    z = F.gelu(z.float() + layer["mlp_in_bias"], approximate="tanh").to(dt)
    z = row_parallel(z, layer["mlp_out"].to(dt), tp_group, sp)
    return x + (z + layer["mlp_out_bias"]).to(dt)


def _tp_size(tp_group) -> int:
    return 1 if tp_group is None else tp_group.size()


def _tp_rank(tp_group) -> int:
    return 0 if tp_group is None else tp_group.rank()


def embed(params: dict, tokens: torch.Tensor, cfg: GPTConfig,
          tp_group=None, sp: bool = False, pos_offset: int = 0) -> torch.Tensor:
    """Embedding pseudo-layer (profile layer 0): token + position lookup.
    Gathers before casting — the same values as the reference's
    cast-then-gather, without a bf16 copy of the whole table.  With
    ``tp_group`` the table is this rank's block of the vocabulary.
    ``tokens`` start at absolute position ``pos_offset`` (a context-parallel
    rank's block); with ``sp`` the result is this tp rank's block of their
    sequence."""
    tok = vocab_parallel_embedding(tokens, params["embed"]["tok"], tp_group,
                                   sp).to(cfg.dtype)
    seq = tok.shape[1]
    start = pos_offset + (_tp_rank(tp_group) * seq if sp else 0)
    pos = params["embed"]["pos"][start:start + seq].to(cfg.dtype)
    return tok + pos[None, :, :]


def unstack_blocks(blocks: dict) -> list[dict]:
    """The per-layer views of the stacked block leaves.

    One ``unbind`` per leaf: its backward stacks the per-layer gradients
    into the leaf's gradient once.  Indexing ``leaf[i]`` per layer instead
    would give each layer's backward a zero-filled gradient of the whole
    stack, summed L times.  A ``ShardedGroup`` (ZeRO-3 shards) gathers each
    layer as the loop reaches it."""
    if isinstance(blocks, ShardedGroup):
        return blocks.layers()
    names = list(blocks)
    per_leaf = [blocks[n].unbind(0) for n in names]
    return [dict(zip(names, leaves)) for leaves in zip(*per_leaf)]


def run_blocks(params: dict, x: torch.Tensor, cfg: GPTConfig,
               attn_impl: AttnFn | None = None, tp_group=None,
               sp: bool = False) -> torch.Tensor:
    """Run the stacked blocks over the activations — a Python loop where
    the reference scans.  With ``sp`` the stream between blocks is this
    rank's block of the sequence: where the reference's ``resid_fn``
    constrains it, the port keeps it split."""
    attn = attn_impl or default_attention(cfg)
    for layer in unstack_blocks(params["blocks"]):
        if cfg.remat:
            x = checkpoint(block_forward, x, layer, cfg, attn, tp_group, sp,
                           use_reentrant=False)
        else:
            x = block_forward(x, layer, cfg, attn, tp_group, sp)
    return x


def head_logits(params: dict, x: torch.Tensor, cfg: GPTConfig,
                tp_group=None, sp: bool = False) -> torch.Tensor:
    """LM-head pseudo-layer (profile layer N-1): final LN + projection,
    fp32 logits — with ``tp_group``, this rank's block of the vocabulary;
    with ``sp`` the sequence is gathered after the layer norm."""
    y = _layer_norm(x, params["head"]["ln_scale"], params["head"]["ln_bias"])
    return column_parallel(y, params["head"]["out"].to(cfg.dtype), tp_group,
                           sp).float()


def forward(params: dict, tokens: torch.Tensor, cfg: GPTConfig,
            attn_impl: AttnFn | None = None, tp_group=None, sp: bool = False,
            pos_offset: int = 0) -> torch.Tensor:
    """Full forward: tokens [batch, seq] -> logits [batch, seq, vocab] (fp32;
    with ``tp_group``, this rank's block of the vocabulary).  ``sp``
    (Megatron sequence parallelism) and ``pos_offset`` (the absolute
    position of ``tokens[:, 0]``, a context-parallel rank's) as in
    ``embed``."""
    x = embed(params, tokens, cfg, tp_group, sp, pos_offset)
    x = run_blocks(params, x, cfg, attn_impl, tp_group, sp)
    return head_logits(params, x, cfg, tp_group, sp)


def next_token_loss(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
                    cfg: GPTConfig, attn_impl: AttnFn | None = None,
                    tp_group=None, sp: bool = False,
                    pos_offset: int = 0) -> torch.Tensor:
    """Mean cross-entropy of next-token prediction (fp32 scalar)."""
    logits = forward(params, tokens, cfg, attn_impl, tp_group, sp, pos_offset)
    return vocab_parallel_cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                        targets.reshape(-1), tp_group)


def param_count(params: dict) -> int:
    return sum(leaf.numel() for sub in params.values() for leaf in sub.values())
