"""Mixture-of-Experts GPT — the port of ``metis_tpu/models/moe.py``.

Each block replaces the GPT FFN with ``num_experts`` expert FFNs behind a
top-k token-choice router, GShard/Switch style, as in the reference:
tokens are routed in groups of ``route_group_size`` (the largest divisor of
the token count not above it), each expert takes ``C`` slots per group, a
token's choices claim slots in priority-major order (every token's first
choice before any second choice), choices past ``C`` are dropped, and
dispatch and combine are one-hot products.  The router runs in fp32, the
top-k gates are renormalized, and the Switch load-balance loss is computed
on the top-1 counts.

Expert parallelism (``ep_group``): the expert leaves carry a leading
``num_experts`` axis that ``execution.mesh.moe_param_specs`` splits over
ep, so each rank holds ``E / ep`` experts.  A rank routes its own rows into
``[G, E, C, h]`` expert inputs, sends each ep peer the slots of the experts
that peer holds (``models.parallel.all_to_all``), runs its experts on what
the peers sent (tp inside each expert: ``expert_in`` column-parallel,
``expert_out`` row-parallel) and sends the results back before the combine.
Routing groups are those of the whole flattened batch, as the
reference's (``g`` consecutive tokens of ``[b*s, h]``), whatever part of
it a rank holds.  When ``g`` divides the rank's contiguous token runs, its
groups are its own and it routes them alone.  Otherwise several ranks
share a group (``SharedGroups``, built by the executors): each computes
its own tokens' router logits and gathers the group's logits from the
ranks that hold them (``parallel.gather_shard``, whose backward returns
every rank's gradient of a token's logits to its owner), makes the
group's decisions (the same on every sharer), dispatches its own tokens
into their slots of the group's expert buffers and combines only them,
and weights each group's aux statistic by its share of the group's real
tokens, so that the sharers' losses sum to the reference's and no
gradient of the aux counts twice.  No activations cross the sharers; the
experts still run every slot of a shared group's buffer on each sharer
(the slots of the other sharers' tokens hold zeros).  Under Megatron
sp the FFN first gathers the tp ranks' sequence blocks (every tp rank runs
it whole, as at tp without sp) and keeps its own block of the result.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from metis_tpu_torch.core.config import ModelSpec
from metis_tpu_torch.models.gpt import (
    AttnFn,
    GPTConfig,
    _layer_norm,
    _tp_size,
    attention_residual,
    default_attention,
    embed,
    head_logits,
    unstack_blocks,
)
from metis_tpu_torch.models.parallel import (
    all_to_all,
    bmm_f32,
    copy_to_tp,
    gather_from_sp,
    gather_shard,
    reduce_from_tp,
    split_to_sp,
    vocab_parallel_cross_entropy,
)


@dataclass(frozen=True)
class MoEConfig(GPTConfig):
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    # weight of the load-balancing auxiliary loss (Switch Transformer default)
    aux_loss_coef: float = 0.01
    # tokens per routing group; capacity is enforced per group
    route_group_size: int = 4096

    @staticmethod
    def from_model_spec(spec: ModelSpec, **overrides) -> "MoEConfig":
        if spec.num_experts < 1:
            raise ValueError(
                "MoEConfig.from_model_spec needs a spec with num_experts >= 1 "
                "(use models.config_for_model_spec to dispatch dense vs MoE)")
        cfg = MoEConfig(
            vocab_size=spec.vocab_size,
            seq_len=spec.sequence_length,
            hidden=spec.hidden_size,
            num_heads=spec.num_heads,
            num_blocks=spec.num_blocks,
            ffn_multiplier=spec.ffn_multiplier,
            num_experts=spec.num_experts,
            top_k=spec.expert_top_k,
            attn=spec.attn,
        )
        return replace(cfg, **overrides) if overrides else cfg


@dataclass(frozen=True)
class SharedGroups:
    """Where a rank's tokens lie in routing groups it shares with other
    ranks: ``gathers``, the ``(process group, dim)`` all-gathers, in order,
    that take the rank's ``[b, s, h]`` tokens (after ``pad_rows`` rows of
    zeros are appended) to a tensor holding every token of its groups;
    ``block``, the flat indices of those groups' tokens in it, in the
    batch's order (None: all of them); ``local``, the positions in the
    block of the rank's own ``b * s`` tokens, row-major; ``valid``, the
    block's real tokens (1) and pad tokens (0), or None when all are
    real."""

    gathers: tuple
    local: torch.Tensor
    pad_rows: int = 0
    block: torch.Tensor | None = None
    valid: torch.Tensor | None = None


def expert_capacity(cfg: MoEConfig, tokens: int) -> int:
    """Per-expert token slots for a group of ``tokens`` routed top_k ways."""
    return max(1, math.ceil(
        tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts))


def _route_group_len(tokens: int, target: int) -> int:
    """Largest divisor of ``tokens`` that is <= ``target`` (group length)."""
    for g in range(min(target, tokens), 0, -1):
        if tokens % g == 0:
            return g
    return tokens


def init_moe_params(gen: torch.Generator, cfg: MoEConfig,
                    device: str | torch.device = "cuda",
                    shard=None) -> dict:
    """As ``gpt.init_params`` (same ``shard`` contract), the blocks carrying
    a router and stacked expert FFNs ([num_blocks, num_experts, ...])."""
    h, f, v, E = cfg.hidden, cfg.ffn_dim, cfg.vocab_size, cfg.num_experts
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
        ("blocks", "qkv", normal((L, 3, h, h), scale)),
        ("blocks", "qkv_bias", const((L, 3, h), 0.0)),
        ("blocks", "proj", normal((L, h, h), resid_scale)),
        ("blocks", "proj_bias", const((L, h), 0.0)),
        ("blocks", "ln2_scale", const((L, h), 1.0)),
        ("blocks", "ln2_bias", const((L, h), 0.0)),
        ("blocks", "router", normal((L, h, E), scale)),
        ("blocks", "expert_in", normal((L, E, h, f), scale)),
        ("blocks", "expert_in_bias", const((L, E, f), 0.0)),
        ("blocks", "expert_out", normal((L, E, f, h), resid_scale)),
        ("blocks", "expert_out_bias", const((L, E, h), 0.0)),
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


def route(tokens: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
          valid: torch.Tensor | None = None) -> dict:
    """The routing of token groups ``tokens`` [G, T, h] (``route_logits``
    of their fp32 router logits)."""
    return route_logits(torch.matmul(tokens.float(), router.float()), cfg, valid)


def route_logits(logits: torch.Tensor, cfg: MoEConfig,
                 valid: torch.Tensor | None = None) -> dict:
    """The routing of token groups whose fp32 router logits are ``logits``
    [G, T, E]: router probabilities ``probs`` [G, T, E], the top-k choices
    ``expert_idx`` and renormalized ``gates`` [G, T, k], each choice's
    ``position`` in its expert's buffer and ``keep`` (position < C), the
    one-hot ``dispatch`` and gate-weighted ``combine`` [G, T, E, C], and
    the Switch ``aux`` loss per group [G].  ``valid`` [G, T] (1 = real
    token) keeps masked tokens out of the capacity competition and the aux
    statistics."""
    G, T, _ = logits.shape
    E, k = cfg.num_experts, cfg.top_k
    C = expert_capacity(cfg, T)
    probs = torch.softmax(logits, dim=-1)
    gates, expert_idx = torch.topk(probs, k, dim=-1)            # [G, T, k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    choice = F.one_hot(expert_idx, E).float()                   # [G, T, k, E]
    if valid is not None:
        choice = choice * valid[:, :, None, None]
    # position of each (token, choice) in its expert's buffer: the count of
    # earlier claims on that expert, choices counted in priority order
    flat = choice.transpose(1, 2).reshape(G, k * T, E)          # priority-major
    before = (flat.cumsum(1) - flat).reshape(G, k, T, E).transpose(1, 2)
    position = (before * choice).sum(-1).long()                 # [G, T, k]
    keep = position < C
    slot = (position[..., None] == torch.arange(C, device=logits.device)).float()
    kept = choice * keep[..., None]
    dispatch = torch.einsum("gtke,gtkc->gtec", kept, slot)
    combine = torch.einsum("gtke,gtkc->gtec", kept * gates[..., None], slot)

    top1 = choice[:, :, 0, :]
    if valid is None:
        aux = E * (probs.mean(1) * top1.mean(1)).sum(-1)
    else:
        denom = valid.sum(1).clamp_min(1.0)[:, None]
        probs_mean = (probs * valid[..., None]).sum(1) / denom
        aux = E * (probs_mean * top1.sum(1) / denom).sum(-1)
    return {"probs": probs, "expert_idx": expert_idx, "gates": gates,
            "position": position, "keep": keep, "dispatch": dispatch,
            "combine": combine, "aux": aux}


def _experts(x: torch.Tensor, layer: dict, cfg: MoEConfig,
             tp_group) -> torch.Tensor:
    """This rank's experts on their slots ``x`` [E_local, N, h]: GELU FFNs,
    the ffn axis split over tp (``expert_in`` column-, ``expert_out``
    row-parallel, the partial sums kept and added in fp32 before the bias,
    so that tp rounds the product once, as one device does)."""
    dt = cfg.dtype
    x = copy_to_tp(x, tp_group)
    z = torch.bmm(x, layer["expert_in"].to(dt))
    z = F.gelu(z.float() + layer["expert_in_bias"][:, None, :],
               approximate="tanh").to(dt)
    if tp_group is None:
        z = torch.bmm(z, layer["expert_out"].to(dt)).float()
    else:
        z = reduce_from_tp(bmm_f32(z, layer["expert_out"].to(dt)), tp_group)
    return (z + layer["expert_out_bias"][:, None, :]).to(dt)


def _expert_slots(expert_in: torch.Tensor, layer: dict, cfg: MoEConfig,
                  tp_group, ep_group) -> torch.Tensor:
    """The experts' outputs [G, E, C, h] on their slots ``expert_in``
    [G, E, C, h].  With ``ep_group`` the slots cross the ep ranks both ways
    (module doc)."""
    G, E, C, h = expert_in.shape
    ep = _tp_size(ep_group)
    # [G, ep, E/ep, C, h] -> peer-major, to each peer the experts it holds
    send = expert_in.reshape(G, ep, E // ep, C, h).transpose(0, 1)
    got = all_to_all(send, ep_group)                 # [ep (source), G, E/ep, C, h]
    z = _experts(got.permute(2, 0, 1, 3, 4).reshape(E // ep, ep * G * C, h),
                 layer, cfg, tp_group)
    back = all_to_all(z.reshape(E // ep, ep, G, C, h).permute(1, 2, 0, 3, 4),
                      ep_group)                      # [ep (expert block), G, E/ep, C, h]
    return back.transpose(0, 1).reshape(G, E, C, h)


def _mix(grouped: torch.Tensor, r: dict, layer: dict, cfg: MoEConfig,
         tp_group, ep_group) -> torch.Tensor:
    """The experts' mixed output ``[G, g, h]`` of token groups ``grouped``
    routed as ``r``."""
    dt = cfg.dtype
    expert_in = torch.einsum("gtec,gth->gech", r["dispatch"].to(dt), grouped)
    z = _expert_slots(expert_in, layer, cfg, tp_group, ep_group)
    return torch.einsum("gtec,gech->gth", r["combine"].to(dt), z)


def _shared_ffn(x: torch.Tensor, layer: dict, cfg: MoEConfig,
                shared: SharedGroups, tp_group, ep_group
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn`` of a rank whose routing groups other ranks share
    (``SharedGroups``; module doc)."""
    b, s, h = x.shape
    E, k, g, dt = cfg.num_experts, cfg.top_k, cfg.route_group_size, cfg.dtype
    # the group's decisions need only its router logits: they, and not
    # the activations, cross the sharing ranks
    logits = torch.matmul(x.float(), layer["router"].float())   # [b, s, E]
    if shared.pad_rows:
        logits = torch.cat([logits, logits.new_zeros(shared.pad_rows, s, E)])
    for group, dim in shared.gathers:
        logits = gather_shard(logits, group, dim)
    logits = logits.reshape(-1, E)
    if shared.block is not None:
        logits = logits.index_select(0, shared.block)
    T = logits.shape[0]
    G = T // g
    valid = None if shared.valid is None else shared.valid.reshape(G, g)
    r = route_logits(logits.reshape(G, g, E), cfg, valid)
    C = r["dispatch"].shape[-1]

    def own_of(a):
        return a.reshape(T, *a.shape[2:]).index_select(0, shared.local)

    # each of the rank's kept choices: its slot in the groups' [G, E, C]
    # buffers; a dropped choice (or a pad token's) goes to a spare slot
    # past them, which the experts never see and which reads back as 0
    keep = own_of(r["keep"])
    if valid is not None:
        keep = keep & (own_of(valid[..., None]) > 0)
    group = (shared.local // g)[:, None]
    slot = torch.where(keep, (group * E + own_of(r["expert_idx"])) * C
                       + own_of(r["position"]), G * E * C).reshape(-1)
    expert_in = x.new_zeros(G * E * C + 1, h).index_add(
        0, slot, x.reshape(b * s, h).repeat_interleave(k, 0))
    z = _expert_slots(expert_in[:-1].reshape(G, E, C, h), layer, cfg,
                      tp_group, ep_group).reshape(G * E * C, h)
    z = torch.cat([z, z.new_zeros(1, h)]).index_select(0, slot).reshape(-1, k, h)
    gates = own_of(r["gates"]).to(dt).float()
    out = (gates[..., None] * z.float()).sum(1).to(dt)
    # each group's aux weighted by this rank's share of its real tokens:
    # the sharers' weighted sums add up to the valid-weighted mean over
    # the batch's groups, each group's gradient counted once
    own = torch.zeros(T, dtype=torch.float32, device=x.device)
    own[shared.local] = 1.0
    own = own.reshape(G, g)
    weights = (own if valid is None else own * valid).sum(-1)
    aux = (r["aux"] * weights).sum() / weights.sum().clamp_min(1.0)
    return out.reshape(b, s, h), aux


def moe_ffn(x: torch.Tensor, layer: dict, cfg: MoEConfig,
            valid_mask: torch.Tensor | None = None, tp_group=None,
            ep_group=None, sp: bool = False,
            shared: SharedGroups | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed expert FFN on [b, s, h]; returns (output, aux loss).

    ``valid_mask`` [b] or [b, s] (1 = real token) masks pad rows out of
    routing, capacity and the aux statistics; the aux loss is then the
    groups' masked means weighted by their valid counts.  With ``ep_group``
    the rank holds ``E / ep`` experts and the expert slots cross the ep
    ranks both ways; ``sp``: ``x`` is this tp rank's block of the
    sequence; ``shared``: the rank's groups are shared with other ranks
    (module doc)."""
    if sp:
        x = gather_from_sp(x, tp_group)
    if shared is not None:
        out, aux = _shared_ffn(x, layer, cfg, shared, tp_group, ep_group)
        return (split_to_sp(out, tp_group) if sp else out), aux
    b, s, h = x.shape
    T = b * s
    g = _route_group_len(T, cfg.route_group_size)
    grouped = x.reshape(T // g, g, h)
    valid = None
    if valid_mask is not None:
        if valid_mask.dim() == 1:
            valid_mask = valid_mask[:, None].expand(b, s)
        valid = valid_mask.float().reshape(T // g, g)
    r = route(grouped, layer["router"], cfg, valid)
    out = _mix(grouped, r, layer, cfg, tp_group, ep_group).reshape(b, s, h)
    if valid is None:
        aux = r["aux"].mean()
    else:
        weights = valid.sum(-1)
        aux = (r["aux"] * weights).sum() / weights.sum().clamp_min(1.0)
    return (split_to_sp(out, tp_group) if sp else out), aux


def moe_block_forward(x: torch.Tensor, layer: dict, cfg: MoEConfig,
                      attn_impl: AttnFn, tp_group=None, ep_group=None,
                      valid_mask: torch.Tensor | None = None, sp: bool = False,
                      shared: SharedGroups | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One MoE block (the GPT attention half, then the routed experts);
    returns (activations, aux loss).  ``sp`` and ``shared`` as
    ``moe_ffn``."""
    x = attention_residual(x, layer, cfg, attn_impl, tp_group, sp)
    y = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"])
    z, aux = moe_ffn(y, layer, cfg, valid_mask, tp_group, ep_group, sp, shared)
    return x + z, aux


def moe_run_blocks(params: dict, x: torch.Tensor, cfg: MoEConfig,
                   attn_impl: AttnFn | None = None, tp_group=None,
                   ep_group=None, valid_mask: torch.Tensor | None = None,
                   sp: bool = False, shared: SharedGroups | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the stacked MoE blocks; returns (activations, mean aux loss)."""
    attn = attn_impl or default_attention(cfg)
    auxes = []
    for layer in unstack_blocks(params["blocks"]):
        args = (x, layer, cfg, attn, tp_group, ep_group, valid_mask, sp, shared)
        if cfg.remat:
            x, aux = checkpoint(moe_block_forward, *args, use_reentrant=False)
        else:
            x, aux = moe_block_forward(*args)
        auxes.append(aux)
    return x, torch.stack(auxes).mean()


def moe_forward(params: dict, tokens: torch.Tensor, cfg: MoEConfig,
                attn_impl: AttnFn | None = None, tp_group=None,
                ep_group=None, sp: bool = False, pos_offset: int = 0,
                shared: SharedGroups | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [b, s] -> (logits [b, s, v] fp32, aux loss scalar); ``sp``
    and ``pos_offset`` as ``gpt.forward``, ``shared`` as ``moe_ffn``."""
    x = embed(params, tokens, cfg, tp_group, sp, pos_offset)
    x, aux = moe_run_blocks(params, x, cfg, attn_impl, tp_group, ep_group,
                            None, sp, shared)
    return head_logits(params, x, cfg, tp_group, sp), aux


def moe_next_token_loss(params: dict, tokens: torch.Tensor,
                        targets: torch.Tensor, cfg: MoEConfig,
                        attn_impl: AttnFn | None = None, tp_group=None,
                        ep_group=None, sp: bool = False, pos_offset: int = 0,
                        shared: SharedGroups | None = None) -> torch.Tensor:
    """Cross-entropy + load-balance auxiliary (fp32 scalar)."""
    logits, aux = moe_forward(params, tokens, cfg, attn_impl, tp_group,
                              ep_group, sp, pos_offset, shared)
    ce = vocab_parallel_cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                      targets.reshape(-1), tp_group)
    return ce + cfg.aux_loss_coef * aux
