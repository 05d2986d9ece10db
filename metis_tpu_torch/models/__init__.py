"""Model families of the port: GPT (``gpt``), LLaMA (``llama``) and the MoE
GPT (``moe``), with the dispatch the executors and the profiler share, as
in ``metis_tpu/models/__init__.py``."""
import dataclasses
import functools
from collections.abc import Callable
from dataclasses import dataclass

from metis_tpu_torch.models.gpt import (
    GPTConfig,
    causal_attention,
    forward,
    init_params,
    next_token_loss,
    param_count,
)
from metis_tpu_torch.models.llama import (
    LlamaConfig,
    init_llama_params,
    llama_forward,
    llama_next_token_loss,
)
from metis_tpu_torch.models.moe import (
    MoEConfig,
    init_moe_params,
    moe_forward,
    moe_next_token_loss,
)


@dataclass(frozen=True)
class Family:
    """One model family's pieces — the single dispatch point the executors,
    the stage runtime, the profiler and the test harness read.  Signatures
    agree across families, except that MoE's ``block``, ``run_blocks`` and
    ``forward`` also return the aux loss, and its ``forward`` and ``loss``
    take an ``ep_group``."""

    name: str
    embed: Callable
    block: Callable
    run_blocks: Callable
    head_logits: Callable
    forward: Callable
    loss: Callable
    init_params: Callable
    attention: Callable  # cfg -> the AttnFn its ``attn`` field selects
    specs: Callable  # (cfg, tp_size) -> the spec tree of its leaves
    # the leaves its forward uses only as ``leaf.to(cfg.dtype)``, which a
    # caller running several microbatches may cast once
    cast_leaves: dict

    @property
    def moe(self) -> bool:
        return self.name == "moe"

    def stage_embed(self, params, tokens, cfg, tp_group=None, pos_offset: int = 0):
        """The embedding of ``tokens`` whose first position is ``pos_offset``
        (a context-parallel rank's block; LLaMA's positions are rotary, in
        its blocks)."""
        if self.name == "llama":
            return self.embed(params, tokens, cfg, tp_group)
        return self.embed(params, tokens, cfg, tp_group, pos_offset=pos_offset)

    def stage_blocks(self, params, x, cfg, attn, tp_group=None, pos_offset: int = 0,
                     ep_group=None, valid_mask=None):
        """``params["blocks"]`` run over ``x``, as a pipeline stage runs
        them: ``(activations, aux loss)`` for MoE (``ep_group`` and the pad
        rows' ``valid_mask`` as ``moe.moe_ffn``), ``(activations, None)``
        otherwise; ``pos_offset`` as ``stage_embed``."""
        if self.moe:
            return self.run_blocks(params, x, cfg, attn, tp_group, ep_group,
                                   valid_mask)
        if self.name == "llama":
            return self.run_blocks(params, x, cfg, attn, tp_group, pos_offset), None
        return self.run_blocks(params, x, cfg, attn, tp_group), None


@functools.cache
def _families() -> dict[str, Family]:
    from metis_tpu_torch.execution import mesh
    from metis_tpu_torch.models import gpt, llama, moe

    gpt_family = Family(
        "gpt", gpt.embed, gpt.block_forward, gpt.run_blocks, gpt.head_logits,
        gpt.forward, gpt.next_token_loss, gpt.init_params,
        gpt.default_attention, lambda cfg, tp: mesh.gpt_param_specs(cfg),
        gpt.COMPUTE_DTYPE_LEAVES)
    return {
        "gpt": gpt_family,
        "llama": Family(
            "llama", llama.llama_embed, llama.llama_block_forward,
            llama.llama_run_blocks, llama.llama_head_logits,
            llama.llama_forward, llama.llama_next_token_loss,
            llama.init_llama_params, llama.default_llama_attention,
            lambda cfg, tp: mesh.llama_param_specs(cfg, tp_size=tp),
            llama.COMPUTE_DTYPE_LEAVES),
        "moe": dataclasses.replace(
            gpt_family, name="moe", block=moe.moe_block_forward,
            run_blocks=moe.moe_run_blocks, forward=moe.moe_forward,
            loss=moe.moe_next_token_loss, init_params=moe.init_moe_params,
            specs=lambda cfg, tp: mesh.moe_param_specs(cfg)),
    }


def family_ops(cfg) -> Family:
    """The ``Family`` of a port config (``GPTConfig`` or a subclass)."""
    if isinstance(cfg, MoEConfig):
        return _families()["moe"]
    if isinstance(cfg, LlamaConfig):
        return _families()["llama"]
    if isinstance(cfg, GPTConfig):
        return _families()["gpt"]
    raise TypeError(f"{type(cfg).__name__} is not a config of the port")


def resolve_attention(cfg, cp_group=None, cp_mode: str = "ring"):
    """The ``AttnFn`` a config's ``attn`` field selects — the one resolution
    point the profiler and the executors share, so a profile describes the
    attention that runs.  With a context-parallel ``cp_group``, the
    attention of ``cp_mode``: ring attention over the flash kernels
    (``"ring"``; GQA-native, ``supports_gqa``) or Ulysses (``"a2a"``; the
    LLaMA block expands grouped K/V for it, as the reference's does)."""
    if cp_group is None:
        return family_ops(cfg).attention(cfg)
    if family_ops(cfg).moe:
        raise NotImplementedError(
            "MoE with context parallelism: a rank's block of the sequence "
            "would split the routing groups, and the reference runs cp with "
            "the dense families only")
    if cp_mode == "a2a":
        from metis_tpu_torch.ops.ulysses import make_ulysses_attention
        return make_ulysses_attention(cp_group)
    if cp_mode != "ring":
        raise ValueError(f"unknown cp_mode {cp_mode!r}")
    from metis_tpu_torch.ops.ring_attention import make_ring_attention
    return make_ring_attention(cp_group)


def config_for_model_spec(spec, **overrides):
    """The executable config of a planner ``ModelSpec``'s model family:
    MoEConfig when the spec declares experts, LlamaConfig for
    ``family == "llama"``, GPTConfig otherwise."""
    if spec.num_experts > 0:
        if spec.family == "llama":
            raise NotImplementedError("MoE is currently GPT-family only")
        return MoEConfig.from_model_spec(spec, **overrides)
    if spec.family == "llama":
        return LlamaConfig.from_model_spec(spec, **overrides)
    return GPTConfig.from_model_spec(spec, **overrides)


__all__ = [
    "GPTConfig",
    "LlamaConfig",
    "MoEConfig",
    "Family",
    "causal_attention",
    "config_for_model_spec",
    "family_ops",
    "forward",
    "init_llama_params",
    "init_moe_params",
    "init_params",
    "llama_forward",
    "llama_next_token_loss",
    "moe_forward",
    "moe_next_token_loss",
    "next_token_loss",
    "param_count",
    "resolve_attention",
]
