"""Model families of the port.  This slice ports the GPT family; LLaMA and
MoE come with a later slice and raise ``NotImplementedError`` here."""
from metis_tpu_torch.models.gpt import (
    GPTConfig,
    causal_attention,
    forward,
    init_params,
    next_token_loss,
    param_count,
)


def _require_gpt(cfg) -> None:
    if not isinstance(cfg, GPTConfig):
        raise NotImplementedError(
            f"{type(cfg).__name__}: only the GPT family is ported so far "
            "(LLaMA and MoE come with a later slice)")


def family_ops(cfg):
    """``(embed, run_blocks, head_logits, init_params)`` of a config's model
    family, with identical signatures across families."""
    from metis_tpu_torch.models import gpt

    _require_gpt(cfg)
    return (gpt.embed, gpt.run_blocks, gpt.head_logits, gpt.init_params)


def resolve_attention(cfg):
    """The ``AttnFn`` a config's ``attn`` field selects — the one resolution
    point the profiler and the executors share, so a profile describes the
    attention that runs."""
    from metis_tpu_torch.models import gpt

    _require_gpt(cfg)
    return gpt.default_attention(cfg)


def config_for_model_spec(spec, **overrides):
    """The executable config of a planner ``ModelSpec``'s model family."""
    if spec.num_experts > 0 or spec.family != "gpt":
        raise NotImplementedError(
            f"model family {spec.family!r} with {spec.num_experts} experts: "
            "only the dense GPT family is ported so far (LLaMA and MoE come "
            "with a later slice)")
    return GPTConfig.from_model_spec(spec, **overrides)


__all__ = [
    "GPTConfig",
    "causal_attention",
    "config_for_model_spec",
    "family_ops",
    "forward",
    "init_params",
    "next_token_loss",
    "param_count",
    "resolve_attention",
]
