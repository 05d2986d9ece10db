"""Compile-check entry: the flagship GPT forward with flash attention — the
port of ``__graft_entry__.py:20 entry``."""
from __future__ import annotations

import torch


def entry(device: str | torch.device = "cuda"):
    """``(fn, example_args)``: the flagship GPT forward with ``attn="flash"``
    and its random parameters and tokens, on ``device``."""
    from metis_tpu_torch.core.device import resolve_device
    from metis_tpu_torch.models import GPTConfig, forward, init_params

    dev = resolve_device(device)
    cfg = GPTConfig(vocab_size=8192, seq_len=256, hidden=1024, num_heads=8,
                    num_blocks=4, attn="flash")
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (4, cfg.seq_len),
                           generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn, (params, tokens)
