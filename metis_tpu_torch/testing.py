"""Differential-testing harness of the port — the counterpart of
``metis_tpu/testing.py``.

``run_plan_rank`` is the rank body the dp x tp tests (``tests/
test_torch_dist.py``) and ``chip_smoke.py``'s dist phase hand to
``execution.dist.spawn``.  It lives in the package because spawned ranks
start from a fresh interpreter and import their body by name; it reads the
kernels' launch counters, host step times and peak memory, none of which
production training needs.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from metis_tpu_torch.core.sharding import slice_leaf
from metis_tpu_torch.execution.builder import build_executable
from metis_tpu_torch.execution.mesh import TP, PlanArtifact, batch_spec, gpt_param_specs
from metis_tpu_torch.execution.train import train_state_from_params
from metis_tpu_torch.models.convert import from_numpy_tree
from metis_tpu_torch.models.gpt import GPTConfig, forward
from metis_tpu_torch.ops import flash_attention as fa


def run_plan_rank(rank: int, device: torch.device, artifact_json: str,
                  cfg: GPTConfig, init, batches, forward_tokens=None,
                  return_params: bool = False) -> dict:
    """Rank body for ``execution.dist.spawn``: build the artifact's
    executable on this rank, initialize it from ``init`` (a seed, or the
    full parameter tree as numpy arrays, of which the rank keeps its
    shards), and take one step per ``(tokens, targets)`` of ``batches``
    (full-batch host tensors).

    Returns host data: ``losses``; ``step_ms`` (host clock, each step
    synchronized by reading its loss); ``launches``, the flash-attention
    kernel launches of each step on this rank; ``peak_memory_bytes`` on
    CUDA; ``slots``, the rank's mesh coordinates; with ``forward_tokens``
    the logits of the rank's dp rows of them before training (its block of
    the vocabulary); with ``return_params`` its shards after training."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    exe = build_executable(cfg, PlanArtifact.from_json(artifact_json), device)
    slots = exe.mesh.slots()
    if isinstance(init, int):
        state = exe.init(init)
    else:
        state = train_state_from_params(from_numpy_tree(
            init, device, specs=gpt_param_specs(cfg), slots=slots))
    out: dict = {"kind": exe.kind, "slots": slots, "losses": [],
                 "step_ms": [], "launches": []}
    if forward_tokens is not None:
        mine = slice_leaf(forward_tokens, batch_spec(), slots)
        with torch.no_grad():
            logits = forward(state.params, mine.to(device), cfg,
                             tp_group=exe.mesh.group(TP))
        out["logits"] = logits.cpu().numpy()
    for tokens, targets in batches:
        tokens, targets = tokens.to(device), targets.to(device)
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        state, loss = exe.step(state, tokens, targets)
        out["losses"].append(loss.item())
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append(dict(fa.launch_counts))
    if cuda:
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    if return_params:
        out["params"] = {g: {n: np.asarray(t.detach().cpu()) for n, t in sub.items()}
                         for g, sub in state.params.items()}
    return out
