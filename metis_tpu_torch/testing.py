"""Differential-testing harness of the port — the counterpart of
``metis_tpu/testing.py``.

``run_plan_rank`` (and ``run_plans_rank``, several plans in one launch) is
the rank body the multi-rank tests (``tests/test_torch_dist.py``,
``test_torch_pipeline.py``, ``test_torch_hetero.py``) and ``chip_smoke.py``'s
dist and pipeline phases hand to ``execution.dist.spawn``.  It lives in the
package because spawned ranks start from a fresh interpreter and import
their body by name; it reads the kernels' launch counters, host step times
and peak memory, none of which production training needs.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from metis_tpu_torch.core.sharding import slice_leaf
from metis_tpu_torch.execution.builder import build_executable, hetero_executable
from metis_tpu_torch.execution.mesh import TP, PlanArtifact, batch_spec
from metis_tpu_torch.models.gpt import GPTConfig, forward
from metis_tpu_torch.ops import flash_attention as fa


def run_plan_rank(rank: int, device: torch.device, artifact_json: str | None,
                  cfg: GPTConfig, init, batches, forward_tokens=None,
                  return_params: bool = False, stages=None,
                  microbatches: int = 1, **build) -> dict:
    """Rank body for ``execution.dist.spawn``: build the artifact's
    executable on this rank (``build``: keyword arguments of
    ``build_executable``, such as ``schedule`` or ``overlap``) — or, given
    ``stages`` (``hetero.StageSpec``s) instead of an artifact, the hetero
    route over ``microbatches`` (``builder.hetero_executable``) — initialize
    it from ``init`` (a seed, or the full parameter tree as numpy arrays,
    of which the rank keeps its piece), and take one step per ``(tokens,
    targets)`` of ``batches`` (full-batch host tensors).

    Returns host data: ``kind`` (the route); ``losses``; ``step_ms`` (host
    clock, each step synchronized by reading its loss); ``launches``, the
    flash-attention kernel launches of each step on this rank;
    ``peak_memory_bytes`` on CUDA; ``slots``, the rank's mesh coordinates;
    ``block_ids``, the global blocks its stacked leaves hold (None: all);
    with ``forward_tokens`` (pp = 1 routes) the logits of the rank's dp
    rows of them before training (its block of the vocabulary); with
    ``return_params`` its leaves after training."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if stages is not None:
        exe = hetero_executable(cfg, stages, microbatches, device, **build)
    else:
        exe = build_executable(cfg, PlanArtifact.from_json(artifact_json),
                               device, **build)
    slots = exe.mesh.slots()
    state = exe.init(init)
    out: dict = {"kind": exe.kind, "slots": slots, "block_ids": exe.block_ids,
                 "losses": [], "step_ms": [], "launches": []}
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
        out["params"] = {g: {n: np.array(t.detach().cpu(), copy=True)
                             for n, t in sub.items()}
                         for g, sub in state.params.items()}
    return out


def run_plans_rank(rank: int, device: torch.device, jobs: list[dict]) -> list:
    """Rank body that runs several plans in one launch, one after another,
    to share the launch's start-up: each job is the keyword arguments of
    ``run_plan_rank``.  Each job's state is freed before the next starts."""
    out = []
    for job in jobs:
        out.append(run_plan_rank(rank, device, **job))
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out
