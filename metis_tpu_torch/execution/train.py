"""Training step — the port of ``metis_tpu/execution/train.py`` for the
GPT, LLaMA and MoE families without a sequence axis: one device, or one
rank of a dp x tp process mesh, or for MoE of a dp x ep x tp one
(``execution/mesh.py``).

PyTorch runs eagerly, so the reference's jitted step becomes a plain
function: forward, ``backward()``, ``optimizer.step()``.  The optimizer is
``torch.optim.AdamW`` configured as ``optax.adamw(1e-4, weight_decay=0.01)``:
betas (0.9, 0.999), eps 1e-8, and decay on every leaf, biases and norms
included (one parameter group, no exclusions).

On a mesh each rank holds its Megatron shards (``param_specs_for``), runs its
dp index's rows of the batch, and averages its gradients over the dp group
before the update — what GSPMD derives from the shardings in the reference.
With expert parallelism the rows split over dp x ep (the reference's
``dp_axis = (DP, EP)``): the dense leaves' gradients are averaged over the
dp x ep ranks; an expert leaf's gradient already holds its ep peers' tokens
(they reached this rank's experts through the all-to-all, and their
gradients came back through its backward), so it is summed over dp only
and scaled by 1 / (dp * ep).
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from dataclasses import dataclass
from functools import partial
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from metis_tpu_torch.core.device import resolve_device
from metis_tpu_torch.core.events import NULL_LOG
from metis_tpu_torch.core.sharding import slice_leaf
from metis_tpu_torch.execution.mesh import (
    DP,
    EP,
    ONE_DEVICE,
    TP,
    ProcessMesh,
    batch_spec,
    expert_leaves,
)
from metis_tpu_torch.models import family_ops
from metis_tpu_torch.models.gpt import GPTConfig
from metis_tpu_torch.models.moe import MoEConfig, _route_group_len


@dataclass
class TrainState:
    """Parameters (nested dict of leaf tensors), the optimizer that owns
    their moments, and the count of steps taken."""

    params: dict
    optimizer: torch.optim.Optimizer
    step: int = 0


def param_specs_for(cfg: GPTConfig, tp_size: int = 1) -> dict:
    """The spec tree of a config's family (the reference's
    ``param_specs_for``): MoE's expert sharding, LLaMA's layout with its KV
    rule at ``tp_size``, else GPT's."""
    return family_ops(cfg).specs(cfg, tp_size)


def init_params_for(gen: torch.Generator, cfg: GPTConfig,
                    device: str | torch.device = "cuda",
                    mesh: ProcessMesh | None = None) -> dict:
    """The seeded parameter tree, or with ``mesh`` this rank's slices of
    it: each leaf is drawn at full size in the unsharded order and cut at
    once, so every rank holds exactly its block of the one-device tree."""
    shard = None
    if mesh is not None:
        specs, slots = param_specs_for(cfg, mesh.size(TP)), mesh.slots()

        def shard(group, name, leaf):
            return slice_leaf(leaf, specs[group][name], slots).contiguous()

    return family_ops(cfg).init_params(gen, cfg, device=resolve_device(device),
                                       shard=shard)


def params_from(source, cfg: GPTConfig, device: torch.device,
                cut: Callable | None = None) -> dict:
    """A rank's parameters from ``source``: a seed (the one-device tree
    drawn on ``device``, ``cut(group, name, leaf)`` applied to each leaf as
    it is drawn) or the full tree, numpy arrays or tensors, each leaf cut.
    ``cut`` returns the rank's piece of a leaf, or None for a leaf it does
    not hold."""
    if isinstance(source, int):
        gen = torch.Generator(device=device).manual_seed(source)
        return family_ops(cfg).init_params(gen, cfg, device=device, shard=cut)
    out: dict = {}
    for group, sub in source.items():
        for name, leaf in sub.items():
            # a copy: the rank's leaves are updated in place and must not
            # alias the caller's arrays
            t = (leaf.detach().clone() if isinstance(leaf, torch.Tensor)
                 else torch.from_numpy(np.array(leaf, copy=True))).to(device)
            t = cut(group, name, t) if cut is not None else t
            if t is not None:
                out.setdefault(group, {})[name] = t
    return out


def loss_fn_for(cfg: GPTConfig) -> Callable:
    return family_ops(cfg).loss


def aligned_routing(cfg: MoEConfig, tokens: int, ranks: int) -> MoEConfig:
    """The config under which each of ``ranks`` ranks, holding an equal
    share of a batch of ``tokens`` tokens, routes in the reference's groups:
    the groups of the whole batch (``_route_group_len`` of its tokens), when
    each rank's tokens hold whole groups.  Otherwise rank-local routing
    would change the groups, and with them the capacity and the drops: that
    raises."""
    g = _route_group_len(tokens, cfg.route_group_size)
    local = tokens // ranks
    if tokens % ranks or local % g:
        raise NotImplementedError(
            f"MoE routing groups of {g} tokens over a batch of {tokens} do "
            f"not align with {ranks} ranks' {local} tokens each; routing "
            "groups that straddle ranks are not supported")
    return dataclasses.replace(cfg, route_group_size=g)


def param_leaves(params: dict) -> list[torch.Tensor]:
    """Leaves of a parameter tree in a fixed (insertion) order."""
    return [leaf for sub in params.values() for leaf in sub.values()]


class StepTimer:
    """Per-step train-loop telemetry -> EventLog ``train_step`` events.

    ``record()`` once per completed step: wall-clock step time, cumulative
    elapsed, and tokens/sec from ``tokens_per_step``.  Kernels launch
    asynchronously, so a step's wall time is honest only when the caller
    synchronizes (``loss.item()`` does); between syncs the per-step times
    are launch times."""

    def __init__(self, events=None, tokens_per_step: int = 0,
                 start_step: int = 0):
        self.events = events if events is not None else NULL_LOG
        self.tokens_per_step = tokens_per_step
        self.step_idx = start_step
        self._clock = time.perf_counter
        self._t0 = self._clock()
        self._last = self._t0

    def record(self, loss: float | None = None, emit: bool = True,
               **fields) -> dict:
        now = self._clock()
        step_ms = (now - self._last) * 1e3
        self._last = now
        self.step_idx += 1
        rec: dict = {"step": self.step_idx,
                     "step_ms": round(step_ms, 3),
                     "elapsed_s": round(now - self._t0, 3)}
        if self.tokens_per_step and step_ms > 0:
            rec["tokens_per_s"] = round(
                self.tokens_per_step / (step_ms / 1e3))
        if loss is not None:
            rec["loss"] = loss
        rec.update(fields)
        if emit:
            self.events.emit("train_step", **rec)
        return rec


class LossAnomalyDetector:
    """Step-loss sanity guard.

    ``observe(loss, step)`` classifies each synced step loss: ``"nan"`` for
    a non-finite loss, ``"spike"`` for one above ``spike_factor`` x the
    rolling mean of the last ``window`` healthy losses (once ``min_history``
    exist), ``None`` for a healthy loss, which joins the window.  Anomalous
    losses never enter the window."""

    def __init__(self, spike_factor: float = 10.0, window: int = 8,
                 min_history: int = 3):
        if spike_factor <= 1.0:
            raise ValueError("spike_factor must exceed 1.0")
        if window < 1 or min_history < 1:
            raise ValueError("window and min_history must be >= 1")
        self.spike_factor = spike_factor
        self.min_history = min_history
        self._healthy: deque = deque(maxlen=window)

    def observe(self, loss: float, step: int | None = None) -> str | None:
        loss = float(loss)
        if not math.isfinite(loss):
            return "nan"
        if len(self._healthy) >= self.min_history:
            mean = sum(self._healthy) / len(self._healthy)
            if mean > 0 and loss > self.spike_factor * mean:
                return "spike"
        self._healthy.append(loss)
        return None

    def reset(self) -> None:
        """Forget history (after a rollback)."""
        self._healthy.clear()


def build_optimizer(lr: float = 1e-4, weight_decay: float = 0.01):
    """A factory ``params -> torch.optim.AdamW`` matching ``optax.adamw``.
    ``fused``: one kernel per tensor group reads and writes each parameter
    and moment once, where the default multi-tensor path makes a pass per
    arithmetic step."""
    return partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                   weight_decay=weight_decay, fused=True)


def train_state_from_params(params: dict, optimizer=None) -> TrainState:
    """Make ``params``' leaves trainable and wrap them with a fresh optimizer
    (one group over every leaf, as optax applies decay to all of them)."""
    factory = optimizer or build_optimizer()
    leaves = param_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    return TrainState(params=params, optimizer=factory(leaves))


def build_train_state(seed: int, cfg: GPTConfig,
                      device: str | torch.device = "cuda",
                      optimizer=None, mesh: ProcessMesh | None = None
                      ) -> TrainState:
    """Initialize parameters on ``device`` from ``seed`` and the matching
    optimizer state; with ``mesh``, this rank's shards of the same
    parameters (``init_params_for``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return train_state_from_params(init_params_for(gen, cfg, dev, mesh),
                                   optimizer)


# Elements per chunk of the dp gradient all-reduce under the overlap
# schedule of the manual-backward pipeline schedules (execution/pipeline.py):
# 2^20 fp32 elements = 4 MB per collective, as in the reference.
DP_CHUNK_ELEMS = 1 << 20


def chunked_all_reduce(tensors: list[torch.Tensor], group) -> None:
    """In place: each tensor becomes its sum over ``group``, reduced in
    flat chunks of at most ``DP_CHUNK_ELEMS`` elements.  Every chunk's
    all-reduce is posted before any is waited for, so the collectives
    pipeline with each other; the sum is elementwise, so the result equals
    one all-reduce per tensor.  The counterpart of the reference's
    ``chunked_pmean``: the port's stages weight each replica's loss by its
    share of the rows, so the dp group sums (``execution/stages.py``)."""
    works = []
    for t in tensors:
        flat = t.view(-1)
        for i in range(0, flat.numel(), DP_CHUNK_ELEMS):
            works.append(dist.all_reduce(flat[i:i + DP_CHUNK_ELEMS],
                                         group=group, async_op=True))
    for w in works:
        w.wait()


def make_train_step(cfg: GPTConfig, attn_impl=None,
                    mesh: ProcessMesh | None = None) -> Callable:
    """``(state, tokens, targets) -> (state, loss)``.

    The reference donates the state to its jitted step; here the step
    updates the parameters and optimizer moments in place and returns the
    same state object, so no second copy of the model is ever held.  The
    loss comes back as a 0-d tensor on the device (read it with ``.item()``,
    which waits for the step).

    With ``mesh`` the step takes the full ``[gbs, seq]`` batch on every rank
    and runs its contiguous ``gbs / (dp * ep)`` rows (the reference's
    ``P(dp, None)``, or ``P((dp, ep), None)`` under expert parallelism);
    the gradients are reduced as the module doc says, and the returned loss
    is the global batch mean."""
    loss_fn = loss_fn_for(cfg)
    mesh = mesh if mesh is not None else ONE_DEVICE
    dp, ep = mesh.size(DP), mesh.size(EP)
    dp_group, ep_group, tp_group = mesh.group(DP), mesh.group(EP), mesh.group(TP)
    moe = family_ops(cfg).moe
    if ep > 1 and not moe:
        raise ValueError(f"ep={ep} needs an MoE config")
    rows = batch_spec((DP, EP) if ep > 1 else DP)
    experts = expert_leaves(param_specs_for(cfg)) if ep > 1 else set()
    extra = {"ep_group": ep_group} if moe else {}
    slots = mesh.slots()

    def step(state: TrainState, tokens: torch.Tensor, targets: torch.Tensor):
        step_cfg = (aligned_routing(cfg, tokens.numel(), dp * ep)
                    if moe and dp * ep > 1 else cfg)
        tokens = slice_leaf(tokens, rows, slots)
        targets = slice_leaf(targets, rows, slots)
        loss = loss_fn(state.params, tokens, targets, step_cfg, attn_impl,
                       tp_group, **extra)
        loss.backward()
        if dp * ep > 1:
            loss = loss.detach().clone()
            dense = [loss]
            for group, sub in state.params.items():
                for name, leaf in sub.items():
                    if (group, name) in experts:
                        # the ep peers' part came through the all-to-all
                        if dp_group is not None:
                            dist.all_reduce(leaf.grad, group=dp_group)
                        leaf.grad.div_(dp * ep)
                    else:
                        dense.append(leaf.grad)
            for group in (dp_group, ep_group):
                if group is not None:
                    for t in dense:
                        dist.all_reduce(t, group=group)
            for t in dense:
                t.div_(dp * ep)
        state.optimizer.step()
        # free the gradients now rather than at the next step's backward
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return state, loss.detach()

    return step
