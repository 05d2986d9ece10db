"""Training step — the port of ``metis_tpu/execution/train.py`` for the
GPT, LLaMA and MoE families: one device, or one rank of a dp x cp x tp
process mesh, or for MoE of a dp x ep x tp one (``execution/mesh.py``),
with Megatron sequence parallelism and ZeRO 1-3.

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
gradients came back through its backward), so it is summed over dp (and
cp) only and scaled by 1 / (dp * ep * cp).  MoE routes in the groups of
the whole batch: where a group straddles ranks (rows over dp x ep, the
sequence over cp), the ranks that hold it share it
(``routing_layout``, ``models.moe.SharedGroups``).

Context parallelism (cp, the mesh's ``SP`` axis) splits the sequence: each
rank runs its contiguous block of it at its absolute positions, attention
runs over the cp group (ring attention or Ulysses,
``models.resolve_attention``), and the dense gradients are averaged over
dp x cp, each rank's loss being the mean over its equal share of the
tokens.  Megatron sequence parallelism (``megatron_sp``, at tp > 1) keeps
the residual stream split over tp along the sequence between the products
(``models/parallel.py``); the leaves that act on that split stream while
the spec keeps them whole (``mesh.sp_partial_leaves``) see only the rank's
tokens, so their gradients are summed over tp.  With cp and sp together the
stream's chunk on a rank is ``cp_rank * tp + tp_rank``.

ZeRO (``train_state_from_params(zero=...)``) splits state over the dp
group, the leaves and dims chosen by the reference's rule
(``mesh.fsdp_wrap_specs``).  Levels 1 and 2 keep every parameter whole; the
optimizer holds moments only for the rank's chunk of each wrapped leaf (a
contiguous flat view of it, updated in place), and after the update the
chunks are all-gathered back into the leaves.  At level 1 the gradient is
all-reduced, at level 2 reduce-scattered to the chunk.  Level 3 stores the
parameters as dp shards along the wrapped dim and gathers each block's
leaves where the model reads them (``parallel.ShardedGroup``); saved-tensor
hooks keep a gathered leaf saved for the backward as its shard, so a
block's whole weights live only during its forward and its backward.  The
gradients come back reduce-scattered.  As in the reference's executor, ZeRO
shards over dp alone, also under cp (the planner prices it over dp x cp,
ROADMAP §C).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from collections import deque
from dataclasses import dataclass, field
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
    SP,
    TP,
    ProcessMesh,
    batch_spec,
    expert_leaves,
    fsdp_wrap_specs,
    seq_offset,
    sp_partial_leaves,
)
from metis_tpu_torch.models import family_ops, resolve_attention
from metis_tpu_torch.models.parallel import (
    ShardedGroup,
    ShardGather,
    all_gather_dim,
    reduce_scatter_dim,
)
from metis_tpu_torch.models.gpt import GPTConfig
from metis_tpu_torch.models.moe import MoEConfig, SharedGroups, _route_group_len


@dataclass
class ZeroLayout:
    """A rank's ZeRO split over the dp ``group`` (module doc): ``dims[(group,
    name)]`` the dim a leaf's wrapped spec splits over dp (None: held whole
    by every rank); at levels 1 and 2 ``chunks[key]`` the flat view of the
    rank's chunk of a wrapped leaf, which the optimizer updates; at level 3
    ``dtypes[key]`` the dtype a leaf is gathered in."""

    level: int
    group: object
    size: int
    dims: dict
    chunks: dict = field(default_factory=dict)
    dtypes: dict = field(default_factory=dict)


@dataclass
class TrainState:
    """Parameters (nested dict of leaf tensors; ZeRO-3's dp shards), the
    optimizer that owns their moments, the count of steps taken, the ZeRO
    layout (None without ZeRO) and the slice map of the plan the state
    was built for (``builder.slice_map``; None for a state built outside
    an ``Executable``)."""

    params: dict
    optimizer: torch.optim.Optimizer
    step: int = 0
    zero: ZeroLayout | None = None
    layout: dict | None = None

    def opt_leaves(self) -> dict:
        """``{(group, name): the tensor the optimizer updates}`` — the leaf,
        or at ZeRO 1 and 2 the rank's chunk of a wrapped leaf."""
        chunks = self.zero.chunks if self.zero is not None else {}
        return {(g, n): chunks.get((g, n), leaf)
                for g, sub in self.params.items() for n, leaf in sub.items()}


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


def aligned_routing(cfg: MoEConfig, tokens: int,
                    run: int) -> tuple[MoEConfig, bool]:
    """The config under which a rank routes its part of a batch of
    ``tokens`` tokens in the reference's groups (the groups of the whole
    batch, ``_route_group_len`` of its tokens), and whether those groups
    are the rank's own: whether the group length divides ``run``, the
    length of each contiguous run of the batch's flattened tokens the rank
    holds.  Where it does not, the rank shares its groups with the ranks
    that hold the rest of them (``models.moe.SharedGroups``)."""
    g = _route_group_len(tokens, cfg.route_group_size)
    return dataclasses.replace(cfg, route_group_size=g), run % g == 0


def routing_layout(mesh: ProcessMesh, seq_axis, rows: int, seq: int, g: int,
                   device) -> SharedGroups:
    """The ``SharedGroups`` of a rank of a gspmd ``mesh`` holding ``rows``
    rows of ``seq``-token rows (its block of the sequence over
    ``seq_axis``), in groups of ``g`` tokens that straddle ranks: the
    sequence is gathered over cp first, then the rows over ep and then dp
    (the rows' order, dp major), each only while the tokens gathered do not
    hold whole groups.  The block is every token gathered."""
    cp = mesh.size(seq_axis) if seq_axis is not None else 1
    width, col0, row0, gathers = seq // cp, 0, 0, []
    if cp > 1:
        gathers.append((mesh.group(seq_axis), 1))
        col0, width = mesh.index(seq_axis) * width, seq
    block = rows
    for axis in (EP, DP):
        if (block * width) % g == 0:
            break
        if mesh.size(axis) > 1:
            gathers.append((mesh.group(axis), 0))
            row0 += mesh.index(axis) * block
            block *= mesh.size(axis)
    r = torch.arange(row0, row0 + rows, device=device)
    c = torch.arange(col0, col0 + seq // cp, device=device)
    return SharedGroups(tuple(gathers), (r[:, None] * width + c[None, :]).reshape(-1))


def param_leaves(params: dict) -> list[torch.Tensor]:
    """Leaves of a parameter tree in a fixed (insertion) order."""
    return [leaf for sub in params.values() for leaf in sub.values()]


class StepTimer:
    """Per-step train-loop telemetry -> EventLog ``train_step`` events.

    ``record()`` once per completed step: wall-clock step time, cumulative
    elapsed, and tokens/sec from ``tokens_per_step``.  Kernels launch
    asynchronously, so a step's wall time is honest only when the caller
    synchronizes (``loss.item()`` does); between syncs the per-step times
    are launch times.  ``monitor`` (an ``obs.ledger.AccuracyMonitor``)
    scores every synced step (``loss`` given) against the plan's
    prediction."""

    def __init__(self, events=None, tokens_per_step: int = 0,
                 start_step: int = 0, monitor=None):
        self.events = events if events is not None else NULL_LOG
        self.tokens_per_step = tokens_per_step
        self.step_idx = start_step
        self.monitor = monitor
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
        if self.monitor is not None and loss is not None:
            self.monitor.observe(step_ms, step=self.step_idx)
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


def train_state_from_params(params: dict, optimizer=None, zero: int = 0,
                            mesh: ProcessMesh | None = None,
                            cfg: GPTConfig | None = None) -> TrainState:
    """Make ``params``' leaves trainable and wrap them with a fresh optimizer
    (one group over every leaf, as optax applies decay to all of them).
    ``zero`` 1-3 with a ``mesh`` of dp > 1 splits the state over dp (module
    doc); ``params`` are then the rank's tp shards of ``cfg``'s leaves."""
    factory = optimizer or build_optimizer()
    layout = None
    if zero and mesh is not None and mesh.size(DP) > 1:
        params, layout = _zero_split(params, zero, mesh, cfg)
    for leaf in param_leaves(params):
        leaf.requires_grad_(True)
    state = TrainState(params=params, optimizer=None, zero=layout)
    state.optimizer = factory(list(state.opt_leaves().values()))
    return state


def _zero_split(params: dict, level: int, mesh: ProcessMesh,
                cfg: GPTConfig) -> tuple[dict, ZeroLayout]:
    if level not in (1, 2, 3):
        raise ValueError(f"zero={level}: expected 0, 1, 2 or 3")
    dp, r = mesh.size(DP), mesh.index(DP)
    shapes = {g: {n: leaf.shape for n, leaf in sub.items()}
              for g, sub in params.items()}
    wrapped = fsdp_wrap_specs(param_specs_for(cfg, mesh.size(TP)), shapes,
                              DP, dp)
    layout = ZeroLayout(level, mesh.group(DP), dp, {})
    cast = family_ops(cfg).cast_leaves
    out: dict = {}
    for g, sub in params.items():
        for n, leaf in sub.items():
            spec = wrapped[g][n]
            dim = spec.index(DP) if DP in spec else None
            layout.dims[(g, n)] = dim
            if dim is not None and level == 3:
                block = leaf.shape[dim] // dp
                leaf = leaf.narrow(dim, r * block, block).clone()
                layout.dtypes[(g, n)] = (cfg.dtype if n in cast.get(g, ())
                                         else leaf.dtype)
            elif dim is not None:
                block = leaf.numel() // dp
                layout.chunks[(g, n)] = (leaf.detach().view(-1)
                                         .narrow(0, r * block, block)
                                         .requires_grad_(True))
            out.setdefault(g, {})[n] = leaf
    return out, layout


def model_params(state: TrainState) -> tuple[dict, ShardGather | None]:
    """The parameter tree the model reads, and at ZeRO 3 the step's
    ``ShardGather`` (its ``hooks()`` must wrap the forward): the shards as
    ``ShardedGroup``s, or the stored leaves."""
    z = state.zero
    if z is None or z.level < 3:
        return state.params, None
    gather = ShardGather(z.group)
    return {g: ShardedGroup(sub, {n: z.dims[(g, n)] for n in sub},
                            {n: z.dtypes.get((g, n)) for n in sub}, gather)
            for g, sub in state.params.items()}, gather


def build_train_state(seed: int, cfg: GPTConfig,
                      device: str | torch.device = "cuda",
                      optimizer=None, mesh: ProcessMesh | None = None,
                      zero: int = 0) -> TrainState:
    """Initialize parameters on ``device`` from ``seed`` and the matching
    optimizer state; with ``mesh``, this rank's shards of the same
    parameters (``init_params_for``), split over dp at ZeRO ``zero``
    (``zero_axis`` is the reference's DP, the only one it shards over)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return train_state_from_params(init_params_for(gen, cfg, dev, mesh),
                                   optimizer, zero, mesh, cfg)


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


class _RankSlice:
    """What a rank of ``mesh`` runs of a full ``[gbs, seq]`` batch: its rows
    over dp (x ep) and its block of the sequence over cp, the config they
    run under, and the model's keyword arguments (MoE: the routing groups
    it shares, where its tokens do not hold whole groups)."""

    def __init__(self, cfg: GPTConfig, mesh: ProcessMesh, seq_axis, megatron_sp):
        self.cfg, self.mesh, self.seq_axis = cfg, mesh, seq_axis
        self.moe = family_ops(cfg).moe
        self.ranks = mesh.size(DP) * mesh.size(EP)
        self.cp = mesh.size(seq_axis) if seq_axis is not None else 1
        self.sp = bool(megatron_sp) and mesh.size(TP) > 1
        self.spec = batch_spec((DP, EP) if mesh.size(EP) > 1 else DP,
                               seq_axis if self.cp > 1 else None)
        self.slots = mesh.slots()
        self._routing: dict = {}

    def routing(self, shape, device) -> tuple[GPTConfig, dict]:
        """The config and MoE keyword arguments of a ``[gbs, seq]`` batch."""
        key = (tuple(shape), str(device))
        if key not in self._routing:
            cfg, kw = self.cfg, {"ep_group": self.mesh.group(EP)}
            gbs, seq = shape
            if self.ranks * self.cp > 1:
                rows = gbs // self.ranks
                run = rows * seq if self.cp == 1 else seq // self.cp
                cfg, local = aligned_routing(self.cfg, gbs * seq, run)
                if not local:
                    kw["shared"] = routing_layout(
                        self.mesh, self.seq_axis, rows, seq,
                        cfg.route_group_size, device)
            self._routing[key] = cfg, kw
        return self._routing[key]

    def __call__(self, tokens: torch.Tensor):
        """(the rank's tokens, their config, the model's keyword args)."""
        cfg, kw = self.cfg, {}
        if self.moe:
            cfg, moe_kw = self.routing(tokens.shape, tokens.device)
            kw.update(moe_kw)
        if self.cp > 1 or self.sp:
            kw.update(sp=self.sp,
                      pos_offset=seq_offset(self.mesh, tokens.shape[1]))
        return slice_leaf(tokens, self.spec, self.slots), cfg, kw


def _seq_axis(mesh: ProcessMesh, seq_axis):
    return seq_axis if seq_axis is not None and mesh.size(seq_axis) > 1 else None


def make_forward(cfg: GPTConfig, attn_impl=None,
                 mesh: ProcessMesh | None = None, seq_axis: str | None = None,
                 megatron_sp: bool = False, cp_mode: str = "ring") -> Callable:
    """``(state, tokens) -> logits`` without gradients: the logits of this
    rank's rows and block of the sequence of the full ``[gbs, seq]``
    ``tokens`` (its block of the vocabulary under tp; MoE's aux loss
    dropped).  Arguments as ``make_train_step``."""
    mesh = mesh if mesh is not None else ONE_DEVICE
    seq_axis = _seq_axis(mesh, seq_axis)
    rank = _RankSlice(cfg, mesh, seq_axis, megatron_sp)
    attn = attn_impl or resolve_attention(
        cfg, mesh.group(seq_axis) if seq_axis else None, cp_mode)
    family = family_ops(cfg)

    def forward(state: TrainState, tokens: torch.Tensor):
        mine, run_cfg, kw = rank(tokens)
        params, _ = model_params(state)  # no_grad saves nothing to pack
        with torch.no_grad():
            logits = family.forward(params, mine, run_cfg, attn,
                                    mesh.group(TP), **kw)
        return logits[0] if family.moe else logits

    return forward


def make_train_step(cfg: GPTConfig, attn_impl=None,
                    mesh: ProcessMesh | None = None,
                    seq_axis: str | None = None, megatron_sp: bool = False,
                    cp_mode: str = "ring") -> Callable:
    """``(state, tokens, targets) -> (state, loss)``.

    The reference donates the state to its jitted step; here the step
    updates the parameters and optimizer moments in place and returns the
    same state object, so no second copy of the model is ever held.  The
    loss comes back as a 0-d tensor on the device (read it with ``.item()``,
    which waits for the step).

    With ``mesh`` the step takes the full ``[gbs, seq]`` batch on every rank
    and runs its contiguous ``gbs / (dp * ep)`` rows (the reference's
    ``P(dp, None)``, or ``P((dp, ep), None)`` under expert parallelism),
    and with ``seq_axis`` (the mesh's ``SP``) its block of the sequence,
    attention by ``cp_mode`` (``"ring"`` or ``"a2a"``); ``megatron_sp``
    splits the residual stream over tp.  The gradients are reduced as the
    module doc says, ZeRO's by the state's layout, and the returned loss is
    the global batch mean."""
    loss_fn = loss_fn_for(cfg)
    mesh = mesh if mesh is not None else ONE_DEVICE
    seq_axis = _seq_axis(mesh, seq_axis)
    dp, ep = mesh.size(DP), mesh.size(EP)
    if ep > 1 and not family_ops(cfg).moe:
        raise ValueError(f"ep={ep} needs an MoE config")
    rank = _RankSlice(cfg, mesh, seq_axis, megatron_sp)
    cp_group = mesh.group(seq_axis) if seq_axis else None
    attn = attn_impl or resolve_attention(cfg, cp_group, cp_mode)
    specs = param_specs_for(cfg, mesh.size(TP))
    experts = expert_leaves(specs) if ep > 1 else set()
    partial_tp = sp_partial_leaves(specs) if rank.sp else set()
    dp_group, tp_group = mesh.group(DP), mesh.group(TP)
    # the groups a dense gradient is summed over besides dp, and the mean's
    # divisor: each rank's loss is the mean over its share of the tokens
    dense_groups = [g for g in (mesh.group(EP), cp_group) if g is not None]
    ranks = dp * ep * rank.cp

    def reduce_grads(state: TrainState) -> None:
        z = state.zero
        for (g, n), opt in state.opt_leaves().items():
            leaf = state.params[g][n]
            others = ([cp_group] if cp_group is not None else []) \
                if (g, n) in experts else list(dense_groups)
            if (g, n) in partial_tp:
                others.append(tp_group)
            dim = z.dims[(g, n)] if z is not None else None
            if dim is not None and z.level == 2:
                grad = reduce_scatter_dim(leaf.grad.view(-1), dp_group, 0)
                leaf.grad = None
            elif dim is not None and z.level == 3:
                grad = leaf.grad  # reduce-scattered by gather_shard
            else:
                grad = leaf.grad
                if dp_group is not None:
                    others.append(dp_group)
            for group in others:
                dist.all_reduce(grad, group=group)
            if ranks > 1:
                grad.div_(ranks)
            if opt is not leaf:  # ZeRO 1 and 2: the chunk's gradient
                opt.grad = grad if z.level == 2 else _chunk_of(grad, z)

    def step(state: TrainState, tokens: torch.Tensor, targets: torch.Tensor):
        tokens, step_cfg, kw = rank(tokens)
        targets, _, _ = rank(targets)
        params, gather = model_params(state)
        with gather.hooks() if gather is not None else contextlib.nullcontext():
            loss = loss_fn(params, tokens, targets, step_cfg, attn, tp_group,
                           **kw)
        loss.backward()
        if ranks > 1:
            loss = loss.detach().clone()
            for group in [dp_group, *dense_groups]:
                if group is not None:
                    dist.all_reduce(loss, group=group)
            loss.div_(ranks)
        if ranks > 1 or partial_tp:
            reduce_grads(state)
        state.optimizer.step()
        if state.zero is not None and state.zero.level < 3:
            _gather_chunks(state)
        # free the gradients now rather than at the next step's backward
        state.optimizer.zero_grad(set_to_none=True)
        for leaf in param_leaves(state.params):
            leaf.grad = None
        state.step += 1
        return state, loss.detach()

    return step


def _chunk_of(grad: torch.Tensor, z: ZeroLayout) -> torch.Tensor:
    """This rank's flat chunk of a whole leaf's gradient (ZeRO 1)."""
    block = grad.numel() // z.size
    return grad.view(-1).narrow(0, dist.get_rank(z.group) * block, block)


def _gather_chunks(state: TrainState) -> None:
    """ZeRO 1 and 2: every wrapped leaf rebuilt from the ranks' updated
    chunks."""
    z = state.zero
    with torch.no_grad():
        for (g, n), chunk in z.chunks.items():
            state.params[g][n].view(-1).copy_(
                all_gather_dim(chunk.detach(), z.group, 0))
