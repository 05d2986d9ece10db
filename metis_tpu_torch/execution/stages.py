"""The stage runtime of the two multi-stage executors
(``execution/pipeline.py``, ``execution/hetero.py``).

The reference writes pipelining SPMD-style, one ``shard_map`` program that
every device runs (masked identity layers, ``ppermute`` rings), or as one
jitted program per stage mesh moved with ``device_put``.  Here each process
runs only its own stage (MPMD):

- **Ranks.** Stage s owns a contiguous range of ranks of the world group,
  laid out as a ``(dp, tp)`` grid (``mesh.stage_meshes``).  A rank holds its
  stage's blocks, cut from the one-device tree as they are drawn, plus the
  embedding on the first stage and the head on the last (the head is not
  tied to the embedding, so no weight is shared across stages).
- **Units.** A rank runs one or more *units*: a contiguous run of blocks,
  with the embedding before it on the model's first unit and the head and
  loss after it on the last.  The interleaved schedule gives each rank
  ``virtual_stages`` units; the others give it one.
- **Rows.** Each dp replica runs only its own rows of every microbatch
  (``StageLayout.bounds``; the data balancer's uneven ``replica_rows``
  included), so nothing is padded.  The loss of a replica is the sum over
  its rows divided by the rows of the whole microbatch, and the dp group
  sums gradients and losses: a mean of per-replica means would be wrong
  whenever the rows are unequal.
- **Boundaries.** A unit's output rows go to the ranks of the next unit
  that run them, and their gradients come back the same way, point to
  point (``_route``).  Each receiving replica gets exactly its rows, from
  the replicas that computed them; its tp peers get the same rows.
- **Ticks.** A schedule is a list of ticks per rank, each holding forward
  (F) and backward (B) actions of (unit, microbatch).  Whatever an action
  sends is received by the action that needs it exactly one tick later, so
  each tick ends in one ``batch_isend_irecv`` of its sends and the next
  tick's receives, posted in the same order on both sides: with NCCL no
  pair of ranks can wait on each other.  A tick with nothing to exchange
  does not synchronize, so a rank runs ahead until it needs data.
- **Remat.** Under the remat schedules (1f1b, interleaved, hetero) a unit
  stores only its boundary input in F (no graph) and recomputes its
  forward inside B; under gpipe F keeps the graph until B.  The unit that
  ends in the loss runs its forward and backward back to back in B either
  way (nothing to send, nothing to keep).
- **Gradients.** Once per step each unit gets views of the stage's
  leaves that are leaves of their own, whose ``.grad`` is their slice of
  one fp32 accumulator per leaf, and the matrices the model uses in
  ``cfg.dtype`` (``models.family_ops(cfg).cast_leaves``) are cast from them once,
  with the cast in the graph: every microbatch's backward adds through it
  into the accumulator in place, in the order the backwards run.  The
  loss of a replica also carries the factor 1 / M, so the accumulators
  hold the microbatch mean; they are summed over the dp group, and every
  stage takes one AdamW step over its own leaves (elementwise, so the
  same as the one-device step).
- **Overlap.** With ``overlap`` a send is waited for only two exchanges
  later (the reference's double-buffered boundary send), and the dp
  reduction of the manual-backward schedules runs in chunks
  (``train.chunked_all_reduce``); both leave every value as lockstep has
  it.  The deferred waits act only where ``batch_isend_irecv`` returns one
  work per operation, as gloo does; NCCL returns one work for the whole
  batch, which ``_Comm`` waits for at once (that branch has run on no
  machine with several cards).

Gloo's point-to-point operations refuse CUDA tensors (the card machine's
gloo fails ``writev`` with "Bad address"), so on the gloo backend the
boundary tensors of CUDA ranks go through host buffers; NCCL sends them
from the card.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from metis_tpu_torch.core.sharding import slice_leaf
from metis_tpu_torch.execution.mesh import (
    DP,
    TP,
    ProcessMesh,
    stage_offsets,
)
from metis_tpu_torch.execution.train import (
    TrainState,
    chunked_all_reduce,
    param_specs_for,
    params_from,
    train_state_from_params,
)
from metis_tpu_torch.models import family_ops
from metis_tpu_torch.models.parallel import vocab_parallel_cross_entropy

FWD_TAG, BWD_TAG = 1, 2


@dataclass(frozen=True)
class StageLayout:
    """Where one stage's ranks are and which rows of a microbatch each of
    its dp replicas runs: replica d owns rows ``bounds[d] .. bounds[d+1]``
    and ranks ``offset + d * tp .. + tp``."""

    offset: int
    dp: int
    tp: int
    bounds: tuple[int, ...]

    def rank(self, d: int, t: int) -> int:
        return self.offset + d * self.tp + t

    def rows(self, d: int) -> tuple[int, int]:
        return self.bounds[d], self.bounds[d + 1]


def replica_counts(rows: int, dp: int, replica_rows=None,
                   replica_groups=None) -> tuple[int, ...]:
    """Rows of a microbatch that each dp replica runs, in canonical row
    order: the data balancer's ``replica_rows``; else, for a stage split
    into device-type groups, each group's share ``rows * dp_g / dp`` split
    evenly inside the group (the reference's per-group row counts); else an
    even split."""
    if replica_rows is not None:
        counts = tuple(int(r) for r in replica_rows)
        if sum(counts) != rows:
            raise ValueError(f"replica_rows {counts} must sum to the "
                             f"microbatch size {rows}")
        return counts
    counts = []
    for dp_g in (replica_groups or (dp,)):
        rows_g = rows * dp_g // dp
        if rows_g % dp_g:
            raise ValueError(f"{rows_g} rows do not split over a group of "
                             f"{dp_g} replicas")
        counts += [rows_g // dp_g] * dp_g
    if sum(counts) != rows:
        raise ValueError(f"{rows} rows do not split over dp = {dp}")
    return tuple(counts)


def layouts_for(shapes: Sequence[tuple[int, int]],
                counts: Sequence[Sequence[int]]) -> list[StageLayout]:
    """One layout per stage: stage s's ``(dp, tp)`` and its replicas' row
    counts, its ranks after those of the stages before it."""
    return [StageLayout(offset, dp, tp,
                        tuple(int(b) for b in np.cumsum((0, *c))))
            for offset, (dp, tp), c in zip(stage_offsets(shapes), shapes, counts)]


def _route(src: StageLayout, dst: StageLayout):
    """Boundary messages from ``src``'s ranks to ``dst``'s, as ``(from, to,
    lo, hi)`` with rows ``lo .. hi`` of the microbatch: forward, every rank
    of a dst replica gets each overlap of its rows with a src replica from
    one src tp peer; backward, every src rank gets the gradient of each
    overlap from one rank of the dst replica (the tp peers of a replica hold
    the same input gradient)."""
    fwd, bwd = [], []
    for d2 in range(dst.dp):
        a2, b2 = dst.rows(d2)
        for d in range(src.dp):
            a, b = src.rows(d)
            lo, hi = max(a, a2), min(b, b2)
            if lo >= hi:
                continue
            for t2 in range(dst.tp):
                fwd.append((src.rank(d, t2 % src.tp), dst.rank(d2, t2), lo, hi))
            for t in range(src.tp):
                bwd.append((dst.rank(d2, t % dst.tp), src.rank(d, t), lo, hi))
    return fwd, bwd


@dataclass(frozen=True)
class Unit:
    """A run of this rank's stacked blocks ``lo .. hi`` (positions in the
    rank's own stacked leaves), with the embedding before it and/or the
    head after it; ``prev`` / ``next`` are the stages that run the units
    before and after it (None at the model's two ends)."""

    lo: int
    hi: int
    has_embed: bool
    has_head: bool
    prev: int | None
    next: int | None


def make_stage_fn(cfg, attn, tp_group) -> Callable:
    """The stage's forward by role: ``f(params, unit, first_in, targets,
    weight)`` takes tokens on the model's first unit and a boundary
    activation elsewhere, and returns the boundary activation, or on the
    last unit the loss (mean cross-entropy of its rows times ``weight``).
    ``params["blocks"]`` holds the unit's blocks only.  The pieces are the
    family's (``models.family_ops``)."""
    family = family_ops(cfg)
    embed, run_blocks, head_logits = (family.embed, family.run_blocks,
                                      family.head_logits)

    def run(params, unit: Unit, first_in, targets=None, weight=1.0):
        x = (embed(params, first_in, cfg, tp_group) if unit.has_embed
             else first_in)
        if unit.hi > unit.lo:
            x = run_blocks(params, x, cfg, attn, tp_group)
        if not unit.has_head:
            return x
        logits = head_logits(params, x, cfg, tp_group)
        return vocab_parallel_cross_entropy(
            logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
            tp_group) * weight

    return run


class _Comm:
    """Posts one tick's sends and receives as one ``batch_isend_irecv``.
    CUDA tensors on gloo go through host buffers (module doc).  Overlap
    defers the send waits on gloo only: NCCL's coalesced batch is one work,
    waited for whole before the receives are read (unverified across
    cards)."""

    def __init__(self, device: torch.device, overlap: bool):
        self.staged = (device.type == "cuda" and dist.is_initialized()
                       and dist.get_backend() == dist.Backend.GLOO)
        self.overlap = overlap
        self.pending: deque = deque()

    def exchange(self, sends, recvs) -> None:
        """``sends``: (tensor, peer, tag); ``recvs``: (destination view,
        peer, tag).  Returns once every receive has landed; sends are
        waited for now (lockstep) or two exchanges later (overlap)."""
        if not sends and not recvs:
            return
        ops, landing, keep = [], [], []
        for t, peer, tag in sends:
            buf = t.detach().to("cpu") if self.staged else t.detach().contiguous()
            keep.append(buf)
            ops.append(dist.P2POp(dist.isend, buf, peer, tag=tag))
        for view, peer, tag in recvs:
            buf = (torch.empty(view.shape, dtype=view.dtype) if self.staged
                   else view)
            landing.append((view, buf))
            ops.append(dist.P2POp(dist.irecv, buf, peer, tag=tag))
        works = dist.batch_isend_irecv(ops)
        if len(works) == len(ops):
            send_works, recv_works = works[:len(sends)], works[len(sends):]
        else:  # NCCL coalesces the batch into one work: wait for all of it
            send_works, recv_works = [], works
        for w in recv_works:
            w.wait()
        for view, buf in landing:
            if buf is not view:
                view.copy_(buf)
        self.pending.append((send_works, keep))
        while len(self.pending) > (2 if self.overlap else 0):
            self.flush_one()

    def flush_one(self) -> None:
        works, _ = self.pending.popleft()
        for w in works:
            w.wait()

    def flush(self) -> None:
        while self.pending:
            self.flush_one()


class StageRunner:
    """One rank's part of a multi-stage plan: its units, its schedule of
    ticks, and ``init`` / ``step`` (module doc)."""

    def __init__(self, cfg, mesh: ProcessMesh, shapes: Sequence[tuple[int, int]],
                 counts: Callable[[int], list], units: list[Unit],
                 block_ids: Sequence[int], schedule: Callable[[int], dict],
                 remat: bool, device: torch.device, optimizer, attn,
                 overlap: bool, chunked_dp: bool):
        """``shapes``: every stage's ``(dp, tp)``; ``counts(rows)``: every
        stage's replica row counts for ``rows``-row microbatches;
        ``schedule(M)``: this rank's ticks for M microbatches."""
        self.cfg = cfg
        self.mesh = mesh
        self.stage = mesh.index("pp")
        self.shapes = [tuple(sh) for sh in shapes]
        self.counts = counts
        self.units = units
        self.block_ids = tuple(int(b) for b in block_ids)
        self.schedule = schedule
        self.remat = remat
        self.device = device
        self.optimizer = optimizer
        self.overlap = overlap
        self.chunked_dp = chunked_dp
        self.dp_group, self.tp_group = mesh.group(DP), mesh.group(TP)
        self.fn = make_stage_fn(cfg, attn, self.tp_group)
        self.specs = param_specs_for(cfg, mesh.size(TP))
        self.cast_once = family_ops(cfg).cast_leaves
        self.slots = {DP: (mesh.index(DP), mesh.size(DP)),
                      TP: (mesh.index(TP), mesh.size(TP))}
        self._routes: dict = {}

    def _layouts(self, rows: int) -> list[StageLayout]:
        return layouts_for(self.shapes, self.counts(rows))

    def _routes_for(self, rows: int) -> dict:
        """``{(src stage, dst stage): (fwd, bwd)}`` of this rank's unit
        boundaries at ``rows``-row microbatches."""
        if rows not in self._routes:
            lay = self._layouts(rows)
            pairs = {(u.prev, self.stage) for u in self.units if u.prev is not None}
            pairs |= {(self.stage, u.next) for u in self.units if u.next is not None}
            self._routes[rows] = {(a, b): _route(lay[a], lay[b]) for a, b in pairs}
        return self._routes[rows]

    # -- parameters --------------------------------------------------------
    def cut(self, group: str, name: str, leaf: torch.Tensor):
        """This rank's piece of a full leaf: its stage's blocks (in its
        units' order) and tp block; None for an embedding or head it does
        not hold."""
        if group == "embed" and not any(u.has_embed for u in self.units):
            return None
        if group == "head" and not any(u.has_head for u in self.units):
            return None
        if group == "blocks":
            leaf = leaf[torch.as_tensor(self.block_ids, dtype=torch.long,
                                        device=leaf.device)]
        return slice_leaf(leaf, self.specs[group][name], self.slots).contiguous()

    def init(self, source) -> TrainState:
        """``source``: a seed (the one-device tree drawn on this rank's
        device, each leaf cut as it is drawn), or the full parameter tree
        (numpy arrays or tensors) of which the rank keeps its piece."""
        params = params_from(source, self.cfg, self.device, self.cut)
        return train_state_from_params(params, self.optimizer)

    # -- the step ------------------------------------------------------------
    def _unit_params(self, params: dict, unit: Unit, acc: dict) -> dict:
        """The unit's leaves for one step: views of the stage's that are
        leaves of their own, each with its slice of the step's fp32
        accumulator as ``.grad`` (autograd adds every backward's gradient
        into it in place), and the family's ``cast_leaves`` cast
        to ``cfg.dtype`` once, the cast in the graph of every microbatch."""
        def take(group, name, t):
            v = t.detach().requires_grad_()
            g = acc[group][name]
            v.grad = g[unit.lo:unit.hi] if group == "blocks" else g
            if name in self.cast_once.get(group, ()):
                return v.to(self.cfg.dtype)
            return v

        out = {"blocks": {n: take("blocks", n, t[unit.lo:unit.hi])
                          for n, t in params["blocks"].items()}}
        for group, has in (("embed", unit.has_embed), ("head", unit.has_head)):
            if has:
                out[group] = {n: take(group, n, t)
                              for n, t in params[group].items()}
        return out

    def step(self, state: TrainState, tokens_mbs: torch.Tensor,
             targets_mbs: torch.Tensor):
        """One training step over microbatch-major ``[M, rows, seq]`` tokens
        and targets (the whole microbatches on every rank; each rank takes
        its replica's rows).  Returns the state and the global loss, the
        mean over microbatches of the microbatch mean, on every rank."""
        cfg, params = self.cfg, state.params
        M, rows, seq = tokens_mbs.shape
        lay = self._layouts(rows)
        routes = self._routes_for(rows)
        me_lay = lay[self.stage]
        me = me_lay.rank(self.mesh.index(DP), self.mesh.index(TP))
        a, b = me_lay.rows(self.mesh.index(DP))
        mine = b - a
        weight = mine / (rows * M)
        tokens = tokens_mbs[:, a:b].to(self.device)
        targets = targets_mbs[:, a:b].to(self.device)
        comm = _Comm(self.device, self.overlap)
        acc = {g: {n: torch.zeros_like(t, dtype=torch.float32)
                   for n, t in sub.items()} for g, sub in params.items()}
        unit_params = [self._unit_params(params, u, acc) for u in self.units]
        saved: dict = {}   # (unit, m) -> boundary input or kept graph
        outbox: list = []  # sends of the current tick
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        act_shape = (mine, seq, cfg.hidden)

        def forward(ui, m):
            unit = self.units[ui]
            x = tokens[m] if unit.has_embed else saved.pop((ui, m, "in"))
            if unit.has_head:
                saved[(ui, m)] = x
                return
            if self.remat:
                saved[(ui, m)] = x
                with torch.no_grad():
                    out = self.fn(unit_params[ui], unit, x)
            else:
                if not unit.has_embed:
                    x.requires_grad_()
                out = self.fn(unit_params[ui], unit, x)
                saved[(ui, m)] = (x, out)
            for src, dst, lo, hi in routes[(self.stage, unit.next)][0]:
                if src == me:
                    outbox.append((out[lo - a:hi - a], dst, FWD_TAG))

        def backward(ui, m):
            nonlocal loss_sum
            unit = self.units[ui]
            if unit.has_head or self.remat:
                x = saved.pop((ui, m))
                if not unit.has_embed:
                    x.requires_grad_()
                out = self.fn(unit_params[ui], unit, x, targets[m], weight)
            else:
                x, out = saved.pop((ui, m))
            if unit.has_head:
                out.backward()
                loss_sum = loss_sum + out.detach()
            else:
                out.backward(saved.pop((ui, m, "grad")))
            if not unit.has_embed:
                for src, dst, lo, hi in routes[(unit.prev, self.stage)][1]:
                    if src == me:
                        outbox.append((x.grad[lo - a:hi - a], dst, BWD_TAG))

        def receives(actions):
            recvs = []
            for kind, ui, m in actions:
                unit = self.units[ui]
                if kind == "F" and not unit.has_embed:
                    msgs = routes[(unit.prev, self.stage)][0]
                    key, tag = (ui, m, "in"), FWD_TAG
                elif kind == "B" and not unit.has_head:
                    msgs = routes[(self.stage, unit.next)][1]
                    key, tag = (ui, m, "grad"), BWD_TAG
                else:
                    continue
                buf = torch.empty(act_shape, dtype=cfg.dtype, device=self.device)
                saved[key] = buf
                for src, dst, lo, hi in msgs:
                    if dst == me:
                        recvs.append((buf[lo - a:hi - a], src, tag))
            return recvs

        ticks = self.schedule(M)
        if mine:
            # every tick from the first to the last, idle ones included, so
            # that each message is posted by both sides at the same tick
            first, last = min(ticks), max(ticks)
            comm.exchange([], receives(ticks.get(first, ())))
            for t in range(first, last + 1):
                for kind, ui, m in ticks.get(t, ()):
                    (forward if kind == "F" else backward)(ui, m)
                comm.exchange(outbox, receives(ticks.get(t + 1, ())))
                outbox.clear()
            comm.flush()

        del unit_params
        leaves = [(acc[g][n], params[g][n]) for g in params for n in params[g]]
        if self.dp_group is not None:
            grads = [g for g, _ in leaves]
            if self.chunked_dp:
                chunked_all_reduce(grads, self.dp_group)
            else:
                for g in grads:
                    dist.all_reduce(g, group=self.dp_group)
            dist.all_reduce(loss_sum, group=self.dp_group)
        for g, p in leaves:
            p.grad = g
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.broadcast(loss_sum, src=lay[-1].offset)
        return state, loss_sum


# -- schedules: {tick: [(kind, unit, microbatch), ...]} for one rank ----------

def fill_drain_ticks(num_stages: int, stage: int, M: int) -> dict:
    """Every microbatch forward, then every backward in reverse order (the
    reference's gpipe scan and its hetero fill / drain): stage s runs F(m)
    at tick m + s and B(m) at tick (M + S - 1) + (M - 1 - m) + (S - 1 - s)."""
    S, s = num_stages, stage
    ticks: dict = {}
    for m in range(M):
        ticks.setdefault(m + s, []).append(("F", 0, m))
        ticks.setdefault((M + S - 1) + (M - 1 - m) + (S - 1 - s), []).append(
            ("B", 0, m))
    return ticks


def one_f_one_b_ticks(num_stages: int, stage: int, M: int) -> dict:
    """The reference's 1F1B ticks: F(m) at tick m + s, B(m) at tick
    m + 2(S - 1) - s, F before B within a tick (on the last stage they are
    the same microbatch)."""
    S, s = num_stages, stage
    ticks: dict = {}
    for m in range(M):
        ticks.setdefault(m + s, []).append(("F", 0, m))
    for m in range(M):
        ticks.setdefault(m + 2 * (S - 1) - s, []).append(("B", 0, m))
    return ticks


def interleaved_ticks(num_stages: int, stage: int, M: int, vs: int) -> dict:
    """The reference's interleaved schedule: microbatches in groups of S;
    within a group, unit ``u = v * S + g`` (chunk v, microbatch g of the
    group) runs forward at tick u + s and backward at tick
    ``(vS + S - 1) + (vS + S - 2 - s - u)``; the groups follow each other."""
    S, s = num_stages, stage
    VS, span = vs * S, vs * S + S - 1
    ticks: dict = {}
    for grp in range(M // S):
        base = grp * 2 * span
        for u in range(VS):
            v, g = divmod(u, S)
            m = grp * S + g
            ticks.setdefault(base + u + s, []).append(("F", v, m))
            ticks.setdefault(base + span + (VS + S - 2 - s - u), []).append(
                ("B", v, m))
    return ticks

