"""The stage runtime of the two multi-stage executors
(``execution/pipeline.py``, ``execution/hetero.py``).

The reference writes pipelining SPMD-style, one ``shard_map`` program that
every device runs (masked identity layers, ``ppermute`` rings), or as one
jitted program per stage mesh moved with ``device_put``.  Here each process
runs only its own stage (MPMD):

- **Ranks.** Stage s owns a contiguous range of ranks of the world group,
  laid out as its grid (``mesh.StageGrid``: ``(dp, tp)``, ``(dp, cp, tp)``
  under context parallelism, ``(dp / ep, ep, tp)`` under expert
  parallelism, whose dp replicas are the ``(dp, ep)`` pairs).  A rank holds
  its stage's blocks, cut from the one-device tree as they are drawn, plus
  the embedding on the first stage and the head on the last (the head is
  not tied to the embedding, so no weight is shared across stages).
- **Units.** A rank runs one or more *units*: a contiguous run of blocks,
  with the embedding before it on the model's first unit and the head and
  loss after it on the last.  The interleaved schedule gives each rank
  ``virtual_stages`` units; the others give it one.
- **Rows and blocks of the sequence.** Each dp replica runs only its own
  rows of every microbatch (``StageLayout.bounds``; the data balancer's
  uneven ``replica_rows`` included), and each of its cp ranks its
  contiguous block of the sequence at its absolute positions, attention
  running over the stage's sp group.  The loss of a rank is the mean over
  its tokens times its share of the microbatch's tokens, and the dp (and
  sp) groups sum gradients and losses: a mean of per-replica means would
  be wrong whenever the rows are unequal.
- **MoE stages.** A dense stage runs only its rows, unpadded.  An MoE
  stage routes its tokens in *programs*, the replicas that route together
  (the whole stage, or each device-type group of a mixed stage, as the
  reference's per-group programs): when a program's rows are uneven each
  of its replicas pads its rows to the program's largest count with
  duplicates of its row 0, masked out of routing, capacity and the aux
  statistics (``valid_mask``), the reference's ``_pad_maps`` layout.  The
  routing groups are those of the program's padded tokens
  (``train.aligned_routing``); where a group straddles replicas, the
  replicas share it (``models.moe.SharedGroups``: gathered over the ep
  group, then the dp group, each replica padded to the stage's widest
  program for the gather).  A non-head unit returns ``(x, aux)``; its
  backward seeds the aux cotangent with ``aux_loss_coef * aux_weight``
  times the rank's share, the reference's ``aux_seed``, so no aux value
  crosses a boundary.
- **Boundaries.** A unit's output rows (and blocks of the sequence) go to
  the ranks of the next unit that run them, and their gradients come back
  the same way, point to point (``_route``): a cp 2 stage feeding a cp 1
  stage sends each rank's block of the sequence to the whole-sequence
  receiver.  Each receiving rank gets exactly its part, from the ranks that
  computed it; its tp peers get the same.
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
  ``cfg.dtype`` (``models.family_ops(cfg).cast_leaves``) are cast from them
  once, with the cast in the graph: every microbatch's backward adds
  through it into the accumulator in place, in the order the backwards
  run.  The loss of a replica also carries the factor 1 / M, so the
  accumulators hold the microbatch mean; they are summed over the stage's
  dp x ep x cp ranks (an expert leaf over dp only: its ep peers' tokens
  reached it through the all-to-all), and every stage takes one AdamW step
  over its own leaves (elementwise, so the same as the one-device step).
- **ZeRO.** A stage's ``zero`` splits its state over its dp group
  (``train.train_state_from_params``, the gspmd route's ``ZeroLayout``).
  At levels 1 and 2 the accumulators are whole leaves, all-reduced (1) or
  reduce-scattered (2) to the rank's chunk after the last microbatch.  At
  level 3 a rank stores its shards, the unit reads them through a
  ``ShardGather`` (each block's leaves gathered where the model reads them,
  saved for the backward as shards, per microbatch), and the accumulator is
  the shard's: the gathers' backward reduce-scatters every microbatch's
  gradient into it.
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

import contextlib
from collections import deque
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from metis_tpu_torch.core.sharding import slice_leaf
from metis_tpu_torch.execution.mesh import (
    DP,
    EP,
    SP,
    TP,
    ProcessMesh,
    StageGrid,
    expert_leaves,
    stage_offsets,
)
from metis_tpu_torch.execution.train import (
    TrainState,
    _chunk_of,
    _gather_chunks,
    aligned_routing,
    chunked_all_reduce,
    param_leaves,
    param_specs_for,
    params_from,
    train_state_from_params,
)
from metis_tpu_torch.models import family_ops
from metis_tpu_torch.models.parallel import (
    ShardedGroup,
    ShardGather,
    reduce_scatter_dim,
    vocab_parallel_cross_entropy,
)

FWD_TAG, BWD_TAG = 1, 2


@dataclass(frozen=True)
class StageLayout:
    """Where one stage's ranks are and which part of a microbatch each
    runs: replica d owns rows ``bounds[d] .. bounds[d+1]``, its cp rank c
    the c-th of ``cp`` equal blocks of the ``seq`` positions, and rank
    ``offset + (d * cp + c) * tp + t`` is its tp rank t."""

    offset: int
    dp: int
    cp: int
    tp: int
    bounds: tuple[int, ...]
    seq: int

    def rank(self, d: int, c: int, t: int) -> int:
        return self.offset + (d * self.cp + c) * self.tp + t

    def rows(self, d: int) -> tuple[int, int]:
        return self.bounds[d], self.bounds[d + 1]

    def cols(self, c: int) -> tuple[int, int]:
        n = self.seq // self.cp
        return c * n, (c + 1) * n


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


def layouts_for(grids: Sequence[StageGrid], counts: Sequence[Sequence[int]],
                seq: int) -> list[StageLayout]:
    """One layout per stage: stage s's grid and its replicas' row counts of
    ``seq``-token rows, its ranks after those of the stages before it."""
    return [StageLayout(offset, g.dp, g.cp, g.tp,
                        tuple(int(b) for b in np.cumsum((0, *c))), seq)
            for offset, g, c in zip(stage_offsets(grids), grids, counts)]


def _route(src: StageLayout, dst: StageLayout):
    """Boundary messages from ``src``'s ranks to ``dst``'s, as ``(from, to,
    lo, hi, s_lo, s_hi)``: rows ``lo .. hi`` at positions ``s_lo .. s_hi``
    of the microbatch.  Forward, every rank of a dst replica's cp block gets
    each overlap of its rows and positions with a src rank's from one src
    tp peer; backward, every src rank gets the gradient of each overlap
    from one rank of the dst replica's cp block (the tp peers of a replica
    hold the same input gradient)."""
    fwd, bwd = [], []
    for d2 in range(dst.dp):
        a2, b2 = dst.rows(d2)
        for c2 in range(dst.cp):
            sa2, sb2 = dst.cols(c2)
            for d in range(src.dp):
                a, b = src.rows(d)
                lo, hi = max(a, a2), min(b, b2)
                if lo >= hi:
                    continue
                for c in range(src.cp):
                    sa, sb = src.cols(c)
                    piece = (lo, hi, max(sa, sa2), min(sb, sb2))
                    if piece[2] >= piece[3]:
                        continue
                    for t2 in range(dst.tp):
                        fwd.append((src.rank(d, c, t2 % src.tp),
                                    dst.rank(d2, c2, t2), *piece))
                    for t in range(src.tp):
                        bwd.append((dst.rank(d2, c2, t % dst.tp),
                                    src.rank(d, c, t), *piece))
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


@dataclass(frozen=True)
class StageStep:
    """What a rank's units run under in one step: the config (an MoE's
    routing groups those of the rank's program), the absolute position of
    its first token, the rows it computes (``rows``: its ``real`` rows,
    padded on an uneven MoE program), the pad mask of those rows (None:
    every row real), the weight of its loss, its share of the step's
    tokens, and the MoE routing groups it shares with other replicas
    (None: its groups are its own)."""

    cfg: object
    pos_offset: int
    rows: int
    real: int
    weight: float
    valid: torch.Tensor | None = None
    shared: object = None  # models.moe.SharedGroups, or None


def make_stage_fn(cfg, attn, tp_group, ep_group=None,
                  aux_weight: float = 0.0) -> Callable:
    """The stage's forward by role: ``f(params, unit, first_in, step,
    targets)`` takes tokens on the model's first unit and a boundary
    activation elsewhere, and returns the boundary activation (MoE: with
    its aux loss, ``(x, aux)``), or on the last unit the loss: the mean
    cross-entropy of its real rows, plus on MoE ``aux_loss_coef *
    aux_weight * aux`` (``aux_weight``: the stage's share of the model's
    blocks), times ``step.weight``.  ``params["blocks"]`` holds the unit's
    blocks only.  The pieces are the family's (``models.family_ops``)."""
    family = family_ops(cfg)

    def run(params, unit: Unit, first_in, step: StageStep, targets=None):
        c = step.cfg
        x = (family.stage_embed(params, first_in, c, tp_group, step.pos_offset)
             if unit.has_embed else first_in)
        aux = None
        if unit.hi > unit.lo:
            x, aux = family.stage_blocks(params, x, c, attn, tp_group,
                                         step.pos_offset, ep_group, step.valid,
                                         step.shared)
        if family.moe and aux is None:  # no router on an embed-only stage
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if not unit.has_head:
            return (x, aux) if family.moe else x
        if step.real:
            logits = family.head_logits(params, x[:step.real], c, tp_group)
            loss = vocab_parallel_cross_entropy(
                logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
                tp_group)
        else:
            # a replica of pad rows only: its loss is 0, but its backward
            # must still run the ep all-to-alls its peers wait for
            loss = x.float().sum() * 0
        if family.moe:
            loss = loss + c.aux_loss_coef * aux_weight * aux
        return loss * step.weight

    return run


class _Comm:
    """Posts one tick's sends and receives as one ``batch_isend_irecv``.
    CUDA tensors on gloo go through host buffers (module doc), and so does
    a receive into a view that is not contiguous (a block of the
    sequence).  Overlap defers the send waits on gloo only: NCCL's
    coalesced batch is one work, waited for whole before the receives are
    read (unverified across cards)."""

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
            buf = view
            if self.staged or not view.is_contiguous():
                buf = torch.empty(view.shape, dtype=view.dtype,
                                  device="cpu" if self.staged else view.device)
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

    def __init__(self, cfg, mesh: ProcessMesh, grids: Sequence[StageGrid],
                 counts: Callable[[int], list], units: list[Unit],
                 block_ids: Sequence[int], schedule: Callable[[int], dict],
                 remat: bool, device: torch.device, optimizer, attn,
                 overlap: bool, chunked_dp: bool, zero: int = 0,
                 programs: Sequence[int] | None = None,
                 aux_weight: float = 0.0):
        """``grids``: every stage's ``StageGrid``; ``counts(rows)``: every
        stage's replica row counts for ``rows``-row microbatches;
        ``schedule(M)``: this rank's ticks for M microbatches; ``attn``: the
        attention of this rank's stage (over its sp group under cp);
        ``zero``: its stage's ZeRO level; on MoE ``programs``: the sizes, in
        replicas, of the stage's routing programs (None: one), and
        ``aux_weight``: the stage's share of the model's blocks."""
        self.cfg = cfg
        self.mesh = mesh
        self.stage = mesh.index("pp")
        self.grids = list(grids)
        self.counts = counts
        self.units = units
        self.block_ids = tuple(int(b) for b in block_ids)
        self.schedule = schedule
        self.remat = remat
        self.device = device
        self.optimizer = optimizer
        self.overlap = overlap
        self.chunked_dp = chunked_dp
        self.zero = zero
        self.moe = family_ops(cfg).moe
        self.programs = tuple(programs or (self.grids[self.stage].dp,))
        self.aux_weight = aux_weight
        self.dp_group, self.tp_group = mesh.group(DP), mesh.group(TP)
        self.sp_group, self.ep_group = mesh.group(SP), mesh.group(EP)
        self.replica = mesh.index(DP) * mesh.size(EP) + mesh.index(EP)
        self.fn = make_stage_fn(cfg, attn, self.tp_group, self.ep_group,
                                aux_weight)
        self.specs = param_specs_for(cfg, mesh.size(TP))
        self.experts = expert_leaves(self.specs) if mesh.size(EP) > 1 else set()
        self.cast_once = family_ops(cfg).cast_leaves
        self._routes: dict = {}

    def _layouts(self, rows: int, seq: int) -> list[StageLayout]:
        return layouts_for(self.grids, self.counts(rows), seq)

    def _routes_for(self, rows: int, seq: int) -> dict:
        """``{(src stage, dst stage): (fwd, bwd)}`` of this rank's unit
        boundaries at ``rows``-row microbatches of ``seq`` tokens."""
        if (rows, seq) not in self._routes:
            lay = self._layouts(rows, seq)
            pairs = {(u.prev, self.stage) for u in self.units if u.prev is not None}
            pairs |= {(self.stage, u.next) for u in self.units if u.next is not None}
            self._routes[rows, seq] = {(a, b): _route(lay[a], lay[b])
                                       for a, b in pairs}
        return self._routes[rows, seq]

    def _step_of(self, lay: StageLayout, M: int, rows: int) -> StageStep:
        """This rank's ``StageStep`` for M microbatches of ``rows`` rows:
        on MoE its program's padded rows, mask and routing config."""
        a, b = lay.rows(self.replica)
        s0, s1 = lay.cols(self.mesh.index(SP))
        real = b - a
        step = StageStep(self.cfg, s0, real, real, real / (rows * M * lay.cp))
        if not self.moe:
            return step
        ends = np.cumsum((0, *self.programs))
        g = int(np.searchsorted(ends, self.replica, side="right")) - 1
        lo, hi = int(ends[g]), int(ends[g + 1])
        counts = [lay.rows(d)[1] - lay.rows(d)[0] for d in range(lo, hi)]
        padded = len(set(counts)) > 1
        width = max(counts) if padded else real
        if not width:
            return step
        seq = s1 - s0
        cfg, local = aligned_routing(self.cfg, (hi - lo) * width * seq,
                                     width * seq)
        valid = shared = None
        if padded:
            valid = torch.zeros(width, device=self.device)
            valid[:real] = 1
        if not local:
            shared = self._shared_groups(lay, lo, hi, width, seq,
                                         cfg.route_group_size)
        return StageStep(cfg, s0, width, real, step.weight, valid, shared)

    def _shared_groups(self, lay: StageLayout, lo: int, hi: int, width: int,
                       seq: int, g: int):
        """The ``SharedGroups`` of this rank's replica, whose program of
        replicas ``lo .. hi`` runs ``width`` (padded) rows of ``seq`` tokens
        in groups of ``g`` that straddle replicas: gathered over the ep
        group (the replica's ep peers, contiguous in the program), then, if
        those tokens do not hold whole groups, over the dp group, which
        gathers every replica of the stage, each padded to the stage's
        largest row count."""
        from metis_tpu_torch.models.moe import SharedGroups

        ep, e = self.mesh.size(EP), self.mesh.index(EP)
        counts = [lay.rows(d)[1] - lay.rows(d)[0] for d in range(lay.dp)]
        gathers, first, n, pad = [], self.replica - e, 1, width
        if ep > 1:
            gathers.append((self.ep_group, 0))
            n = ep
        if ep == 1 or (ep * width * seq) % g:
            gathers.append((self.dp_group, 0))
            first, n, pad = 0, lay.dp, max(counts)
        reps = [q for q in range(first, first + n) if lo <= q < hi]
        rows = torch.cat([(q - first) * pad + torch.arange(width) for q in reps])
        block = (rows[:, None] * seq + torch.arange(seq)[None, :]).reshape(-1)
        valid = None
        if any(counts[q] != width for q in reps):
            valid = torch.cat([(torch.arange(width) < counts[q]).float()
                               .repeat_interleave(seq) for q in reps])
            valid = valid.to(self.device)
        mine = reps.index(self.replica) * width * seq
        return SharedGroups(
            tuple(gathers), torch.arange(mine, mine + width * seq).to(self.device),
            pad - width, block.to(self.device), valid)

    # -- parameters --------------------------------------------------------
    def cut(self, group: str, name: str, leaf: torch.Tensor):
        """This rank's piece of a full leaf: its stage's blocks (in its
        units' order) and its tp and ep block; None for an embedding or
        head it does not hold."""
        if group == "embed" and not any(u.has_embed for u in self.units):
            return None
        if group == "head" and not any(u.has_head for u in self.units):
            return None
        if group == "blocks":
            leaf = leaf[torch.as_tensor(self.block_ids, dtype=torch.long,
                                        device=leaf.device)]
        return slice_leaf(leaf, self.specs[group][name],
                          self.mesh.slots()).contiguous()

    def init(self, source) -> TrainState:
        """``source``: a seed (the one-device tree drawn on this rank's
        device, each leaf cut as it is drawn), or the full parameter tree
        (numpy arrays or tensors) of which the rank keeps its piece; split
        over the stage's dp group at its ZeRO level."""
        params = params_from(source, self.cfg, self.device, self.cut)
        return train_state_from_params(params, self.optimizer, self.zero,
                                       self.mesh, self.cfg)

    # -- the step ------------------------------------------------------------
    def _unit_params(self, state: TrainState, unit: Unit, acc: dict,
                     gather: ShardGather | None) -> dict:
        """The unit's leaves for one step: views of the stage's that are
        leaves of their own, each with its slice of the step's fp32
        accumulator as ``.grad`` (autograd adds every backward's gradient
        into it in place), and the family's ``cast_leaves`` cast to
        ``cfg.dtype`` once, the cast in the graph of every microbatch.  At
        ZeRO 3 each group is a ``ShardedGroup`` of the shards' views, which
        ``gather`` casts as it gathers them."""
        z = state.zero

        def take(group, name, t, cast):
            v = t.detach().requires_grad_()
            g = acc[group][name]
            v.grad = g[unit.lo:unit.hi] if group == "blocks" else g
            if cast and name in self.cast_once.get(group, ()):
                return v.to(self.cfg.dtype)
            return v

        def views(group, leaves):
            if gather is None:
                return {n: take(group, n, t, True) for n, t in leaves.items()}
            dims = {n: z.dims[(group, n)] for n in leaves}
            return ShardedGroup(
                {n: take(group, n, t, dims[n] is None) for n, t in leaves.items()},
                dims, {n: z.dtypes.get((group, n)) for n in leaves}, gather)

        params = state.params
        out = {"blocks": views("blocks", {n: t[unit.lo:unit.hi] for n, t in
                                          params["blocks"].items()})}
        for group, has in (("embed", unit.has_embed), ("head", unit.has_head)):
            if has:
                out[group] = views(group, params[group])
        return out

    def step(self, state: TrainState, tokens_mbs: torch.Tensor,
             targets_mbs: torch.Tensor):
        """One training step over microbatch-major ``[M, rows, seq]`` tokens
        and targets (the whole microbatches on every rank; each rank takes
        its replica's rows and its block of the sequence).  Returns the
        state and the global loss, the mean over microbatches of the
        microbatch mean (MoE: with every stage's weighted aux loss), on
        every rank."""
        cfg, params = self.cfg, state.params
        M, rows, seq = tokens_mbs.shape
        lay = self._layouts(rows, seq)
        routes = self._routes_for(rows, seq)
        me_lay = lay[self.stage]
        me = me_lay.rank(self.replica, self.mesh.index(SP), self.mesh.index(TP))
        a, _ = me_lay.rows(self.replica)
        s0, s1 = me_lay.cols(self.mesh.index(SP))
        run = self._step_of(me_lay, M, rows)
        mine = run.rows
        tokens = tokens_mbs[:, a:a + run.real, s0:s1].to(self.device)
        if mine > run.real:  # pad rows: duplicates of row 0
            row0 = tokens[:, :1] if run.real else torch.zeros(
                (M, 1, s1 - s0), dtype=tokens.dtype, device=self.device)
            tokens = torch.cat([tokens, row0.expand(M, mine - run.real, -1)], 1)
        targets = targets_mbs[:, a:a + run.real, s0:s1].to(self.device)
        comm = _Comm(self.device, self.overlap)
        acc = {g: {n: torch.zeros_like(t, dtype=torch.float32)
                   for n, t in sub.items()} for g, sub in params.items()}
        gather = None
        if state.zero is not None and state.zero.level == 3:
            gather = ShardGather(state.zero.group)
        hooks = gather.hooks if gather is not None else contextlib.nullcontext
        unit_params = [self._unit_params(state, u, acc, gather) for u in self.units]
        saved: dict = {}   # (unit, m) -> boundary input or kept graph
        outbox: list = []  # sends of the current tick
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        aux_seed = (cfg.aux_loss_coef * self.aux_weight * run.weight
                    if self.moe else 0.0)
        act_shape = (mine, s1 - s0, cfg.hidden)

        def mine_of(t, lo, hi, slo, shi):
            return t[lo - a:hi - a, slo - s0:shi - s0]

        def forward(ui, m):
            unit = self.units[ui]
            x = tokens[m] if unit.has_embed else saved.pop((ui, m, "in"))
            if not unit.has_embed and mine > run.real:
                x[run.real:] = x[:1] if run.real else 0
            if unit.has_head:
                saved[(ui, m)] = x
                return
            if self.remat:
                saved[(ui, m)] = x
                with torch.no_grad():
                    out = self.fn(unit_params[ui], unit, x, run)
            else:
                if not unit.has_embed:
                    x.requires_grad_()
                with hooks():
                    out = self.fn(unit_params[ui], unit, x, run)
                saved[(ui, m)] = (x, out)
            y = out[0] if self.moe else out
            for src, dst, *piece in routes[(self.stage, unit.next)][0]:
                if src == me:
                    outbox.append((mine_of(y, *piece), dst, FWD_TAG))

        def backward(ui, m):
            nonlocal loss_sum
            unit = self.units[ui]
            if unit.has_head or self.remat:
                x = saved.pop((ui, m))
                if not unit.has_embed:
                    x.requires_grad_()
                with hooks():
                    out = self.fn(unit_params[ui], unit, x, run, targets[m])
            else:
                x, out = saved.pop((ui, m))
            if unit.has_head:
                out.backward()
                loss_sum = loss_sum + out.detach()
            elif self.moe:
                y, aux = out
                loss_sum = loss_sum + aux.detach() * aux_seed
                seeds = [(y, saved.pop((ui, m, "grad")))]
                if aux.requires_grad:
                    seeds.append((aux, torch.full_like(aux, aux_seed)))
                torch.autograd.backward(*zip(*seeds))
            else:
                out.backward(saved.pop((ui, m, "grad")))
            if not unit.has_embed:
                for src, dst, *piece in routes[(unit.prev, self.stage)][1]:
                    if src == me:
                        outbox.append((mine_of(x.grad, *piece), dst, BWD_TAG))

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
                # a pad row's gradient is 0; its input is set in forward
                buf = (torch.zeros if kind == "B" and mine > run.real
                       else torch.empty)(act_shape, dtype=cfg.dtype,
                                         device=self.device)
                saved[key] = buf
                for src, dst, *piece in msgs:
                    if dst == me:
                        recvs.append((mine_of(buf, *piece), src, tag))
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
        self._reduce(state, acc)
        state.optimizer.step()
        if state.zero is not None and state.zero.level < 3:
            _gather_chunks(state)
        state.optimizer.zero_grad(set_to_none=True)
        for leaf in param_leaves(params):
            leaf.grad = None
        state.step += 1
        if dist.is_initialized() and dist.get_world_size() > 1:
            # each replica's tp rank 0 (every cp rank) holds its share
            if self.mesh.index(TP):
                loss_sum.zero_()
            dist.all_reduce(loss_sum)
        return state, loss_sum

    def _reduce(self, state: TrainState, acc: dict) -> None:
        """Sum the step's accumulators over the stage's ranks (module doc)
        and hand them to the optimizer: whole leaves' as their ``.grad``,
        at ZeRO 1 and 2 a wrapped leaf's chunk's, at ZeRO 3 its shard's
        (already summed over dp by the gathers' backward)."""
        z = state.zero
        plain = []
        for (g, n), opt in state.opt_leaves().items():
            grad = acc[g][n]
            others = [self.sp_group]
            if (g, n) not in self.experts:
                others.append(self.ep_group)
            for group in others:
                if group is not None:
                    dist.all_reduce(grad, group=group)
            dim = z.dims[(g, n)] if z is not None else None
            if dim is None:
                plain.append(grad)
                opt.grad = grad
            elif z.level == 3:
                opt.grad = grad
            elif z.level == 2:
                opt.grad = reduce_scatter_dim(grad.view(-1), self.dp_group, 0)
            else:
                dist.all_reduce(grad, group=self.dp_group)
                opt.grad = _chunk_of(grad, z)
        if self.dp_group is None:
            return
        if self.chunked_dp:
            chunked_all_reduce(plain, self.dp_group)
        else:
            for grad in plain:
                dist.all_reduce(grad, group=self.dp_group)


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

