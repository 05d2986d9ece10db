"""Live plan migration: reshard running state between two plans in place —
the port of ``metis_tpu/execution/reshard.py``.

Every replan otherwise implies drain -> checkpoint -> rebuild ->
digest-verified restore, a filesystem round trip.  This module moves the
state between the ranks of one process group instead:

1. **Delta** — ``plan_reshard`` compares the slice maps
   (``builder.slice_map``) of every rank's source state with those of a
   fresh state of the destination plan and keeps only the tensors a rank
   does not already hold exactly as the destination wants them (the
   minimal-transfer set; resident tensors are copied in place).
2. **Transfer** — ``execute_reshard`` moves each moved leaf, one leaf at a
   time, point to point (``torch.distributed.batch_isend_irecv``): every
   distinct piece of the one-device leaf goes from the lowest rank holding
   it to each destination rank whose part overlaps it, the part that
   overlaps (a ZeRO 1 or 2 moment chunk whole), and the destination
   assembles its part (``checkpoint.overlap``).  On gloo, CUDA tensors go
   through host buffers (gloo refuses them point to point); on NCCL they
   stay on the card.  Each leaf's transfer consults the ``reshard_send``
   fault point and is retried (``resilience.retry.RetryPolicy``); the
   ranks agree on a fault, so they retry together.
3. **Verify** — the sha256 digest of every one-device leaf (the
   checkpoint's formula, ``checkpoint.leaf_digest``, on the leaf assembled
   on rank 0) is taken on the source before and on the destination after;
   any mismatch, or an injected ``reshard_verify`` fault, raises
   ``MigrationError``.  The source state is never written, so a failed
   migration loses nothing: the caller falls back to a checkpoint restore.

``ReshardReport.phases_ms`` splits the stall into these parts on rank 0
(``PHASES``), so that the slowest of them can be found on the card.

The destination plan runs on all of the group's ranks or on its first
ones (``builder.build_executable`` gives a rank outside it None): such a
rank passes None as its destination and only sends.  Which executables can reshard
live is ``migration_eligible``'s rule: gspmd to gspmd (one device
included), pipeline to pipeline at the same block layout, never hetero.

The analytic half (``stage_layout``, ``layout_moved_bytes``,
``price_migration_ms``) prices a prospective switch from plan artifacts
alone, with the moved-bytes rule ``cost/estimator.py`` charges as its
``migration`` term (``SearchConfig.migrate_from``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from metis_tpu_torch.core.errors import MigrationError
from metis_tpu_torch.core.events import NULL_LOG, EventLog
from metis_tpu_torch.execution.checkpoint import (
    MOMENTS,
    _family,
    _gather,
    _schema,
    _world,
    assemble,
    extent,
    full_entry,
    leaf_digest,
    logical_path,
    overlap,
    owners,
)
from metis_tpu_torch.execution.mesh import PP, PlanArtifact
from metis_tpu_torch.execution.train import TrainState
from metis_tpu_torch.resilience.faults import NULL_INJECTOR, FaultInjector
from metis_tpu_torch.resilience.retry import RetryPolicy


# ---------------------------------------------------------------------------
# analytic layout delta + pricing (shared with cost/estimator.py)
# ---------------------------------------------------------------------------


def stage_layout(artifact: PlanArtifact,
                 num_layers: int | None = None) -> tuple:
    """Canonical per-stage layout of a plan artifact: one
    ``(tp, layer_start, layer_end)`` triple per pipeline stage — the
    ``SearchConfig.migrate_from`` encoding the migration cost term prices
    against.  Uniform artifacts (one strategy, pp in the mesh shape) are
    expanded to per-stage triples; artifacts without a recorded layer
    partition rebuild the canonical even split from ``num_layers``."""
    strategies = [dict(s) for s in artifact.strategies]
    if artifact.mesh_shape and PP in artifact.mesh_axes:
        pp = artifact.mesh_shape[artifact.mesh_axes.index(PP)]
    else:
        pp = len(strategies)
    if len(strategies) == 1 and pp > 1:
        strategies = strategies * pp
    bounds = tuple(artifact.layer_partition)
    if not bounds:
        if num_layers is None:
            raise ValueError(
                "artifact records no layer partition — pass num_layers to "
                "rebuild the canonical even split")
        from metis_tpu_torch.cost.estimator import uniform_layer_split

        counts = uniform_layer_split(num_layers, pp)
        acc = [0]
        for c in counts:
            acc.append(acc[-1] + c)
        bounds = tuple(acc)
    return tuple((int(s["tp"]), int(bounds[i]), int(bounds[i + 1]))
                 for i, s in enumerate(strategies))


def layout_moved_bytes(old_layout: tuple, new_layout: tuple,
                       volume) -> float:
    """Parameter bytes a switch from ``old_layout`` to ``new_layout`` must
    move: every layer the new layout does NOT already hold at the same tp
    under some old stage transfers its (new-tp-sharded) parameter bytes.
    The identical rule ``cost/estimator._migration_ms`` amortizes — kept
    in lockstep so the priced term and the live transfer agree."""
    old_tp: dict[int, int] = {}
    for tp, start, end in old_layout:
        for layer in range(start, end):
            old_tp[layer] = tp
    moved = 0.0
    for tp, start, end in new_layout:
        per = volume.parameter_bytes_per_layer(tp)
        for layer in range(start, end):
            if old_tp.get(layer) != tp:
                moved += per[layer]
    return moved


def price_migration_ms(old_layout: tuple, new_layout: tuple, volume,
                       bw_gbps: float = 100.0) -> float:
    """One-time live-transfer cost of the switch, in ms (decimal GB/s —
    the native bandwidth convention).  This is the UN-amortized figure the
    supervisor compares against the measured checkpoint-restore time; the
    cost model divides the same bytes by ``migration_amortize_steps`` to
    make it a per-step term."""
    return layout_moved_bytes(old_layout, new_layout, volume) / (bw_gbps * 1e6)


def device_sets_intersect(old_cluster, new_cluster) -> bool:
    """Whether any device survives a topology change — the cheap first
    gate of migration eligibility (a live reshard needs a surviving
    intersection to move state over; a wholesale fleet swap does not
    have one and must go through the checkpoint)."""
    types = ({n.device_type for n in old_cluster.nodes}
             | {n.device_type for n in new_cluster.nodes})
    return any(
        min(old_cluster.num_devices_by_type(t),
            new_cluster.num_devices_by_type(t)) > 0
        for t in types)


def migration_eligible(old_kind: str, new_kind: str,
                       old_block_layout: str, new_block_layout: str,
                       devices_intersect: bool) -> tuple[bool, str]:
    """(eligible, reason) for a live in-memory reshard between two built
    executables.  Shape-compatibility is structural: the gspmd route's
    state is one tree of the one-device leaves (always migratable to
    another gspmd plan), the pipeline route stacks blocks per stage (same
    recorded block layout required), and the hetero route's per-stage
    state has no cross-plan adapter, as in the reference (a checkpoint
    restore handles it)."""
    if not devices_intersect:
        return False, "old and new device sets are disjoint"
    if old_kind == "hetero" or new_kind == "hetero":
        return False, "hetero per-stage state has no live-reshard adapter"
    if old_kind != new_kind:
        return False, (f"state shapes differ across executors "
                       f"({old_kind} -> {new_kind})")
    if old_kind == "pipeline" and old_block_layout != new_block_layout:
        return False, (f"pipeline block layouts differ "
                       f"({old_block_layout} -> {new_block_layout})")
    return True, "ok"


# ---------------------------------------------------------------------------
# the live transfer
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ReshardReport:
    """What one executed migration did."""

    leaves: int          # one-device tensors of the state (parameters, moments)
    moved: int           # of them, those some rank received
    moved_bytes: int     # their one-device bytes
    stall_ms: float      # wall-clock plan + transfer + verify, the slowest rank's
    verified: bool       # digest check ran and passed
    # rank 0's wall ms of each part of ``stall_ms`` (``PHASES``)
    phases_ms: dict = field(default_factory=dict)


#: the parts of a migration's stall that ``ReshardReport.phases_ms`` times
#: on rank 0, the card's queued work finished at each boundary: the plan
#: (the maps gathered, the moved set); the transfer (every tensor into
#: the destination state); and the verification's two halves, source and
#: destination together: each one-device leaf assembled on rank 0 and
#: copied to the host, and its sha256 there
PHASES = ("plan", "transfer", "verify_gather", "verify_hash")


def _clock() -> float:
    """``time.perf_counter`` after the card's queued work."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter()


def _any(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank."""
    return any(_gather(bool(flag)))


class _Local:
    """This rank's side of a state: its slice map (None for a rank outside
    the plan) and its tensors, ``(leaf, what)`` -> tensor (``what``
    "param" or a moment), and its moments' AdamW step per leaf."""

    def __init__(self, state: TrainState | None):
        self.layout = state.layout if state is not None else None
        self.tensors, self.steps = {}, {}
        if state is None:
            return
        if self.layout is None:
            raise MigrationError(
                "the state has no slice map (TrainState.layout, set by "
                "Executable.init); a live reshard reads the plans' maps")
        for (g, n), opt in state.opt_leaves().items():
            key = f"{g}/{n}"
            self.tensors[key, "param"] = state.params[g][n]
            st = state.optimizer.state.get(opt)
            if st:
                for m in MOMENTS:
                    self.tensors[key, m] = st[m]
                self.steps[key] = float(st["step"])


def _entry(layout: dict | None, key: str, what: str) -> dict | None:
    e = layout["leaves"].get(key) if layout is not None else None
    if e is None or what != "param":
        return e
    return {**e, "flat": None}


def _tensors_of(schema: dict, moments: bool) -> list[tuple[str, str]]:
    """The one-device tensors of a state of ``schema``: each leaf's
    parameter, then with ``moments`` its AdamW moments."""
    whats = ("param", *MOMENTS) if moments else ("param",)
    return [(key, w) for key in schema for w in whats]


def _resident(srcs: list, dsts: list, key: str, what: str) -> bool:
    """Whether every rank that holds a part of the tensor under the
    destination plan already holds exactly that part."""
    return all(_entry(d, key, what) == _entry(s, key, what)
               for s, d in zip(srcs, dsts) if _entry(d, key, what) is not None)


def _plan(srcs: list, dsts: list, moments: bool):
    """(the moved tensors, all tensors, the moved ones' one-device bytes),
    after the schema and eligibility checks."""
    src0 = next((s for s in srcs if s is not None), None)
    dst0 = next((d for d in dsts if d is not None), None)
    if src0 is None or dst0 is None:
        raise MigrationError("no rank holds a source or a destination state")
    ok, why = migration_eligible(
        _family(src0["kind"]), _family(dst0["kind"]), src0["block_layout"],
        dst0["block_layout"], True)
    if not ok:
        raise MigrationError(f"no live reshard: {why}")
    schema = _schema(srcs)
    if schema != _schema(dsts):
        raise MigrationError(
            "src and dst states differ in their leaves, shapes or dtypes — "
            "the plans do not share a state schema, reshard cannot apply")
    tensors = _tensors_of(schema, moments)
    moved = [t for t in tensors if not _resident(srcs, dsts, *t)]
    moved_bytes = sum(int(np.prod(schema[k][0])) * _itemsize(schema[k][1])
                      for k, _ in moved)
    return moved, tensors, moved_bytes


def _itemsize(dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def plan_reshard(src_state: TrainState | None, dst_reference: TrainState | None,
                 src_map: dict | None = None, dst_map: dict | None = None,
                 ) -> tuple[list, int, int]:
    """The minimal-transfer set over the one-device tensors of the state:
    ``(moved, total, moved_bytes)``, ``moved`` the ``(leaf, what)`` pairs
    some rank must receive.  ``src_map`` / ``dst_map``: this rank's slice
    maps (default: the states' ``layout``; None on a rank outside a plan).
    Every rank of the process group calls it.  Raises ``MigrationError``
    when the two states are not the same logical state (leaves, shapes or
    dtypes differ) or ``migration_eligible`` refuses the pair."""
    if src_map is None and src_state is not None:
        src_map = src_state.layout
    if dst_map is None and dst_reference is not None:
        dst_map = dst_reference.layout
    moments = src_state is not None and bool(src_state.optimizer.state)
    gathered = _gather((src_map, dst_map, moments))
    moved, tensors, moved_bytes = _plan(
        [g[0] for g in gathered], [g[1] for g in gathered],
        any(g[2] for g in gathered))
    return moved, len(tensors), moved_bytes


def _backend_host() -> bool:
    """Whether point-to-point tensors go through host memory (gloo)."""
    return dist.is_initialized() and dist.get_backend() == "gloo"


def _home() -> torch.device:
    """Where this rank receives a tensor it holds nothing of: its card on
    NCCL (which sends from and to cards only), else the host."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _transfer(key: str, what: str, srcs: list, dsts: list, mine: _Local,
              dtype: torch.dtype, device) -> torch.Tensor | None:
    """This rank's destination part of tensor ``(key, what)``, moved from
    the source ranks' parts (module doc).  Every rank calls it; a rank
    holding no destination part gets None."""
    rank, world = _world()
    moment = what != "param"
    src_own = _entry(srcs[rank], key, what)
    plan = []  # (owner, dst rank, owner's entry, overlap) in one order on every rank
    for d in range(world):
        e_d = _entry(dsts[d], key, what)
        if e_d is None or e_d == _entry(srcs[d], key, what):
            continue
        for o, e_o in owners(srcs, key, moment):
            ov = overlap(e_d, e_o)
            if ov is not None:
                plan.append((o, d, e_o, ov))
    host = _backend_host()
    ops, got = [], {}
    for i, (o, d, e_o, ov) in enumerate(plan):
        if o == d:
            continue
        if o == rank:
            t = mine.tensors[key, what]
            piece = (t if e_o["flat"] is not None else t[ov[1]]).contiguous()
            ops.append(dist.P2POp(dist.isend, piece.cpu() if host else piece, d))
        elif d == rank:
            shape = ((e_o["flat"][1] - e_o["flat"][0],) if e_o["flat"] is not None
                     else tuple(_span(ix, n) for ix, n in zip(ov[1], extent(e_o))))
            got[i] = torch.empty(shape, dtype=dtype,
                                 device="cpu" if host else device)
            ops.append(dist.P2POp(dist.irecv, got[i], o))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    e_d = _entry(dsts[rank], key, what)
    if e_d is None:
        return None
    if e_d == src_own:
        return mine.tensors[key, what].detach().to(device, copy=True)
    pieces = []
    for i, (o, d, e_o, ov) in enumerate(plan):
        if d != rank:
            continue
        if o == rank:
            pieces.append((e_o, mine.tensors[key, what].detach()))
        elif e_o["flat"] is not None:
            pieces.append((e_o, got[i]))
        else:
            pieces.append((_sub_entry(e_o, ov[1]), got[i]))
    return assemble(e_d, pieces, dtype, device)


def _span(ix, n: int) -> int:
    if isinstance(ix, slice):
        return len(range(*ix.indices(n)))
    return int(ix.numel())


def _sub_entry(e: dict, index: tuple) -> dict:
    """The entry of ``e``'s tensor indexed by ``index`` (an ``overlap``)."""
    rows = list(e["ids"]) if e["ids"] is not None else list(range(*e["box"][0]))
    if e["box"]:
        i0 = index[0]
        rows = rows[i0] if isinstance(i0, slice) else [rows[j] for j in i0.tolist()]
    box = [[rows[0], rows[-1] + 1] if rows else [0, 0]] if e["box"] else []
    for (a, _), ix in zip(e["box"][1:], index[1:]):
        box.append([a + ix.start, a + ix.stop])
    ids = None if rows == list(range(*box[0])) else rows
    return {"shape": e["shape"], "ids": ids, "box": box, "flat": None}


def logical_digests(state: TrainState | None, moments: bool | None = None,
                    phases_ms: dict | None = None) -> dict[str, str]:
    """``leaf_digest`` of every one-device tensor of the state the ranks
    hold (each assembled on rank 0; paths ``checkpoint.logical_path``'s
    and ``['step']``), returned on every rank.  Every rank of the process
    group calls it, a rank outside the plan with None.  Equal to
    ``checkpoint.logical_digests`` of a checkpoint of the same state.
    ``phases_ms``: adds this rank's ms of assembling and of hashing to its
    ``verify_gather`` and ``verify_hash`` (``PHASES``)."""
    times = {"verify_gather": 0.0, "verify_hash": 0.0}
    mine = _Local(state)
    gathered = _gather((mine.layout, bool(mine.steps), mine.steps,
                        state.step if state is not None else None))
    layouts = [g[0] for g in gathered]
    has_moments = any(g[1] for g in gathered) if moments is None else moments
    steps = {}
    for g in reversed(gathered):
        steps.update(g[2])
    rank, world = _world()
    schema = _schema(layouts)
    out = {}
    for key, what in _tensors_of(schema, has_moments):
        shape, dtype = schema[key]
        on_rank0 = [{"leaves": {key: full_entry(shape)}}] + [None] * (world - 1)
        device = (mine.tensors[key, what].device if (key, what) in mine.tensors
                  else _home())
        t0 = _clock()
        t = _transfer(key, what, layouts, on_rank0, mine, getattr(torch, dtype),
                      device)
        if rank == 0:
            t = t.cpu()
        t1 = _clock()
        if rank == 0:
            out[logical_path(key, what)] = leaf_digest(t)
        times["verify_gather"] += (t1 - t0) * 1e3
        times["verify_hash"] += (time.perf_counter() - t1) * 1e3
    if rank == 0:
        for key in schema:
            if has_moments and key in steps:
                out[logical_path(key, "step")] = leaf_digest(
                    torch.tensor(steps[key], dtype=torch.float32))
        step = next(g[3] for g in gathered if g[3] is not None)
        out["['step']"] = leaf_digest(np.asarray(int(step), np.int32))
    if world > 1:
        box = [out]
        dist.broadcast_object_list(box, src=0)
        out = box[0]
    if phases_ms is not None:
        for k, v in times.items():
            phases_ms[k] = phases_ms.get(k, 0.0) + v
    return out


def execute_reshard(
    src_state: TrainState | None,
    dst_reference: TrainState | None,
    *,
    step: int | None = None,
    events: EventLog = NULL_LOG,
    faults: FaultInjector = NULL_INJECTOR,
    retry: RetryPolicy | None = None,
    sleep=time.sleep,
    verify: bool = True,
):
    """Reshard ``src_state`` (this rank's state under the source plan) onto
    ``dst_reference`` (a fresh state of the destination plan,
    ``Executable.init``; None on a rank outside it) and return
    ``(new_state, ReshardReport)``; ``new_state`` is ``dst_reference``
    filled in place (its values are discarded): parameters, AdamW moments
    and their step, the step.  Every rank of the process group calls it.

    Emits ``reshard_plan`` once, ``reshard_step`` per moved tensor and
    ``migration_complete`` on success.  Any failure — another state
    schema or an ineligible pair, exhausted ``reshard_send`` retries, a
    digest mismatch, an injected ``reshard_verify`` fault — raises
    ``MigrationError`` (or ``RetryExhaustedError``) with the source state
    untouched, so the caller can fall back to a checkpoint restore."""
    t0 = _clock()
    phases = dict.fromkeys(PHASES, 0.0)
    src, dst = _Local(src_state), _Local(dst_reference)
    gathered = _gather((src.layout, dst.layout, bool(src.steps), src.steps,
                        src_state.step if src_state is not None else None))
    srcs, dsts = [g[0] for g in gathered], [g[1] for g in gathered]
    moments = any(g[2] for g in gathered)
    steps = {}
    for g in reversed(gathered):
        steps.update(g[3])
    train_step = next(g[4] for g in gathered if g[4] is not None)
    moved, tensors, moved_bytes = _plan(srcs, dsts, moments)
    phases["plan"] = (_clock() - t0) * 1e3
    src_digests = logical_digests(src_state, moments, phases) if verify else {}
    t1 = _clock()
    events.emit("reshard_plan", leaves=len(tensors), moved=len(moved),
                moved_bytes=moved_bytes, step=step)
    policy = retry if retry is not None else RetryPolicy()
    schema = _schema(srcs)
    moved_set = set(moved)
    opt_state = {}
    index = ({f"{g}/{n}": i for i, (g, n) in
              enumerate(dst_reference.opt_leaves())}
             if dst_reference is not None else {})
    for key, what in tensors:
        shape, dtype = schema[key]
        target = dst.tensors.get((key, "param"))
        device = target.device if target is not None else _home()
        path = logical_path(key, what)

        def move(key=key, what=what, dtype=dtype, device=device):
            if _any(faults.check("reshard_send", step) is not None):
                raise OSError(f"injected reshard_send fault ({path})")
            return _transfer(key, what, srcs, dsts, src, getattr(torch, dtype),
                             device)

        if (key, what) in moved_set:
            out = policy.call(move, op=f"reshard_send:{path}", events=events,
                              sleep=sleep)
            events.emit("reshard_step", leaf=path,
                        bytes=int(np.prod(shape)) * _itemsize(dtype), step=step)
        else:
            out = _transfer(key, what, srcs, dsts, src, getattr(torch, dtype),
                            device)
        if out is None:
            continue
        if what == "param":
            with torch.no_grad():
                target.copy_(out)
        else:
            st = opt_state.setdefault(index[key], {})
            st[what] = out
            st["step"] = torch.tensor(steps[key], dtype=torch.float32)
    if dst_reference is not None:
        dst_reference.optimizer.load_state_dict(
            {"state": opt_state,
             "param_groups": dst_reference.optimizer.state_dict()["param_groups"]})
        dst_reference.step = train_step
    phases["transfer"] = (_clock() - t1) * 1e3
    verified = False
    if verify:
        if _any(faults.check("reshard_verify", step) is not None):
            raise MigrationError(
                "injected reshard_verify fault: post-transfer digest "
                "mismatch")
        dst_digests = logical_digests(dst_reference, moments, phases)
        bad = sorted(k for k, v in src_digests.items()
                     if dst_digests.get(k) != v)
        if bad:
            shown = ", ".join(bad[:3]) + ("..." if len(bad) > 3 else "")
            raise MigrationError(
                f"reshard digest mismatch for {len(bad)} leaf/leaves "
                f"({shown}) — state diverged in flight")
        verified = True
    times = _gather(((_clock() - t0) * 1e3, phases))
    stall_ms = max(t for t, _ in times)
    events.emit("migration_complete", leaves=len(tensors), moved=len(moved),
                moved_bytes=moved_bytes, stall_ms=round(stall_ms, 3),
                step=step)
    return dst_reference, ReshardReport(
        leaves=len(tensors), moved=len(moved), moved_bytes=moved_bytes,
        stall_ms=stall_ms, verified=verified, phases_ms=times[0][1])
