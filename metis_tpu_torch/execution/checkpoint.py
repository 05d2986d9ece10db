"""Checkpoint / resume of training state and plan artifacts — the port of
``metis_tpu/execution/checkpoint.py``, without orbax (the card machine has
neither JAX nor orbax): every rank writes its own state with ``torch.save``.

What a checkpoint directory of the port holds:

- ``state/rank{r:05d}.pt``: rank ``r``'s own state, ``torch.save`` of CPU
  tensors, read back with ``weights_only=True``: its parameters (at ZeRO 3
  its shards), its optimizer's ``state_dict`` (the AdamW moments; at ZeRO 1
  and 2 those of its flat chunks), the step, and its slice map
  (``layout``: ``builder.slice_map``, plus ``opt``, the leaf of each of
  the optimizer's tensors in order).  On the hetero route it is the
  rank's stage's state.
  A plan on the process group's first ranks (``builder.build_executable``
  gives the others None) is written by those ranks alone: a rank outside
  the plan passes None as its state, writes nothing and takes part in the
  barriers; a restore counts the rank files, not the process group.
- ``meta.json`` (``CheckpointMeta``, byte for byte the reference's JSON)
  and ``plan.json`` (the ``PlanArtifact``), written by rank 0.
- **Digests.** ``CheckpointMeta.digests`` maps a leaf's path to sha256 over
  ``str(shape)``, then the dtype's name, then its C-contiguous bytes, the
  reference's formula (a bf16 leaf hashes as ``"bfloat16"`` over its raw
  2-byte words).  The paths are the reference's ``keystr`` paths of
  ``{"params", "opt_state", "step"}``: on a one-device plan the ``params``
  and ``step`` digests equal the reference's on the same numpy parameters
  (the layouts are the same leaf for leaf, ``models/convert.py``).  The
  ``opt_state`` paths are the port's own (``torch.optim`` is not optax):
  ``['opt_state'][i]['exp_avg']`` for the optimizer's i-th tensor.  On a
  plan of several ranks each path is prefixed with ``rank{r:05d}``.
- ``mesh_axes`` / ``mesh_shape``: the plan artifact's, and ``("stage",)``
  / ``(n,)`` on the hetero route, as the reference writes them.

**Restore scope.** Onto the plan that wrote it, on as many ranks, each
rank reads its own file.  Onto another plan, as the reference's orbax
reshards on read, each rank fills each of its tensors from the parts of
the one-device leaf that the old ranks' slice maps say they hold
(``assemble``): one leaf at a time, every source tensor read through
``mmap`` and verified against its digest first (one whose digest the meta
lacks is corrupt), a part held by several
old ranks (dp replicas, a leaf kept whole over tp) read from the lowest,
the flat ZeRO 1 and 2 chunks of the moments joined, the moments' AdamW
step carried with them.  What restores is what the reference restores:
the gspmd and pipeline routes' one tree of state onto any dp, tp, ep, cp,
sp, ZeRO and pp at a compatible block layout (a one-device plan
included), the hetero route's per-stage state onto the same stages and
layer partition.  Everything else raises ``MetisError`` before any state
is touched: the hetero route against the others, another stage partition
or block layout, another model.  A checkpoint without slice maps (one
written before they were) restores onto its own plan only, into a state
built as the saved one was: its optimizer state goes by position, each
moment's shape checked against its parameter's.

**Crash safety.** A save writes into a ``.tmp`` sibling and swaps it in,
parking the previous checkpoint at ``.prev`` during the swap (kept with
``keep_prev``), fenced by barriers over the process group; at every
instant one complete checkpoint is on disk.  A restore verifies every leaf
against its digest and falls back to ``.prev`` when the primary is corrupt,
the ranks agreeing on the generation they read.  ``AsyncCheckpointWriter``
copies the state to host memory on the training thread and writes it from
a background thread; its ``wait`` / ``close`` gather the ranks' digests,
write the meta and swap, and re-raise a failed write on every rank.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from metis_tpu_torch.core.errors import (
    CheckpointCorruptError,
    CheckpointWriteError,
    MetisError,
)
from metis_tpu_torch.execution.mesh import PlanArtifact
from metis_tpu_torch.execution.train import TrainState

_STATE_DIR = "state"
_PLAN_FILE = "plan.json"
_META_FILE = "meta.json"
# threads hashing a rank's leaves
_HASH_THREADS = min(8, os.cpu_count() or 1)


@dataclass(frozen=True)
class CheckpointMeta:
    """Sidecar metadata — enough to sanity-check a resume.

    ``block_layout`` records the physical ordering of the stacked block
    axis: "canonical", or "interleaved:<pp>x<vs>" for the interleaved
    pipeline schedule's permutation, or "uneven:<pp>x<counts>"
    (``builder.checkpoint_block_layout``); resume compares it.  ``digests``
    maps each leaf's path to the sha256 of its content (module doc); a
    restore recomputes and compares them."""

    step: int
    mesh_axes: tuple[str, ...]
    mesh_shape: tuple[int, ...]
    block_layout: str = "canonical"
    digests: dict[str, str] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({
            "step": self.step,
            "mesh_axes": list(self.mesh_axes),
            "mesh_shape": list(self.mesh_shape),
            "block_layout": self.block_layout,
            "digests": self.digests,
        }, indent=2)

    @staticmethod
    def from_json(payload: str) -> "CheckpointMeta":
        d = json.loads(payload)
        return CheckpointMeta(
            step=d["step"],
            mesh_axes=tuple(d["mesh_axes"]),
            mesh_shape=tuple(d["mesh_shape"]),
            block_layout=d.get("block_layout", "canonical"),
            digests=dict(d.get("digests", {})),
        )


# -- the process group ----------------------------------------------------------

def _world() -> tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) outside one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    if _world()[1] > 1:
        dist.barrier()


def _gather(obj) -> list:
    """Every rank's ``obj``, in rank order (a host-side collective)."""
    rank, world = _world()
    if world == 1:
        return [obj]
    out: list = [None] * world
    dist.all_gather_object(out, obj)
    return out


# -- digests ----------------------------------------------------------------------

def _key(k) -> str:
    return f"[{k!r}]" if isinstance(k, str) else f"[{k}]"


def _flatten(tree, prefix: str = ""):
    """``(path, leaf)`` of a tree of dicts and lists, the paths in the
    reference's ``keystr`` form, dict keys in sorted order as jax flattens
    them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + _key(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + _key(i))
    else:
        yield prefix, tree


def leaf_digest(leaf) -> str:
    """sha256 of (shape, dtype name, C-contiguous bytes) of a tensor or
    array, the reference's formula."""
    h = hashlib.sha256()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        h.update(str(tuple(t.shape)).encode())
        h.update(str(t.dtype).removeprefix("torch.").encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy())
    else:
        arr = np.asarray(leaf)
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    return h.hexdigest()


def _digest_futures(pool: ThreadPoolExecutor, tree, prefix: str = "") -> dict:
    """Leaf path -> a future of its ``leaf_digest`` (sha256 releases the
    GIL, so the leaves hash on several cores)."""
    return {path: pool.submit(leaf_digest, leaf)
            for path, leaf in _flatten(tree, prefix)}


def tree_digests(tree, prefix: str = "") -> dict[str, str]:
    """Leaf path -> ``leaf_digest`` of every leaf of ``tree``."""
    with ThreadPoolExecutor(_HASH_THREADS) as pool:
        return {k: f.result() for k, f in _digest_futures(pool, tree, prefix).items()}


# -- the state a rank writes --------------------------------------------------------

def _host(obj):
    """A host copy of a tree of tensors (and plain values)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_host(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_host(v) for v in obj)
    return obj


def _snapshot(state: TrainState | None, step: int | None = None,
              stage: int | None = None) -> dict | None:
    """What a rank writes (module doc), copied to host memory: ``params``,
    ``optimizer`` (its ``state_dict``), ``step``, on the hetero route the
    rank's ``stage``, and the state's slice map as ``layout``; None for a
    rank outside the plan."""
    if state is None:
        return None
    snap = {"params": _host(state.params),
            "optimizer": _host(state.optimizer.state_dict()),
            "step": int(state.step if step is None else step)}
    if stage is not None:
        snap["stage"] = stage
    if state.layout is not None:
        # the slice map, and the leaf of each of the optimizer's tensors
        snap["layout"] = {**state.layout,
                          "opt": [f"{g}/{n}" for g, n in state.opt_leaves()]}
    return snap


def _digest_tree(snap: dict) -> dict:
    """The digested tree of a snapshot: the reference's ``{"params",
    "opt_state", "step"}``, or on the hetero route ``{"stages": {s:
    {"params", "opt_state"}}, "step"}`` (the step an int32 scalar, as the
    reference's)."""
    body = {"params": snap["params"], "opt_state": snap["optimizer"]["state"]}
    step = np.asarray(snap["step"], np.int32)
    if "stage" in snap:
        return {"stages": {snap["stage"]: body}, "step": step}
    return {**body, "step": step}


def _rank_prefix(rank: int, world: int) -> str:
    return f"rank{rank:05d}" if world > 1 else ""


def _rank_file(directory: Path, rank: int) -> Path:
    return directory / _STATE_DIR / f"rank{rank:05d}.pt"


def _writers(snap: dict | None) -> int:
    """How many ranks write (those holding a state), after checking that
    they are the process group's first ranks."""
    held = _gather(snap is not None)
    n = sum(held)
    if held != [True] * n + [False] * (len(held) - n) or n == 0:
        raise MetisError(f"a checkpoint is written by a plan on the process "
                         f"group's first ranks; the ranks holding a state: {held}")
    return n


def _write_rank(tmp: Path, snap: dict | None, rank: int, world: int) -> dict:
    """Write one rank's snapshot into ``tmp`` (nothing for None), hashing it
    meanwhile; its digests.  ``world``: the ranks that write."""
    if snap is None:
        return {}
    with ThreadPoolExecutor(_HASH_THREADS) as pool:
        futures = _digest_futures(pool, _digest_tree(snap),
                                  _rank_prefix(rank, world))
        torch.save(snap, _rank_file(tmp, rank))
        return {k: f.result() for k, f in futures.items()}


# -- the crash-safe swap --------------------------------------------------------------

def _prepare_tmp(directory: Path) -> tuple[Path, Path]:
    """(tmp, prev), tmp freshly (re)created by rank 0 with its state dir,
    every rank fenced behind its existence."""
    tmp = directory.with_name(directory.name + ".tmp")
    prev = directory.with_name(directory.name + ".prev")
    if _world()[0] == 0:
        if tmp.exists():
            shutil.rmtree(tmp)
        (tmp / _STATE_DIR).mkdir(parents=True)
    _barrier()
    return tmp, prev


def _swap_tmp_into_place(directory: Path, tmp: Path, prev: Path,
                         keep_prev: bool = False) -> None:
    """Rank 0 parks the primary at ``.prev``, renames ``.tmp`` into place
    and drops ``.prev`` unless ``keep_prev``: never deleting the only
    complete checkpoint.  Fenced so no rank returns mid-swap."""
    _barrier()
    if _world()[0] == 0:
        if directory.exists():
            if prev.exists():
                shutil.rmtree(prev)
            directory.rename(prev)
        tmp.rename(directory)
        if prev.exists() and not keep_prev:
            shutil.rmtree(prev)
    _barrier()


def _mesh_axes_shape(mesh) -> tuple[tuple, tuple]:
    """The (axes, shape) a checkpoint records of ``mesh``: a
    ``PlanArtifact``'s mesh fields, or an ``(axes, shape)`` pair."""
    if isinstance(mesh, PlanArtifact):
        return tuple(mesh.mesh_axes), tuple(mesh.mesh_shape)
    axes, shape = mesh
    return tuple(axes), tuple(shape)


def _finish(directory: Path, tmp: Path, prev: Path, digests: dict,
            meta_fields: dict, plan: PlanArtifact | None,
            keep_prev: bool) -> None:
    """Rank 0 writes the meta (every rank's digests, gathered by the
    caller) and the plan into ``tmp``; then the swap."""
    if _world()[0] == 0:
        meta = CheckpointMeta(digests=digests, **meta_fields)
        (tmp / _META_FILE).write_text(meta.to_json())
        if plan is not None:
            (tmp / _PLAN_FILE).write_text(plan.to_json())
    _swap_tmp_into_place(directory, tmp, prev, keep_prev)


def _merged(per_rank: list[dict]) -> dict:
    out: dict = {}
    for d in per_rank:
        out.update(d)
    return out


def _save(directory, snap: dict | None, meta_fields: dict, plan,
          keep_prev) -> Path:
    directory = Path(directory).absolute()
    tmp, prev = _prepare_tmp(directory)
    rank, world = _world()[0], _writers(snap)
    error, digests = None, {}
    try:
        digests = _write_rank(tmp, snap, rank, world)
    except Exception as e:  # noqa: BLE001 — every rank must hear of it
        error = f"{type(e).__name__}: {e}"
    results = _gather((error, digests))
    _raise_failed(directory, results, "")
    _finish(directory, tmp, prev, _merged([d for _, d in results]),
            meta_fields, plan, keep_prev)
    return directory


def _raise_failed(directory: Path, results: list, what: str) -> None:
    failed = [(r, e) for r, (e, _) in enumerate(results) if e is not None]
    if failed:
        r, e = failed[0]
        raise CheckpointWriteError(
            f"{what}checkpoint write to {directory} failed on rank {r}: {e}")


def save_checkpoint(directory: str | Path, state: TrainState | None, mesh,
                    plan: PlanArtifact | None = None,
                    block_layout: str = "canonical",
                    keep_prev: bool = False) -> Path:
    """Write this rank's state (every rank of the process group calls it;
    None on a rank outside the plan) and, from rank 0, the meta and
    ``plan``, under ``directory``, through the crash-safe swap.  ``mesh``:
    what the meta records (the plan artifact, or an ``(axes, shape)``
    pair).  Synchronous."""
    return _save(directory, _snapshot(state),
                 _meta_fields(state, mesh, block_layout), plan, keep_prev)


def _meta_fields(state: TrainState | None, mesh, block_layout: str) -> dict:
    """The meta's fields besides the digests (rank 0's state's step)."""
    axes, shape = _mesh_axes_shape(mesh)
    return dict(step=None if state is None else int(state.step),
                mesh_axes=axes, mesh_shape=shape, block_layout=block_layout)


class AsyncCheckpointWriter:
    """Checkpoint writes overlapped with training.

    ``save`` copies this rank's state to host memory on the calling thread
    (the state may change as soon as it returns) and writes the copy from
    a background thread.  The swap of ``save_checkpoint`` is deferred to
    ``wait()``, or the start of the next ``save``: there the ranks gather
    their digests and their outcomes, rank 0 writes the meta, and the
    write is swapped in.  A failed write re-raises on every rank as
    ``CheckpointWriteError`` naming the checkpoint and the rank, and leaves
    the previous checkpoint the primary.  Every rank calls ``save``,
    ``wait`` and ``close`` at the same points (they hold collectives).

    Usage::

        with AsyncCheckpointWriter() as writer:
            for step in ...:
                state, loss = train_step(state, ...)
                if step % interval == 0:
                    writer.save(ckpt_dir, state, artifact, plan)
    """

    def __init__(self, keep_prev: bool = False):
        self._pending = None
        self._keep_prev = keep_prev

    def save(self, directory: str | Path, state: TrainState | None, mesh,
             plan: PlanArtifact | None = None,
             block_layout: str = "canonical") -> None:
        self.wait()  # finish and swap any previous write first
        directory = Path(directory).absolute()
        tmp, prev = _prepare_tmp(directory)
        snap = _snapshot(state)
        rank, world = _world()[0], _writers(snap)
        box: dict = {}

        def write():
            try:
                box["digests"] = _write_rank(tmp, snap, rank, world)
            except Exception as e:  # noqa: BLE001 — re-raised by wait()
                box["error"] = f"{type(e).__name__}: {e}"

        thread = threading.Thread(target=write, name="metis-checkpoint",
                                  daemon=True)
        thread.start()
        self._pending = (directory, tmp, prev, thread, box, plan,
                         _meta_fields(state, mesh, block_layout))

    def wait(self) -> None:
        """Block until the in-flight write (if any) is on disk on every
        rank and swapped into place as the primary checkpoint."""
        if self._pending is None:
            return
        directory, tmp, prev, thread, box, plan, meta_fields = self._pending
        self._pending = None
        thread.join()
        results = _gather((box.get("error"), box.get("digests", {})))
        _raise_failed(directory, results, "async ")
        _finish(directory, tmp, prev, _merged([d for _, d in results]),
                meta_fields, plan, self._keep_prev)

    def close(self) -> None:
        """Flush and swap the in-flight write; a failure is surfaced, never
        swallowed."""
        self.wait()

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is not None:
            # the body is already unwinding: a secondary flush failure must
            # not mask its error
            try:
                self.close()
            except Exception:  # noqa: BLE001
                pass
        else:
            self.close()


# -- restore --------------------------------------------------------------------

def _resolve_dir(directory: str | Path) -> Path:
    """The primary checkpoint dir, or its ``.prev`` backup if a crash
    interrupted the last save mid-swap."""
    directory = Path(directory).absolute()
    if directory.exists():
        return directory
    prev = directory.with_name(directory.name + ".prev")
    if prev.exists():
        return prev
    return directory


def load_meta(directory: str | Path) -> CheckpointMeta:
    return CheckpointMeta.from_json(
        (_resolve_dir(directory) / _META_FILE).read_text())


def load_plan(directory: str | Path) -> PlanArtifact | None:
    p = _resolve_dir(directory) / _PLAN_FILE
    return PlanArtifact.from_json(p.read_text()) if p.exists() else None


def _load_meta_if_present(directory: Path) -> CheckpointMeta | None:
    p = directory / _META_FILE
    if not p.exists():
        return None
    try:
        return CheckpointMeta.from_json(p.read_text())
    except Exception as e:
        raise CheckpointCorruptError(
            f"checkpoint {directory} has an unreadable {_META_FILE}: "
            f"{type(e).__name__}: {e}") from e


def _check_scope(directory: Path, meta: CheckpointMeta | None, mesh,
                 world: int) -> None:
    """Refuse a checkpoint of another mesh or world size (``world``: the
    ranks that hold a state) where no slice map says how to reshard it
    (module doc)."""
    files = sorted((directory / _STATE_DIR).glob("rank*.pt"))
    want = None if mesh is None else _mesh_axes_shape(mesh)
    got = None if meta is None else (meta.mesh_axes, meta.mesh_shape)
    if len(files) != world or (want is not None and got is not None
                               and got != want):
        raise MetisError(
            f"checkpoint {directory} was written by {len(files)} rank(s) on "
            f"mesh {got}; this run has {world} rank(s) on mesh {want}, and "
            "the checkpoint or the state has no slice map (a checkpoint that "
            "predates the slice map restores onto its own plan only)")


def _load_snap(path: Path, mmap: bool = False) -> dict:
    try:
        return torch.load(path, map_location="cpu", weights_only=True,
                          mmap=mmap)
    except Exception as e:
        raise CheckpointCorruptError(
            f"checkpoint {path.parent.parent} is unreadable: "
            f"{type(e).__name__}: {e}") from e


def _verify_snap(directory: Path, meta: CheckpointMeta | None, snap: dict,
                 rank: int, world: int) -> None:
    if meta is not None and meta.digests:
        actual = tree_digests(_digest_tree(snap), _rank_prefix(rank, world))
        bad = sorted(k for k, v in actual.items() if meta.digests.get(k) != v)
        if bad:
            shown = ", ".join(bad[:3]) + ("..." if len(bad) > 3 else "")
            raise CheckpointCorruptError(
                f"checkpoint {directory}: content digest mismatch for "
                f"{len(bad)} leaf/leaves ({shown}) — the checkpoint on disk "
                "is corrupt")


def _restore_verified(directory: Path, mesh, world: int | None = None) -> dict:
    """This rank's snapshot from ``directory``, verified against the
    digests its meta recorded (the restore onto the same plan, held by
    the first ``world`` ranks; None: the whole process group).  ``FileNotFoundError`` when the directory
    holds no checkpoint; ``CheckpointCorruptError`` for anything unreadable
    or a digest that disagrees."""
    if not (directory / _STATE_DIR).exists():
        raise FileNotFoundError(f"no checkpoint state at {directory / _STATE_DIR}")
    meta = _load_meta_if_present(directory)
    rank, group = _world()
    world = group if world is None else world
    _check_scope(directory, meta, mesh, world)
    snap = _load_snap(_rank_file(directory, rank))
    _verify_snap(directory, meta, snap, rank, world)
    return snap


def _restore_candidates(directory: str | Path) -> list[Path]:
    """Generations to try, newest first: the resolved primary, then the
    retained ``.prev`` (when it exists and is not the primary already)."""
    directory = Path(directory).absolute()
    primary = _resolve_dir(directory)
    prev = directory.with_name(directory.name + ".prev")
    out = [primary]
    if prev.exists() and prev != primary:
        out.append(prev)
    return out


def _with_fallback(directory: str | Path, restore):
    """``restore(generation)`` of the newest generation that every rank
    reads without corruption: if the newest is corrupt on any rank (an
    unreadable file or a digest mismatch) and a ``.prev`` generation is
    retained, every rank restores that instead.  Only when every
    generation fails does an error propagate; a missing checkpoint stays
    ``FileNotFoundError``, but corruption anywhere wins over a missing
    fallback."""
    errors: list[Exception] = []
    for cand in _restore_candidates(directory):
        out, err = None, None
        try:
            out = restore(cand)
        except (CheckpointCorruptError, FileNotFoundError) as e:
            err = e
        if not any(_gather(err is not None)):
            return out
        errors.append(err or CheckpointCorruptError(
            f"checkpoint {cand} is corrupt on another rank"))
    for e in errors:
        if isinstance(e, CheckpointCorruptError):
            raise e
    raise errors[0]


def block_layouts_compatible(meta: CheckpointMeta, expected: str) -> bool:
    """Whether a checkpoint's recorded block layout matches ``expected``.

    Handles the legacy "interleaved:<vs>" format (before pp was encoded in
    the string): it is accepted iff the vs matches AND the checkpoint's own
    recorded mesh pp extent equals the expected pp — the permutation
    depends on both, so a same-vs checkpoint from a different pp must still
    be refused."""
    if meta.block_layout == expected:
        return True
    if (meta.block_layout.startswith("interleaved:")
            and "x" not in meta.block_layout
            and expected.startswith("interleaved:")
            and "x" in expected):
        exp_pp, _, exp_vs = expected[len("interleaved:"):].partition("x")
        legacy_vs = meta.block_layout[len("interleaved:"):]
        try:
            meta_pp = meta.mesh_shape[meta.mesh_axes.index("pp")]
        except ValueError:
            meta_pp = 1
        return legacy_vs == exp_vs and str(meta_pp) == exp_pp
    return False


# -- restore onto another plan -------------------------------------------------

#: the AdamW moments of a leaf, as ``torch.optim.AdamW`` names them
MOMENTS = ("exp_avg", "exp_avg_sq")


def _family(kind: str) -> str:
    """The state family of an executable kind: one device is a gspmd
    plan of one rank."""
    return "gspmd" if kind == "single_device" else kind


def _key_parts(key: str) -> tuple[str, str]:
    group, name = key.split("/")
    return group, name


def _schema(layouts) -> dict:
    """``{leaf: (shape, dtype)}`` over the ranks' slice maps."""
    out = {}
    for lay in layouts:
        if lay is not None:
            for key, e in lay["leaves"].items():
                out[key] = (tuple(e["shape"]), e["dtype"])
    return out


def _rows(e: dict):
    """The one-device rows along dim 0 that an entry's tensor holds."""
    if e["ids"] is not None:
        return list(e["ids"])
    return range(*e["box"][0])


def extent(e: dict) -> tuple[int, ...]:
    """The shape of the tensor a slice-map entry describes (its box; the
    moments of a ``flat`` entry are the flattened box's ``flat`` part)."""
    ext = [b - a for a, b in e["box"]]
    if e["ids"] is not None:
        ext[0] = len(e["ids"])
    return tuple(ext)


def overlap(dst: dict, src: dict):
    """``(dst index, src index, elements)`` of the part of the one-device
    leaf that both entries' boxes hold (indices into their tensors), or
    None.  Dim 0 may be a block id list; flat parts are not read."""
    if not dst["box"]:
        return (), (), 1
    d0, s0 = _rows(dst), _rows(src)
    if isinstance(d0, range) and isinstance(s0, range):
        lo, hi = max(d0.start, s0.start), min(d0.stop, s0.stop)
        if lo >= hi:
            return None
        di, si, n = [slice(lo - d0.start, hi - d0.start)], [slice(lo - s0.start, hi - s0.start)], hi - lo
    else:
        pos = {g: i for i, g in enumerate(s0)}
        pairs = [(i, pos[g]) for i, g in enumerate(d0) if g in pos]
        if not pairs:
            return None
        di, si, n = [_index([a for a, _ in pairs])], [_index([b for _, b in pairs])], len(pairs)
    for (a, b), (c, d) in zip(dst["box"][1:], src["box"][1:]):
        lo, hi = max(a, c), min(b, d)
        if lo >= hi:
            return None
        di.append(slice(lo - a, hi - a))
        si.append(slice(lo - c, hi - c))
        n *= hi - lo
    return tuple(di), tuple(si), n


def _index(idx: list[int]):
    """A slice where ``idx`` is a run, else an index tensor."""
    if idx == list(range(idx[0], idx[0] + len(idx))):
        return slice(idx[0], idx[0] + len(idx))
    return torch.tensor(idx, dtype=torch.long)


def _whole(pieces: list) -> list:
    """``(entry, tensor)`` pieces with every flat chunk of one box joined
    into the box's tensor (``flat`` entries are the ZeRO 1 and 2 moments'
    chunks of the ranks of one dp group)."""
    out, chunks = [], {}
    for e, t in pieces:
        if e.get("flat") is None:
            out.append((e, t))
        else:
            key = (None if e["ids"] is None else tuple(e["ids"]),
                   tuple(map(tuple, e["box"])))
            chunks.setdefault(key, (e, []))[1].append((e["flat"][0], t))
    for e, parts in chunks.values():
        parts.sort(key=lambda p: p[0])
        flat = torch.cat([t.reshape(-1) for _, t in parts])
        if flat.numel() != math.prod(extent(e)):
            raise MetisError(f"the flat chunks of a {extent(e)} box cover "
                             f"{flat.numel()} elements")
        out.append(({**e, "flat": None}, flat.reshape(extent(e))))
    return out


def assemble(dst: dict, pieces: list, dtype: torch.dtype,
             device="cpu") -> torch.Tensor:
    """The tensor a slice-map entry ``dst`` describes, filled from
    ``pieces``: ``(entry, tensor)`` of disjoint parts of the same one-device
    leaf (flat chunks joined first).  Raises ``MetisError`` unless they
    cover all of it."""
    out = torch.empty(extent(dst), dtype=dtype, device=device)
    filled = 0
    for e, t in _whole([(e, t.to(device)) for e, t in pieces]):
        ov = overlap(dst, e)
        if ov is not None:
            out[ov[0]] = t[ov[1]]
            filled += ov[2]
    if filled != out.numel():
        raise MetisError(f"the pieces cover {filled} of the {out.numel()} "
                         f"elements of a {tuple(out.shape)} slice")
    if dst.get("flat") is not None:
        out = out.reshape(-1)[dst["flat"][0]:dst["flat"][1]]
    return out


def owners(layouts, key: str, moment: bool) -> list[tuple[int, dict]]:
    """``(rank, entry)`` of the distinct pieces of leaf ``key`` that the
    ranks' slice maps hold, each read from the lowest rank holding it
    (dp replicas, leaves kept whole over tp).  ``moment``: the AdamW
    moments' pieces (flat chunks at ZeRO 1 and 2); else the parameter's."""
    seen, out = set(), []
    for r, lay in enumerate(layouts):
        e = lay["leaves"].get(key) if lay is not None else None
        if e is None:
            continue
        e = e if moment else {**e, "flat": None}
        sig = (None if e["ids"] is None else tuple(e["ids"]),
               tuple(map(tuple, e["box"])),
               None if e["flat"] is None else tuple(e["flat"]))
        if sig not in seen:
            seen.add(sig)
            out.append((r, e))
    return out


def full_entry(shape) -> dict:
    """The slice-map entry of a whole one-device leaf."""
    return {"shape": list(shape), "ids": None,
            "box": [[0, int(n)] for n in shape], "flat": None}


class _Generation:
    """A checkpoint generation's rank files, read lazily (``torch.load``
    with ``mmap``), each tensor verified against its digest the first time
    it is read."""

    def __init__(self, directory: Path):
        if not (directory / _STATE_DIR).exists():
            raise FileNotFoundError(f"no checkpoint state at {directory / _STATE_DIR}")
        self.directory = directory
        self.meta = _load_meta_if_present(directory)
        files = sorted((directory / _STATE_DIR).glob("rank*.pt"))
        self.snaps = [_load_snap(f, mmap=True) for f in files]
        self.world = len(files)
        self.layouts = [snap.get("layout") for snap in self.snaps]
        self.bytes_read = 0
        self._verified: set = set()

    def _read(self, r: int, path: str, t: torch.Tensor) -> torch.Tensor:
        key = _rank_prefix(r, self.world)
        if "stage" in self.snaps[r]:
            key += f"['stages'][{self.snaps[r]['stage']}]"
        key += path
        if key not in self._verified:
            if self.meta is not None and self.meta.digests:
                want = self.meta.digests.get(key)
                if want is None:
                    raise CheckpointCorruptError(
                        f"checkpoint {self.directory}: its meta records no "
                        f"digest for {key} — the checkpoint on disk is corrupt")
                if leaf_digest(t) != want:
                    raise CheckpointCorruptError(
                        f"checkpoint {self.directory}: content digest mismatch "
                        f"for {key} — the checkpoint on disk is corrupt")
            self._verified.add(key)
            self.bytes_read += t.numel() * t.element_size()
        return t

    def param(self, r: int, key: str) -> torch.Tensor:
        g, n = _key_parts(key)
        return self._read(r, f"['params']['{g}']['{n}']",
                          self.snaps[r]["params"][g][n])

    def opt(self, r: int, key: str) -> dict | None:
        """Rank ``r``'s AdamW state of leaf ``key`` (``step``, ``exp_avg``,
        ``exp_avg_sq``), None before the first step."""
        i = self.layouts[r]["opt"].index(key)
        st = self.snaps[r]["optimizer"]["state"].get(i)
        if st is None:
            return None
        return {k: self._read(r, f"['opt_state'][{i}]['{k}']", v)
                for k, v in st.items()}

    def leaf(self, key: str, dst: dict, what: str, dtype) -> torch.Tensor | None:
        """The ``dst`` part of leaf ``key``'s parameter (``what`` "param")
        or of one of its moments ("exp_avg", "exp_avg_sq"); None for a
        moment before the first step."""
        pieces = []
        for r, e in owners(self.layouts, key, what != "param"):
            if what == "param":
                pieces.append((e, self.param(r, key)))
                continue
            st = self.opt(r, key)
            if st is None:
                return None
            pieces.append((e, st[what]))
        return assemble(dst, pieces, dtype)

    def opt_step(self, key: str):
        r, _ = owners(self.layouts, key, True)[0]
        st = self.opt(r, key)
        return None if st is None else st["step"]


def logical_path(key: str, what: str = "param") -> str:
    """The digest path of a one-device leaf: ``['params'][g][n]``, or of
    its AdamW state ``['opt_state'][g][n][what]`` (``what`` a moment or
    ``"step"``)."""
    g, n = _key_parts(key)
    if what == "param":
        return f"['params']['{g}']['{n}']"
    return f"['opt_state']['{g}']['{n}']['{what}']"


def logical_digests(directory: str | Path) -> dict[str, str]:
    """``leaf_digest`` of every leaf of the one-device state a checkpoint
    holds, assembled leaf by leaf through its slice maps (the reference's
    formula; paths ``logical_path``'s and ``['step']``): what any plan
    restored from it holds, whatever plan wrote it."""
    gen = _Generation(_resolve_dir(directory))
    if any(lay is None for lay in gen.layouts):
        raise MetisError(f"checkpoint {directory} predates the slice map")
    out = {}
    for key, (shape, dtype) in _schema(gen.layouts).items():
        whole = full_entry(shape)
        out[logical_path(key)] = leaf_digest(
            gen.leaf(key, whole, "param", getattr(torch, dtype)))
        for m in MOMENTS:
            t = gen.leaf(key, whole, m, getattr(torch, dtype))
            if t is not None:
                out[logical_path(key, m)] = leaf_digest(t)
        step = gen.opt_step(key)
        if step is not None:
            out[logical_path(key, "step")] = leaf_digest(step)
    out["['step']"] = leaf_digest(np.asarray(int(gen.snaps[0]["step"]), np.int32))
    return out


def _check_restorable(gen: _Generation, dsts: list) -> None:
    """Refuse, before any state is touched, what the reference refuses to
    restore: another route's state (hetero against the others), another
    stage partition, another block layout, another state schema."""
    src = gen.layouts[0]
    dst = next(d for d in dsts if d is not None)
    fs, fd = _family(src["kind"]), _family(dst["kind"])
    where = f"checkpoint {gen.directory}"
    if fs != fd and "hetero" in (fs, fd):
        raise MetisError(
            f"{where} holds {src['kind']} state; the {dst['kind']} plan's state "
            "has another structure (per-stage state against one tree), which "
            "the reference does not restore across either")
    if fs == "hetero" and src["stages"] != dst["stages"]:
        raise MetisError(
            f"{where} holds the stages {src['stages']} (block ranges); the "
            f"plan has {dst['stages']}: another stage partition")
    if fs != "hetero" and not block_layouts_compatible(gen.meta, dst["block_layout"]):
        raise MetisError(
            f"{where} was written with block layout "
            f"'{gen.meta.block_layout}', the plan uses "
            f"'{dst['block_layout']}': another block layout")
    if _schema(gen.layouts) != _schema(dsts):
        raise MetisError(
            f"{where}: the state structure does not fit the plan's (leaves, "
            "shapes or dtypes differ: another model)")


def _load_resharded(gen: _Generation, state: TrainState) -> TrainState:
    """Fill ``state`` (this rank's fresh state of another plan) from the
    generation's rank files through their slice maps, one leaf at a time:
    its parameters, its AdamW moments and their step, the step."""
    leaves = state.layout["leaves"]
    opt_state = {}
    with torch.no_grad():
        for i, ((g, n), opt_leaf) in enumerate(state.opt_leaves().items()):
            key, leaf = f"{g}/{n}", state.params[g][n]
            e = leaves[key]
            leaf.copy_(gen.leaf(key, {**e, "flat": None}, "param", leaf.dtype))
            st = {k: gen.leaf(key, e, k, opt_leaf.dtype) for k in MOMENTS}
            if st["exp_avg"] is not None:
                st["step"] = gen.opt_step(key).clone()
                opt_state[i] = st
    state.optimizer.load_state_dict(
        {"state": opt_state,
         "param_groups": state.optimizer.state_dict()["param_groups"]})
    state.step = int(gen.snaps[0]["step"])
    return state


def _load_into(state: TrainState, snap: dict) -> TrainState:
    """Copy a snapshot into ``state`` (a fresh state of the same plan on
    this rank) in place: the parameters, the optimizer's moments, the
    step."""
    with torch.no_grad():
        for g, sub in state.params.items():
            for n, leaf in sub.items():
                saved = snap["params"][g][n]
                if saved.shape != leaf.shape:
                    raise MetisError(
                        f"checkpoint leaf {g}.{n} has shape {tuple(saved.shape)}, "
                        f"this rank holds {tuple(leaf.shape)}: another plan, "
                        "and the checkpoint or the state has no slice map")
                # ZeRO 1 and 2's chunks are views of the leaves: they follow
                leaf.copy_(saved)
    opt = snap["optimizer"]
    saved_keys = snap.get("layout", {}).get("opt")
    if saved_keys is None:
        # by position: a state that orders its leaves otherwise would take
        # another leaf's moments, which the shapes catch where they differ
        for j, ((g, n), leaf) in enumerate(state.opt_leaves().items()):
            saved = opt["state"].get(j, {}).get("exp_avg")
            if saved is not None and saved.shape != leaf.shape:
                raise MetisError(
                    f"checkpoint optimizer state {j} has shape "
                    f"{tuple(saved.shape)}, this state's parameter {g}.{n} "
                    f"has {tuple(leaf.shape)}: a checkpoint without slice "
                    "maps restores into a state built as the saved one was")
    else:
        # the optimizer's state is by position: put each leaf's where this
        # state's optimizer holds the leaf (a state made from a full tree
        # orders its leaves as the tree does)
        index = {k: i for i, k in enumerate(saved_keys)}
        opt = {**opt, "state": {
            j: opt["state"][index[f"{g}/{n}"]]
            for j, (g, n) in enumerate(state.opt_leaves())
            if index[f"{g}/{n}"] in opt["state"]}}
    state.optimizer.load_state_dict(opt)
    state.step = int(snap["step"])
    return state


def _snap_bytes(snap: dict) -> int:
    return sum(t.numel() * t.element_size()
               for tree in (snap["params"], snap["optimizer"]["state"])
               for _, t in _flatten(tree) if isinstance(t, torch.Tensor))


def _restore(directory: str | Path, state: TrainState | None, mesh,
             stage: int | None, stats: dict | None) -> TrainState | None:
    """Restore into ``state`` (this rank's fresh state of the plan to
    resume on; None on a rank outside that plan, which only takes part in
    the ranks' agreement): from this rank's own file when the checkpoint
    was written by the same plan on the same ranks, or when either side
    has no slice map (``mesh``, and on the hetero route this rank's
    ``stage``, are then checked against the checkpoint's); else through
    the slice maps (module doc).  ``stats``, when given, is filled with
    ``resharded`` (read through the maps) and ``bytes_read`` (of the
    checkpoint's tensors).  Every rank of the process group calls it."""
    stats = {} if stats is None else stats
    held = _gather((state is not None, state.layout if state is not None else None))
    dsts = [d for _, d in held]
    # the ranks of the plan to resume on: the process group's first ones
    world = sum(h for h, _ in held)

    def restore(cand: Path):
        gen = _Generation(cand)
        no_maps = (any(s is None for s in gen.layouts)
                   or all(d is None for d in dsts))
        same = (not no_maps and gen.world == world
                and all(d is not None and {**s, "opt": None} == {**d, "opt": None}
                        for s, d in zip(gen.layouts, dsts)))
        if same and state is None:
            return None
        if same or (no_maps and state is not None):
            snap = _restore_verified(cand, mesh, world)
            if snap.get("stage") != stage:
                raise MetisError(
                    f"checkpoint {cand}: this rank's file holds stage "
                    f"{snap.get('stage')}, the rank runs stage {stage} (None: "
                    "not the hetero route, whose checkpoints "
                    "restore_hetero_checkpoint restores)")
            stats.update(resharded=False, bytes_read=_snap_bytes(snap))
            return _load_into(state, snap)
        if no_maps:
            raise MetisError(
                f"checkpoint {cand} predates the slice map, or the plan's "
                "state has none: it restores onto the plan that wrote it only")
        _check_restorable(gen, dsts)
        if state is None:
            return None
        out = _load_resharded(gen, state)
        stats.update(resharded=True, bytes_read=gen.bytes_read)
        return out

    return _with_fallback(directory, restore)


def restore_checkpoint(directory: str | Path, reference_state: TrainState | None,
                       expected_block_layout: str | None = None,
                       mesh=None, stats: dict | None = None) -> TrainState | None:
    """Restore this rank's state into ``reference_state`` (a fresh state,
    ``Executable.init``, of the plan that wrote the checkpoint or of
    another one; None on a rank outside the plan), in place, and return
    it.  ``expected_block_layout``: refuse a checkpoint whose recorded
    layout differs.  ``mesh`` (the plan artifact, or an ``(axes, shape)``
    pair): refuse a checkpoint written on another mesh when the slice maps
    cannot reshard it.  ``stats``: filled as ``_restore`` says.
    Digest-verified, with the ``.prev`` fallback."""
    if expected_block_layout is not None:
        meta = load_meta(directory)
        if not block_layouts_compatible(meta, expected_block_layout):
            raise ValueError(
                f"checkpoint {directory} was written with block layout "
                f"'{meta.block_layout}', expected '{expected_block_layout}' "
                "— refusing to restore (a layout mismatch silently "
                "scrambles the stacked block axis)")
    return _restore(directory, reference_state, mesh, None, stats)


# -- hetero (per-stage) checkpoints ----------------------------------------------

def save_hetero_checkpoint(directory: str | Path, state: TrainState | None,
                           step: int, mesh, plan: PlanArtifact | None = None,
                           keep_prev: bool = False) -> Path:
    """Checkpoint the hetero executor's state: every rank writes its
    stage's state (``mesh``: the rank's ``ProcessMesh``, whose ``pp`` axis
    is the stage; both None on a rank outside the plan); the meta records the stage count in place of a mesh
    shape, as the reference's.  Synchronous, the same swap as
    ``save_checkpoint``."""
    if state is None:  # a rank outside the plan
        return _save(directory, None, {}, plan, keep_prev)
    stages, stage = mesh.size("pp"), mesh.index("pp")
    return _save(directory, _snapshot(state, step, stage),
                 dict(step=int(step), mesh_axes=("stage",),
                      mesh_shape=(stages,)), plan, keep_prev)


def restore_hetero_checkpoint(directory: str | Path,
                              reference_state: TrainState | None,
                              mesh, stats: dict | None = None) -> TrainState | None:
    """Restore this rank's stage state into ``reference_state`` (a fresh
    state of the hetero plan that wrote the checkpoint, or of one with the
    same stages and layer partition; None on a rank outside the plan), in
    place.  ``mesh``: the rank's ``ProcessMesh``; ``stats`` as
    ``restore_checkpoint``'s.  Digest-verified, with the ``.prev``
    fallback."""
    if reference_state is None:
        return _restore(directory, None, None, None, stats)
    return _restore(directory, reference_state,
                    (("stage",), (mesh.size("pp"),)), mesh.index("pp"), stats)
