"""Checkpoint / resume of training state and plan artifacts — the port of
``metis_tpu/execution/checkpoint.py``, without orbax (the card machine has
neither JAX nor orbax): every rank writes its own state with ``torch.save``.

What a checkpoint directory of the port holds:

- ``state/rank{r:05d}.pt``: rank ``r``'s own state, ``torch.save`` of CPU
  tensors, read back with ``weights_only=True``: its parameters (at ZeRO 3
  its shards), its optimizer's ``state_dict`` (the AdamW moments; at ZeRO 1
  and 2 those of its flat chunks) and the step.  On the hetero route it is
  the rank's stage's state.
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

**Restore scope.** A checkpoint restores onto the same plan on the same
world size: each rank reads its own file.  Another mesh or world size
raises ``MetisError``; resharding on read, which the reference gets from
orbax, is ROADMAP §A.4's work.

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


def _snapshot(state: TrainState, step: int | None = None,
              stage: int | None = None) -> dict:
    """What a rank writes (module doc), copied to host memory: ``params``,
    ``optimizer`` (its ``state_dict``), ``step``, and on the hetero route
    the rank's ``stage``."""
    snap = {"params": _host(state.params),
            "optimizer": _host(state.optimizer.state_dict()),
            "step": int(state.step if step is None else step)}
    if stage is not None:
        snap["stage"] = stage
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


def _write_rank(tmp: Path, snap: dict, rank: int, world: int) -> dict:
    """Write one rank's snapshot into ``tmp``, hashing it meanwhile; its
    digests."""
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


def _save(directory, snap: dict, meta_fields: dict, plan, keep_prev) -> Path:
    directory = Path(directory).absolute()
    tmp, prev = _prepare_tmp(directory)
    rank, world = _world()
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


def save_checkpoint(directory: str | Path, state: TrainState, mesh,
                    plan: PlanArtifact | None = None,
                    block_layout: str = "canonical",
                    keep_prev: bool = False) -> Path:
    """Write this rank's state (every rank of the process group calls it)
    and, from rank 0, the meta and ``plan``, under ``directory``, through
    the crash-safe swap.  ``mesh``: what the meta records (the plan
    artifact, or an ``(axes, shape)`` pair).  Synchronous."""
    axes, shape = _mesh_axes_shape(mesh)
    return _save(directory, _snapshot(state),
                 dict(step=int(state.step), mesh_axes=axes, mesh_shape=shape,
                      block_layout=block_layout), plan, keep_prev)


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

    def save(self, directory: str | Path, state: TrainState, mesh,
             plan: PlanArtifact | None = None,
             block_layout: str = "canonical") -> None:
        self.wait()  # finish and swap any previous write first
        directory = Path(directory).absolute()
        tmp, prev = _prepare_tmp(directory)
        snap = _snapshot(state)
        rank, world = _world()
        box: dict = {}

        def write():
            try:
                box["digests"] = _write_rank(tmp, snap, rank, world)
            except Exception as e:  # noqa: BLE001 — re-raised by wait()
                box["error"] = f"{type(e).__name__}: {e}"

        thread = threading.Thread(target=write, name="metis-checkpoint",
                                  daemon=True)
        thread.start()
        axes, shape = _mesh_axes_shape(mesh)
        self._pending = (directory, tmp, prev, thread, box, plan, dict(
            step=int(state.step), mesh_axes=axes, mesh_shape=shape,
            block_layout=block_layout))

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


def _check_scope(directory: Path, meta: CheckpointMeta | None, mesh) -> None:
    """Refuse a checkpoint of another mesh or world size (module doc)."""
    _, world = _world()
    files = sorted((directory / _STATE_DIR).glob("rank*.pt"))
    want = None if mesh is None else _mesh_axes_shape(mesh)
    got = None if meta is None else (meta.mesh_axes, meta.mesh_shape)
    if len(files) != world or (want is not None and got is not None
                               and got != want):
        raise MetisError(
            f"checkpoint {directory} was written by {len(files)} rank(s) on "
            f"mesh {got}; this run has {world} rank(s) on mesh {want}.  The "
            "port restores onto the same plan only; resharding onto another "
            "mesh is ROADMAP §A.4")


def _restore_verified(directory: Path, mesh) -> dict:
    """This rank's snapshot from ``directory``, verified against the
    digests its meta recorded.  ``FileNotFoundError`` when the directory
    holds no checkpoint; ``CheckpointCorruptError`` for anything
    unreadable or a digest that disagrees."""
    if not (directory / _STATE_DIR).exists():
        raise FileNotFoundError(f"no checkpoint state at {directory / _STATE_DIR}")
    meta = _load_meta_if_present(directory)
    _check_scope(directory, meta, mesh)
    rank, world = _world()
    try:
        snap = torch.load(_rank_file(directory, rank), map_location="cpu",
                          weights_only=True)
    except Exception as e:
        raise CheckpointCorruptError(
            f"checkpoint {directory} is unreadable: {type(e).__name__}: {e}") from e
    if meta is not None and meta.digests:
        actual = tree_digests(_digest_tree(snap), _rank_prefix(rank, world))
        bad = sorted(k for k, v in actual.items() if meta.digests.get(k) != v)
        if bad:
            shown = ", ".join(bad[:3]) + ("..." if len(bad) > 3 else "")
            raise CheckpointCorruptError(
                f"checkpoint {directory}: content digest mismatch for "
                f"{len(bad)} leaf/leaves ({shown}) — the checkpoint on disk "
                "is corrupt")
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


def _restore_with_fallback(directory: str | Path, mesh) -> dict:
    """Digest-verified restore with fallback: if the newest generation is
    corrupt on any rank (an unreadable file or a digest mismatch) and a
    ``.prev`` generation is retained, every rank restores that instead.
    Only when every generation fails does an error propagate; a missing
    checkpoint stays ``FileNotFoundError``, but corruption anywhere wins
    over a missing fallback."""
    errors: list[Exception] = []
    for cand in _restore_candidates(directory):
        snap, err = None, None
        try:
            snap = _restore_verified(cand, mesh)
        except (CheckpointCorruptError, FileNotFoundError) as e:
            err = e
        if not any(_gather(err is not None)):
            return snap
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
                        f"this rank holds {tuple(leaf.shape)}: another plan "
                        "(resharding is ROADMAP §A.4)")
                # ZeRO 1 and 2's chunks are views of the leaves: they follow
                leaf.copy_(saved)
    state.optimizer.load_state_dict(snap["optimizer"])
    state.step = int(snap["step"])
    return state


def restore_checkpoint(directory: str | Path, reference_state: TrainState,
                       expected_block_layout: str | None = None,
                       mesh=None) -> TrainState:
    """Restore this rank's state into ``reference_state`` (a fresh state of
    the same plan, ``Executable.init``), in place, and return it.
    ``expected_block_layout``: refuse a checkpoint whose recorded layout
    differs.  ``mesh`` (the plan artifact, or an ``(axes, shape)`` pair):
    refuse a checkpoint written on another mesh.  Digest-verified, with
    the ``.prev`` fallback."""
    if expected_block_layout is not None:
        meta = load_meta(directory)
        if not block_layouts_compatible(meta, expected_block_layout):
            raise ValueError(
                f"checkpoint {directory} was written with block layout "
                f"'{meta.block_layout}', expected '{expected_block_layout}' "
                "— refusing to restore (a layout mismatch silently "
                "scrambles the stacked block axis)")
    snap = _restore_with_fallback(directory, mesh)
    if "stage" in snap:
        raise MetisError(f"checkpoint {directory} holds hetero stage state; "
                         "use restore_hetero_checkpoint")
    return _load_into(reference_state, snap)


# -- hetero (per-stage) checkpoints ----------------------------------------------

def save_hetero_checkpoint(directory: str | Path, state: TrainState, step: int,
                           mesh, plan: PlanArtifact | None = None,
                           keep_prev: bool = False) -> Path:
    """Checkpoint the hetero executor's state: every rank writes its
    stage's state (``mesh``: the rank's ``ProcessMesh``, whose ``pp`` axis
    is the stage); the meta records the stage count in place of a mesh
    shape, as the reference's.  Synchronous, the same swap as
    ``save_checkpoint``."""
    stages, stage = mesh.size("pp"), mesh.index("pp")
    return _save(directory, _snapshot(state, step, stage),
                 dict(step=int(step), mesh_axes=("stage",),
                      mesh_shape=(stages,)), plan, keep_prev)


def restore_hetero_checkpoint(directory: str | Path,
                              reference_state: TrainState,
                              mesh) -> TrainState:
    """Restore this rank's stage state into ``reference_state`` (a fresh
    state of the same plan), in place.  Digest-verified, with the
    ``.prev`` fallback."""
    snap = _restore_with_fallback(directory, (("stage",), (mesh.size("pp"),)))
    if snap.get("stage") != mesh.index("pp"):
        raise MetisError(
            f"checkpoint {directory}: this rank's file holds stage "
            f"{snap.get('stage')}, the rank runs stage {mesh.index('pp')} "
            "(another plan; resharding is ROADMAP §A.4)")
    return _load_into(reference_state, snap)
