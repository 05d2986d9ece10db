"""Process launcher for multi-device plans.

The reference is one program over a device mesh; the port runs one process
per device.  ``RankPool(world, backend, devices)`` starts ``world``
processes (``torch.multiprocessing``, start method ``spawn``, so a parent
that has already initialized CUDA can launch) and joins them into one
process group through a file store in a fresh temporary directory
(concurrent launches never race for a port).  It keeps them for several
jobs: ``run(fn, *args)`` runs ``fn(rank, device, *args)`` on rank ``r``
with ``device = devices[r]`` (its current device) and returns the ranks'
results in rank order, without paying each launch's process start-up,
CUDA context and group join again.  ``spawn(fn, world, backend, devices,
*args)`` is one job of a pool of its own.  Results cross back by pickle,
so a body returns host data (numbers, numpy arrays), not CUDA tensors.
Each job starts from the state a fresh rank has (the default generator's
seed, the kernels' launch counts at 0) and ends with the rank's cached
card memory freed and its peak statistics reset.  A job that raises on any
rank stops the pool and raises in the caller with that rank's traceback;
the other ranks are terminated rather than left waiting in a collective.

Several launchers can join one process group: ``RankPool(local, backend,
devices, init_method="tcp://HOST:PORT", first_rank=I * local,
world_size=W)`` starts this process's ``local`` ranks as global ranks
``first_rank .. first_rank + local - 1`` of a group of ``W`` that meets at
the TCP store global rank 0 serves (``execution/multihost.py``: one
launcher per host).  Its jobs then run on every launcher's pool at once,
and each pool returns its own ranks' results; ``fn`` gets the global rank.

Backends: ``nccl`` needs one distinct card per rank and is the default on
CUDA; ``gloo`` is the default on the CPU.  Gloo on CUDA tensors (several
ranks sharing one card; gloo reduces through the host) runs only when the
caller asks for it.  ``fn`` must be importable (a module-level function of
the package): the children start from a fresh interpreter.
"""
from __future__ import annotations

import datetime
import gc
import pickle
import tempfile
import threading
import traceback
from multiprocessing.connection import wait
from pathlib import Path
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from metis_tpu_torch.core.device import resolve_device
from metis_tpu_torch.core.errors import MetisError

BACKENDS = ("nccl", "gloo")
# a rank that waits longer than this in a collective fails instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)


def default_devices(device: str | torch.device = "cuda") -> list[torch.device]:
    """One CPU device on the host; every visible card on CUDA."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def default_backend(devices: Sequence) -> str:
    return "nccl" if torch.device(devices[0]).type == "cuda" else "gloo"


def init_process_group(backend: str, rank: int, world: int,
                       store_path: str | Path,
                       device: torch.device | None = None) -> None:
    """Join the group through the file store at ``store_path`` (a path no
    other launch uses; the file must not exist before the first rank), or
    through the TCP store a ``tcp://HOST:PORT`` names (global rank 0
    serves it).  NCCL binds the group to this rank's ``device``."""
    extra = {"device_id": device} if backend == "nccl" else {}
    store = str(store_path)
    init = store if store.startswith("tcp://") else f"file://{store}"
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world, timeout=TIMEOUT, **extra)


def _check_launch(world: int, backend: str,
                  devices: Sequence) -> list[torch.device]:
    """The launch's devices, validated: one per rank, NCCL on distinct cards."""
    if backend not in BACKENDS:
        raise MetisError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if len(devices) != world:
        raise MetisError(f"{world} ranks need {world} devices, got {len(devices)}")
    devs = [torch.device(d) for d in devices]
    if backend == "nccl":
        if any(d.type != "cuda" for d in devs):
            raise MetisError("backend 'nccl' runs on CUDA devices only")
        if len(set(devs)) < world:
            raise MetisError(
                f"backend 'nccl' needs one card per rank: {world} ranks on "
                f"{len(set(devs))} distinct card(s); pass backend='gloo' "
                "explicitly to share a card")
    for d in set(devs):
        resolve_device(d)
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise MetisError(
                f"{d} requested; this machine has {torch.cuda.device_count()} "
                "card(s)")
    return devs


def spawn(fn: Callable, world: int, backend: str, devices: Sequence,
          *args) -> list:
    """Run ``fn(rank, device, *args)`` on ``world`` ranks and return their
    results (one job of a pool of its own)."""
    with RankPool(world, backend, devices) as pool:
        return pool.run(fn, *args)


class RankPool:
    """``world`` ranks started once, in one process group, that run jobs in
    turn (module doc).  ``run`` may be called from any thread; jobs do not
    overlap.  ``close()`` (or leaving a ``with`` block) stops the ranks."""

    def __init__(self, world: int, backend: str, devices: Sequence, *,
                 init_method: str | None = None, first_rank: int = 0,
                 world_size: int | None = None):
        """``world`` ranks of this process on ``devices``; with
        ``init_method`` (``tcp://HOST:PORT``) global ranks ``first_rank
        ..`` of a group of ``world_size`` that other launchers join too
        (module doc)."""
        self.world, self.backend = world, backend
        self.devices = _check_launch(world, backend, devices)
        self.first_rank = first_rank
        self.world_size = world_size or world
        if not 0 <= first_rank <= self.world_size - world:
            raise MetisError(
                f"ranks {first_rank}..{first_rank + world - 1} do not fit a "
                f"group of {self.world_size}")
        if init_method is None and self.world_size != world:
            raise MetisError("a pool in a larger group needs its init_method")
        self.jobs = 0
        self._lock = threading.Lock()
        self._tmp = tempfile.TemporaryDirectory(prefix="metis_pool_")
        store = init_method or str(Path(self._tmp.name) / "store")
        ctx = mp.get_context("spawn")
        self._conns, self._procs = [], []
        for rank in range(world):
            mine, theirs = ctx.Pipe()
            proc = ctx.Process(target=_pool_main, name=f"metis-rank{rank}",
                               args=(rank, first_rank, self.world_size,
                                     backend, self.devices, store, theirs))
            proc.start()
            theirs.close()
            self._conns.append(mine)
            self._procs.append(proc)

    def run(self, fn: Callable, *args) -> list:
        """``fn(rank, device, *args)`` on every rank; the results in rank
        order."""
        with self._lock:
            if not self._procs:
                raise MetisError("the rank pool is closed")
            job = pickle.dumps((fn, args))
            for conn in self._conns:
                conn.send_bytes(job)
            results: dict = {}
            try:
                while len(results) < self.world:
                    waiting = {self._conns[r]: r for r in range(self.world)
                               if r not in results}
                    for conn in wait([*waiting, *(p.sentinel for p in self._procs)]):
                        if conn not in waiting:
                            continue
                        rank = waiting[conn]
                        kind, value = pickle.loads(conn.recv_bytes())
                        if kind == "error":
                            raise MetisError(
                                f"rank {self.first_rank + rank} of "
                                f"{self.world_size} failed in "
                                f"{getattr(fn, '__name__', fn)}:\n{value}")
                        results[rank] = value
                    dead = [r for r, p in enumerate(self._procs)
                            if not p.is_alive() and r not in results]
                    if dead:
                        raise MetisError(
                            f"rank {self.first_rank + dead[0]} of "
                            f"{self.world_size} died (exit code "
                            f"{self._procs[dead[0]].exitcode}) in "
                            f"{getattr(fn, '__name__', fn)}")
            except BaseException:
                self._stop(terminate=True)
                raise
            self.jobs += 1
            return [results[r] for r in range(self.world)]

    def _stop(self, terminate: bool) -> None:
        for conn in self._conns:
            try:
                if not terminate:
                    conn.send_bytes(pickle.dumps(None))
            except OSError:
                pass
        for proc in self._procs:
            if terminate:
                proc.terminate()
            proc.join(timeout=None if not terminate else 30)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []
        self._tmp.cleanup()

    def close(self) -> None:
        with self._lock:
            if self._procs:
                self._stop(terminate=False)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _fresh_job(seed: int) -> None:
    """The state a freshly spawned rank starts a job from."""
    from metis_tpu_torch.ops import flash_attention as fa

    torch.manual_seed(seed)
    fa.reset_launch_counts()


def _free(device: torch.device) -> None:
    """Drop what a job left: its objects, the card memory its caching
    allocator and cuBLAS keep, its peak statistics."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        if hasattr(torch._C, "_cuda_clearCublasWorkspaces"):
            torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _pool_main(local: int, first_rank: int, world: int, backend: str,
               devices: list, store: str, conn) -> None:
    dev = devices[local]
    rank = first_rank + local
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    seed = torch.initial_seed()
    init_process_group(backend, rank, world, store, dev)
    try:
        while True:
            try:
                job = pickle.loads(conn.recv_bytes())
            except EOFError:  # the parent is gone
                break
            if job is None:
                break
            fn, args = job
            try:
                _fresh_job(seed)
                result = fn(rank, dev, *args)
                dist.barrier()
            except BaseException:  # noqa: BLE001 — the caller raises it
                conn.send_bytes(pickle.dumps(("error", traceback.format_exc())))
                break
            finally:
                _free(dev)
            # results cross by pickle (module doc)
            conn.send_bytes(pickle.dumps(("ok", result)))
    finally:
        dist.destroy_process_group()
