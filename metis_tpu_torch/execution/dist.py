"""Process launcher for multi-device plans.

The reference is one program over a device mesh; the port runs one process
per device.  ``spawn(fn, world, backend, devices, *args)`` starts ``world``
processes (``torch.multiprocessing``, start method ``spawn``, so a parent
that has already initialized CUDA can launch), joins them into one process
group through a file store in a fresh temporary directory (concurrent
launches never race for a port), runs ``fn(rank, device, *args)`` on
rank ``r`` with ``device = devices[r]`` (its current device), and returns
the ranks' results in rank order.  Results cross back by pickle, so a body
returns host data (numbers, numpy arrays), not CUDA tensors.  A rank that
raises fails the launch with its traceback; the other ranks are terminated
rather than left waiting in a collective.

Backends: ``nccl`` needs one distinct card per rank and is the default on
CUDA; ``gloo`` is the default on the CPU.  Gloo on CUDA tensors (several
ranks sharing one card; gloo reduces through the host) runs only when the
caller asks for it.  ``fn`` must be importable (a module-level function of
the package): the children start from a fresh interpreter.
"""
from __future__ import annotations

import datetime
import pickle
import tempfile
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
    other launch uses; the file must not exist before the first rank).
    NCCL binds the group to this rank's ``device``."""
    extra = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"file://{store_path}",
                            rank=rank, world_size=world, timeout=TIMEOUT,
                            **extra)


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
    results."""
    devs = _check_launch(world, backend, devices)
    with tempfile.TemporaryDirectory(prefix="metis_dist_") as tmp:
        work = Path(tmp)
        mp.start_processes(
            _rank_main, args=(fn, world, backend, devs, str(work), args),
            nprocs=world, join=True, start_method="spawn")
        return [pickle.loads((work / f"result_{r}.pkl").read_bytes())
                for r in range(world)]


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               devices: list, work: str, args: tuple) -> None:
    dev = devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # ranks share the host's cores; one intra-op thread each
        torch.set_num_threads(1)
    init_process_group(backend, rank, world, Path(work) / "store", dev)
    try:
        result = fn(rank, dev, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    # written only by this package's ranks and read only by their parent
    (Path(work) / f"result_{rank}.pkl").write_bytes(pickle.dumps(result))
