"""Multi-host (multi-controller) training — the port of
``metis_tpu/execution/multihost.py``.

The reference runs one JAX process per host over a global device set
(``jax.distributed.initialize``), each feeding only the shards its own
devices hold.  The port runs one process per device, so the counterpart of
a JAX host process is a launcher that starts its host's share of the
ranks: ``N`` launchers (``train --coordinator HOST:PORT --num-processes N
--process-id I``) each start ``L = world / N`` ranks on their own devices,
as global ranks ``I * L .. I * L + L - 1`` of one process group that meets
at ``tcp://HOST:PORT`` (``execution.dist.RankPool``'s ``init_method``; the
TCP store runs in global rank 0, on launcher 0).  Every launcher runs the
same plan search and builds the same plan, so the gspmd (pp = 1) and
pipeline (pp > 1, rectangular) routes run unchanged over the global group;
the hetero route runs one controller per stage instead
(``execution/multihost2.py``).

- :func:`initialize_multihost` checks the launch and returns the
  reference's :class:`MultihostInfo` fields (this launcher's index and
  count, the global and local rank counts) with its ranks' place.
- :func:`global_batch_pipeline` is per-rank data feeding: every rank walks
  the same deterministic batch schedule of the seed
  (``data.pipeline._host_batches``) but gathers only the rows of the
  global batch its executor reads (:func:`rank_rows`); the others stay
  zero and are never read.

``python -m metis_tpu_torch.execution.multihost <proc_id> <num_procs>
<port> <mode>`` runs one launcher of the fixed workload (mode ``gspmd``,
dp 2 x tp 2, or ``pipeline``, pp 2 x dp 2 at 2 microbatches, on 4 gloo CPU
ranks over ``num_procs`` launchers); ``spawn_workers`` starts them and
returns their reports.  ``--params FILE.npz`` starts every rank from that
parameter tree (``group/name`` keys), else from seed 0.
"""
from __future__ import annotations

import json
import sys
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from metis_tpu_torch.core.errors import MetisError


@dataclass(frozen=True)
class MultihostInfo:
    """The reference's fields: this launcher's index and the launcher
    count, the ranks of the whole group and this launcher's; and where its
    ranks are: global ranks ``first_rank .. first_rank +
    local_device_count - 1`` of the group meeting at ``init_method``."""

    process_index: int
    process_count: int
    global_device_count: int
    local_device_count: int
    init_method: str = ""

    @property
    def first_rank(self) -> int:
        return self.process_index * self.local_device_count


def parse_coordinator(address: str) -> tuple[str, int]:
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise MetisError(f"bad coordinator address {address!r} (want host:port)")
    return host, int(port)


def initialize_multihost(coordinator_address: str, num_processes: int,
                         process_id: int, world: int) -> MultihostInfo:
    """This launcher's share of a ``world``-rank group over
    ``num_processes`` launchers: ``world / num_processes`` ranks each (a
    world they do not divide is refused), meeting at
    ``tcp://coordinator_address``.  Starts nothing: the launcher's
    ``RankPool`` joins the group (``execution.dist``)."""
    host, port = parse_coordinator(coordinator_address)
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise MetisError(f"process id {process_id} is not one of "
                         f"{num_processes} process(es)")
    if world % num_processes:
        raise MetisError(
            f"the plan's {world} ranks do not split over {num_processes} "
            "processes (each process starts world / num_processes ranks)")
    return MultihostInfo(process_index=process_id,
                         process_count=num_processes,
                         global_device_count=world,
                         local_device_count=world // num_processes,
                         init_method=f"tcp://{host}:{port}")


def rank_rows(artifact, rank: int) -> np.ndarray:
    """The rows of the global ``[gbs, seq]`` batch that ``rank`` of a
    rectangular ``artifact`` reads: its dp (x ep) replica's contiguous
    share of every microbatch (one microbatch at pp = 1), the layout the
    gspmd and pipeline routes slice."""
    if not artifact.mesh_shape:
        raise MetisError("per-rank feeding needs a rectangular plan (the "
                         "gspmd or pipeline route)")
    shape = dict(zip(artifact.mesh_axes, artifact.mesh_shape))
    coords = dict(zip(artifact.mesh_axes,
                      np.unravel_index(rank, artifact.mesh_shape)))
    dp, ep = shape.get("dp", 1), shape.get("ep", 1)
    replica = int(coords.get("dp", 0)) * ep + int(coords.get("ep", 0))
    M = artifact.microbatches if shape.get("pp", 1) > 1 else 1
    mb = artifact.gbs // M
    per = mb // (dp * ep)
    return np.concatenate([m * mb + replica * per + np.arange(per)
                           for m in range(M)])


def global_batch_pipeline(dataset, gbs: int, rows, device=None,
                          shuffle_seed: int | None = 0,
                          epochs: int | None = None, skip_batches: int = 0):
    """Iterator of full-shape ``(tokens, targets)`` batches of which only
    ``rows`` are gathered (``rank_rows``); every rank walks the same
    deterministic schedule of the seed, so the rows it reads are those of
    the batch one controller would feed it.  The schedule must be the same
    on every rank (same dataset, seed and skip)."""
    from metis_tpu_torch.data.pipeline import make_input_pipeline

    return make_input_pipeline(dataset, gbs, device=device,
                               shuffle_seed=shuffle_seed, epochs=epochs,
                               skip_batches=skip_batches,
                               rows=np.asarray(rows))


# -- the fixed workload: one launcher per process ----------------------------

WORKLOAD = dict(vocab_size=512, seq_len=16, hidden=64, num_heads=4,
                num_blocks=2, ffn_multiplier=2)
GBS, STEPS, WORLD = 8, 2, 4
MODES = {
    # the reference's worker modes at 4 ranks
    "gspmd": dict(mesh_axes=("pp", "dp", "ep", "sp", "tp"),
                  mesh_shape=(1, 2, 1, 1, 2), microbatches=1,
                  strategies=({"dp": 2, "tp": 2},)),
    "pipeline": dict(mesh_axes=("pp", "dp", "tp"), mesh_shape=(2, 2, 1),
                     microbatches=2, strategies=({"dp": 2, "tp": 1},)),
}


def workload_artifact(mode: str):
    from metis_tpu_torch.execution.mesh import PlanArtifact

    spec = MODES[mode]
    return PlanArtifact(layer_partition=(), gbs=GBS, schedule="gpipe", **spec)


def workload_dataset():
    """The worker's token stream (every launcher derives the same one)."""
    from metis_tpu_torch.data.pipeline import TokenDataset

    return TokenDataset.synthetic(WORKLOAD["vocab_size"],
                                  GBS * WORKLOAD["seq_len"] * (STEPS + 2) + 1,
                                  WORKLOAD["seq_len"])


def load_tree(path: str) -> dict:
    """A parameter tree from an ``.npz`` of ``group/name`` keys."""
    tree: dict = {}
    with np.load(path) as f:
        for key in f.files:
            group, name = key.split("/")
            tree.setdefault(group, {})[name] = f[key]
    return tree


def workload_rank(rank: int, device, mode: str, params_path: str | None) -> dict:
    """One rank of the fixed workload: its rows of each batch through
    ``global_batch_pipeline``, ``STEPS`` steps; the losses and the rows it
    gathered."""
    import torch

    from metis_tpu_torch.execution.builder import build_executable
    from metis_tpu_torch.models.gpt import GPTConfig

    art = workload_artifact(mode)
    cfg = GPTConfig(**WORKLOAD, dtype=torch.float32)
    exe = build_executable(cfg, art, device)
    state = exe.init(load_tree(params_path) if params_path else 0)
    rows = rank_rows(art, rank)
    batches = global_batch_pipeline(workload_dataset(), GBS, rows, device=device)
    losses = []
    try:
        for _ in range(STEPS):
            toks, tgts = next(batches)
            state, loss = exe.step(state, toks, tgts)
            losses.append(float(loss))
    finally:
        batches.close()
    return {"losses": losses, "rows": rows.tolist()}


def _worker_main(argv: Sequence[str]) -> int:
    import argparse

    from metis_tpu_torch.execution.dist import RankPool

    p = argparse.ArgumentParser(prog="python -m metis_tpu_torch.execution.multihost")
    p.add_argument("proc_id", type=int)
    p.add_argument("num_procs", type=int)
    p.add_argument("port", type=int)
    p.add_argument("mode", choices=sorted(MODES))
    p.add_argument("--params", default=None)
    args = p.parse_args(argv)
    info = initialize_multihost(f"127.0.0.1:{args.port}", args.num_procs,
                                args.proc_id, WORLD)
    L = info.local_device_count
    with RankPool(L, "gloo", ["cpu"] * L, init_method=info.init_method,
                  first_rank=info.first_rank, world_size=WORLD) as pool:
        ranks = pool.run(workload_rank, args.mode, args.params)
    print(json.dumps({
        "process": info.process_index, "processes": info.process_count,
        "global_devices": info.global_device_count, "local_devices": L,
        "mode": args.mode, "losses": ranks[0]["losses"],
        "rank_losses": [r["losses"] for r in ranks],
        "rows": [r["rows"] for r in ranks],
    }), flush=True)
    return 0


def free_port() -> int:
    """A TCP port no socket on this host holds now (bind port 0)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_workers(mode: str, num_procs: int = 2, port: int | None = None,
                  params: str | None = None,
                  timeout_s: float = 300.0) -> list[dict]:
    """Start ``num_procs`` launchers of the fixed workload (this module's
    ``__main__``) and return their reports; every child is reaped, so a
    failed launcher cannot leave its peers waiting in the group's
    rendezvous."""
    import os
    import subprocess
    from pathlib import Path

    if WORLD % num_procs:
        raise MetisError(f"{WORLD} ranks do not split over {num_procs}")
    port = port or free_port()
    repo = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": repo}
    extra = ["--params", params] if params else []
    procs = [subprocess.Popen(
        [sys.executable, "-m", "metis_tpu_torch.execution.multihost",
         str(i), str(num_procs), str(port), mode, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=repo) for i in range(num_procs)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout_s)
            if p.returncode != 0:
                raise MetisError(f"multihost worker failed:\n{err[-1500:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


if __name__ == "__main__":
    sys.exit(_worker_main(sys.argv[1:]))
