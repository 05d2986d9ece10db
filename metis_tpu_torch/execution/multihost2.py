"""One controller per stage of a hetero plan — the port of
``metis_tpu/execution/multihost2.py``.

``execution.hetero`` runs a non-uniform plan from one launcher: every
stage's ranks are in one process group and exchange boundary activations
point to point.  Where the stages cannot share one group (clusters of
another generation, hosts that share no collective fabric) each stage
runs under a controller of its own: it owns only its stage's ranks, in a
process group of their own (``execution.dist.RankPool``; a one-device
stage runs in the controller's process), and the boundary activations and
their gradients cross a TCP socket pair between neighbouring stages:

- the transport (:func:`send_array` / :func:`recv_array`) frames an array
  with its dtype and shape, as the reference's does; bf16, which numpy
  lacks, goes as its 16-bit pattern under the tag ``bfloat16``, so the
  frames are the reference's frames;
- the socket is held by the stage's first rank: a stage's output is
  gathered over its ranks (each replica's rows and block of the sequence)
  before it is sent, and what arrives is scattered to the ranks that run
  it (:class:`_Boundary`);
- the stage's program is the single-controller executor's
  (``stages.StageRunner``'s stage function, leaf views, accumulators, dp
  reduction and AdamW step), and the step is its fill and drain: every
  microbatch forward (storing only the boundary input), then every
  backward in reverse microbatch order, recomputing the forward (stage
  remat), then one optimizer step.  So the loss stream equals the
  single-controller hetero executor's on the same plan.

Roles: the first stage embeds, a middle stage relays activations forward
and input gradients backward, the last stage ends in the loss.  Refused,
as in the reference: MoE (the router's aux loss couples the stages through
the head loss, which the socket does not carry), non-gpipe schedules, and
(``cli.py``) stages that span device types.  With a checkpoint directory
each controller checkpoints and resumes its stage under
``<dir>/slice{N}/``; after the ring connects, neighbours agree on the
lowest step any of them resumes from and a slice that is ahead rolls back
to its retained ``.prev`` generation, or the run is refused.

``python -m metis_tpu_torch.execution.multihost2 <stage> <stages> <port>``
runs one controller of the fixed parity workload (two stages, dp 2 | tp 2,
gbs 8, 2 microbatches, 3 steps) on gloo CPU ranks; ``--params`` /
``--tokens`` start it from a parameter tree / token array in ``.npz`` /
``.npy`` files.
"""
from __future__ import annotations

import json
import socket
import struct
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from metis_tpu_torch.execution.checkpoint import _world

# ---------------------------------------------------------------------------
# boundary transport: length-framed arrays over TCP
# ---------------------------------------------------------------------------

_BF16 = "bfloat16"


def send_array(sock: socket.socket, arr) -> None:
    """One frame: ``<QQ`` (header and payload lengths), the JSON header
    ``{"dtype", "shape"}``, the raw bytes.  ``arr``: a numpy array or a
    tensor (a CUDA one is copied to the host); a bf16 tensor goes as its
    16-bit pattern under the dtype ``bfloat16``."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            dtype, arr = _BF16, t.view(torch.int16).numpy()
        else:
            arr = t.numpy()
            dtype = str(arr.dtype)
    else:
        arr = np.asarray(arr)
        dtype = str(arr.dtype)
    meta = json.dumps({"dtype": dtype, "shape": list(arr.shape)}).encode()
    payload = np.ascontiguousarray(arr).tobytes()
    sock.sendall(struct.pack("<QQ", len(meta), len(payload)) + meta + payload)


def recv_array(sock: socket.socket) -> torch.Tensor:
    """The next frame as a host tensor of its dtype and shape."""
    n_meta, n_payload = struct.unpack("<QQ", _recv_exact(sock, 16))
    meta = json.loads(_recv_exact(sock, n_meta))
    raw = bytearray(_recv_exact(sock, n_payload))
    if meta["dtype"] == _BF16:
        arr = np.frombuffer(raw, dtype=np.int16).reshape(meta["shape"])
        return torch.from_numpy(arr).view(torch.bfloat16)
    arr = np.frombuffer(raw, dtype=np.dtype(meta["dtype"]))
    return torch.from_numpy(arr.reshape(meta["shape"]))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("boundary peer closed the socket")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _connect_ring_addrs(stage_id: int, num_stages: int, link_addrs,
                        timeout_s: float = 120.0):
    """(to_prev, to_next) sockets of this stage: ``link_addrs[i] = (host,
    port)`` is the link between stage i and stage i + 1 — stage i listens
    there (on that host's interface, never all of them), stage i + 1 dials
    it."""
    to_prev = to_next = None
    if stage_id < num_stages - 1:
        srv = socket.create_server(tuple(link_addrs[stage_id]))
        srv.settimeout(timeout_s)
        to_next, _ = srv.accept()
        srv.close()
    if stage_id > 0:
        host, port = link_addrs[stage_id - 1]
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                to_prev = socket.create_connection((host, port), timeout=2.0)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
    # transfers block: a peer may spend minutes building its kernels
    # before its first send
    for s in (to_prev, to_next):
        if s is not None:
            s.settimeout(None)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return to_prev, to_next


def parse_link_addrs(peers: str) -> list[tuple[str, int]]:
    """``host:port,host:port,...`` -> [(host, port), ...] — one entry per
    boundary link (stage i listens on entry i; stage i+1 dials it)."""
    out = []
    for part in peers.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"bad link address {part!r} (want host:port)")
        out.append((host, int(port)))
    if not out:
        raise ValueError("no boundary link addresses given")
    return out


# ---------------------------------------------------------------------------
# the stage's ranks: gather before sending, scatter after receiving
# ---------------------------------------------------------------------------

def _share(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``t`` on every rank of the stage, bit for bit (gloo sums
    the bytes over a zeroed buffer, as ``parallel.all_gather_dim``)."""
    if _world()[1] == 1:
        return t
    if dist.get_backend() == dist.Backend.GLOO:
        if _world()[0]:
            t.zero_()
        dist.all_reduce(t.view(-1).view(torch.uint8))
    else:
        dist.broadcast(t, src=0)
    return t


class _Boundary:
    """One stage's end of its two links.  A tensor crossing a boundary is
    the whole microbatch ``[rows, seq, hidden]``: rank 0 of the stage
    sends it after gathering every replica's rows and block of the
    sequence, and receives it and shares it with the stage's ranks, each
    keeping its piece."""

    def __init__(self, runner, layout, to_prev, to_next, device, dtype):
        self.runner, self.lay = runner, layout
        self.to_prev, self.to_next = to_prev, to_next
        self.device, self.dtype = device, dtype
        mesh = runner.mesh
        self.a, self.b = layout.rows(runner.replica)
        self.s0, self.s1 = layout.cols(mesh.index("sp"))

    def _full(self) -> torch.Tensor:
        return torch.empty((self.lay.bounds[-1], self.lay.seq,
                            self.runner.cfg.hidden), dtype=self.dtype,
                           device=self.device)

    def receive(self, sock) -> torch.Tensor:
        full = self._full()
        if _world()[0] == 0:
            full.copy_(recv_array(sock))
        full = _share(full)
        return full[self.a:self.b, self.s0:self.s1].clone()

    def send(self, piece: torch.Tensor, sock) -> None:
        from metis_tpu_torch.models.parallel import all_gather_dim

        piece = piece.detach().to(self.dtype).contiguous()
        if _world()[1] == 1:
            send_array(sock, piece)
            return
        pieces = all_gather_dim(piece[None], dist.group.WORLD, 0)
        if _world()[0]:
            return
        lay, full = self.lay, self._full()
        for d in range(lay.dp):
            a, b = lay.rows(d)
            for c in range(lay.cp):
                s0, s1 = lay.cols(c)
                full[a:b, s0:s1] = pieces[lay.rank(d, c, 0)]
        send_array(sock, full)


def stage_runner(cfg, spec, device):
    """The single-controller executor's program of stage ``spec``
    (``stages.StageRunner``) over this controller's ranks alone: one unit
    with no neighbour ranks (its boundaries cross the sockets)."""
    from metis_tpu_torch.execution.mesh import SP, StageGrid, stage_meshes
    from metis_tpu_torch.execution.stages import StageRunner, Unit, replica_counts
    from metis_tpu_torch.execution.train import build_optimizer
    from metis_tpu_torch.models import resolve_attention

    grid = StageGrid(spec.dp, spec.tp, spec.cp, spec.ep)
    mesh = stage_meshes([grid])
    attn = (resolve_attention(cfg, mesh.group(SP), spec.cp_mode)
            if spec.cp > 1 else resolve_attention(cfg))
    unit = Unit(0, spec.num_blocks, spec.has_embed, spec.has_head, None, None)

    def counts(rows):
        return [replica_counts(rows, spec.dp, spec.replica_rows)]

    return StageRunner(
        cfg, mesh, [grid], counts, [unit], range(*spec.blocks),
        schedule=None, remat=True, device=device,
        optimizer=build_optimizer(), attn=attn, overlap=False,
        chunked_dp=False, zero=spec.zero,
        aux_weight=spec.num_blocks / max(cfg.num_blocks, 1))


def _slice_step(runner, state, tokens_mbs, targets_mbs, to_prev, to_next):
    """One fill-and-drain step of this stage (module doc); the loss (the
    last stage's; 0 elsewhere) on every rank of the stage."""
    import contextlib

    from metis_tpu_torch.execution.stages import _gather_chunks
    from metis_tpu_torch.execution.train import param_leaves
    from metis_tpu_torch.models.parallel import ShardGather

    cfg, unit, dev = runner.cfg, runner.units[0], runner.device
    M, rows, seq = tokens_mbs.shape
    lay = runner._layouts(rows, seq)[0]
    run = runner._step_of(lay, M, rows)
    a, _ = lay.rows(runner.replica)
    s0, s1 = lay.cols(runner.mesh.index("sp"))
    tokens = tokens_mbs[:, a:a + run.real, s0:s1].to(dev)
    targets = targets_mbs[:, a:a + run.real, s0:s1].to(dev)
    edge = _Boundary(runner, lay, to_prev, to_next, dev, cfg.dtype)
    acc = {g: {n: torch.zeros_like(t, dtype=torch.float32)
               for n, t in sub.items()} for g, sub in state.params.items()}
    gather = None
    if state.zero is not None and state.zero.level == 3:
        gather = ShardGather(state.zero.group)
    hooks = gather.hooks if gather is not None else contextlib.nullcontext
    params = runner._unit_params(state, unit, acc, gather)
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    saved = []
    # forward fill: store the boundary input, send the output
    for m in range(M):
        x = tokens[m] if unit.has_embed else edge.receive(to_prev)
        saved.append(x)
        if not unit.has_head:
            with torch.no_grad():
                y = runner.fn(params, unit, x, run)
            edge.send(y, to_next)
    # backward drain, in reverse microbatch order, recomputing the forward
    for m in reversed(range(M)):
        x = saved[m]
        if not unit.has_embed:
            x.requires_grad_()
        with hooks():
            out = runner.fn(params, unit, x, run, targets[m])
        if unit.has_head:
            out.backward()
            loss_sum = loss_sum + out.detach()
        else:
            out.backward(edge.receive(to_next))
        if not unit.has_embed:
            edge.send(x.grad, to_prev)
        saved[m] = None
    del params
    runner._reduce(state, acc)
    state.optimizer.step()
    if state.zero is not None and state.zero.level < 3:
        _gather_chunks(state)
    state.optimizer.zero_grad(set_to_none=True)
    for leaf in param_leaves(state.params):
        leaf.grad = None
    state.step += 1
    if _world()[1] > 1:
        if runner.mesh.index("tp"):
            loss_sum.zero_()
        dist.all_reduce(loss_sum)
    return state, loss_sum


def _agree_start(start_step: int, to_prev, to_next, num_stages: int,
                 device) -> int:
    """The lowest start step of the chain: ``num_stages - 1`` rounds of
    exchanging the running minimum with the neighbours (rank 0 of each
    stage), then shared with the stage's ranks."""
    agreed = start_step
    if _world()[0] == 0:
        for _ in range(max(num_stages - 1, 1)):
            for sock in (to_prev, to_next):
                if sock is not None:
                    send_array(sock, np.asarray([agreed], np.int64))
            for sock in (to_prev, to_next):
                if sock is not None:
                    agreed = min(agreed, int(recv_array(sock)[0]))
    return int(_share(torch.tensor([agreed], dtype=torch.int64,
                                   device=device))[0])


def slice_stage_rank(rank: int, device, job: dict) -> dict:
    """One rank of a slice controller's stage (``RankPool``'s body, or the
    stage's one device in the controller's process): ``job`` holds
    ``cfg``, ``stages`` (every stage's ``StageSpec``), ``stage_id``,
    ``links``, ``microbatches``, ``init`` (a seed or a full numpy
    parameter tree), the batches (``batches``: a list of microbatch-major
    ``(tokens, targets)``, or ``data`` for the train pipeline), and
    optionally ``checkpoint_dir``, ``checkpoint_every`` and ``plan`` (the
    artifact JSON it pins).  Rank 0 holds the sockets.  Returns ``stage``,
    ``stages``, ``local_devices``, ``steps``, ``start_step``, the
    ``losses`` (the last stage's; [] elsewhere), and each step's kernel
    ``launches`` on this rank and its host ``step_ms`` (synchronized by
    reading the loss)."""
    from metis_tpu_torch.execution.mesh import PlanArtifact

    cfg, stages, sid = job["cfg"], job["stages"], job["stage_id"]
    num_stages = len(stages)
    runner = stage_runner(cfg, stages[sid], device)

    def init_state():
        return runner.init(job["init"])

    state = init_state()
    sdir = (Path(job["checkpoint_dir"]) / f"slice{sid}"
            if job.get("checkpoint_dir") else None)
    plan = PlanArtifact.from_json(job["plan"]) if job.get("plan") else None
    start_step = 0
    if sdir is not None:
        from metis_tpu_torch.execution.checkpoint import (
            load_meta,
            restore_hetero_checkpoint,
        )

        try:
            start_step = load_meta(sdir).step
            state = restore_hetero_checkpoint(sdir, state, runner.mesh)
        except FileNotFoundError:
            start_step = 0
    to_prev = to_next = None
    if rank == 0:
        to_prev, to_next = _connect_ring_addrs(sid, num_stages, job["links"])
    try:
        run = _run_slice(job, runner, state, start_step, sdir, plan,
                         init_state, to_prev, to_next)
    finally:
        # a failed controller closes its links, so its neighbours fail
        # instead of waiting on them
        for sock in (to_prev, to_next):
            if sock is not None:
                sock.close()
    return {"stage": sid, "stages": num_stages, "local_devices": _world()[1],
            **run}


def _run_slice(job, runner, state, start_step, sdir, plan, init_state,
               to_prev, to_next) -> dict:
    """The handshake, the steps and the saves of ``slice_stage_rank``:
    its report's ``steps``, ``start_step``, ``losses``, ``launches`` and
    ``step_ms``."""
    from metis_tpu_torch.ops import flash_attention as fa

    sid, num_stages = job["stage_id"], len(job["stages"])
    is_last = sid == num_stages - 1
    agreed = _agree_start(start_step, to_prev, to_next, num_stages,
                          runner.device)
    if agreed != start_step:
        rolled = None
        if agreed == 0:  # step 0 needs no checkpoint: a fresh init
            rolled = init_state()
        elif sdir is not None:
            rolled = _rollback(sdir, agreed, init_state(), runner.mesh)
        if rolled is None:
            raise RuntimeError(
                f"stage {sid} resumes at step {start_step} but the slice "
                f"chain agrees on {agreed}, and no rollback generation "
                "reaches it — slice checkpoints are out of sync (same "
                "--checkpoint-dir on every controller?)")
        state, start_step = rolled, agreed

    def save(step):
        from metis_tpu_torch.execution.checkpoint import save_hetero_checkpoint

        # keep_prev: the controllers save without coordination; the
        # retained generation is the rollback target of a torn chain
        save_hetero_checkpoint(sdir, state, step, runner.mesh, plan=plan,
                               keep_prev=True)

    every = job.get("checkpoint_every") or 0
    losses, launches, step_ms, steps = [], [], [], 0
    batches = _batches(job, start_step)
    try:
        for toks, tgts in batches:
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            state, loss = _slice_step(runner, state, toks, tgts, to_prev,
                                      to_next)
            loss = float(loss)  # the sync that makes the step time real
            step_ms.append((time.perf_counter() - t0) * 1e3)
            launches.append({k: v for k, v in fa.launch_counts.items() if v})
            steps += 1
            if is_last:
                losses.append(loss)
            if sdir is not None and every and steps % every == 0:
                save(start_step + steps)
    finally:
        close = getattr(batches, "close", None)
        if close is not None:
            close()
    if sdir is not None and not (every and steps % every == 0):
        save(start_step + steps)
    return {"steps": steps, "start_step": start_step, "losses": losses,
            "launches": launches, "step_ms": step_ms}


def _rollback(sdir: Path, target: int, fresh, mesh):
    """The stage's state at exactly step ``target``: from the primary
    generation if it holds that step, else from the retained ``.prev``;
    None when neither does."""
    from metis_tpu_torch.execution.checkpoint import (
        load_meta,
        restore_hetero_checkpoint,
    )

    prev = sdir.with_name(sdir.name + ".prev")
    for d in (sdir, prev):
        try:
            if load_meta(d).step != target:
                continue
        except (FileNotFoundError, OSError):
            continue
        return restore_hetero_checkpoint(d, fresh, mesh)
    return None


def _batches(job: dict, start_step: int):
    """Microbatch-major ``(tokens, targets)`` pairs: the job's list, or the
    train CLI's deterministic pipeline over ``data`` fast-forwarded past
    the ``start_step`` batches the resumed steps consumed."""
    if job.get("batches") is not None:
        return iter(job["batches"][start_step:])
    from metis_tpu_torch.data.pipeline import (
        TokenDataset,
        make_input_pipeline,
        synthetic_run_dataset,
    )
    from metis_tpu_torch.execution.pipeline import microbatch_split

    model, gbs, M = job["model"], job["gbs"], job["microbatches"]
    path = job.get("data")
    if path:
        toks_src = (np.load(path, mmap_mode="r") if path.endswith(".npy")
                    else np.memmap(path, dtype=np.int32, mode="r"))
        dataset = TokenDataset(toks_src, model.sequence_length)
    else:
        dataset = synthetic_run_dataset(model.vocab_size, gbs,
                                        model.sequence_length,
                                        seed=job.get("seed", 0))
    pipe = make_input_pipeline(dataset, gbs, epochs=None,
                               skip_batches=start_step)

    def gen():
        try:
            for _ in range(job["steps"]):
                toks, tgts = next(pipe)
                yield (microbatch_split(torch.from_numpy(toks), M),
                       microbatch_split(torch.from_numpy(tgts), M))
        finally:
            pipe.close()

    return gen()


def run_stage(job: dict, devices, backend: str | None = None) -> dict:
    """This controller's stage on ``devices`` (one per rank of the
    stage): in this process for a one-device stage, else on a
    ``RankPool`` of its own; rank 0's report."""
    from metis_tpu_torch.core.device import resolve_device
    from metis_tpu_torch.execution import dist as mdist

    spec = job["stages"][job["stage_id"]]
    if len(devices) < spec.devices:
        raise RuntimeError(f"stage {job['stage_id']} needs {spec.devices} "
                           f"devices, have {len(devices)}")
    devices = list(devices)[:spec.devices]
    if spec.devices == 1:
        return slice_stage_rank(0, resolve_device(devices[0]), job)
    return mdist.spawn(slice_stage_rank, spec.devices,
                       backend or mdist.default_backend(devices), devices,
                       job)[0]


# ---------------------------------------------------------------------------
# the plan-artifact controller (train --slice-controller)
# ---------------------------------------------------------------------------

def run_artifact_stage_worker(artifact, model, stage_id: int, link_addrs,
                              steps: int, devices, backend: str | None = None,
                              data_path: str | None = None, seed: int = 0,
                              checkpoint_dir: str | None = None,
                              checkpoint_every: int = 0, init=0) -> dict:
    """One slice controller running stage ``stage_id`` of a plan artifact
    on ``devices``: any number of stages (first / middle / last roles),
    batches from the train CLI's deterministic pipeline (``seed`` /
    ``data_path``, the same on every controller), per-slice checkpoints
    under ``<checkpoint_dir>/slice{stage_id}/``.  Refuses MoE plans and
    non-gpipe schedules, in the reference's words."""
    from metis_tpu_torch.execution.hetero import stage_specs_from_plan
    from metis_tpu_torch.models import config_for_model_spec, family_ops

    cfg = config_for_model_spec(model)
    if family_ops(cfg).moe:
        raise ValueError(
            "slice-controller execution supports dense plans only (the MoE "
            "router aux couples stages through the head loss)")
    if getattr(artifact, "schedule", "gpipe") != "gpipe":
        raise ValueError(
            f"slice-controller execution implements the gpipe fill-drain "
            f"schedule only; this plan was priced as "
            f"schedule={artifact.schedule!r} — running it as gpipe would "
            "invalidate the planner's cost basis")
    stages = stage_specs_from_plan(artifact.layer_partition,
                                   artifact.strategies, cfg)
    num_stages = len(stages)
    if num_stages < 2:
        raise ValueError("slice-controller execution needs >= 2 stages")
    if not 0 <= stage_id < num_stages:
        raise ValueError(f"stage {stage_id} out of range 0..{num_stages - 1}")
    if len(link_addrs) != num_stages - 1:
        raise ValueError(
            f"{num_stages} stages need {num_stages - 1} boundary links, "
            f"got {len(link_addrs)}")
    job = dict(cfg=cfg, stages=stages, stage_id=stage_id,
               links=list(link_addrs), microbatches=artifact.microbatches,
               init=init, model=model, gbs=artifact.gbs, steps=steps,
               data=data_path, seed=seed, checkpoint_dir=checkpoint_dir,
               checkpoint_every=checkpoint_every, plan=artifact.to_json())
    return run_stage(job, devices, backend)


# ---------------------------------------------------------------------------
# the fixed two-stage workload (with its single-controller oracle)
# ---------------------------------------------------------------------------

WORKLOAD = dict(vocab_size=256, seq_len=16, hidden=64, num_heads=4,
                num_blocks=3, ffn_multiplier=2)
PARTITION = (0, 2, 5)   # stage 0 = embed + 1 block, stage 1 = 2 blocks + head
STRATEGIES = ({"dp": 2, "tp": 1}, {"dp": 1, "tp": 2})
GBS, MICROBATCHES, STEPS = 8, 2, 3


def workload_plan(cfg=None):
    """(cfg, stage_specs) of the fixed parity workload (fp32)."""
    from metis_tpu_torch.execution.hetero import stage_specs_from_plan
    from metis_tpu_torch.models.gpt import GPTConfig

    if cfg is None:
        cfg = GPTConfig(dtype=torch.float32, **WORKLOAD)
    return cfg, stage_specs_from_plan(PARTITION, STRATEGIES, cfg)


def workload_batches(tokens=None) -> list:
    """``[steps]`` microbatch-major ``(tokens, targets)`` (targets = the
    tokens, as the reference's workload): ``tokens`` (``[steps, M, rows,
    seq]`` ints), else drawn from seed 17 — every controller derives the
    same schedule."""
    if tokens is None:
        tokens = np.random.default_rng(17).integers(
            0, WORKLOAD["vocab_size"],
            (STEPS, MICROBATCHES, GBS // MICROBATCHES, WORKLOAD["seq_len"]))
    out = []
    for step in np.asarray(tokens):
        t = torch.from_numpy(np.ascontiguousarray(step).astype(np.int64))
        out.append((t, t))
    return out


def _oracle_rank(rank: int, device, cfg, stages, init, batches) -> list:
    from metis_tpu_torch.execution.builder import hetero_executable

    exe = hetero_executable(cfg, stages, MICROBATCHES, device)
    state = exe.init(init)
    losses = []
    for toks, tgts in batches:
        state, loss = exe.step(state, toks.reshape(GBS, -1),
                               tgts.reshape(GBS, -1))
        losses.append(float(loss))
    return losses


def run_single_controller_losses(init=0, tokens=None) -> list[float]:
    """The same run under the single-controller hetero executor, its four
    ranks in one process group (gloo, the CPU): the parity oracle."""
    from metis_tpu_torch.execution import dist as mdist

    cfg, stages = workload_plan()
    world = sum(s.devices for s in stages)
    return mdist.spawn(_oracle_rank, world, "gloo", ["cpu"] * world, cfg,
                       stages, init, workload_batches(tokens))[0]


def run_stage_worker(stage_id: int, num_stages: int, base_port: int,
                     init=0, tokens=None) -> dict:
    """One controller of the fixed workload's stage ``stage_id`` on gloo
    CPU ranks, its links on consecutive localhost ports from
    ``base_port``."""
    if num_stages != 2:
        raise ValueError(
            f"the fixed parity workload has exactly 2 stages, "
            f"got num_stages={num_stages}")
    cfg, stages = workload_plan()
    job = dict(cfg=cfg, stages=stages, stage_id=stage_id,
               links=[("127.0.0.1", base_port + i)
                      for i in range(num_stages - 1)],
               microbatches=MICROBATCHES, init=init,
               batches=workload_batches(tokens))
    return run_stage(job, ["cpu"] * stages[stage_id].devices, "gloo")


def spawn_hetero_workers(base_port: int, params: str | None = None,
                         tokens: str | None = None,
                         timeout_s: float = 300.0) -> list[dict]:
    """One controller process per stage of the fixed workload; their
    reports.  Every child is reaped, so a failed controller cannot leave
    its neighbour waiting on the socket."""
    import os
    import subprocess

    repo = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": repo}
    extra = (["--params", params] if params else []) + (
        ["--tokens", tokens] if tokens else [])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "metis_tpu_torch.execution.multihost2",
         str(i), str(len(STRATEGIES)), str(base_port), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=repo) for i in range(len(STRATEGIES))]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout_s)
            if p.returncode != 0:
                raise RuntimeError(f"hetero worker failed:\n{err[-1500:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _main(argv) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="python -m metis_tpu_torch.execution.multihost2")
    p.add_argument("stage", type=int)
    p.add_argument("stages", type=int)
    p.add_argument("port", type=int)
    p.add_argument("--params", default=None, help="parameter tree (.npz)")
    p.add_argument("--tokens", default=None,
                   help="[steps, M, rows, seq] token array (.npy)")
    args = p.parse_args(argv)
    from metis_tpu_torch.execution.multihost import load_tree

    init = load_tree(args.params) if args.params else 0
    tokens = np.load(args.tokens) if args.tokens else None
    print(json.dumps(run_stage_worker(args.stage, args.stages, args.port,
                                      init, tokens)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
