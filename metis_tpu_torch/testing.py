"""Differential-testing harness of the port — the counterpart of
``metis_tpu/testing.py``.

``run_plan_rank`` (and ``run_plans_rank``, several plans in one launch) is
the rank body the multi-rank tests (``tests/test_torch_dist.py``,
``test_torch_pipeline.py``, ``test_torch_hetero.py``,
``test_torch_stage_axes.py`` and others) and ``chip_smoke.py``'s multi-rank
phases hand to ``execution.dist.spawn``; its ``stages`` take every stage
axis of the hetero route (ZeRO, cp, ep, MoE rows and groups).  It lives in the
package because spawned ranks start from a fresh interpreter and import
their body by name; it reads the kernels' launch counters, host step times
and peak memory, none of which production training needs.
"""
from __future__ import annotations

import gc
import time
from collections import Counter
from unittest import mock

import numpy as np
import torch

from metis_tpu_torch.core.sharding import slice_leaf
from metis_tpu_torch.execution.builder import build_executable, hetero_executable
from metis_tpu_torch.execution.mesh import (
    DP,
    EP,
    SP,
    TP,
    PlanArtifact,
    _grid,
    batch_spec,
)
from metis_tpu_torch.execution.train import aligned_routing
from metis_tpu_torch.models import family_ops
from metis_tpu_torch.models.gpt import GPTConfig
from metis_tpu_torch.models.moe import MoEConfig
from metis_tpu_torch.ops import flash_attention as fa


def run_plan_rank(rank: int, device: torch.device, artifact_json: str | None,
                  cfg: GPTConfig, init, batches, forward_tokens=None,
                  return_params: bool = False, stages=None,
                  microbatches: int = 1, routing_tokens=None,
                  first_grads: str | None = None, **build) -> dict:
    """Rank body for ``execution.dist.spawn``: build the artifact's
    executable on this rank (``build``: keyword arguments of
    ``build_executable``, such as ``schedule`` or ``overlap``) — or, given
    ``stages`` (``hetero.StageSpec``s) instead of an artifact, the hetero
    route over ``microbatches`` (``builder.hetero_executable``) — initialize
    it from ``init`` (a seed, or the full parameter tree as numpy arrays,
    of which the rank keeps its piece), and take one step per ``(tokens,
    targets)`` of ``batches`` (full-batch host tensors).

    Returns host data: ``kind`` (the route); ``losses``; ``step_ms`` (host
    clock, each step synchronized by reading its loss); ``launches``, the
    flash-attention kernel launches of each step on this rank;
    ``peak_memory_bytes`` on CUDA; ``slots``, the rank's mesh coordinates;
    ``block_ids``, the global blocks its stacked leaves hold (None: all);
    with ``forward_tokens`` (pp = 1 routes) the logits of the rank's dp
    rows and cp block of the sequence of them before training (its block
    of the vocabulary); with
    ``routing_tokens`` (MoE, pp = 1 routes) the routing decisions of its
    rows of them in the first block before training (``forward_routing``); with
    ``return_params`` its stored leaves after training (ZeRO 3: its dp
    shards); with ``first_grads`` the gradients the first optimizer step
    applies, reduced over the plan's ranks, as ``grads`` (``"arrays"``: the
    gradients; ``"norms"``: their L2 norms), one per leaf: at ZeRO 1 and 2
    a wrapped leaf's is that of the rank's flat chunk of it, at ZeRO 3 that
    of its shard, on the gspmd route and on a hetero stage alike.
    ``zero_dims``: ``{(group, name): the dim ZeRO splits a leaf along}``
    (None: not split; absent without ZeRO, or on a stage without it).  A
    rank outside a plan on the process group's first ranks gets ``kind``
    None and no losses."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if stages is not None:
        exe = hetero_executable(cfg, stages, microbatches, device, **build)
    else:
        exe = build_executable(cfg, PlanArtifact.from_json(artifact_json),
                               device, **build)
    if exe is None:
        return {"kind": None, "losses": []}
    slots = exe.mesh.slots()
    state = exe.init(init)
    out: dict = {"kind": exe.kind, "slots": slots, "block_ids": exe.block_ids,
                 "losses": [], "step_ms": [], "launches": []}
    if state.zero is not None:
        out["zero_dims"] = dict(state.zero.dims)
    if forward_tokens is not None:
        out["logits"] = exe.forward(state, forward_tokens.to(device)).cpu().numpy()
    if routing_tokens is not None:
        out["routing"] = forward_routing(exe, state, routing_tokens.to(device))
    if first_grads is not None:
        out["grads"] = capture_first_grads(state, first_grads)
    for tokens, targets in batches:
        tokens, targets = tokens.to(device), targets.to(device)
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        state, loss = exe.step(state, tokens, targets)
        out["losses"].append(loss.item())
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append(dict(fa.launch_counts))
    if cuda:
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    if return_params:
        out["params"] = {g: {n: np.array(t.detach().cpu(), copy=True)
                             for n, t in sub.items()}
                         for g, sub in state.params.items()}
    return out


def resume_rank(rank: int, device: torch.device, artifact_json: str | None,
                cfg: GPTConfig, batches, split: int, directory: str,
                stages=None, microbatches: int = 1) -> dict:
    """Rank body for ``execution.dist.spawn``: train ``batches`` straight
    from seed 0, and again with a checkpoint after ``split`` steps
    (``execution.checkpoint``; the hetero pair on the hetero route),
    restored into a fresh state from seed 1 before the rest.  Returns both
    runs' ``losses`` and ``params`` (host arrays), the ``step`` restored and
    the checkpoint's ``meta`` (``CheckpointMeta``)."""
    from metis_tpu_torch.execution import checkpoint as ckpt

    if stages is not None:
        exe = hetero_executable(cfg, stages, microbatches, device)
        art = None
    else:
        art = PlanArtifact.from_json(artifact_json)
        exe = build_executable(cfg, art, device)

    def run(state, part):
        losses = []
        for tokens, targets in part:
            state, loss = exe.step(state, tokens.to(device), targets.to(device))
            losses.append(loss.item())
        return state, losses

    def host(state):
        return {g: {n: np.array(t.detach().cpu(), copy=True) for n, t in sub.items()}
                for g, sub in state.params.items()}

    straight, want = run(exe.init(0), batches)
    state, got = run(exe.init(0), batches[:split])
    if exe.kind == "hetero":
        ckpt.save_hetero_checkpoint(directory, state, split, exe.mesh)
        resumed = ckpt.restore_hetero_checkpoint(directory, exe.init(1), exe.mesh)
    else:
        ckpt.save_checkpoint(directory, state, art)
        resumed = ckpt.restore_checkpoint(directory, exe.init(1), mesh=art)
    step = resumed.step
    resumed, rest = run(resumed, batches[split:])
    return {"losses": (want, got + rest), "params": (host(straight), host(resumed)),
            "step": step, "meta": ckpt.load_meta(directory), "slots": exe.mesh.slots()}


def elastic_rank(rank: int, device: torch.device, jobs: list[dict]) -> list[dict]:
    """Rank body for ``execution.dist.spawn``: the ``jobs`` in turn, each a
    plan of the launch's ranks for the model ``cfg`` (``artifact`` JSON, or
    hetero ``stages`` over ``microbatches``; an artifact may take the first
    ranks only, the others passing None) that is initialized from ``init``,
    restored from the checkpoint ``restore`` when given, trained on
    ``batches`` and checkpointed to ``save`` when given (the artifact as
    the plan).

    Returns, per job: ``kind``; ``refused`` (the ``MetisError`` of a
    refused restore, the job then stopping there); ``step`` after the
    restore; ``digests``, the one-device digests of the state after the
    restore (``reshard.logical_digests``; not with ``digests=False``),
    ``losses``."""
    from metis_tpu_torch.core.errors import MetisError
    from metis_tpu_torch.execution import checkpoint as ckpt
    from metis_tpu_torch.execution.reshard import logical_digests

    out = []
    for job in jobs:
        art, cfg = None, job["cfg"]
        if job.get("stages") is not None:
            exe = hetero_executable(cfg, job["stages"], job.get("microbatches", 1),
                                    device)
        else:
            art = PlanArtifact.from_json(job["artifact"])
            exe = build_executable(cfg, art, device)
        state = exe.init(job.get("init", 0)) if exe is not None else None
        res = {"kind": exe.kind if exe is not None else None, "refused": None,
               "losses": []}
        out.append(res)
        if job.get("restore"):
            try:
                if job.get("stages") is not None:
                    state = ckpt.restore_hetero_checkpoint(job["restore"], state,
                                                           exe.mesh)
                else:
                    state = ckpt.restore_checkpoint(job["restore"], state)
            except MetisError as e:
                res["refused"] = str(e)
                continue
            if job.get("digests", True):
                res["digests"] = logical_digests(state)
        if exe is None:
            continue
        res["step"] = state.step
        for tokens, targets in job.get("batches", ()):
            state, loss = exe.step(state, tokens.to(device), targets.to(device))
            res["losses"].append(loss.item())
        if job.get("save"):
            if exe.kind == "hetero":
                ckpt.save_hetero_checkpoint(job["save"], state, state.step,
                                            exe.mesh)
            else:
                ckpt.save_checkpoint(job["save"], state, art, plan=art)
    return out


def reshard_rank(rank: int, device: torch.device, cfg: GPTConfig, init,
                 batches, source: str, targets: list[str],
                 other_cfg: GPTConfig | None = None) -> dict:
    """Rank body for ``execution.dist.spawn``: the live reshard's cases
    (``execution/reshard.py``).  Train plan ``source`` (artifact JSON, on
    every rank of the launch) from ``init`` on ``batches[:2]``; reshard it
    onto each of ``targets`` (artifact JSONs, on the launch's first ranks;
    the others only send) and train each on ``batches[2:]``: its
    ``ReshardReport``, ``losses``, the one-device digests of the source
    and of the resharded state (``reshard.logical_digests``) and the
    ``moved`` tensors of ``plan_reshard``.  Then the drills on the first
    target: an injected ``reshard_send`` (its events), an injected
    ``reshard_verify`` and, given ``other_cfg``, a state of another model
    (the errors, and the source's digests after each), and the
    ``moved`` tensors onto a fresh state of ``source`` itself."""
    from metis_tpu_torch.execution import reshard
    from metis_tpu_torch.resilience import FaultInjector

    class Events:
        def __init__(self):
            self.seen = []

        def emit(self, event, **fields):
            self.seen.append((event, fields))

    exe = build_executable(cfg, PlanArtifact.from_json(source), device)
    state = exe.init(init)
    for tokens, targets_ in batches[:2]:
        state, _ = exe.step(state, tokens.to(device), targets_.to(device))
    out = {"source_digests": reshard.logical_digests(state), "targets": []}

    def fresh(artifact_json, model=cfg):
        dst = build_executable(model, PlanArtifact.from_json(artifact_json),
                               device)
        return dst, (dst.init(1) if dst is not None else None)

    for target in targets:
        dst, ref = fresh(target)
        moved = reshard.plan_reshard(state, ref)[0]
        events = Events()
        new, report = reshard.execute_reshard(state, ref, step=2, events=events)
        res = {"report": report, "moved": moved, "losses": [],
               "digests": reshard.logical_digests(new),
               "events": [e for e, _ in events.seen]}
        if dst is not None:
            for tokens, targets_ in batches[2:]:
                new, loss = dst.step(new, tokens.to(device), targets_.to(device))
                res["losses"].append(loss.item())
        out["targets"].append(res)
        del new, ref
        gc.collect()
    drills = {}
    events = Events()
    _, ref = fresh(targets[0])
    _, report = reshard.execute_reshard(
        state, ref, step=2, events=events, sleep=lambda s: None,
        faults=FaultInjector("reshard_send@2x2") if rank == 0 else FaultInjector())
    drills["send"] = {"report": report, "events": [e for e, _ in events.seen]}
    cases = [("verify", targets[0], cfg, FaultInjector("reshard_verify@2"))]
    if other_cfg is not None:
        cases.append(("schema", targets[0], other_cfg, FaultInjector()))
    for name, target, model, faults in cases:
        _, ref = fresh(target, model)
        try:
            reshard.execute_reshard(state, ref, step=2, faults=faults)
            drills[name] = {"error": None}
        except Exception as e:  # noqa: BLE001 — the drill reports it
            drills[name] = {"error": f"{type(e).__name__}: {e}"}
        drills[name]["source_digests"] = reshard.logical_digests(state)
    drills["resident"] = reshard.plan_reshard(state, fresh(source)[1])
    out["drills"] = drills
    return out


def _state_digests(state) -> dict | None:
    """The digests of what a checkpoint would write of a rank's state (None
    on a rank outside the plan)."""
    from metis_tpu_torch.execution import checkpoint as ckpt

    if state is None:
        return None
    return ckpt.tree_digests(ckpt._digest_tree(ckpt._snapshot(state)))


def live_reshard_rank(rank: int, device: torch.device, cfg: GPTConfig,
                      batches, plans: list[str], directory: str) -> dict:
    """Rank body for ``execution.dist.spawn``: a live reshard held against
    a checkpoint restore.  Train ``plans[0]`` (artifact JSON, every rank)
    on ``batches[:2]``; then for each next plan (on the launch's first
    ranks; the others only send): checkpoint the current state, reshard it
    live onto the plan (``execute_reshard``) and take a step on
    ``batches[2]``, restore the checkpoint onto a fresh state of the plan
    and take the same step.  Returns per leg the ``report``, both steps'
    ``losses`` and the ``digests`` of the rank's state after them (the
    same plan, so the same tensors on each rank: ``checkpoint.tree_digests``
    of what a checkpoint would write), the save and restore ms and the
    kernels' launches of the live step; the next leg starts from the live
    state."""
    from metis_tpu_torch.execution import checkpoint as ckpt
    from metis_tpu_torch.execution import reshard

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    art = PlanArtifact.from_json(plans[0])
    exe = build_executable(cfg, art, device)
    state = exe.init(0)
    for tokens, targets in batches[:2]:
        state, loss = exe.step(state, tokens.to(device), targets.to(device))
    loss.item()
    tokens, targets = (t.to(device) for t in batches[2])
    out = {"legs": []}
    for i, plan in enumerate(plans[1:]):
        path = f"{directory}/leg{i}"
        t0 = time.perf_counter()
        ckpt.save_checkpoint(path, state, art)
        leg = {"save_ms": (time.perf_counter() - t0) * 1e3}
        art = PlanArtifact.from_json(plan)
        dst = build_executable(cfg, art, device)
        live, leg["report"] = reshard.execute_reshard(
            state, dst.init(1) if dst is not None else None, step=state.step)
        del state
        gc.collect()
        fa.reset_launch_counts()
        if dst is not None:
            live, loss = dst.step(live, tokens, targets)
            leg["losses"] = [loss.item()]
        leg["launches"] = dict(fa.launch_counts)
        leg["digests"] = [_state_digests(live)]
        fresh = dst.init(1) if dst is not None else None
        sync()
        t0 = time.perf_counter()
        leg["restore_stats"] = {}
        restored = ckpt.restore_checkpoint(path, fresh, stats=leg["restore_stats"])
        sync()
        leg["restore_ms"] = (time.perf_counter() - t0) * 1e3
        if dst is not None:
            restored, loss = dst.step(restored, tokens, targets)
            leg["losses"].append(loss.item())
        leg["digests"].append(_state_digests(restored))
        del restored, fresh
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out["legs"].append(leg)
        state = live
    return out


def train_ranks(rank: int, device: torch.device, jobs: list[dict]) -> list:
    """Rank body: the ``train`` subcommand's rank body (``cli.train_rank``)
    for each of ``jobs`` (``cli.train_job``'s) in turn, one launch for
    several runs; each run's ``{"rc", "summary"}``."""
    from metis_tpu_torch.cli import train_rank

    out = []
    for job in jobs:
        out.append(train_rank(rank, device, job))
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def capture_first_grads(state, kind: str) -> dict:
    """A tree, filled when the first optimizer step starts (every route
    sets each leaf's reduced ``.grad`` just before it), of the gradients or
    their norms (``kind``: ``"arrays"`` or ``"norms"``)."""
    if kind not in ("arrays", "norms"):
        raise ValueError(f"first_grads={kind!r}: expected 'arrays' or 'norms'")
    tree: dict = {}

    def hook(optimizer, args, kwargs):
        for (group, name), leaf in state.opt_leaves().items():
            g = leaf.grad.detach()
            tree.setdefault(group, {})[name] = (
                g.norm().item() if kind == "norms"
                else np.array(g.cpu(), copy=True))
        handle.remove()

    handle = state.optimizer.register_step_pre_hook(hook)
    return tree


def run_plans_rank(rank: int, device: torch.device, jobs: list[dict]) -> list:
    """Rank body that runs several plans in one launch, one after another,
    to share the launch's start-up: each job is the keyword arguments of
    ``run_plan_rank``.  Each job's state is freed before the next starts."""
    out = []
    for job in jobs:
        out.append(run_plan_rank(rank, device, **job))
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _rank_rows(tokens: torch.Tensor, cfg: GPTConfig, mesh, device):
    """This rank's rows of ``tokens`` on ``device``, and the config they
    run under (an MoE's routing groups those of the whole batch)."""
    ep, ranks = mesh.size(EP), mesh.size(DP) * mesh.size(EP)
    if family_ops(cfg).moe and ranks > 1:
        cfg, _ = aligned_routing(cfg, tokens.numel(), tokens.numel() // ranks)
    mine = slice_leaf(tokens, batch_spec((DP, EP) if ep > 1 else DP),
                      mesh.slots()).to(device)
    return mine, cfg


def _router_input(params: dict, tokens: torch.Tensor, cfg: MoEConfig, tp_group):
    """The first MoE block's router input of ``tokens``: the layer norm
    after its attention half, ``[rows, seq, h]``, and the block's layer."""
    from metis_tpu_torch.models import resolve_attention
    from metis_tpu_torch.models.gpt import (
        _layer_norm, attention_residual, embed, unstack_blocks)

    layer = unstack_blocks(params["blocks"])[0]
    x = attention_residual(embed(params, tokens, cfg, tp_group), layer, cfg,
                           resolve_attention(cfg), tp_group)
    return _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"]), layer


def forward_routing(exe, state, tokens: torch.Tensor) -> dict:
    """The first MoE block's routing decisions as ``exe.forward`` of the
    full batch ``tokens`` makes them on this rank (``expert_idx``,
    ``position``, ``keep``, each ``[groups, group length, top_k]``, as
    numpy): the groups of the rank's own tokens, or, where it shares its
    groups with other ranks (``shared`` true), those of the tokens it
    gathered; ``ties``, how many of those tokens' top ``k + 1`` router
    probabilities hold two equal values (where two runs may choose
    differently)."""
    from metis_tpu_torch.models import moe

    route, ffn = moe.route_logits, moe.moe_ffn
    first: dict = {}

    def record_route(*args, **kwargs):
        r = route(*args, **kwargs)
        if "keep" not in first:
            first.update({k: r[k].cpu().numpy()
                          for k in ("expert_idx", "position", "keep")})
            k = r["expert_idx"].shape[-1]
            top = r["probs"].topk(min(k + 1, r["probs"].shape[-1]), -1).values
            first["ties"] = int((top[..., 1:] == top[..., :-1]).any(-1).sum())
        return r

    def record_ffn(*args, **kwargs):
        # moe_block_forward passes every argument by position
        first.setdefault("shared", (args[7] if len(args) > 7
                                    else kwargs.get("shared")) is not None)
        return ffn(*args, **kwargs)

    with mock.patch.object(moe, "route_logits", record_route), \
            mock.patch.object(moe, "moe_ffn", record_ffn):
        exe.forward(state, tokens)
    return first


def moe_routing(params: dict, tokens: torch.Tensor, cfg: MoEConfig, mesh,
                device: torch.device) -> dict:
    """The first MoE block's routing decisions (``expert_idx``,
    ``position``, ``keep``, each ``[groups, group length, top_k]``) for this
    rank's rows of ``tokens``, as numpy: the decisions of two runs of the
    same weights and tokens on different meshes compare one for one."""
    from metis_tpu_torch.models.moe import _route_group_len, route

    mine, cfg = _rank_rows(tokens, cfg, mesh, device)
    with torch.no_grad():
        y, layer = _router_input(params, mine, cfg, mesh.group(TP))
        T = y.shape[0] * y.shape[1]
        g = _route_group_len(T, cfg.route_group_size)
        r = route(y.reshape(T // g, g, -1), layer["router"], cfg)
    return {k: r[k].cpu().numpy() for k in ("expert_idx", "position", "keep")}


def stage_moe_routing(params: dict, tokens: torch.Tensor, cfg: MoEConfig,
                      replica_rows, device: torch.device) -> dict:
    """The first MoE block's routing decisions of ``tokens`` (``[rows,
    seq]``, the whole model's ``params``) as an MoE stage whose one program
    of replicas runs ``replica_rows`` rows routes them
    (``execution/stages.py``): uneven rows padded to the largest count with
    masked rows, in the groups of the padded tokens
    (``train.aligned_routing``).  The real tokens' ``expert_idx``,
    ``position`` and ``keep``, each ``[tokens, top_k]``, in row order."""
    from metis_tpu_torch.models.moe import route

    rows = [int(r) for r in replica_rows]
    width, n = max(rows), len(rows)
    with torch.no_grad():
        y, layer = _router_input(params, tokens.to(device), cfg, None)
        seq, h = y.shape[1], y.shape[2]
        g = aligned_routing(cfg, n * width * seq, width * seq)[0].route_group_size
        out: dict = {k: [] for k in ("expert_idx", "position", "keep")}
        start = 0
        for r in rows:
            part = y.new_zeros((width, seq, h))
            part[:r] = y[start:start + r]
            valid = None
            if len(set(rows)) > 1:
                valid = torch.zeros(width * seq, device=device)
                valid[:r * seq] = 1
                valid = valid.reshape(-1, g)
            dec = route(part.reshape(-1, g, h), layer["router"], cfg, valid)
            for k in out:
                out[k].append(dec[k].reshape(width * seq, -1)[:r * seq])
            start += r
    return {k: torch.cat(v).cpu().numpy() for k, v in out.items()}


def attention_rank(rank: int, device: torch.device, jobs: list[dict]) -> list:
    """Rank body: ``_attention_job(**job)`` for each of ``jobs``."""
    return [_attention_job(device, **job) for job in jobs]


def _attention_job(device: torch.device, mode: str, shape, q, k, v,
                   dout) -> dict:
    """Context-parallel attention of ``mode`` (``"ring"``, the
    flash ring; ``"ring_dense"``; ``"a2a"``, Ulysses) on a ``(cp, tp)``
    grid (``shape``) of the current process group.  Each rank takes its
    tp block of the heads and cp block of the sequence of the full ``[b, h,
    s, d]`` host tensors ``q``, ``k``, ``v`` and the output gradient
    ``dout``, and returns its blocks of the output and of dq, dk, dv, and
    ``calls``: how often the ring called each kernel wrapper on this rank
    (the wrappers count launches on the card only)."""
    from metis_tpu_torch.models import resolve_attention
    from metis_tpu_torch.models.gpt import GPTConfig
    from metis_tpu_torch.ops import ring_attention
    from metis_tpu_torch.ops.ring_attention import make_ring_attention

    mesh = _grid(tuple(shape), (SP, TP))
    spec = (None, TP, SP, None)

    def mine(t):
        return slice_leaf(t, spec, mesh.slots()).to(device).requires_grad_()

    qs, ks, vs = mine(q), mine(k), mine(v)
    if mode == "ring_dense":
        attn = make_ring_attention(mesh.group(SP), impl="dense")
    else:
        cfg = GPTConfig(vocab_size=1, seq_len=q.shape[2], hidden=1,
                        num_heads=1, num_blocks=1, attn="flash")
        attn = resolve_attention(cfg, mesh.group(SP), mode)
    calls: Counter = Counter()

    def counted(name):
        fn = getattr(ring_attention, name)

        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    names = ("flash_attention_stats", "fa_bwd_dq", "fa_bwd_dkv")
    with mock.patch.multiple(ring_attention, **{n: counted(n) for n in names}):
        out = attn(qs, ks, vs)
        out.backward(slice_leaf(dout, spec, mesh.slots()).to(device))
    host = [t.detach().cpu().numpy() for t in (out, qs.grad, ks.grad, vs.grad)]
    return {"slots": mesh.slots(), "out": host[0], "dq": host[1],
            "dk": host[2], "dv": host[3], "calls": dict(calls)}


def pool_probe_rank(rank: int, device: torch.device, fail_on: int | None = None) -> dict:
    """Rank body that reports the state it started in (the default
    generator's first draw, the kernel launch counts), then draws and
    counts itself; it raises on rank ``fail_on``."""
    out = {"draw": torch.rand(1).item(), "launches": dict(fa.launch_counts)}
    fa.launch_counts["fa_fwd"] += 1
    if rank == fail_on:
        raise ValueError(f"rank {rank} fails on purpose")
    return out


def failure_paths_rank(rank: int, device: torch.device, local: bool = False) -> dict:
    """Rank body for the failure paths of a run across ranks: a rank outside
    a one-device hetero plan asking for its train step; a search that raises
    on rank 0 (``resilience.supervisor._on_rank0``); a supervised run whose
    loop fails on every rank together.  With ``local`` the loop fails on
    rank 1 alone instead (rank 0's returns after a second)."""
    from types import SimpleNamespace

    from metis_tpu_torch.core.errors import MetisError, TrainingAnomalyError
    from metis_tpu_torch.execution.hetero import StageSpec, make_hetero_train_step
    from metis_tpu_torch.resilience import supervisor as sv

    cfg = GPTConfig(vocab_size=64, seq_len=8, hidden=16, num_heads=2, num_blocks=1,
                    dtype=torch.float32)
    out = {}

    def run_failing(err):
        sup = sv.TrainingSupervisor(
            SimpleNamespace(total_devices=2), None, None, None,
            checkpoint_dir="unused", steps=1, device=device)

        def loop(*_):
            if err is not None:
                raise err
            time.sleep(1.0)
        sup._run_loop = loop
        report = sup.run()
        return report.outcome, report.detail

    if local:
        out["local"] = run_failing(MetisError("rank 1 fails alone") if rank == 1
                                   else None)
        return out
    try:
        make_hetero_train_step(cfg, [StageSpec(blocks=(0, 1), has_embed=True,
                                               has_head=True, dp=1, tp=1)], device)
        out["outside_plan"] = None
    except MetisError as e:
        out["outside_plan"] = str(e)

    def search():
        raise ValueError("the search fails on rank 0")
    try:
        sv._on_rank0(search)
        out["on_rank0"] = None
    except Exception as e:  # noqa: BLE001 — the test reads what was raised
        out["on_rank0"] = (type(e).__name__, str(e), getattr(e, "on_every_rank", False))
    out["agreed"] = run_failing(sv._on_every_rank(TrainingAnomalyError("recoveries exhausted")))
    return out
