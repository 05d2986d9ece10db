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
    (None: not split; absent without ZeRO, or on a stage without it)."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if stages is not None:
        exe = hetero_executable(cfg, stages, microbatches, device, **build)
    else:
        exe = build_executable(cfg, PlanArtifact.from_json(artifact_json),
                               device, **build)
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
