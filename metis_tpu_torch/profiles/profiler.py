"""Measured profiler — the port of ``metis_tpu/profiles/profiler.py``.

Each profiled layer (embedding pseudo-layer, one transformer block, LM-head
pseudo-layer) runs as its own forward + backward closure on the device and
is timed; the per-layer vector is then normalized so its sum equals the
measured whole-model forward + backward time (only the ratios of the
isolated closures are trusted, as in the reference).  On the default
``marginal_blocks=True`` path the block time is the marginal cost of a
2-block vs 1-block run, so per-call launch overhead cancels, and the
embed/head closures have that same overhead (``2*t1 - t2``) subtracted,
floored at 10% of the raw measurement.

Timing on CUDA uses the two-point queue form (``core/timing.py``): kernels
queue on one stream and run in order.  On the CPU each call is timed
synchronously and the median taken.  Memory on CUDA is the peak allocated
during each closure (``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats``) plus the bytes of the closure's inputs — the
reference's compiled arguments + temporaries + outputs.  On the CPU the
analytic model stands in.

``tp = 1`` runs in the calling process.  A larger tp runs as a job of tp
ranks (``execution.dist.spawn``, one per device of the profiler's device
list), each on its Megatron shards of the model with the collectives of
``models/parallel.py`` (the reference profiles each tp on a (1, tp) mesh):
every time is the maximum over the ranks, every memory row a per-rank peak
(the maximum over ranks, as XLA's per-device analysis in the reference), and
rank 0's result enters the store.  Before the job starts the calling process
drops its own parameters and returns its cached blocks to the card, since
rank 0 shares the first device with it.  A tp above the device list's length
is skipped with a ``profile_skipped`` event.  The device list defaults to one
device on the CPU and every visible card on CUDA; the ranks' process group
is NCCL on CUDA and gloo on the CPU.
Decode-mode profiling comes with a later slice.
"""
from __future__ import annotations

import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from metis_tpu_torch.core.config import ModelSpec
from metis_tpu_torch.core.device import resolve_device
from metis_tpu_torch.core.errors import MetisError
from metis_tpu_torch.core.events import NULL_LOG, EventLog
from metis_tpu_torch.core.timing import two_point_queue_ms
from metis_tpu_torch.execution.mesh import (
    TP,
    ProcessMesh,
    mesh_dp_tp,
)
from metis_tpu_torch.execution.train import (
    build_optimizer,
    init_params_for,
    loss_fn_for,
    param_leaves,
    param_specs_for,
)
from metis_tpu_torch.models import (
    config_for_model_spec,
    family_ops,
    resolve_attention,
)
from metis_tpu_torch.models.gpt import GPTConfig, unstack_blocks
from metis_tpu_torch.models.parallel import vocab_parallel_cross_entropy
from metis_tpu_torch.profiles.store import (
    DeviceTypeMeta,
    LayerProfile,
    ModelProfileMeta,
    ProfileStore,
)

_MB = 1024 * 1024


@dataclass(frozen=True)
class ProfilerConfig:
    """Measurement knobs.  ``marginal_blocks``: measure the block time as
    the difference between a 2-block and a 1-block run (see module doc)."""

    warmup: int = 2
    iters: int = 5
    seed: int = 0
    marginal_blocks: bool = True


def infer_device_type(device: str | torch.device = "cuda") -> str:
    """Profile-key device type: the model code in the CUDA device name
    ('NVIDIA H100 80GB HBM3' -> 'H100'), or 'CPU'."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "CPU"
    name = torch.cuda.get_device_name(dev)
    m = re.search(r"\b([A-Z]+\d+)", name)
    # filenames embed this key (DeviceType.{key}_tp..), keep it word-safe
    return m.group(1) if m else "".join(c for c in name if c.isalnum()) or "GPU"


def _median_ms(fn: Callable, args: tuple, warmup: int, iters: int,
               device: torch.device) -> float:
    """Wall time of ``fn(*args)`` in ms, after warmup, fully synced.

    CPU: per-call medians.  CUDA: the two-point queue form with
    ``torch.cuda.synchronize`` as the fence."""
    fn(*args)
    if device.type == "cpu":
        for _ in range(max(warmup - 1, 0)):
            fn(*args)
        samples = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            samples.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(samples))

    def enqueue(n: int):
        for _ in range(n):
            fn(*args)

    return two_point_queue_ms(enqueue, iters,
                              sync=lambda _: torch.cuda.synchronize(device))


def _analytic_memory_mb(param_bytes: float, act_bytes: float, tp: int) -> float:
    """Memory model where no measurement exists (the CPU): sharded weights +
    fp32 Adam state (master + 2 moments over bf16: x6) + live activations."""
    return (param_bytes / tp * 7.0 + act_bytes) / _MB


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _param_bytes(tree: dict) -> int:
    return _tensor_bytes(tree.values())


def _leaf_copies(blocks: dict, k: int, stacked: bool = True) -> dict:
    """The first ``k`` blocks as trainable leaves of their own (a single
    unstacked layer when ``stacked`` is False), so a closure's backward
    produces gradients of exactly those blocks — not of the whole stack,
    as a view into it would."""
    return {name: (leaf[:k] if stacked else leaf[0]).detach().clone()
            .requires_grad_() for name, leaf in blocks.items()}


class LayerProfiler:
    """Profiles one model shape (GPT, LLaMA or MoE, ``config_for_model_spec``)
    across (tp, bs): tp 1 on ``device``, larger tps on ranks over
    ``devices``."""

    def __init__(
        self,
        model: ModelSpec,
        device_type: str | None = None,
        device: str | torch.device = "cuda",
        config: ProfilerConfig = ProfilerConfig(),
        dtype: torch.dtype = torch.bfloat16,
        events: EventLog = NULL_LOG,
        devices: Sequence | None = None,
    ):
        from metis_tpu_torch.execution import dist as mdist

        self.model = model
        self.device = resolve_device(device)
        self.devices = list(devices if devices is not None
                            else mdist.default_devices(self.device))
        self.device_type = device_type or infer_device_type(self.device)
        self.config = config
        self.dtype = dtype
        self.cfg = config_for_model_spec(model, dtype=dtype)
        self.events = events
        self._params: dict | None = None
        self._mesh: ProcessMesh | None = None

    def _tp_group(self):
        return self._mesh.group(TP) if self._mesh is not None else None

    def _model_params(self) -> dict:
        """One seeded parameter set (this rank's shards on a tp rank),
        shared by every measurement."""
        if self._params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.config.seed)
            params = init_params_for(gen, self.cfg, self.device, self._mesh)
            for leaf in param_leaves(params):
                leaf.requires_grad_(True)
            self._params = params
        return self._params

    # -- per-layer closures -------------------------------------------------
    def _make_layer_fns(self, cfg: GPTConfig):
        """(embed_fb, block_fb, head_fb, scan_fb): each runs forward plus the
        gradients of its parameters and input activations, with the
        family's pieces (LLaMA's embedding has no positions and its head is
        RMSNorm; an MoE block's aux loss joins the measured graph)."""
        attn = resolve_attention(cfg)
        group = self._tp_group()
        family = family_ops(cfg)
        embed, block, head_logits, moe = (family.embed, family.block,
                                          family.head_logits, family.moe)

        def run_block(x, layer):
            """(output, aux loss): MoE's aux, else None."""
            out = block(x, layer, cfg, attn, group)
            return out if moe else (out, None)

        def total(y, aux):
            out = y.float().sum()
            return out if aux is None else out + aux

        def embed_fb(embed_params, tokens):
            out = embed({"embed": embed_params}, tokens, cfg, group).float().sum()
            return torch.autograd.grad(out, list(embed_params.values()))

        def block_fb(layer, x):
            return torch.autograd.grad(total(*run_block(x, layer)),
                                       [*layer.values(), x])

        def scan_fb(layers, x):
            """fwd+bwd of a k-block run — the marginal-cost probe body (MoE:
            the blocks' aux losses summed in, as the reference's scan)."""
            y, aux = x, None
            for layer in unstack_blocks(layers):
                y, a = run_block(y, layer)
                aux = a if aux is None else aux + a
            return torch.autograd.grad(total(y, aux), [*layers.values(), x])

        def head_fb(head_params, x, targets):
            logits = head_logits({"head": head_params}, x, cfg, group)
            loss = vocab_parallel_cross_entropy(
                logits.reshape(-1, logits.shape[-1]), targets.reshape(-1), group)
            return torch.autograd.grad(loss, [*head_params.values(), x])

        return embed_fb, block_fb, head_fb, scan_fb

    def _peak_memory_mb(self, fn: Callable, args: tuple, arg_bytes: int
                        ) -> float | None:
        """Peak bytes one call of ``fn`` allocates beyond what was live, plus
        its inputs' bytes; None off CUDA."""
        if self.device.type != "cuda":
            return None
        torch.cuda.synchronize(self.device)
        base = torch.cuda.memory_allocated(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        out = fn(*args)
        torch.cuda.synchronize(self.device)
        peak = torch.cuda.max_memory_allocated(self.device)
        del out
        return (peak - base + arg_bytes) / _MB

    def _profile_one(self, tp: int, bs: int) -> LayerProfile:
        cfg, model, dev = self.cfg, self.model, self.device
        params = self._model_params()
        gen = torch.Generator(device=dev).manual_seed(self.config.seed)
        tokens = torch.randint(0, cfg.vocab_size, (bs, cfg.seq_len),
                               generator=gen, device=dev)
        x = torch.randn((bs, cfg.seq_len, cfg.hidden), generator=gen,
                        device=dev).to(cfg.dtype).requires_grad_()
        layer0 = _leaf_copies(params["blocks"], 1, stacked=False)
        embed_fb, block_fb, head_fb, scan_fb = self._make_layer_fns(cfg)
        embed_p, head_p = params["embed"], params["head"]
        w, it = self.config.warmup, self.config.iters

        def timed(fn, *args):
            return _median_ms(fn, args, w, it, dev)

        marginal = self.config.marginal_blocks and cfg.num_blocks >= 2
        layers1 = _leaf_copies(params["blocks"], 1) if marginal else None
        layers2 = _leaf_copies(params["blocks"], 2) if marginal else None
        # whole-model fwd+bwd — the ground truth the decomposition sums to
        loss_fn, group = loss_fn_for(cfg), self._tp_group()
        leaves = param_leaves(params)

        def full_fb(tokens):
            return torch.autograd.grad(
                loss_fn(params, tokens, tokens, cfg, tp_group=group), leaves)

        raw = [timed(embed_fb, embed_p, tokens), timed(head_fb, head_p, x, tokens),
               timed(block_fb, layer0, x),
               timed(scan_fb, layers1, x) if marginal else 0.0,
               timed(scan_fb, layers2, x) if marginal else 0.0,
               timed(full_fb, tokens)]
        # a tp job's time is its slowest rank's
        embed_ms, head_ms, iso_block_ms, t1, t2, full_ms = self._max_over_ranks(raw)

        block_ms = iso_block_ms
        if marginal and t2 > t1:
            # marginal block cost: 2 blocks minus 1 — per-call overhead
            # cancels.  t1 = overhead + one block, so overhead = 2*t1 - t2;
            # bound it by the isolated block's own excess over the marginal
            # time, and floor the adjusted pseudo-layers at 10% of their raw
            # time
            block_ms = t2 - t1
            overhead = max(min(2 * t1 - t2, iso_block_ms - block_ms), 0.0)
            embed_ms = max(embed_ms - overhead, 0.1 * embed_ms)
            head_ms = max(head_ms - overhead, 0.1 * head_ms)
        raw = [embed_ms] + [block_ms] * cfg.num_blocks + [head_ms]
        scale = full_ms / sum(raw)
        times = [t * scale for t in raw]

        s, h, v = cfg.seq_len, cfg.hidden, cfg.vocab_size
        act_block = 10 * bs * s * h * model.dtype_bytes / tp
        act_head = bs * s * v * model.dtype_bytes / tp
        pbytes = self._params_per_layer_bytes(params, tp)
        mem_embed = self._peak_memory_mb(
            embed_fb, (embed_p, tokens), _param_bytes(embed_p) + _tensor_bytes([tokens]))
        mem_block = self._peak_memory_mb(
            block_fb, (layer0, x), _param_bytes(layer0) + _tensor_bytes([x]))
        mem_head = self._peak_memory_mb(
            head_fb, (head_p, x, tokens),
            _param_bytes(head_p) + _tensor_bytes([x, tokens]))
        if mem_embed is not None:
            mem_embed, mem_block, mem_head = self._max_over_ranks(
                [mem_embed, mem_block, mem_head])
        mems = [mem_embed if mem_embed is not None
                else _analytic_memory_mb(pbytes[0], act_block, tp)]
        mems += [mem_block if mem_block is not None
                 else _analytic_memory_mb(pbytes[1], act_block, tp)] * cfg.num_blocks
        mems += [mem_head if mem_head is not None
                 else _analytic_memory_mb(pbytes[-1], act_head, tp)]
        return LayerProfile(layer_times_ms=tuple(times),
                            layer_memory_mb=tuple(mems), fb_sync_ms=0.0)

    def _max_over_ranks(self, values: list[float]) -> list[float]:
        """Each value's maximum over the tp job's ranks (itself at tp 1)."""
        if self._mesh is None:
            return values
        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t.tolist()

    def _params_per_layer_bytes(self, params: dict, tp: int = 1) -> tuple[int, ...]:
        """Parameter bytes per profiled layer (embed, blocks..., head) — the
        ``parameters_per_layer_bytes`` contract field, counted over the whole
        model as the reference counts global array sizes; ``params`` are the
        shards of a ``tp`` rank (full leaves at tp 1)."""
        specs = param_specs_for(self.cfg, tp)

        def global_bytes(group: str) -> int:
            return sum(_tensor_bytes([leaf]) * (tp if TP in specs[group][name] else 1)
                       for name, leaf in params[group].items())

        embed_b = global_bytes("embed")
        blocks_b = global_bytes("blocks") // self.cfg.num_blocks
        head_b = global_bytes("head")
        return tuple([embed_b] + [blocks_b] * self.cfg.num_blocks + [head_b])

    def _profile_optimizer_ms(self) -> float:
        """AdamW update time over the whole model's parameters (all-ones
        gradients), with the optimizer the executor runs.  The updates move
        the shared parameters, which every timing has already used."""
        leaves = param_leaves(self._model_params())
        for leaf in leaves:
            leaf.grad = torch.ones_like(leaf)
        opt = build_optimizer()(leaves)
        try:
            return _median_ms(opt.step, (), self.config.warmup,
                              self.config.iters, self.device)
        finally:
            opt.zero_grad(set_to_none=True)

    def _profile_batch_gen_ms(self, bs: int) -> float:
        """Host batching through the port's input pipeline plus the
        host-to-device copy — the loader that feeds training."""
        from metis_tpu_torch.data.pipeline import TokenDataset, batch_source

        n_batches = self.config.warmup + 3 * self.config.iters + 2
        ds = TokenDataset.synthetic(
            self.cfg.vocab_size, bs * n_batches * self.cfg.seq_len + 1,
            self.cfg.seq_len, seed=self.config.seed)
        gen = batch_source(ds, bs, device=self.device)
        return _median_ms(gen, (), self.config.warmup, self.config.iters,
                          self.device)

    # -- public API ---------------------------------------------------------
    def run(self, tps: Sequence[int] = (1,),
            bss: Sequence[int] = (1,)) -> ProfileStore:
        """Profile every (tp, bs) the device list can measure into a
        ProfileStore; a tp that does not divide the heads or exceeds the
        device list is skipped with an event."""
        n_dev = len(self.devices)
        self.events.emit(
            "profile_started", device_type=self.device_type,
            model=self.model.name, tps=list(tps), bss=list(bss), devices=n_dev)
        entries: dict[tuple[str, int, int], LayerProfile] = {}
        t_run = time.perf_counter()
        for tp in tps:
            if self.cfg.num_heads % tp != 0 or tp > n_dev:
                self.events.emit(
                    "profile_skipped", device_type=self.device_type, tp=tp,
                    reason=(f"tp={tp} does not divide {self.cfg.num_heads} heads"
                            if self.cfg.num_heads % tp
                            else f"tp={tp} exceeds {n_dev} device(s)"))
                continue
            if tp == 1:
                measured = []
                for bs in bss:
                    t_cfg = time.perf_counter()
                    measured.append((self._profile_one(1, bs),
                                     time.perf_counter() - t_cfg))
            else:
                measured = self._profile_tp_job(tp, bss)
            for bs, (prof, wall_s) in zip(bss, measured):
                entries[(self.device_type, tp, bs)] = prof
                self.events.emit(
                    "profile_measured", device_type=self.device_type,
                    tp=tp, bs=bs,
                    full_model_ms=round(sum(prof.layer_times_ms), 4),
                    max_layer_memory_mb=round(max(prof.layer_memory_mb), 2),
                    wall_s=round(wall_s, 3))
        if not entries:
            raise MetisError(
                f"no (tp, bs) combination profileable on {n_dev} device(s); "
                f"requested tps={list(tps)}")

        pbytes = self._params_per_layer_bytes(self._model_params())
        opt_ms = self._profile_optimizer_ms()
        bg_ms = self._profile_batch_gen_ms(max(bss))
        self.events.emit(
            "profile_finished", device_type=self.device_type,
            num_configs=len(entries), optimizer_ms=round(opt_ms, 4),
            batch_gen_ms=round(bg_ms, 4),
            wall_s=round(time.perf_counter() - t_run, 3))
        meta = ModelProfileMeta(
            num_layers=self.cfg.num_profile_layers,
            optimizer_time_ms=opt_ms,
            batch_generator_ms=bg_ms,
            params_per_layer_bytes=pbytes,
        )
        type_meta = {self.device_type: DeviceTypeMeta(opt_ms, bg_ms)}
        return ProfileStore(entries, meta, type_meta)

    def _profile_tp_job(self, tp: int, bss: Sequence[int]) -> list:
        """``(LayerProfile, wall seconds)`` per bs from a job of ``tp`` ranks
        on the first ``tp`` devices — rank 0's, which carries every rank's
        maximum."""
        from metis_tpu_torch.execution import dist as mdist

        # rank 0 runs on the first device, beside this process: hand it the
        # memory of the tp 1 measurements (rebuilt from the seed afterwards)
        self._params = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        devices = self.devices[:tp]
        ranks = mdist.spawn(_profile_tp_rank, tp, mdist.default_backend(devices),
                            devices, self.model, self.device_type, self.config,
                            self.dtype, tp, tuple(bss))
        return ranks[0]


def _profile_tp_rank(rank: int, device: torch.device, model: ModelSpec,
                     device_type: str, config: ProfilerConfig,
                     dtype: torch.dtype, tp: int, bss: tuple) -> list:
    """Rank body of a tp profiling job (``execution.dist.spawn``): this
    rank's shards on a (dp 1, tp) mesh, each bs measured in step with the
    other ranks."""
    prof = LayerProfiler(model, device_type, device, config, dtype)
    prof._mesh = mesh_dp_tp(1, tp)
    out = []
    for bs in bss:
        t0 = time.perf_counter()
        out.append((prof._profile_one(tp, bs), time.perf_counter() - t0))
    return out


def profile_model(
    model: ModelSpec,
    tps: Sequence[int] = (1,),
    bss: Sequence[int] = (1,),
    device_type: str | None = None,
    device: str | torch.device = "cuda",
    config: ProfilerConfig = ProfilerConfig(),
    events: EventLog = NULL_LOG,
    devices: Sequence | None = None,
) -> ProfileStore:
    """One-call measured profiling (see :class:`LayerProfiler`).
    ``devices``: the ranks' devices of a tp > 1 job (default: one device on
    the CPU, every visible card on CUDA)."""
    return LayerProfiler(model, device_type, device, config, events=events,
                         devices=devices).run(tps, bss)


def profile_to_dir(
    model: ModelSpec,
    out_dir: str | Path,
    tps: Sequence[int] = (1,),
    bss: Sequence[int] = (1,),
    device_type: str | None = None,
    device: str | torch.device = "cuda",
    config: ProfilerConfig = ProfilerConfig(),
) -> list[Path]:
    """Profile and write reference-schema JSON files."""
    store = profile_model(model, tps, bss, device_type, device, config)
    return store.dump_to_dir(
        out_dir, {"model_name": model.name, "attn": model.attn})
