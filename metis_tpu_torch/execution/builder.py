"""PlanArtifact -> executable training step — the port of
``metis_tpu/execution/builder.py``.

This slice realizes the ``pp == 1`` routes: one device outside a process
group (``kind="single_device"``), and the reference's GSPMD route
(``kind="gspmd"``) inside a process group of the plan's size — Megatron
tensor parallelism plus data-parallel gradient averaging, one rank per
device, started by ``execution.dist.spawn``.  Pipelined plans, hetero stages
and the strategy axes zero / sp / cp / ep raise ``NotImplementedError``
naming the later slice.

The path is normalized to ``(init, step)`` as in the reference:
``init(seed) -> state`` and ``step(state, tokens, targets) -> (state, loss)``
on full-batch ``[gbs, seq]`` token tensors (each rank of a mesh runs its dp
rows of them).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist

from metis_tpu_torch.core.device import resolve_device
from metis_tpu_torch.core.errors import MetisError
from metis_tpu_torch.execution.mesh import DP, PP, TP, PlanArtifact, ProcessMesh
from metis_tpu_torch.execution.train import build_train_state, make_train_step
from metis_tpu_torch.models.gpt import GPTConfig


@dataclass(frozen=True)
class Executable:
    """A plan realized: which path runs it, plus the normalized step API."""

    kind: str  # "single_device" or "gspmd"
    init: Callable
    step: Callable
    mesh: ProcessMesh | None = None


def build_executable(cfg: GPTConfig, artifact: PlanArtifact,
                     device: str | torch.device = "cuda",
                     optimizer=None) -> Executable:
    """Route ``artifact`` to the execution path that realizes it."""
    dev = resolve_device(device)
    if artifact.schedule not in ("gpipe", "1f1b", "interleaved"):
        raise ValueError(f"unknown pipeline schedule {artifact.schedule!r}")
    strategies = [dict(s) for s in artifact.strategies]
    if artifact.mesh_shape and PP in artifact.mesh_axes:
        pp = artifact.mesh_shape[artifact.mesh_axes.index(PP)]
    else:
        pp = len(strategies)
    if not artifact.mesh_shape or pp > 1 or len(strategies) != 1:
        raise NotImplementedError(
            "pipelined and hetero plans run on the pipeline / hetero "
            "executors of a later slice; this slice runs pp == 1")
    s0 = strategies[0]
    defaults = {"cp": 1, "ep": 1, "zero": 0, "sp": False}
    extras = {k: s0[k] for k, v in defaults.items() if s0.get(k, v) != v}
    if extras:
        raise NotImplementedError(
            f"strategy axes {extras} come with later slices (context and "
            "expert parallelism, ZeRO, sequence parallelism)")
    if dist.is_initialized():
        return _gspmd_executable(cfg, artifact, dev, optimizer)
    if artifact.num_devices != 1:
        raise MetisError(
            f"mesh {dict(zip(artifact.mesh_axes, artifact.mesh_shape))} needs "
            f"{artifact.num_devices} ranks; run it through the launcher "
            "(metis_tpu_torch.execution.dist.spawn), one rank per device, "
            "and build it on every rank")
    return _single_device_executable(cfg, dev, optimizer)


def _single_device_executable(cfg, device, optimizer) -> Executable:
    def init(seed: int):
        return build_train_state(seed, cfg, device=device, optimizer=optimizer)

    return Executable(kind="single_device", init=init,
                      step=make_train_step(cfg))


def _gspmd_executable(cfg, artifact, device, optimizer) -> Executable:
    mesh = artifact.build_mesh()
    dp, tp = mesh.size(DP), mesh.size(TP)
    if artifact.gbs % dp:
        raise ValueError(f"gbs {artifact.gbs} does not split over dp = {dp}")
    for what, n in (("heads", cfg.num_heads), ("vocab rows", cfg.vocab_size),
                    ("ffn units", cfg.ffn_dim)):
        if n % tp:
            raise ValueError(f"{n} {what} do not split over tp = {tp}")

    def init(seed: int):
        return build_train_state(seed, cfg, device=device, optimizer=optimizer,
                                 mesh=mesh)

    return Executable(kind="gspmd", init=init,
                      step=make_train_step(cfg, mesh=mesh), mesh=mesh)

