"""The plan artifact — the port's copy of ``PlanArtifact`` from
``metis_tpu/execution/mesh.py`` (the JSON contract between planner and
executor).

This slice executes on one device, so there is no device mesh: an artifact
whose mesh needs more than one device raises ``NotImplementedError``.
Multi-device plans (dp x tp over NCCL, pipelines, hetero stages) come with
later slices.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

from metis_tpu_torch.core.types import UniformPlan

PP, DP, TP, SP, EP = "pp", "dp", "tp", "sp", "ep"


@dataclass(frozen=True)
class PlanArtifact:
    """Serializable chosen plan — the bridge from search to execution.  The
    JSON is byte-compatible with the reference's, both ways."""

    mesh_axes: tuple[str, ...]
    mesh_shape: tuple[int, ...]
    layer_partition: tuple[int, ...]
    strategies: tuple[dict, ...]
    gbs: int
    microbatches: int
    # hetero extras (empty for uniform plans)
    node_sequence: tuple[str, ...] = ()
    device_groups: tuple[int, ...] = ()
    # pipeline schedule the plan was priced with
    schedule: str = "gpipe"
    virtual_stages: int = 1

    def to_json(self) -> str:
        return json.dumps({
            "mesh_axes": list(self.mesh_axes),
            "mesh_shape": list(self.mesh_shape),
            "layer_partition": list(self.layer_partition),
            "strategies": list(self.strategies),
            "gbs": self.gbs,
            "microbatches": self.microbatches,
            "node_sequence": list(self.node_sequence),
            "device_groups": list(self.device_groups),
            "schedule": self.schedule,
            "virtual_stages": self.virtual_stages,
        }, indent=2)

    @staticmethod
    def from_json(payload: str) -> "PlanArtifact":
        d = json.loads(payload)
        return PlanArtifact(
            mesh_axes=tuple(d["mesh_axes"]),
            mesh_shape=tuple(d["mesh_shape"]),
            layer_partition=tuple(d["layer_partition"]),
            strategies=tuple(d["strategies"]),
            gbs=d["gbs"],
            microbatches=d["microbatches"],
            node_sequence=tuple(d.get("node_sequence", ())),
            device_groups=tuple(d.get("device_groups", ())),
            schedule=d.get("schedule", "gpipe"),
            virtual_stages=d.get("virtual_stages", 1),
        )

    def save(self, path) -> None:
        Path(path).write_text(self.to_json())

    @staticmethod
    def load(path) -> "PlanArtifact":
        return PlanArtifact.from_json(Path(path).read_text())

    def require_single_device(self) -> None:
        """Raise unless the artifact's mesh holds exactly one device — the
        only execution this slice has."""
        if not self.mesh_shape:
            raise NotImplementedError(
                "non-rectangular (hetero) plans run on the per-stage executor "
                "of a later slice")
        devices = math.prod(self.mesh_shape)
        if devices != 1:
            raise NotImplementedError(
                f"mesh {dict(zip(self.mesh_axes, self.mesh_shape))} needs "
                f"{devices} devices; multi-device execution (dp x tp over "
                "NCCL, pipeline and hetero executors) comes with a later slice")

    @staticmethod
    def from_uniform_plan(plan: UniformPlan) -> "PlanArtifact":
        return PlanArtifact(
            mesh_axes=(PP, DP, TP),
            mesh_shape=(plan.pp, plan.dp, plan.tp),
            layer_partition=(),
            strategies=({"dp": plan.dp, "tp": plan.tp},),
            gbs=plan.gbs,
            microbatches=plan.num_microbatches,
        )

    @staticmethod
    def from_ranked_plan(ranked) -> "PlanArtifact":
        """Capture a hetero planner result (``planner.api.RankedPlan``).  When
        every stage shares one strategy shape the artifact is rectangular
        with every plan axis named honestly — (pp, dp, ep, sp, tp), trivial
        axes kept at size 1.  Otherwise mesh fields stay empty and per-stage
        data drives execution.  The JSON is the reference's byte for byte;
        this slice executes the one-device case (mesh ``(1, 1, 1, 1, 1)``)."""
        from dataclasses import asdict

        inter, intra = ranked.inter, ranked.intra
        strategies = tuple(asdict(s) for s in intra.strategies)
        uniform = len(
            {(s.dp, s.tp, s.cp, s.ep) for s in intra.strategies}) == 1
        s0 = intra.strategies[0]
        return PlanArtifact(
            mesh_axes=(PP, DP, EP, SP, TP) if uniform else (),
            mesh_shape=(
                (inter.num_stages, s0.dp // s0.ep, s0.ep, s0.cp, s0.tp)
                if uniform else ()),
            layer_partition=tuple(intra.layer_partition),
            strategies=strategies,
            gbs=inter.gbs,
            microbatches=inter.batches,
            node_sequence=tuple(inter.node_sequence),
            device_groups=tuple(inter.device_groups),
            schedule=getattr(intra, "schedule", "gpipe"),
            virtual_stages=getattr(intra, "virtual_stages", 1),
        )
