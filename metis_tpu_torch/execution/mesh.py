"""Plan -> process mesh and parameter shards — the port of
``metis_tpu/execution/mesh.py``.

The reference places arrays on a ``jax.sharding.Mesh`` and lets GSPMD insert
the collectives.  Here one process runs per device (``execution/dist.py``
starts them), a ``ProcessMesh`` tells each process its coordinates and one
``torch.distributed`` group per mesh axis, and the model calls the
collectives itself (``models/parallel.py``).  The spec trees are the
reference's ``PartitionSpec`` trees with plain tuples of axis names (None =
not split, ``core/sharding.py``) standing in for ``P``: column-parallel qkv /
mlp-in, row-parallel proj / mlp-out, vocab-parallel embedding and head, the
batch over dp.  A multi-stage plan gives each stage a contiguous range of
ranks laid out as its own grid (``StageGrid``, ``stage_meshes``).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from metis_tpu_torch.core.errors import MetisError
from metis_tpu_torch.core.sharding import Spec, slice_leaf
from metis_tpu_torch.core.types import UniformPlan

PP, DP, TP, SP, EP = "pp", "dp", "tp", "sp", "ep"
# the group of all of a plan's ranks where the plan takes only the first
# ranks of the process group (``ProcessMesh.group(PLAN)``; None: the
# whole process group)
PLAN = "plan"


@dataclass(frozen=True)
class ProcessMesh:
    """This process's place in a row-major device grid (last axis fastest,
    as the reference's ``_grid`` reshapes its device list): the axis names,
    the grid's shape, this rank's coordinate on each axis, and the process
    group of the ranks that differ from this one only on that axis (None
    for an axis of size 1, where no collective is needed)."""

    axes: tuple[str, ...]
    shape: tuple[int, ...]
    coords: tuple[int, ...]
    groups: dict = field(default_factory=dict, compare=False, repr=False)

    def size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)] if axis in self.axes else 1

    def index(self, axis: str) -> int:
        return self.coords[self.axes.index(axis)] if axis in self.axes else 0

    def group(self, axis: str):
        return self.groups.get(axis)

    def slots(self) -> dict[str, tuple[int, int]]:
        """``{axis: (index, size)}`` — what ``slice_leaf`` takes."""
        return {a: (c, n) for a, c, n in zip(self.axes, self.coords, self.shape)}


#: the mesh of a process that runs the whole model alone: no axis, no group
ONE_DEVICE = ProcessMesh((), (), ())


def _require_group(need: int, what: str) -> int:
    """This process's rank, after checking that the current process group
    has at least ``need`` ranks (a grid of fewer ranks than the group runs
    on its first ``need``: ``_grid``)."""
    if not dist.is_initialized():
        raise MetisError(
            f"{what} needs a process group of {need} ranks; run it through "
            "the launcher (metis_tpu_torch.execution.dist.spawn)")
    world = dist.get_world_size()
    if world < need:
        raise MetisError(f"{what} needs {need} ranks, the process group has "
                         f"{world}")
    return dist.get_rank()


def _axis_groups(shape: tuple[int, ...], axes: tuple[str, ...], base: int,
                 rank: int) -> dict:
    """One process group per line of the grid of ranks ``base ..`` along
    each axis of size > 1 (every rank creates every line's group, in the
    same order, as ``torch.distributed.new_group`` requires); returns the
    groups of the lines that hold ``rank``."""
    grid = base + np.arange(math.prod(shape)).reshape(shape)
    groups = {}
    for i, axis in enumerate(axes):
        if shape[i] == 1:
            continue
        for line in np.moveaxis(grid, i, -1).reshape(-1, shape[i]):
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    return groups


def _grid(shape: tuple[int, ...], axes: tuple[str, ...]) -> ProcessMesh | None:
    """The mesh of this process inside the current process group.  A group
    larger than the grid runs it on its first ranks (the live reshard's
    destination, ``execution/reshard.py``): a rank outside it gets None,
    after taking part in creating the grid's groups, which is
    collective."""
    need = math.prod(shape)
    rank = _require_group(need, f"mesh {dict(zip(axes, shape))}")
    groups = _axis_groups(shape, axes, 0, rank)
    if dist.get_world_size() > need:
        plan = dist.new_group(list(range(need)))
        if rank >= need:
            return None
        groups[PLAN] = plan
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    return ProcessMesh(tuple(axes), tuple(shape), coords, groups)


@dataclass(frozen=True)
class StageGrid:
    """The rank grid of one pipeline stage, as the reference lays out a
    stage's mesh (``metis_tpu/execution/hetero.py``): ``(dp / ep, ep, tp)``
    over axes ``(dp, ep, tp)`` with expert parallelism (ep rides inside dp:
    the stage's dp replicas are its ``(dp, ep)`` pairs, dp major),
    ``(dp, cp, tp)`` over ``(dp, sp, tp)`` with context parallelism, else
    ``(dp, tp)``."""

    dp: int
    tp: int
    cp: int = 1
    ep: int = 1

    @property
    def devices(self) -> int:
        return self.dp * self.cp * self.tp

    @property
    def axes(self) -> tuple[str, ...]:
        if self.ep > 1:
            return (DP, EP, TP)
        return (DP, SP, TP) if self.cp > 1 else (DP, TP)

    @property
    def shape(self) -> tuple[int, ...]:
        if self.ep > 1:
            return (self.dp // self.ep, self.ep, self.tp)
        return (self.dp, self.cp, self.tp) if self.cp > 1 else (self.dp, self.tp)


def stage_offsets(grids) -> list[int]:
    """First rank of each stage, and the world size last: stage s owns the
    ``dp_s * cp_s * tp_s`` ranks after those of the stages before it."""
    return np.cumsum([0] + [g.devices for g in grids]).tolist()


def stage_meshes(grids) -> ProcessMesh:
    """This process's mesh in a plan of pipeline stages with per-stage
    ``StageGrid``s: stage s owns a contiguous range of ranks
    (``stage_offsets``), laid out row-major as its grid.
    Axes ``(pp, *grid axes)``, shape ``(S, *grid shape)`` of this rank's
    stage, and the groups of its grid's axes: stage-local, so a stage's sp
    and ep groups hold only its own ranks; there is no pp group (stages
    talk point to point).  Every rank creates every stage's groups, the
    stages it is not in included, in the same order, because ``new_group``
    is collective.  A plan of one device outside a process group gets the
    one-device mesh with a pp axis.  A group larger than the plan runs it
    on its first ranks, as ``_grid``'s: a rank outside it gets None."""
    grids = list(grids)
    offsets = stage_offsets(grids)
    if not dist.is_initialized() and offsets[-1] == 1:
        return ProcessMesh((PP, DP, TP), (1, 1, 1), (0, 0, 0))
    rank = _require_group(offsets[-1], f"stages {[g.shape for g in grids]}")
    mine = None
    for s, grid in enumerate(grids):
        groups = _axis_groups(grid.shape, grid.axes, offsets[s], rank)
        if offsets[s] <= rank < offsets[s + 1]:
            coords = tuple(int(c) for c in
                           np.unravel_index(rank - offsets[s], grid.shape))
            mine = ProcessMesh((PP, *grid.axes), (len(grids), *grid.shape),
                               (s, *coords), groups)
    if dist.get_world_size() > offsets[-1]:
        plan = dist.new_group(list(range(offsets[-1])))
        if mine is not None:
            mine.groups[PLAN] = plan
    return mine


def mesh_for_uniform_plan(plan: UniformPlan) -> ProcessMesh:
    """(pp, dp, tp) mesh over the current process group."""
    return _grid((plan.pp, plan.dp, plan.tp), (PP, DP, TP))


def mesh_dp_tp(dp: int, tp: int) -> ProcessMesh:
    """(dp, tp) mesh for non-pipelined execution."""
    return _grid((dp, tp), (DP, TP))


def gpt_param_specs(cfg, tp_axis: str = TP) -> dict:
    """Spec tree matching ``models.gpt.init_params`` (the reference's
    ``gpt_param_specs`` without a pipeline axis)."""
    t = tp_axis
    return {
        "embed": {
            "tok": (t, None),       # vocab-parallel embedding
            "pos": (),
        },
        "blocks": {
            "ln1_scale": (None, None),
            "ln1_bias": (None, None),
            "qkv": (None, None, None, t),  # column-parallel (whole heads)
            "qkv_bias": (None, None, t),
            "proj": (None, t, None),       # row-parallel
            "proj_bias": (None, None),
            "ln2_scale": (None, None),
            "ln2_bias": (None, None),
            "mlp_in": (None, None, t),     # column-parallel
            "mlp_in_bias": (None, t),
            "mlp_out": (None, t, None),    # row-parallel
            "mlp_out_bias": (None, None),
        },
        "head": {
            "ln_scale": (),
            "ln_bias": (),
            "out": (None, t),       # vocab-parallel head
        },
    }


def moe_param_specs(cfg, tp_axis: str = TP, ep_axis: str = EP) -> dict:
    """Spec tree matching ``models.moe.init_moe_params`` (the reference's
    ``moe_param_specs``): the expert leaves split their leading
    ``num_experts`` axis over ``ep_axis`` and their ffn axis over tp
    (``expert_in`` column-, ``expert_out`` row-parallel within an expert);
    the dense leaves as ``gpt_param_specs``."""
    t, e = tp_axis, ep_axis
    specs = gpt_param_specs(cfg, tp_axis=tp_axis)
    blocks = dict(specs["blocks"])
    for key in ("mlp_in", "mlp_in_bias", "mlp_out", "mlp_out_bias"):
        del blocks[key]
    blocks.update({
        "router": (None, None, None),
        "expert_in": (None, e, None, t),
        "expert_in_bias": (None, e, t),
        "expert_out": (None, e, t, None),
        "expert_out_bias": (None, e, None),
    })
    return {**specs, "blocks": blocks}


def llama_param_specs(cfg, tp_axis: str = TP, tp_size: int = 1) -> dict:
    """Spec tree matching ``models.llama.init_llama_params`` (the
    reference's ``llama_param_specs``): wq / w_gate / w_up column-parallel,
    wo / w_down row-parallel, norms replicated, vocab-parallel embedding and
    head.  ``wkv`` is column-parallel only when the KV heads split evenly
    over ``tp_size``; otherwise every rank holds all of it."""
    from metis_tpu_torch.models.llama import kv_sharded

    t = tp_axis
    kv_t = t if kv_sharded(cfg, tp_size) else None
    return {
        "embed": {"tok": (t, None)},
        "blocks": {
            "attn_norm": (None, None),
            "wq": (None, None, t),
            "wkv": (None, None, None, kv_t),
            "wo": (None, t, None),
            "ffn_norm": (None, None),
            "w_gate": (None, None, t),
            "w_up": (None, None, t),
            "w_down": (None, t, None),
        },
        "head": {
            "norm": (),
            "out": (None, t),
        },
    }


def expert_leaves(specs: dict, ep_axis: str = EP) -> set[tuple[str, str]]:
    """``(group, name)`` of the leaves a spec tree splits over ``ep_axis``."""
    return {(group, name) for group, sub in specs.items()
            for name, spec in sub.items() if ep_axis in spec}


def batch_spec(dp_axis: str | tuple = DP, seq_axis: str | None = None) -> Spec:
    """Spec of [batch, seq] token arrays (``(DP, EP)``: rows split over
    the dp x ep ranks, dp major, as the reference's ``P((DP, EP))``;
    ``seq_axis``, the context-parallel ``SP``: each rank a contiguous block
    of the sequence)."""
    return (dp_axis, seq_axis)


def seq_offset(mesh: ProcessMesh, seq_len: int, seq_axis: str = SP) -> int:
    """Absolute position of the first token of this rank's block of a
    ``seq_len`` sequence split over ``seq_axis``."""
    return mesh.index(seq_axis) * (seq_len // mesh.size(seq_axis))


def fsdp_wrap_specs(specs: dict, shapes: dict, dp_axis: str = DP,
                    axis_size: int = 1) -> dict:
    """The reference's ZeRO rule (``fsdp_wrap_specs``): each leaf of two or
    more dims shards its largest dim that the spec leaves unsplit and that
    divides by ``axis_size`` over ``dp_axis``; leaves of fewer dims, or
    with no such dim, stay as they are.  ``shapes``: the leaves' shapes,
    whole or this rank's (the unsplit dims are the same)."""
    def wrap(spec: Spec, shape) -> Spec:
        if len(shape) < 2:
            return spec
        parts = list(spec) + [None] * (len(shape) - len(spec))
        free = [i for i in range(len(shape))
                if parts[i] is None and shape[i] % max(axis_size, 1) == 0]
        if not free:
            return spec
        parts[max(free, key=lambda j: shape[j])] = dp_axis
        return tuple(parts)

    return {group: {name: wrap(specs[group][name], tuple(shape))
                    for name, shape in sub.items()}
            for group, sub in shapes.items()}


# leaves kept whole over tp that every tp rank applies to the whole
# sequence under sp: LLaMA's replicated ``wkv`` (``copy_to_tp`` sums its
# gradient), and the MoE FFN's router and output bias (the FFN gathers the
# sequence first, ``moe.moe_ffn``)
_SP_WHOLE_SEQUENCE = {("blocks", "wkv"), ("blocks", "router"),
                      ("blocks", "expert_out_bias")}


def sp_partial_leaves(specs: dict, tp_axis: str = TP) -> set[tuple[str, str]]:
    """``(group, name)`` of the leaves whose gradient each tp rank holds
    only a part of under Megatron sequence parallelism: the leaves the spec
    keeps whole over tp (norms, biases after a row-parallel product, GPT's
    positions) act on the rank's block of the sequence alone, except those
    of ``_SP_WHOLE_SEQUENCE``."""
    return {(group, name) for group, sub in specs.items()
            for name, spec in sub.items()
            if tp_axis not in spec and (group, name) not in _SP_WHOLE_SEQUENCE}


def shard_params(params: dict, mesh: ProcessMesh, specs: dict) -> dict:
    """This rank's slices of a full parameter tree (contiguous copies)."""
    slots = mesh.slots()
    return {group: {name: slice_leaf(leaf, specs[group][name], slots).contiguous()
                    for name, leaf in sub.items()}
            for group, sub in params.items()}


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

    @property
    def num_devices(self) -> int:
        if self.mesh_shape:
            return math.prod(self.mesh_shape)
        return sum(s["dp"] * s["tp"] * s.get("cp", 1) for s in self.strategies)

    def build_mesh(self) -> ProcessMesh | None:
        """This process's mesh inside a process group of the artifact's
        size.  A rectangular artifact gets its whole grid; both layouts
        work: ``(pp, dp, tp)`` from ``from_uniform_plan`` and ``(pp, dp,
        ep, sp, tp)`` from ``from_ranked_plan``, trivial axes of size 1; a
        larger group runs the grid on its first ranks and the others get
        None (``_grid``).  A non-rectangular one (per-stage strategies,
        empty mesh fields) gets its stage's mesh from ``stage_meshes``."""
        if not self.mesh_shape:
            return stage_meshes([StageGrid(s["dp"], s["tp"], s.get("cp", 1),
                                           s.get("ep", 1))
                                 for s in self.strategies])
        return _grid(self.mesh_shape, self.mesh_axes)

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
        data drives execution.  The JSON is the reference's byte for byte."""
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
