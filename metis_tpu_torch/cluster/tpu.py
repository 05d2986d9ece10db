"""TPU slice topology model — the ICI/DCN replacement for clusterfile scalars.

The port's copy of ``metis_tpu/cluster/tpu.py``: pure Python, no torch.  The
planner plans TPU slices with it (``planner.api.plan_tpu``, the ``tpu``
command); the per-chip numbers are inputs of the planner, published figures,
not measurements of the port.

The reference describes interconnect with two scalars per node type
(``inter_bandwidth``/``intra_bandwidth``, ``README.md:203-230``).  On TPU the
interconnect is a per-slice ICI torus (per-axis links, wraparound) plus DCN
between slices; this module models that natively (SURVEY.md §2.3 "TPU-native
equivalent").

Numbers are public figures (jax-ml.github.io/scaling-book, Google Cloud TPU
docs) and are *calibration defaults* — a collective calibration
(``cost/calibration.py``) can overwrite them with microbenchmarked values per
deployment.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

from metis_tpu_torch.cluster.spec import ClusterSpec, DeviceSpec, NodeSpec
from metis_tpu_torch.core.errors import ClusterSpecError


@dataclass(frozen=True)
class TpuGeneration:
    """Per-chip hardware description of one TPU generation."""

    name: str
    hbm_gb: float
    hbm_bw_gbps: float
    bf16_tflops: float
    ici_bw_gbps: float  # one-way, per link, per direction
    torus_dims: int     # 2 for v5e, 3 for v4/v5p
    dcn_bw_gbps: float  # per-host DCN egress (default NIC provisioning)


TPU_GENERATIONS: dict[str, TpuGeneration] = {
    "tpu_v4": TpuGeneration("tpu_v4", hbm_gb=32, hbm_bw_gbps=1228,
                            bf16_tflops=275, ici_bw_gbps=45, torus_dims=3,
                            dcn_bw_gbps=25),
    "tpu_v5e": TpuGeneration("tpu_v5e", hbm_gb=16, hbm_bw_gbps=819,
                             bf16_tflops=197, ici_bw_gbps=45, torus_dims=2,
                             dcn_bw_gbps=25),
    "tpu_v5p": TpuGeneration("tpu_v5p", hbm_gb=95, hbm_bw_gbps=2765,
                             bf16_tflops=459, ici_bw_gbps=90, torus_dims=3,
                             dcn_bw_gbps=25),
    "tpu_v6e": TpuGeneration("tpu_v6e", hbm_gb=32, hbm_bw_gbps=1640,
                             bf16_tflops=918, ici_bw_gbps=90, torus_dims=2,
                             dcn_bw_gbps=50),
}


@dataclass(frozen=True)
class TpuSliceSpec:
    """One TPU slice: a generation plus its torus topology, e.g. v4 4x4x2.

    ``wrap[axis]`` is True when that torus axis has wraparound links (rings);
    on real hardware an axis wraps when its extent fills the physical torus
    dimension — we default to wrapping any axis of extent >= 4, which matches
    standard slice shapes (v4-32 = 4x4x2 wraps x,y; v5e-16 = 4x4 wraps both).
    """

    generation: str
    topology: tuple[int, ...]
    wrap: tuple[bool, ...] = ()

    def __post_init__(self) -> None:
        if self.generation not in TPU_GENERATIONS:
            raise ClusterSpecError(f"unknown TPU generation {self.generation!r}")
        gen = TPU_GENERATIONS[self.generation]
        if len(self.topology) != gen.torus_dims:
            raise ClusterSpecError(
                f"{self.generation} has a {gen.torus_dims}D torus; got topology "
                f"{self.topology}")
        if not self.wrap:
            object.__setattr__(
                self, "wrap", tuple(d >= 4 for d in self.topology))

    @property
    def gen(self) -> TpuGeneration:
        return TPU_GENERATIONS[self.generation]

    @property
    def num_chips(self) -> int:
        return math.prod(self.topology)

    def axis_ring_bw_gbps(self, axis: int) -> float:
        """Aggregate bandwidth available to a ring collective along ``axis``
        from one chip's perspective: 2 directions when the axis wraps (a true
        ring uses both), 1 otherwise."""
        dirs = 2 if (self.wrap[axis] and self.topology[axis] > 2) else 1
        return self.gen.ici_bw_gbps * dirs

    def bisection_bw_gbps(self) -> float:
        """ICI bisection bandwidth of the slice (per the narrowest cut)."""
        if self.num_chips == 1:
            return float("inf")
        # Cut perpendicular to the largest axis: cross-section area is the
        # product of the other axes; wrapped axes contribute two cut links.
        worst = float("inf")
        for axis, extent in enumerate(self.topology):
            if extent == 1:
                continue
            cross = self.num_chips // extent
            links = cross * (2 if self.wrap[axis] else 1)
            worst = min(worst, links * self.gen.ici_bw_gbps)
        return worst

    # -- lowering to the generic cluster abstraction -----------------------
    def as_nodes(self, chips_per_node: int = 4) -> list[NodeSpec]:
        if self.num_chips % chips_per_node:
            raise ClusterSpecError(
                f"slice of {self.num_chips} chips not divisible into "
                f"{chips_per_node}-chip nodes")
        return [NodeSpec(self.generation, chips_per_node)
                for _ in range(self.num_chips // chips_per_node)]

    def as_device_spec(self) -> DeviceSpec:
        """Scalar-model view of this slice's chips: intra = per-chip ICI ring
        bandwidth (slowest axis), inter = DCN share per chip."""
        g = self.gen
        intra = min(self.axis_ring_bw_gbps(a) for a in range(len(self.topology)))
        return DeviceSpec(
            name=self.generation,
            memory_gb=g.hbm_gb,
            intra_bw_gbps=intra,
            inter_bw_gbps=g.dcn_bw_gbps,
        )


@dataclass(frozen=True)
class TpuClusterSpec:
    """A collection of TPU slices joined by DCN — the hetero-TPU analogue of
    the reference's mixed-GPU cluster (north star: v4-32 + v5e-16)."""

    slices: tuple[TpuSliceSpec, ...]

    @property
    def total_chips(self) -> int:
        return sum(s.num_chips for s in self.slices)

    def slice_of_rank(self, rank: int) -> int:
        acc = 0
        for i, s in enumerate(self.slices):
            acc += s.num_chips
            if rank < acc:
                return i
        raise IndexError(rank)

    def as_cluster_spec(self, chips_per_node: int = 4) -> ClusterSpec:
        """Lower to the generic ClusterSpec the planner consumes.

        Each slice contributes homogeneous nodes of its generation; the
        scalar-bandwidth view is a *lower-fidelity* projection used by the
        compat estimator — the ICI/DCN-aware estimator consumes the
        TpuClusterSpec directly (metis_tpu_torch.cost.ici).
        """
        nodes: list[NodeSpec] = []
        devices: dict[str, DeviceSpec] = {}
        for s in self.slices:
            nodes.extend(s.as_nodes(chips_per_node))
            spec = s.as_device_spec()
            prev = devices.get(s.generation)
            if prev is not None and prev != spec:
                # Two same-generation slices with different topologies project
                # to different scalar bandwidths; the flat ClusterSpec keys
                # device specs by type, so it cannot represent that.  Fail
                # loudly rather than silently costing one slice with the
                # other's bandwidth.
                raise ClusterSpecError(
                    f"slices of generation {s.generation} have differing "
                    f"scalar projections ({prev} vs {spec}); use the ICI/DCN "
                    "bandwidth model or uniform slice topologies")
            devices[s.generation] = spec
        return ClusterSpec(nodes=tuple(nodes), devices=devices)


def rank_slice_placement(
    tpu_cluster: TpuClusterSpec, node_sequence: Sequence[str]
) -> list[tuple[int, int]]:
    """rank -> (slice index, slice-local offset) under the plan's
    node-sequence placement: all chips of ``node_sequence[0]``'s generation
    take the lowest ranks (slices keep declaration order within a
    generation) — the one placement convention shared by the bandwidth
    models and mesh emission."""
    placement: list[tuple[int, int]] = []
    for generation in node_sequence:
        for idx, s in enumerate(tpu_cluster.slices):
            if s.generation == generation:
                placement.extend((idx, off) for off in range(s.num_chips))
    return placement


def stage_groups_torus_aligned(
    tpu_cluster: TpuClusterSpec,
    node_sequence: Sequence[str],
    device_groups: Sequence[int],
) -> bool:
    """Whether every pipeline stage's contiguous rank range maps onto the
    physical topology cleanly (SURVEY.md §7 hard part #4: "device groups
    must map to contiguous sub-toruses — the C8 enumerator needs a
    topology-aware validity filter").  A stage is aligned when it either

    - spans *whole* slices (its intra-stage collectives then ride each
      slice's ICI with DCN only between replicas the cost model already
      charges), or
    - stays inside one slice with its local offset aligned to its own size
      and its size dividing the slice — for the power-of-two group sizes
      the enumerator emits on power-of-two torus extents, an aligned
      row-major block IS a rectangular sub-torus.

    Misaligned ranges (straddling a slice boundary partially, or cutting
    across sub-grid boundaries) would make XLA route per-step collectives
    over DCN or fold multiple torus rows into one ring — plans the
    execution layer should never be handed.
    """
    placement = rank_slice_placement(tpu_cluster, node_sequence)
    start = 0
    for size in device_groups:
        ranks = placement[start:start + size]
        slices = sorted({s for s, _ in ranks})
        if len(slices) == 1:
            spec = tpu_cluster.slices[slices[0]]
            local_start = ranks[0][1]
            if size < spec.num_chips and (
                    local_start % size != 0 or spec.num_chips % size != 0):
                return False
        else:
            # multi-slice stage: every spanned slice must be whole
            for s in slices:
                spec = tpu_cluster.slices[s]
                covered = sum(1 for si, _ in ranks if si == s)
                if covered != spec.num_chips:
                    return False
        start += size
    return True


def slice_from_name(name: str) -> TpuSliceSpec:
    """Parse names like ``v4-32``, ``v5e-16``, ``v5p-128`` (chip counts; the
    accelerator-count convention for v4/v5p names is cores, we use chips) into
    a standard topology."""
    gen_part, _, count_part = name.partition("-")
    gen = f"tpu_{gen_part}" if not gen_part.startswith("tpu_") else gen_part
    if gen not in TPU_GENERATIONS:
        raise ClusterSpecError(f"unknown generation in {name!r}")
    chips = int(count_part)
    dims = TPU_GENERATIONS[gen].torus_dims
    return TpuSliceSpec(gen, _default_topology(chips, dims))


def _default_topology(chips: int, dims: int) -> tuple[int, ...]:
    """Most-cubic factorization of ``chips`` into ``dims`` power-of-two-ish
    extents (e.g. 32 chips, 3D → 4x4x2; 16 chips, 2D → 4x4)."""
    if chips < 1:
        raise ClusterSpecError("chip count must be positive")
    topo = [1] * dims
    remaining = chips
    # Repeatedly assign the smallest prime factor to the currently-smallest axis.
    factors: list[int] = []
    n = remaining
    p = 2
    while p * p <= n:
        while n % p == 0:
            factors.append(p)
            n //= p
        p += 1
    if n > 1:
        factors.append(n)
    for f in sorted(factors, reverse=True):
        topo[topo.index(min(topo))] *= f
    return tuple(sorted(topo, reverse=True))
