"""ICI/DCN-aware collective cost model — the TPU-native bandwidth layer.

The port's copy of ``metis_tpu/cost/ici.py``: pure Python, no torch.  The
reference asks JAX's default backend whether a ``"cpu"`` calibration applies;
the port has no such global, so :class:`IciDcnBandwidth` takes the planned
``device`` as an argument (``"cuda"`` by default), and a ``"cpu"`` calibration
applies only when the caller passes ``device="cpu"``.

Replaces the reference's two-scalars-per-node convention and slowest-link
scans (SURVEY.md §2.3 "TPU-native equivalent") with per-collective analytic
costs over the slice torus: ring all-reduce/all-gather/reduce-scatter along
mesh axes at ICI ring bandwidth, hop-aware point-to-point for pipeline
neighbors, DCN for anything crossing a slice boundary.

Fidelity layers (SURVEY.md §7 hard part #1):

1. **Analytic formulas** (``ring_all_reduce_ms`` & co.) with published
   per-generation link constants (``cluster/tpu.py``) — the zero-TPU default.
2. **Torus placement** — :class:`IciDcnBandwidth` maps each communication
   group to slice-local torus *coordinates* (row-major over the slice
   topology, matching how ``PlanArtifact.build_mesh`` lays ranks out) and
   derives an effective bandwidth from the axes the group actually spans:
   a collective over a sub-grid decomposes into sequential per-axis ring
   phases (the standard multi-axis decomposition XLA performs), strided
   groups share links with their interleaved siblings, and only a full
   wrapped axis gets both ring directions.
3. **Measured calibration** — a :class:`~metis_tpu_torch.cost.calibration.
   CollectiveCalibration` (microbenchmarked with
   ``microbenchmark_collectives`` on the deployment's own mesh) overrides
   the published link constant with the measured wire bandwidth and adds the
   measured latency floor whenever its platform matches the slice costed.

Bandwidths convert as GB/s -> 1e6 bytes/ms (decimal, the physical unit; the
reference's 1024*1024 factor is a compat-mode quirk confined to the
estimator).
"""
from __future__ import annotations

import math
from typing import Sequence

from metis_tpu_torch.cluster.tpu import TpuClusterSpec, TpuSliceSpec
from metis_tpu_torch.core.types import InterStagePlan, Strategy
from metis_tpu_torch.cost.calibration import CollectiveCalibration


def _bytes_per_ms(bw_gbps: float) -> float:
    return bw_gbps * 1e6


def ring_all_reduce_ms(nbytes: float, group_size: int, bw_gbps: float,
                       latency_ms: float = 0.0) -> float:
    """Bandwidth-optimal ring all-reduce: 2(n-1)/n of the payload crosses the
    slowest link (reduce-scatter + all-gather); 2(n-1) latency steps."""
    if group_size <= 1:
        return 0.0
    return (2 * (group_size - 1) / group_size * nbytes
            / _bytes_per_ms(bw_gbps)) + 2 * (group_size - 1) * latency_ms


def all_gather_ms(nbytes: float, group_size: int, bw_gbps: float,
                  latency_ms: float = 0.0) -> float:
    """Ring all-gather of a full ``nbytes`` result: (n-1)/n crosses each
    link, n-1 latency steps."""
    if group_size <= 1:
        return 0.0
    return ((group_size - 1) / group_size * nbytes
            / _bytes_per_ms(bw_gbps)) + (group_size - 1) * latency_ms


reduce_scatter_ms = all_gather_ms  # same wire volume, opposite direction


def all_to_all_ms(nbytes: float, group_size: int, bw_gbps: float,
                  latency_ms: float = 0.0, wrap: bool = True) -> float:
    """All-to-all on a ring: each chip sends ``nbytes/n`` to every peer over
    shortest paths; the per-direction link traffic sums to ``n*nbytes/8``
    on a bidirectional ring (mean hop distance n/4, both directions used),
    double on a line.  This replaces the r1 placeholder that reused the
    all-gather formula — all-to-all is ~4x cheaper than an all-gather of the
    same buffer at n=8 and, unlike all-gather, *grows* with n (bisection
    limited), which is exactly the regime MoE dispatch planning cares about.
    """
    if group_size <= 1:
        return 0.0
    factor = 8.0 if wrap else 4.0
    return (group_size * nbytes / factor / _bytes_per_ms(bw_gbps)
            + (group_size - 1) * latency_ms)


def p2p_ms(nbytes: float, bw_gbps: float, hops: int = 1,
           hop_latency_ms: float = 0.0) -> float:
    """Point-to-point send: store-and-forward hops pipeline, so extra hops
    add per-hop latency, not bandwidth division."""
    return nbytes / _bytes_per_ms(bw_gbps) + hops * hop_latency_ms


# ---------------------------------------------------------------------------
# torus placement
# ---------------------------------------------------------------------------


def sub_torus_eff_bw_gbps(slice_spec: TpuSliceSpec,
                          offsets: Sequence[int],
                          link_bw_gbps: float | None = None) -> float:
    """Effective per-chip ring bandwidth for a collective over the chips at
    slice-local ``offsets`` (row-major coordinates over the slice topology).

    Model: the collective decomposes into sequential ring phases, one per
    torus axis the group spans (extent ``e_a`` along axis ``a``), so

        t/V = sum_a  2(e_a - 1)/e_a / bw_a

    and the effective bandwidth is the value that makes the flat ring
    formula over the full group size reproduce that time.  Per-axis
    ``bw_a``: the link constant, x2 when the phase traverses a full wrapped
    axis contiguously (both ring directions usable), /stride when the
    group's coordinates along the axis are strided (interleaved sibling
    groups share the same physical links).

    Groups that do not form a sub-grid (coordinate-product != group size)
    fall back to the slowest-axis scalar — the r1 behavior.
    """
    n = len(offsets)
    if n <= 1:
        return float("inf")
    link = link_bw_gbps if link_bw_gbps is not None else slice_spec.gen.ici_bw_gbps
    topo = slice_spec.topology
    coords = [[] for _ in topo]
    for off in offsets:
        for a in range(len(topo) - 1, -1, -1):
            coords[a].append(off % topo[a])
            off //= topo[a]
    slowest = min(slice_spec.axis_ring_bw_gbps(a) for a in range(len(topo)))
    scale = slowest / slice_spec.gen.ici_bw_gbps
    phases: list[tuple[int, float]] = []
    grid = 1
    for a, extent in enumerate(topo):
        vals = sorted(set(coords[a]))
        e = len(vals)
        grid *= e
        if e == 1:
            continue
        strides = {vals[i + 1] - vals[i] for i in range(e - 1)}
        stride = vals[1] - vals[0] if len(strides) == 1 else None
        if stride is None:
            phases.append((e, link))  # irregular spacing: single direction
            continue
        full_ring = (stride == 1 and e == extent and slice_spec.wrap[a]
                     and e > 2)
        bw = link * (2 if full_ring else 1) / max(stride, 1)
        phases.append((e, bw))
    if grid != n or not phases:
        return link * scale
    denom = sum(2 * (e - 1) / e / bw for e, bw in phases)
    return 2 * (n - 1) / n / denom


_KIND_TO_GENERATION = {
    "v4": "tpu_v4", "v5 lite": "tpu_v5e", "v5e": "tpu_v5e",
    "v5p": "tpu_v5p", "v5": "tpu_v5p", "v6 lite": "tpu_v6e", "v6e": "tpu_v6e",
}


def generation_of_device_kind(device_kind: str) -> str | None:
    """Map a TPU ``device_kind`` string (e.g. "TPU v5 lite") to a
    ``TPU_GENERATIONS`` key; None when unrecognized.  A calibration the port
    measured names a torch device (``torch.cuda.get_device_name``, e.g.
    "NVIDIA H100 80GB HBM3"), which maps to None: it never overrides a TPU
    slice's constants, as in the reference."""
    kind = device_kind.lower()
    best = None
    for sub, gen in _KIND_TO_GENERATION.items():
        if sub in kind and (best is None or len(sub) > len(best[0])):
            best = (sub, gen)
    return best[1] if best else None


class IciDcnBandwidth:
    """StageBandwidthModel over a TPU slice collection.

    Ranks follow the plan's node-sequence placement (all chips of
    ``node_sequence[0]``'s generation take the lowest ranks, and so on —
    the same convention as ``balance.rank_device_types``), so permuted
    placements cost against the correct hardware.  Within a slice, the
    slice-local rank offset is the row-major torus coordinate (matching
    ``PlanArtifact.build_mesh``'s device order).

    ``calibration``: measured collective constants; applied when the
    calibration's platform matches the slice (TPU generation matched via
    device_kind, or a CPU calibration when ``device`` is ``"cpu"``).

    ``device``: the device type the plan is made for; the reference reads
    it from JAX's default backend.  Only ``"cpu"`` changes anything: it lets
    a CPU calibration apply.
    """

    def __init__(self, tpu_cluster: TpuClusterSpec, plan: InterStagePlan,
                 calibration: CollectiveCalibration | None = None,
                 device: str = "cuda"):
        from metis_tpu_torch.cluster.tpu import rank_slice_placement

        self.tpu_cluster = tpu_cluster
        self.plan = plan
        self.calibration = calibration
        self.device = device
        # rank -> (slice index, slice-local offset), node-sequence order
        self._rank_slice = rank_slice_placement(
            tpu_cluster, plan.node_sequence)

    # -- calibration hooks -------------------------------------------------
    def _cal_matches(self, slice_spec: TpuSliceSpec) -> bool:
        cal = self.calibration
        if cal is None:
            return False
        if cal.platform == "cpu":
            # A CPU calibration describes host devices, never real ICI: it
            # applies only when the caller plans for the CPU (e.g. the
            # predicted-vs-measured validator on host ranks), not to TPU
            # hardware.
            return self.device == "cpu"
        gen = generation_of_device_kind(cal.device_kind)
        return gen == slice_spec.generation

    def collective_latency_ms(self, collective: str, group_size: int) -> float:
        """Measured per-collective latency floor, rescaled from the
        calibration's ring-step count to ``group_size``'s (consumed by the
        estimator as an additive term; 0 without a matching calibration)."""
        cal = self.calibration
        if cal is None or group_size <= 1:
            return 0.0
        if not any(self._cal_matches(s) for s in self.tpu_cluster.slices):
            return 0.0
        steps_of = lambda n: (2 * (n - 1) if collective == "all_reduce"  # noqa: E731
                              else n - 1)
        cal_steps = max(steps_of(max(cal.group_size, 2)), 1)
        return cal.latency_ms(collective) / cal_steps * steps_of(group_size)

    def _link_bw(self, slice_spec: TpuSliceSpec, collective: str) -> float:
        """Per-link bandwidth, measured when calibrated: the fit's effective
        bandwidth is per logical payload, so invert the collective's wire
        factor at the calibration's group size to recover the link rate."""
        if not self._cal_matches(slice_spec):
            return slice_spec.gen.ici_bw_gbps
        cal = self.calibration
        eff = cal.bw_gbps(collective)
        if eff is None or not math.isfinite(eff):
            return slice_spec.gen.ici_bw_gbps
        n = max(cal.group_size, 2)
        wire_factor = {
            "all_reduce": 2 * (n - 1) / n,
            "all_gather": (n - 1) / n,
            "reduce_scatter": (n - 1) / n,
            "all_to_all": n / 8.0,
            "ppermute": 1.0,
        }.get(collective, 1.0)
        return eff * wire_factor

    # -- placement ---------------------------------------------------------
    def _slice_of(self, rank: int) -> int:
        return self._rank_slice[rank][0]

    def _group_bandwidth(self, ranks: Sequence[int],
                         collective: str = "all_reduce") -> float:
        located = [self._rank_slice[r] for r in ranks]
        slices = {s for s, _ in located}
        if len(slices) == 1:
            idx = next(iter(slices))
            spec = self.tpu_cluster.slices[idx]
            return sub_torus_eff_bw_gbps(
                spec, [off for _, off in located],
                link_bw_gbps=self._link_bw(spec, collective))
        # Crossing slices: DCN, shared by the chips of the slowest side.
        return min(
            self.tpu_cluster.slices[i].gen.dcn_bw_gbps for i in slices)

    def pp_bandwidth(self, stage_id: int) -> float:
        """Boundary p2p: ICI if both stages live in one slice, else DCN."""
        start, _ = self.plan.stage_rank_range(stage_id)
        groups = self.plan.device_groups
        end = start + groups[stage_id] + (
            groups[stage_id + 1] if stage_id + 1 < len(groups) else 0)
        slices = {self._slice_of(r) for r in range(start, end)}
        if len(slices) == 1:
            s = self.tpu_cluster.slices[next(iter(slices))]
            return self._link_bw(s, "ppermute")
        return min(self.tpu_cluster.slices[i].gen.dcn_bw_gbps for i in slices)

    def dp_bandwidth(self, stage_id: int, strategy: Strategy) -> float:
        """Slowest gradient-sync ring.  Stage ranks lay out (dp, cp, tp)
        row-major, so the sync group of model-shard slot (c, t) is
        ``{start + d*cp*tp + c*tp + t : d}`` — the groups that actually
        all-reduce gradients together (the r1 ``ranks[d::dp]`` stride scan
        grouped *by replica*, which is the transpose of the sync layout)."""
        start, end = self.plan.stage_rank_range(stage_id)
        width = strategy.cp * strategy.tp
        slowest = float("inf")
        for slot in range(width):
            group = [start + d * width + slot for d in range(strategy.dp)]
            if group[-1] >= end:
                group = [r for r in group if r < end]
            if len(group) > 1:
                slowest = min(
                    slowest, self._group_bandwidth(group, "all_reduce"))
        return slowest if math.isfinite(slowest) else self._group_bandwidth(
            list(range(start, end)), "all_reduce")

    def cp_bandwidth(self, stage_id: int, strategy: Strategy) -> float:
        """Ring-attention ring bandwidth (rank layout: cp_ring_groups)."""
        # imported here: cost.bandwidth -> balance -> cost.expert_parallel
        # imports this module's all_to_all_ms
        from metis_tpu_torch.cost.bandwidth import cp_ring_groups

        start, _ = self.plan.stage_rank_range(stage_id)
        return min(
            self._group_bandwidth(ring, "ppermute")
            for ring in cp_ring_groups(start, strategy))
