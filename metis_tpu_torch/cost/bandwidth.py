"""Scalar bandwidth models — compat projections of the reference's
slowest-link scans (``model/cluster_bandwidth.py``).

The port's copy of ``metis_tpu/cost/bandwidth.py``.

These exist for (a) golden/differential parity with the reference cost model
and (b) clusters genuinely described by per-type scalars — every GPU
cluster the port plans (the reference's TPU ICI/DCN model is not ported).

Reference semantics reproduced exactly (differential-tested):

- a process group confined to ONE node gets that node type's intra bandwidth;
  any group spanning nodes gets the "inter" bandwidth, which — via the
  reference's swapped getter (``gpu_cluster.py:56-58``) — is the minimum
  *intra* bandwidth among spanned node types under ``strict_compat``;
- "one node" is literal: two same-type nodes still count as spanning
  (``cluster_bandwidth.py:172-177`` keys on distinct node ids);
- hetero DP groups are built round-robin, tp-major (``:148-156``), i.e. group
  d holds stage ranks ``d::dp`` — note this is the *reference's* grouping
  quirk reproduced for differential parity: it scans by replica, the
  transpose of the (dp, cp, tp) gradient-sync layout that
  ``cp_ring_groups`` declares and the ICI model costs
  (``ici.IciDcnBandwidth.dp_bandwidth``).  For the scalar model both scans
  touch the same node set in almost all layouts, so parity wins here.
"""
from __future__ import annotations

from typing import Protocol, Sequence

import numpy as np

from metis_tpu_torch.cluster.spec import ClusterSpec
from metis_tpu_torch.core.types import InterStagePlan, Strategy
from metis_tpu_torch.balance.stage_perf import node_device_types


def cp_ring_groups(start: int, strategy: Strategy) -> list[list[int]]:
    """Rank groups of every context-parallel ring in a stage whose ranks
    begin at ``start``, laid out (dp, cp, tp) row-major — the single source of
    truth for the planner's cp rank layout (shared by all bandwidth models
    and, once cp meshes are emitted, the execution layer)."""
    width = strategy.cp * strategy.tp
    return [
        [start + d * width + c * strategy.tp + t for c in range(strategy.cp)]
        for d in range(strategy.dp)
        for t in range(strategy.tp)
    ]


class StageBandwidthModel(Protocol):
    """What the hetero estimator needs: slowest link for a stage's pipeline
    boundary and for its DP rings, in GB/s."""

    def pp_bandwidth(self, stage_id: int) -> float: ...

    def dp_bandwidth(self, stage_id: int, strategy: Strategy) -> float: ...

    def cp_bandwidth(self, stage_id: int, strategy: Strategy) -> float:
        """Slowest link of any ring-attention (context-parallel) ring.  Stage
        rank layout is (dp, cp, tp) row-major: replica d's cp ring at tp slot t
        is ranks ``start + d*cp*tp + c*tp + t``."""
        ...


class HeteroScalarBandwidth:
    """≅ reference ``HetClusterBandwidth`` (``cluster_bandwidth.py:135-195``)."""

    def __init__(self, cluster: ClusterSpec, plan: InterStagePlan,
                 strict_compat: bool = True):
        self.cluster = cluster
        self.plan = plan
        self.strict_compat = strict_compat
        self.node_types = node_device_types(cluster, plan.node_sequence)
        # rank -> node index under the node-sequence placement: nodes are
        # reordered type-first (stable within a type) to match
        # rank_device_types, so ragged node widths classify correctly.
        self._rank_node: list[int] = []
        node_id = 0
        for device_type in plan.node_sequence:
            for n in cluster.nodes:
                if n.device_type == device_type:
                    self._rank_node.extend([node_id] * n.num_devices)
                    node_id += 1

    def _group_bandwidth(self, ranks: Sequence[int]) -> float:
        nodes = {self._rank_node[r] for r in ranks}
        types = [self.node_types[n] for n in nodes]
        if len(nodes) == 1:
            return self.cluster.intra_bw_for_type(types[0])
        return self.cluster.inter_bw_for_types(types, self.strict_compat)

    def pp_bandwidth(self, stage_id: int) -> float:
        """Slowest link among the ranks of stage_id ∪ stage_id+1
        (≅ ``:143-146,169-177``)."""
        start, _ = self.plan.stage_rank_range(stage_id)
        groups = self.plan.device_groups
        end = start + groups[stage_id] + (
            groups[stage_id + 1] if stage_id + 1 < len(groups) else 0)
        return self._group_bandwidth(range(start, end))

    def dp_bandwidth(self, stage_id: int, strategy: Strategy) -> float:
        start, end = self.plan.stage_rank_range(stage_id)
        ranks = list(range(start, end))
        slowest = float("inf")
        for d in range(strategy.dp):
            slowest = min(slowest, self._group_bandwidth(ranks[d::strategy.dp]))
        return slowest

    def cp_bandwidth(self, stage_id: int, strategy: Strategy) -> float:
        start, _ = self.plan.stage_rank_range(stage_id)
        return min(
            self._group_bandwidth(ring)
            for ring in cp_ring_groups(start, strategy))


class HomoScalarBandwidth:
    """≅ reference ``HomoClusterBandwidth`` (``cluster_bandwidth.py:71-132``)
    for uniform Megatron grids."""

    def __init__(self, cluster: ClusterSpec, strict_compat: bool = True):
        self.cluster = cluster
        first_type = cluster.nodes[0].device_type
        self.intra = cluster.intra_bw_for_type(first_type)
        self.inter = (
            self.intra if strict_compat
            else cluster.spec(first_type).inter_bw_gbps
        )

    def _within_one_node(self, ranks: Sequence[int]) -> bool:
        return len({self.cluster.node_of_rank(r) for r in ranks}) == 1

    def pp_bandwidth(self, pp: int, tp: int, stage_id: int) -> float:
        """Slowest stage->stage+1 peer link over the rank grid
        (≅ ``:83-100,111-123``)."""
        total = self.cluster.total_devices
        grid = np.arange(total).reshape(pp, -1, tp)
        model_groups = np.concatenate(list(grid), axis=1)  # (dp, pp*tp)
        slowest = self.intra
        for row in model_groups:
            for t in range(tp):
                pair = (int(row[stage_id * tp + t]), int(row[(stage_id + 1) * tp + t]))
                if not self._within_one_node(pair):
                    slowest = self.inter
        return slowest

    def dp_bandwidth(self, pp: int, tp: int) -> float:
        """Slowest DP-row link (≅ ``:102-109,125-132``; the reference treats
        each whole pp-row — dp*tp ranks — as one group)."""
        total = self.cluster.total_devices
        grid = np.arange(total).reshape(pp, -1, tp)
        slowest = self.intra
        for row in range(pp):
            if not self._within_one_node([int(r) for r in grid[row].flatten()]):
                slowest = self.inter
        return slowest
