"""Elastic re-planning on topology change — the port of
``metis_tpu/planner/replan.py``, copied (it is host Python over the
planner), with ``plan_hetero`` and the cluster spec of the port.
``decisions=`` passes through to ``plan_hetero``, which records the new
search in the decision log (``obs/provenance.py``).

SURVEY.md §5 ("Failure detection / elastic recovery"): the reference's only
fault posture is per-plan pruning; its natural recovery mechanism — re-running
the planner against an edited cluster file — is manual.  This module makes it
a first-class API: diff two cluster descriptions, re-plan on the survivor
topology, and report what changed, so an orchestrator can drop a failed slice,
re-plan in seconds, and resume from the last checkpoint
(execution.checkpoint restores onto the new mesh).

Second trigger (cost-model drift, ``obs/ledger.py``): when the accuracy
ledger's rolling predicted-vs-measured error leaves the configured band, the
plan was chosen on predictions the hardware no longer honors — the same
re-plan machinery runs against the *current* topology via
:func:`replan_on_drift`, fed by a ``DriftDetector`` status.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

from metis_tpu_torch.cluster.spec import ClusterSpec, NodeSpec, _registry_lookup
from metis_tpu_torch.core.config import ModelSpec, SearchConfig
from metis_tpu_torch.core.errors import ClusterSpecError
from metis_tpu_torch.planner.api import PlannerResult, plan_hetero
from metis_tpu_torch.profiles.store import ProfileStore


@dataclass(frozen=True)
class ClusterDelta:
    """Device-count changes by type between two cluster descriptions."""

    added: dict[str, int]
    removed: dict[str, int]

    @property
    def is_empty(self) -> bool:
        return not self.added and not self.removed

    @property
    def num_added(self) -> int:
        """Total devices gained — the capacity the fleet scheduler grants
        back toward tenant shares on a grow delta."""
        return sum(self.added.values())

    @property
    def num_removed(self) -> int:
        """Total devices lost — the capacity the fleet scheduler must
        reclaim from tenants (lowest priority first) on a shrink delta."""
        return sum(self.removed.values())

    @staticmethod
    def between(old: ClusterSpec, new: ClusterSpec) -> "ClusterDelta":
        old_counts = Counter()
        new_counts = Counter()
        for node in old.nodes:
            old_counts[node.device_type] += node.num_devices
        for node in new.nodes:
            new_counts[node.device_type] += node.num_devices
        added = {t: new_counts[t] - old_counts[t]
                 for t in new_counts if new_counts[t] > old_counts.get(t, 0)}
        removed = {t: old_counts[t] - new_counts[t]
                   for t in old_counts if old_counts[t] > new_counts.get(t, 0)}
        return ClusterDelta(added=added, removed=removed)

    def apply(self, cluster: ClusterSpec,
              full: ClusterSpec | None = None) -> ClusterSpec:
        """The topology after this delta: removals peel from the end via
        :func:`shrink_cluster`; additions restore toward ``full`` when one
        is given (:func:`grow_cluster`'s node-order contract) or append one
        node per added type otherwise.  Round-trip symmetric with
        :meth:`between`: ``ClusterDelta.between(old, d.apply(old)) == d``
        whenever ``d`` is applicable to ``old``.  Growth of a device type
        unknown to both the cluster and the registry (or to ``full`` when
        given) raises :class:`ClusterSpecError`."""
        out = cluster
        if self.removed:
            out = shrink_cluster(out, self.removed)
        if not self.added:
            return out
        if full is not None:
            return grow_cluster(out, full, self.added)
        nodes = list(out.nodes)
        devices = dict(out.devices)
        for t in sorted(self.added):
            n = int(self.added[t])
            if n < 1:
                raise ClusterSpecError(f"added[{t!r}] must be >= 1, got {n}")
            if t not in devices:
                devices[t] = _registry_lookup(t)
            nodes.append(NodeSpec(t, n))
        return ClusterSpec(nodes=tuple(nodes), devices=devices)


def shrink_cluster(cluster: ClusterSpec,
                   removed: dict[str, int]) -> ClusterSpec:
    """The survivor topology after losing ``removed`` (type -> device count).

    Devices are peeled from the END of the node list (highest ranks first —
    the linear placement puts later pipeline stages there, so survivors keep
    the front ranks a restored plan maps onto).  A partial loss narrows the
    last matching node rather than dropping it.  Raises
    :class:`ClusterSpecError` when a type loses more devices than it has, or
    when nothing survives — an empty topology cannot be re-planned."""
    remaining = dict(removed)
    for t, n in remaining.items():
        if n < 1:
            raise ClusterSpecError(f"removed[{t!r}] must be >= 1, got {n}")
        have = cluster.num_devices_by_type(t)
        if n > have:
            raise ClusterSpecError(
                f"cannot remove {n}x{t}: cluster only has {have}")
    survivors: list[NodeSpec] = []
    for node in reversed(cluster.nodes):
        need = remaining.get(node.device_type, 0)
        if need <= 0:
            survivors.append(node)
            continue
        take = min(need, node.num_devices)
        remaining[node.device_type] = need - take
        if node.num_devices > take:
            survivors.append(NodeSpec(node.device_type,
                                      node.num_devices - take))
    if not survivors:
        raise ClusterSpecError(
            "device loss removed every device — nothing to re-plan on")
    return ClusterSpec(nodes=tuple(reversed(survivors)),
                       devices=dict(cluster.devices))


def grow_cluster(cluster: ClusterSpec, full: ClusterSpec,
                 added: dict[str, int]) -> ClusterSpec:
    """Restore ``added`` devices (type -> count) toward a reference ``full``
    topology — the inverse of :func:`shrink_cluster` for elastic scale-up
    (the reference's replay loop and its serve daemon's ``cluster_delta``
    use it).

    ``cluster`` must be (equivalent to) a shrink of ``full``; the grown
    topology is rebuilt as ``full`` shrunk by whatever is STILL missing, so
    shrink-then-grow round-trips exactly and node order always matches the
    reference topology.  Raises :class:`ClusterSpecError` when a type would
    exceed the reference's capacity or is unknown to it."""
    still_missing: dict[str, int] = {}
    types = {n.device_type for n in full.nodes} | \
            {n.device_type for n in cluster.nodes} | set(added)
    for t in sorted(types):
        add = int(added.get(t, 0))
        if add < 0:
            raise ClusterSpecError(f"added[{t!r}] must be >= 0, got {add}")
        have = cluster.num_devices_by_type(t)
        cap = full.num_devices_by_type(t)
        if add > 0 and cap == 0:
            raise ClusterSpecError(
                f"cannot add {add}x{t}: device type {t!r} is unknown to "
                "the reference topology")
        if have + add > cap:
            raise ClusterSpecError(
                f"cannot add {add}x{t}: cluster has {have}, reference "
                f"topology caps the type at {cap}")
        if cap - have - add > 0:
            still_missing[t] = cap - have - add
    if not still_missing:
        return ClusterSpec(nodes=full.nodes, devices=dict(full.devices))
    return shrink_cluster(full, still_missing)


@dataclass(frozen=True)
class ReplanReport:
    """Outcome of an elastic re-plan."""

    delta: ClusterDelta
    result: PlannerResult
    old_best_cost_ms: float | None
    new_best_cost_ms: float | None
    plan_changed: bool

    @property
    def cost_ratio(self) -> float | None:
        """New best step time relative to the old one (>1 = slower — the
        price of the lost capacity)."""
        if self.old_best_cost_ms and self.new_best_cost_ms:
            return self.new_best_cost_ms / self.old_best_cost_ms
        return None


def replan(
    old_cluster: ClusterSpec,
    new_cluster: ClusterSpec,
    profiles: ProfileStore,
    model: ModelSpec,
    config: SearchConfig,
    old_result: PlannerResult | None = None,
    search_old: bool = True,
    decisions=None,
    decision_meta: dict | None = None,
    **plan_kwargs,
) -> ReplanReport:
    """Re-plan against ``new_cluster`` and report the topology delta and cost
    movement.  ``old_result`` (if available) supplies the previous best cost
    and plan identity; otherwise the old cluster is re-planned too — unless
    ``search_old=False``, which searches ONLY the survivor topology (the
    time-critical elastic-recovery path: old-plan comparison is then
    reported as unknown rather than paid for).

    ``decisions`` / ``decision_meta`` (``obs.provenance``): record the NEW
    search as one decision record — kind ``delta_replan`` unless the meta
    overrides it.  The old-comparison search is never recorded; it picks
    no plan, it only prices the one being displaced."""
    delta = ClusterDelta.between(old_cluster, new_cluster)
    if old_result is None and search_old:
        old_result = plan_hetero(old_cluster, profiles, model, config,
                                 **plan_kwargs)
    meta = None
    if decisions is not None:
        meta = {"kind": "delta_replan", **(decision_meta or {})}
        detail = dict(meta.get("detail") or {})
        detail.setdefault("removed", delta.removed)
        detail.setdefault("added", delta.added)
        if detail:
            meta["detail"] = detail
    new_result = plan_hetero(new_cluster, profiles, model, config,
                             decisions=decisions, decision_meta=meta,
                             **plan_kwargs)

    old_best = old_result.best if old_result is not None else None
    new_best = new_result.best
    changed = (
        old_best is None or new_best is None
        or old_best.inter != new_best.inter
        or old_best.intra.strategies != new_best.intra.strategies
        or old_best.intra.layer_partition != new_best.intra.layer_partition
    )
    return ReplanReport(
        delta=delta,
        result=new_result,
        old_best_cost_ms=old_best.cost.total_ms if old_best else None,
        new_best_cost_ms=new_best.cost.total_ms if new_best else None,
        plan_changed=changed,
    )


def replan_on_drift(
    status,
    cluster: ClusterSpec,
    profiles: ProfileStore,
    model: ModelSpec,
    config: SearchConfig,
    old_result: PlannerResult | None = None,
    decisions=None,
    decision_meta: dict | None = None,
    **plan_kwargs,
) -> ReplanReport | None:
    """Cost-model-drift replan trigger.

    ``status`` is an ``obs.ledger.DriftStatus`` (or anything with an
    ``in_drift`` bool) from the accuracy ledger's drift detector: None is
    returned while the predicted-vs-measured error sits inside the band —
    no search is paid for.  Once in drift, the CURRENT topology is
    re-searched (fresh profiles / calibration may rank a different plan) and
    the standard :class:`ReplanReport` comes back; ``old_result`` (the run's
    original search, if still at hand) supplies the cost comparison without
    a second search, mirroring ``replan``'s time-critical path.
    """
    if not getattr(status, "in_drift", False):
        return None
    meta = None
    if decisions is not None:
        meta = {"kind": "drift_replan", "cause": "drift_alarm",
                **(decision_meta or {})}
    return replan(cluster, cluster, profiles, model, config,
                  old_result=old_result, search_old=False,
                  decisions=decisions, decision_meta=meta, **plan_kwargs)
