"""Multi-tenant fleet scheduler: one cluster, many planners, quota-safe —
the port of ``metis_tpu/sched/fleet.py``.

The single-job planners (``planner.api.plan_hetero``,
``inference.planner.plan_inference``) answer "what is the best plan for
THIS job on THIS cluster".  This module answers the fleet question above
them: given one physical cluster and a registry of tenants — each with a
priority, a quota floor/ceiling, and a training or inference workload —
carve the cluster into per-tenant sub-clusters, run each tenant's planner
on its carve, and pick the carve-up that maximizes a fleet-wide objective.

Design rules (each one load-bearing for a test):

* **Partitioning is a pure function** of (current cluster, tenant
  registry, share targets).  No incremental mutation: a shrink followed
  by the symmetric grow lands on byte-identical fleet state, which is the
  chaos drill's closing assertion.
* **Floors are inviolable.**  A carve that would leave any tenant below
  its quota floor raises :class:`~metis_tpu_torch.core.errors.FleetOverCommitError`
  instead of silently starving it — both upfront (floors sum past
  capacity) and post-assignment (node granularity).
* **Preemption is the reverse of allocation.**  Capacity is granted in
  (priority desc, name asc) order, so when the fleet shrinks, surplus
  drains from the lowest-priority tenant first — emergently, with no
  separate preemption pass to keep consistent.
* **Price-aware tier assignment.**  Nodes are offered in hazard order
  (reserved before spot, then physical rank), so high-priority tenants
  sit on reserved capacity and spot exposure concentrates on whoever
  is cheapest to displace — the ``expected_recovery`` term then
  prices that exposure inside each tenant's own search.
* **Displacement reuses the migration calculus.**  A training tenant
  whose carve changed is driven through the same
  :func:`~metis_tpu_torch.resilience.supervisor.migration_decision` rule the
  supervisor applies on device loss, so fleet preemption and single-job
  recovery can never disagree about migrate vs checkpoint-restore.
* **Single tenant == today's planner.**  One registered tenant gets every
  node; ``ClusterSpec.subset`` of every node reproduces the parent node
  tuple, and the planner is invoked with the same arguments the serve
  daemon uses — the pinned regression test asserts byte-identical dumps.
"""
from __future__ import annotations

import json
from dataclasses import dataclass

from metis_tpu_torch.cluster.spec import ClusterSpec
from metis_tpu_torch.core.events import EventLog, NULL_LOG
from metis_tpu_torch.core.errors import FleetOverCommitError
from metis_tpu_torch.core.types import dump_ranked_plans
from metis_tpu_torch.inference.planner import dump_inference_plans, plan_inference
from metis_tpu_torch.planner.api import plan_hetero
from metis_tpu_torch.planner.replan import ClusterDelta
from metis_tpu_torch.profiles.store import ProfileStore
from metis_tpu_torch.sched.tenant import TenantRegistry, TenantSpec


@dataclass(frozen=True)
class TenantAllocation:
    """One tenant's slice of a fleet plan: which nodes it holds (current-
    cluster node indices, ascending), what its planner found there, and
    how the slice scores against the tenant's full-fleet baseline."""

    tenant: str
    kind: str
    priority: int
    node_indices: tuple[int, ...]
    devices: int
    reserved_devices: int
    spot_devices: int
    feasible: bool
    utility: float
    utility_frac: float
    plan_json: str | None

    def to_json_dict(self) -> dict:
        return {
            "tenant": self.tenant,
            "kind": self.kind,
            "priority": self.priority,
            "node_indices": list(self.node_indices),
            "devices": self.devices,
            "reserved_devices": self.reserved_devices,
            "spot_devices": self.spot_devices,
            "feasible": self.feasible,
            "utility": round(self.utility, 9),
            "utility_frac": round(self.utility_frac, 9),
            "plan": json.loads(self.plan_json) if self.plan_json else None,
        }


@dataclass(frozen=True)
class FleetPlan:
    """A complete carve-up: every tenant's allocation plus the fleet-level
    score.  ``dump()`` is canonical JSON (sorted keys, rounded floats) —
    the byte-identity subject for the chaos drill's closing assertion and
    the sha-pinned regression golden."""

    cluster_devices: int
    shares_label: str
    objective: float
    utilization_frac: float
    allocations: tuple[TenantAllocation, ...]

    def allocation(self, tenant: str) -> TenantAllocation | None:
        for a in self.allocations:
            if a.tenant == tenant:
                return a
        return None

    @property
    def feasible_tenants(self) -> tuple[str, ...]:
        return tuple(a.tenant for a in self.allocations if a.feasible)

    def dump(self) -> str:
        payload = {
            "cluster_devices": self.cluster_devices,
            "shares_label": self.shares_label,
            "objective": round(self.objective, 9),
            "utilization_frac": round(self.utilization_frac, 9),
            "tenants": {a.tenant: a.to_json_dict()
                        for a in self.allocations},
        }
        return json.dumps(payload, indent=2, sort_keys=True)


@dataclass(frozen=True)
class _Planned:
    """Memoized outcome of one tenant's search on one node multiset."""

    feasible: bool
    utility: float
    plan_json: str | None
    best: object | None


class FleetScheduler:
    """Partition ``full_cluster`` across registered tenants and keep the
    partition valid as capacity comes and goes.

    ``profiles`` is the default :class:`ProfileStore` every tenant plans
    against; :meth:`admit` accepts a per-tenant override for tenants whose
    model the shared store does not cover.  ``top_k`` flows through to
    ``plan_hetero`` unchanged (``plan_inference`` keeps its own default of
    20) so the single-tenant path stays argument-identical to a direct
    planner call.
    """

    def __init__(self, full_cluster: ClusterSpec, profiles: ProfileStore,
                 *, events: EventLog = NULL_LOG,
                 top_k: int | None = None,
                 search_state_provider=None,
                 metrics=None, decisions=None):
        self.full_cluster = full_cluster
        self.cluster = full_cluster
        self.profiles = profiles
        self.events = events
        self.top_k = top_k
        # obs.provenance.DecisionLog (or None — library use records no
        # provenance): every re-partition appends one ``fleet_repartition``
        # record, every displaced tenant one ``tenant_replan`` (and, for
        # training tenants, one ``migration_decision``) child, so
        # `metis-tpu why` can walk a served tenant plan back to the
        # capacity event that displaced it.
        self.decisions = decisions
        self.last_decision_seq: int | None = None
        # obs.metrics.MetricsRegistry (the serve daemon passes its own):
        # fleet utilization/objective + per-tenant gauges refresh on every
        # schedule(); preemption counters tick in apply_delta().  None
        # (library use) records nothing.
        from metis_tpu_torch.obs.metrics import NULL_METRICS
        self.metrics = metrics if metrics is not None else NULL_METRICS
        # optional callable (spec, cluster, sub_cluster, node_indices) ->
        # warm CandidateEvaluator or None: the serve daemon hands tenants'
        # training searches their retained planner.api.make_search_state
        # evaluators, so a re-partition that lands a tenant back on a
        # carve it planned before starts with every memo table warm.
        # ``cluster`` is the topology ``node_indices`` index into (the
        # current fleet, or the reference topology for the baseline).
        # Ranking is byte-identical either way (the state caches the same
        # floats the cold path computes).
        self.search_state_provider = search_state_provider
        self.registry = TenantRegistry()
        self._stores: dict[str, ProfileStore] = {}
        self._baseline: dict[str, float] = {}
        self._memo: dict[tuple, _Planned] = {}
        self.last_plan: FleetPlan | None = None

    # -- admission --------------------------------------------------------

    def admit(self, spec: TenantSpec,
              profiles: ProfileStore | None = None) -> TenantSpec:
        """Register a tenant and compute its full-fleet baseline utility
        (the denominator of ``utility_frac``).  Raises
        :class:`FleetOverCommitError` when the new floor pushes the sum of
        floors past the CURRENT capacity — admission control, so an
        unsatisfiable tenant never enters a partition."""
        need = self.registry.total_quota_floor + spec.quota_floor
        cap = self.cluster.total_devices
        if need > cap:
            raise FleetOverCommitError(
                f"cannot admit tenant {spec.name!r}: quota floors would "
                f"sum to {need} devices but the fleet has {cap}",
                required=need, available=cap)
        self.registry.register(spec)
        self._stores[spec.name] = profiles if profiles is not None \
            else self.profiles
        try:
            base = self._plan_tenant(
                spec, self.full_cluster,
                tuple(range(len(self.full_cluster.nodes))))
        except Exception:
            # a tenant whose baseline search cannot even run (model the
            # profile store does not cover) must not stay registered
            self.registry.remove(spec.name)
            self._stores.pop(spec.name, None)
            raise
        self._baseline[spec.name] = base.utility
        self.events.emit("tenant_admit", tenant=spec.name,
                         priority=spec.priority, kind=spec.kind,
                         quota_floor=spec.quota_floor)
        return spec

    def remove(self, name: str) -> TenantSpec:
        spec = self.registry.remove(name)
        self._stores.pop(name, None)
        self._baseline.pop(name, None)
        # memo keys are (tenant, node shapes) with no model/config hash;
        # remove + re-register is the supported way to change a tenant's
        # spec, so the re-admitted tenant must never inherit plans
        # memoized for the old one
        for key in [k for k in self._memo if k[0] == name]:
            del self._memo[key]
        return spec

    # -- partitioning (pure helpers) --------------------------------------

    def _offer_order(self, cluster: ClusterSpec) -> list[int]:
        """Node indices in grant order: lowest hazard first (reserved
        before spot), physical rank as the deterministic tie-break — the
        price-aware part of the carve-up."""
        return sorted(
            range(len(cluster.nodes)),
            key=lambda i: (
                cluster.devices[cluster.nodes[i].device_type].hazard_per_hr,
                i))

    def _assign(self, cluster: ClusterSpec, order: tuple[TenantSpec, ...],
                shares: dict[str, int]) -> dict[str, tuple[int, ...]]:
        """Whole-node carve toward per-tenant device targets.

        Tenants draw nodes in allocation order from the hazard-sorted
        offer; a surplus take (beyond the tenant's own floor) is refused
        whenever it would leave the pool unable to cover the floors of the
        tenants still waiting.  Post-checks every floor and raises
        :class:`FleetOverCommitError` when node granularity defeats one.
        Pure: identical inputs give identical output, which is what makes
        shrink-then-grow land on byte-identical fleet state."""
        cap = cluster.total_devices
        offer = [(i, cluster.nodes[i]) for i in self._offer_order(cluster)]
        pool = sum(n.num_devices for _, n in offer)
        given = {t.name: 0 for t in order}
        alloc: dict[str, list[int]] = {t.name: [] for t in order}
        for pos, t in enumerate(order):
            ceiling = t.ceiling_or(cap)
            target = min(max(shares.get(t.name, 0), t.quota_floor), ceiling)
            rest_floor = sum(x.quota_floor for x in order[pos + 1:])
            keep = []
            for idx, node in offer:
                have = given[t.name]
                fits = have + node.num_devices <= ceiling
                wants = have < target
                to_floor = have < t.quota_floor
                safe = pool - node.num_devices >= rest_floor
                if wants and fits and (to_floor or safe):
                    alloc[t.name].append(idx)
                    given[t.name] = have + node.num_devices
                    pool -= node.num_devices
                else:
                    keep.append((idx, node))
            offer = keep
        for t in order:
            if given[t.name] < t.quota_floor:
                raise FleetOverCommitError(
                    f"tenant {t.name!r} lands at {given[t.name]} devices, "
                    f"below its quota floor of {t.quota_floor} "
                    "(node granularity defeats the floor)",
                    required=t.quota_floor, available=given[t.name])
        return {name: tuple(sorted(ix)) for name, ix in alloc.items()}

    def _share_candidates(
            self, order: tuple[TenantSpec, ...],
            cap: int) -> list[tuple[str, dict[str, int]]]:
        """Deduplicated share-target candidates the objective arbitrates:
        priority-weighted surplus split, even split, and top-priority
        fill.  Enumeration order is the deterministic tie-break."""
        floors = {t.name: t.quota_floor for t in order}
        surplus = cap - sum(floors.values())

        def clamp(raw: dict[str, int]) -> dict[str, int]:
            # ceiling-clamp, then hand the clamped-off excess to the
            # first tenants (allocation order) that still have headroom.
            out = {}
            excess = 0
            for t in order:
                c = t.ceiling_or(cap)
                want = max(raw[t.name], floors[t.name])
                out[t.name] = min(want, c)
                excess += want - out[t.name]
            for t in order:
                if excess <= 0:
                    break
                c = t.ceiling_or(cap)
                room = c - out[t.name]
                take = min(room, excess)
                out[t.name] += take
                excess -= take
            return out

        cands: list[tuple[str, dict[str, int]]] = []

        weights = {t.name: 1 + max(t.priority, 0) for t in order}
        total_w = sum(weights.values()) or 1
        raw = {}
        handed = 0
        for i, t in enumerate(order):
            cut = (surplus * weights[t.name]) // total_w \
                if i < len(order) - 1 else surplus - handed
            handed += cut
            raw[t.name] = floors[t.name] + cut
        cands.append(("weighted", clamp(raw)))

        n = len(order)
        raw = {}
        for i, t in enumerate(order):
            cut = surplus // n + (1 if i < surplus % n else 0)
            raw[t.name] = floors[t.name] + cut
        cands.append(("even", clamp(raw)))

        raw = dict(floors)
        left = surplus
        for t in order:
            room = t.ceiling_or(cap) - floors[t.name]
            take = min(max(room, 0), left)
            raw[t.name] = floors[t.name] + take
            left -= take
        cands.append(("topfill", clamp(raw)))

        seen: set[tuple] = set()
        out = []
        for label, shares in cands:
            key = tuple(shares[t.name] for t in order)
            if key not in seen:
                seen.add(key)
                out.append((label, shares))
        return out

    # -- per-tenant planning ----------------------------------------------

    def _plan_tenant(self, spec: TenantSpec, cluster: ClusterSpec,
                     node_indices: tuple[int, ...]) -> _Planned:
        """Run the tenant's planner on its carve, memoized on the carve's
        node multiset (two carves with identical node shapes plan
        identically, so candidates share searches)."""
        if not node_indices:
            return _Planned(False, 0.0, None, None)
        sub = cluster.subset(node_indices)
        key = (spec.name,
               tuple((n.device_type, n.num_devices) for n in sub.nodes))
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        store = self._stores.get(spec.name, self.profiles)
        if spec.workload is not None:
            res = plan_inference(sub, store, spec.model, spec.config,
                                 spec.workload,
                                 **({"top_k": self.top_k}
                                    if self.top_k is not None else {}))
            best = res.best
            feasible = best is not None
            utility = best.cost.throughput_rps if feasible else 0.0
            dump = dump_inference_plans(res, spec.workload) \
                if feasible else None
        else:
            state = None
            if self.search_state_provider is not None:
                state = self.search_state_provider(spec, cluster, sub,
                                                   node_indices)
            res = plan_hetero(sub, store, spec.model, spec.config,
                              top_k=self.top_k, search_state=state)
            best = res.best
            feasible = best is not None
            utility = (spec.config.gbs * 1000.0 / best.cost.total_ms
                       if feasible else 0.0)
            dump = dump_ranked_plans(res.plans) if feasible else None
        planned = _Planned(feasible, utility, dump, best)
        self._memo[key] = planned
        return planned

    def _score(self, cluster: ClusterSpec, order: tuple[TenantSpec, ...],
               assignment: dict[str, tuple[int, ...]],
               label: str) -> FleetPlan:
        allocations = []
        objective = 0.0
        useful = 0
        for t in order:
            ix = assignment.get(t.name, ())
            planned = self._plan_tenant(t, cluster, ix)
            sub = cluster.subset(ix) if ix else None
            devices = sub.total_devices if sub else 0
            base = self._baseline.get(t.name, 0.0)
            frac = planned.utility / base if base > 0 else \
                (1.0 if planned.feasible else 0.0)
            weight = 1 + max(t.priority, 0)
            objective += weight * frac
            if planned.feasible:
                useful += devices
            allocations.append(TenantAllocation(
                tenant=t.name, kind=t.kind, priority=t.priority,
                node_indices=ix, devices=devices,
                reserved_devices=(sub.num_devices_by_tier("reserved")
                                  if sub else 0),
                spot_devices=(sub.num_devices_by_tier("spot")
                              if sub else 0),
                feasible=planned.feasible, utility=planned.utility,
                utility_frac=frac, plan_json=planned.plan_json))
        total = cluster.total_devices
        return FleetPlan(
            cluster_devices=total,
            shares_label=label,
            objective=objective,
            utilization_frac=(useful / total) if total else 0.0,
            allocations=tuple(sorted(allocations, key=lambda a: a.tenant)))

    # -- fleet operations --------------------------------------------------

    def schedule(self, decision_cause: str = "",
                 decision_parent: int | None = None) -> FleetPlan:
        """Carve the CURRENT cluster across all registered tenants and
        return the objective-maximizing fleet plan.  Deterministic: ties
        between candidates keep the earliest in enumeration order.

        ``decision_cause`` / ``decision_parent`` label the provenance
        record ("preemption", the triggering ``cluster_delta`` seq, ...)
        when a :class:`~metis_tpu_torch.obs.provenance.DecisionLog` is
        attached."""
        order = self.registry.allocation_order()
        cap = self.cluster.total_devices
        if not order:
            plan = FleetPlan(cap, "none", 0.0, 0.0, ())
            self.last_plan = plan
            return plan
        if self.registry.total_quota_floor > cap:
            raise FleetOverCommitError(
                f"quota floors sum to {self.registry.total_quota_floor} "
                f"devices but the fleet has {cap}",
                required=self.registry.total_quota_floor, available=cap)
        best: FleetPlan | None = None
        errors: list[FleetOverCommitError] = []
        for label, shares in self._share_candidates(order, cap):
            try:
                assignment = self._assign(self.cluster, order, shares)
            except FleetOverCommitError as e:
                errors.append(e)
                continue
            plan = self._score(self.cluster, order, assignment, label)
            if best is None or plan.objective > best.objective:
                best = plan
        if best is None:
            raise errors[0]
        self.events.emit(
            "fleet_objective", objective=round(best.objective, 9),
            utilization_frac=round(best.utilization_frac, 9),
            tenants=len(order), shares_label=best.shares_label,
            cluster_devices=cap)
        m = self.metrics
        m.gauge("metis_fleet_utilization_frac").set(best.utilization_frac)
        m.gauge("metis_fleet_objective").set(best.objective)
        for a in best.allocations:
            # gauges for removed tenants go stale rather than vanish —
            # Prometheus has no unregister; dashboards filter on the
            # current tenant set from /stats
            m.gauge("metis_fleet_tenant_utilization_frac",
                    tenant=a.tenant).set(a.utility_frac)
            m.gauge("metis_fleet_tenant_devices",
                    tenant=a.tenant).set(a.devices)
        if self.decisions is not None:
            dec = self.decisions.record(
                "fleet_repartition",
                cause=decision_cause, parent_seq=decision_parent,
                detail={"objective": round(best.objective, 9),
                        "utilization_frac": round(
                            best.utilization_frac, 9),
                        "shares_label": best.shares_label,
                        "tenants": len(order),
                        "cluster_devices": cap})
            self.last_decision_seq = dec.seq
        self.last_plan = best
        return best

    def apply_delta(self, removed: dict[str, int] | None = None,
                    added: dict[str, int] | None = None,
                    decision_cause: str = "",
                    decision_parent: int | None = None
                    ) -> tuple[FleetPlan, dict[str, dict]]:
        """Re-partition after capacity change — the robustness core.

        Shrinks peel from the end of the node list (``shrink_cluster``),
        grows restore toward the full reference topology
        (``grow_cluster``), and the pure re-partition runs on the
        survivor.  Per tenant the delta produces: a ``tenant_preempt``
        event when its device count drops, and a ``tenant_replan`` event
        (with the migrate-vs-checkpoint decision for training tenants)
        when its carve changed at all.  Returns the new fleet plan plus
        the per-tenant switch decisions.  Raises
        :class:`FleetOverCommitError` — leaving fleet state untouched —
        when the surviving capacity cannot cover the quota floors,
        whether the floor sum fails upfront or node granularity defeats
        a floor during assignment."""
        delta = ClusterDelta(added=dict(added or {}),
                             removed=dict(removed or {}))
        new_cluster = delta.apply(self.cluster, full=self.full_cluster)
        floors = self.registry.total_quota_floor
        if floors > new_cluster.total_devices:
            raise FleetOverCommitError(
                f"capacity change leaves {new_cluster.total_devices} "
                f"devices but quota floors sum to {floors}",
                required=floors, available=new_cluster.total_devices)
        old_plan = self.last_plan
        old_cluster = self.cluster
        # the floor-sum pre-check above is necessary but not sufficient:
        # node granularity can still defeat a floor inside _assign, so
        # commit the new topology only once scheduling on it succeeds
        self.cluster = new_cluster
        try:
            plan = self.schedule(decision_cause=decision_cause,
                                 decision_parent=decision_parent)
        except Exception:
            self.cluster = old_cluster
            self.last_plan = old_plan
            raise
        decisions: dict[str, dict] = {}
        for t in self.registry.preemption_order():
            old_alloc = old_plan.allocation(t.name) if old_plan else None
            new_alloc = plan.allocation(t.name)
            if old_alloc is None or new_alloc is None:
                continue
            preempted = new_alloc.devices < old_alloc.devices
            changed = (new_alloc.node_indices != old_alloc.node_indices
                       or new_alloc.devices != old_alloc.devices)
            if preempted:
                self.events.emit(
                    "tenant_preempt", tenant=t.name,
                    from_devices=old_alloc.devices,
                    to_devices=new_alloc.devices, priority=t.priority)
                self.metrics.counter("metis_fleet_preemptions_total",
                                     tenant=t.name).inc()
            if changed:
                decision = self._switch_decision(t, old_alloc, new_alloc,
                                                 old_cluster)
                self.events.emit("tenant_replan", tenant=t.name,
                                 devices=new_alloc.devices, **decision)
                decisions[t.name] = {
                    **decision,
                    "devices": new_alloc.devices,
                    "from_devices": old_alloc.devices,
                    "to_devices": new_alloc.devices,
                    "preempted": preempted,
                    "feasible": new_alloc.feasible,
                }
                if self.decisions is not None:
                    # child chain: repartition -> tenant_replan ->
                    # migration_decision, so a tenant's served plan walks
                    # back through its displacement to the capacity event
                    trep = self.decisions.record(
                        "tenant_replan",
                        plan_fingerprint=self._alloc_fingerprint(
                            new_alloc),
                        parent_seq=self.last_decision_seq,
                        cause=decision_cause, tenant=t.name,
                        detail={"devices": new_alloc.devices,
                                "from_devices": old_alloc.devices,
                                "preempted": preempted,
                                "feasible": new_alloc.feasible})
                    decisions[t.name]["decision_seq"] = trep.seq
                    if t.workload is None:
                        self.decisions.record(
                            "migration_decision",
                            plan_fingerprint=self._alloc_fingerprint(
                                new_alloc),
                            parent_seq=trep.seq, cause=decision_cause,
                            tenant=t.name,
                            detail={"path": decision.get("path"),
                                    "migration_ms":
                                        decision.get("migration_ms")})
        return plan, decisions

    # -- durable state ------------------------------------------------------

    def export_state(self) -> dict:
        """JSON-serializable fleet state for the serve daemon's snapshot/
        oplog (``serve/persist.py``): registered tenant specs, baselines,
        the memoized per-carve search outcomes, and the last fleet plan.

        ``plan_json`` strings are carried VERBATIM (never parsed and
        re-dumped) — byte-identity of a tenant's served plan across a
        restore is the HA drill's closing assertion.  The memo's live
        ``best`` objects are not serializable and restore as None; the
        one degradation is that :meth:`_switch_decision` prices a
        displaced tenant's first post-restore move as "ckpt" instead of
        comparing layouts (documented in README "Persistence & HA")."""
        import dataclasses as _dc

        def _alloc(a: TenantAllocation) -> dict:
            return {
                "tenant": a.tenant, "kind": a.kind,
                "priority": a.priority,
                "node_indices": list(a.node_indices),
                "devices": a.devices,
                "reserved_devices": a.reserved_devices,
                "spot_devices": a.spot_devices,
                "feasible": a.feasible,
                "utility": a.utility,
                "utility_frac": a.utility_frac,
                "plan_json": a.plan_json,
            }

        plan = self.last_plan
        return {
            "tenants": [_dc.asdict(t) for t in
                        self.registry.allocation_order()],
            "baseline": dict(self._baseline),
            "memo": [
                [[name, [list(shape) for shape in shapes]],
                 {"feasible": p.feasible, "utility": p.utility,
                  "plan_json": p.plan_json}]
                for (name, shapes), p in self._memo.items()],
            "last_plan": None if plan is None else {
                "cluster_devices": plan.cluster_devices,
                "shares_label": plan.shares_label,
                "objective": plan.objective,
                "utilization_frac": plan.utilization_frac,
                "allocations": [_alloc(a) for a in plan.allocations],
            },
            "last_decision_seq": self.last_decision_seq,
        }

    def restore_state(self, state: dict) -> None:
        """Rebuild fleet state from :meth:`export_state` output without
        re-running a single search — restore must be fast (the HA drill
        budgets 1 s for the whole daemon), and re-searching could not
        reproduce the served plans byte-identically anyway if profiles
        changed underneath.  Per-tenant profile-store overrides are not
        persisted (the daemon's ``tenant_register`` never passes one);
        every restored tenant plans against the shared store."""
        from metis_tpu_torch.sched.tenant import tenant_from_dict

        self.registry = TenantRegistry()
        self._stores = {}
        for td in state.get("tenants", []):
            spec = tenant_from_dict(td)
            self.registry.register(spec)
            self._stores[spec.name] = self.profiles
        self._baseline = {name: float(v) for name, v in
                          state.get("baseline", {}).items()}
        self._memo = {
            (key[0], tuple((shape[0], int(shape[1]))
                           for shape in key[1])):
                _Planned(feasible=bool(p["feasible"]),
                         utility=float(p["utility"]),
                         plan_json=p.get("plan_json"), best=None)
            for key, p in state.get("memo", [])}
        lp = state.get("last_plan")
        if lp is None:
            self.last_plan = None
        else:
            self.last_plan = FleetPlan(
                cluster_devices=int(lp["cluster_devices"]),
                shares_label=lp["shares_label"],
                objective=float(lp["objective"]),
                utilization_frac=float(lp["utilization_frac"]),
                allocations=tuple(
                    TenantAllocation(
                        tenant=a["tenant"], kind=a["kind"],
                        priority=int(a["priority"]),
                        node_indices=tuple(a["node_indices"]),
                        devices=int(a["devices"]),
                        reserved_devices=int(a["reserved_devices"]),
                        spot_devices=int(a["spot_devices"]),
                        feasible=bool(a["feasible"]),
                        utility=float(a["utility"]),
                        utility_frac=float(a["utility_frac"]),
                        plan_json=a.get("plan_json"))
                    for a in lp["allocations"]))
        self.last_decision_seq = state.get("last_decision_seq")

    @staticmethod
    def _alloc_fingerprint(alloc: TenantAllocation) -> str:
        """Plan fingerprint of an allocation's best ranked plan, from its
        serialized dump ("" when infeasible or not parseable)."""
        if not alloc.plan_json:
            return ""
        try:
            data = json.loads(alloc.plan_json)
        except (ValueError, TypeError):
            return ""
        if isinstance(data, dict):  # dump_inference_plans payload
            data = data.get("plans") or []
        if not (isinstance(data, list) and data
                and isinstance(data[0], dict)):
            return ""
        from metis_tpu_torch.obs.provenance import fingerprint_plan_dict
        return fingerprint_plan_dict(data[0])

    def _switch_decision(self, spec: TenantSpec,
                         old_alloc: TenantAllocation,
                         new_alloc: TenantAllocation,
                         old_cluster: ClusterSpec) -> dict:
        """Migrate-vs-checkpoint-restore for a displaced tenant, via the
        supervisor's shared rule.  Inference tenants are stateless at this
        layer — routing just moves to the new plan."""
        if spec.workload is not None:
            return {"path": "reroute", "migration_ms": None}
        if not (old_alloc.feasible and new_alloc.feasible):
            return {"path": "ckpt", "migration_ms": None}
        from metis_tpu_torch.cost.volume import TransformerVolume
        from metis_tpu_torch.execution.mesh import PlanArtifact
        from metis_tpu_torch.execution.reshard import stage_layout
        from metis_tpu_torch.resilience.supervisor import migration_decision

        store = self._stores.get(spec.name, self.profiles)
        volume = TransformerVolume(spec.model,
                                   store.model.params_per_layer_bytes)
        old_best = self._best_for(spec, old_alloc, old_cluster)
        new_best = self._best_for(spec, new_alloc, self.cluster)
        if old_best is None or new_best is None:
            return {"path": "ckpt", "migration_ms": None}
        path, price_ms = migration_decision(
            stage_layout(PlanArtifact.from_ranked_plan(old_best),
                         spec.model.num_layers),
            stage_layout(PlanArtifact.from_ranked_plan(new_best),
                         spec.model.num_layers),
            volume, spec.config.migration_bw_gbps,
            spec.config.spot_recover_s)
        return {"path": path,
                "migration_ms": round(price_ms, 6)
                if price_ms is not None else None}

    def _best_for(self, spec: TenantSpec, alloc: TenantAllocation,
                  cluster: ClusterSpec):
        """The memoized best ranked plan behind an allocation (the memo is
        keyed on node shapes, so this never re-searches).  ``cluster``
        must be the topology the allocation's indices were carved from."""
        if not alloc.node_indices:
            return None
        try:
            sub = cluster.subset(alloc.node_indices)
        except Exception:
            return None
        key = (spec.name,
               tuple((n.device_type, n.num_devices) for n in sub.nodes))
        hit = self._memo.get(key)
        return hit.best if hit is not None else None
