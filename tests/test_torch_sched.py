"""The port's multi-tenant fleet scheduler (``metis_tpu_torch/sched/``)
against the reference's (``metis_tpu/sched/``).

The reference's ``tests/test_sched.py`` runs on the port, its tenant
drill cases (``TestTenantDrill``) on the port's drill
(``metis_tpu_torch/resilience/fleet_drill.py``), with the reference's
synthetic profiles read back through the profile JSON contract.  The two packages are then held to each other: on the same
fixture and the same sequence of admissions, shrinks, grows and removals
the port's fleet plans dump byte-identically to the reference's, its
switch decisions and exported state are equal, each package restores the
other's exported state, and the port's scheduler events pass the
reference's event schema.

The reference's contracts:
- TenantSpec/TenantRegistry: typed validation (zero-quota rejection,
  floor/ceiling sanity), deterministic allocation + preemption orders.
- FleetScheduler: a lone tenant's plan is byte-identical to the
  single-job planner output (training AND inference), quota floors are
  hard (FleetOverCommitError on admit and on shrink, before any state
  mutation), equal-priority tie-breaks are name-deterministic, a
  shrink->grow round trip restores the fleet plan byte-identically, and
  preemption displaces the lowest priority first.
- PlanService tenant integration: tenant-routed /plan byte-identity,
  tenant-tagged cache keys surviving deltas that didn't move the tenant,
  typed errors for unknown tenants.
- The multi-tenant chaos drill (``run_tenant_drill``): evictions preempt
  tenants without breaching a floor, the closing fleet state equals the
  baseline, the same seed replays the same report — and the port's report
  equals the reference drill's.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

from metis_tpu_torch.cluster import ClusterSpec
from metis_tpu_torch.core.config import SearchConfig
from metis_tpu_torch.core.errors import FleetOverCommitError, TenantSpecError
from metis_tpu_torch.sched import FleetScheduler, TenantRegistry, TenantSpec

import metis_tpu.cluster.spec as jcluster  # noqa: E402
import metis_tpu.inference.workload as jworkload  # noqa: E402
import metis_tpu.sched as jsched  # noqa: E402
import metis_tpu_torch.cluster.spec as tcluster  # noqa: E402
import metis_tpu_torch.inference.workload as tworkload  # noqa: E402
import metis_tpu_torch.sched as tsched  # noqa: E402
from metis_tpu.testing import PARITY_INFERENCE
from torch_serve_reference import (
    both_stores,
    dump_synthetic,
    ref_config,
    ref_model,
    synthesize_profiles,
    tiny_test_model,
)

@pytest.fixture(scope="module")
def fleet_fixture():
    """4 nodes of 2 devices (2xA100 + 2xT4): fine enough node granularity
    that two 2-device quota floors survive a shrink to one type."""
    model = tiny_test_model(num_layers=4)
    profiles = synthesize_profiles(model, ["A100", "T4"], tps=[1, 2],
                                   bss=[1, 2, 4])
    cluster = ClusterSpec.of(("A100", 2, 2), ("T4", 2, 2))
    config = SearchConfig(gbs=16, max_profiled_tp=2, max_profiled_bs=4)
    return cluster, profiles, model, config


def _workload():
    from metis_tpu_torch.inference.workload import InferenceWorkload

    return InferenceWorkload(**PARITY_INFERENCE)


# ---------------------------------------------------------------------------
# TenantSpec / TenantRegistry
# ---------------------------------------------------------------------------


class TestTenantSpec:
    def test_zero_quota_ceiling_rejected_typed(self, fleet_fixture):
        _, _, model, config = fleet_fixture
        with pytest.raises(TenantSpecError, match="zero-quota"):
            TenantSpec("t", model, config, quota_ceiling=0)

    def test_bad_specs_rejected_typed(self, fleet_fixture):
        _, _, model, config = fleet_fixture
        with pytest.raises(TenantSpecError, match="non-empty"):
            TenantSpec("", model, config)
        with pytest.raises(TenantSpecError, match="quota_floor"):
            TenantSpec("t", model, config, quota_floor=-1)
        with pytest.raises(TenantSpecError, match="quota_ceiling"):
            TenantSpec("t", model, config, quota_ceiling=-2)
        with pytest.raises(TenantSpecError, match="< quota_floor"):
            TenantSpec("t", model, config, quota_floor=8, quota_ceiling=4)

    def test_kind_and_effective_ceiling(self, fleet_fixture):
        _, _, model, config = fleet_fixture
        train = TenantSpec("t", model, config, quota_ceiling=6)
        serve = TenantSpec("s", model, config, workload=_workload())
        assert train.kind == "training"
        assert serve.kind == "inference"
        assert train.ceiling_or(16) == 6
        assert serve.ceiling_or(16) == 16  # unbounded -> fleet cap

    def test_roundtrip_through_dict(self, fleet_fixture):
        import dataclasses

        from metis_tpu_torch.sched import tenant_from_dict

        _, _, model, config = fleet_fixture
        spec = TenantSpec("t", model, config, priority=2, quota_floor=2,
                          workload=_workload())
        rebuilt = tenant_from_dict(dataclasses.asdict(spec))
        assert rebuilt == spec


class TestTenantRegistry:
    def test_register_remove_and_typed_misses(self, fleet_fixture):
        _, _, model, config = fleet_fixture
        reg = TenantRegistry()
        reg.register(TenantSpec("a", model, config))
        with pytest.raises(TenantSpecError, match="already registered"):
            reg.register(TenantSpec("a", model, config))
        with pytest.raises(TenantSpecError, match="no such tenant"):
            reg.get("b")
        assert reg.remove("a").name == "a"
        with pytest.raises(TenantSpecError, match="no such tenant"):
            reg.remove("a")

    def test_orders_are_deterministic_and_reversed(self, fleet_fixture):
        _, _, model, config = fleet_fixture
        reg = TenantRegistry()
        # registration order scrambled on purpose: order must come from
        # (-priority, name), never from dict insertion
        reg.register(TenantSpec("zeta", model, config, priority=1))
        reg.register(TenantSpec("beta", model, config, priority=0))
        reg.register(TenantSpec("alpha", model, config, priority=1))
        alloc = [t.name for t in reg.allocation_order()]
        assert alloc == ["alpha", "zeta", "beta"]
        assert [t.name for t in reg.preemption_order()] == alloc[::-1]
        assert reg.total_quota_floor == 0
        assert reg.names() == ("alpha", "beta", "zeta")


# ---------------------------------------------------------------------------
# FleetScheduler
# ---------------------------------------------------------------------------


class TestFleetScheduler:
    def test_single_training_tenant_byte_identical(self, fleet_fixture):
        from metis_tpu_torch.core.types import dump_ranked_plans
        from metis_tpu_torch.planner import plan_hetero

        cluster, profiles, model, config = fleet_fixture
        offline = dump_ranked_plans(
            plan_hetero(cluster, profiles, model, config).plans)
        sched = FleetScheduler(cluster, profiles)
        sched.admit(TenantSpec("solo", model, config, quota_floor=2))
        plan = sched.schedule()
        alloc = plan.allocation("solo")
        assert alloc.devices == cluster.total_devices
        assert alloc.plan_json == offline

    def test_single_inference_tenant_byte_identical(self, fleet_fixture):
        from metis_tpu_torch.inference.planner import (
            dump_inference_plans,
            plan_inference,
        )

        cluster, profiles, model, config = fleet_fixture
        workload = _workload()
        offline = dump_inference_plans(
            plan_inference(cluster, profiles, model, config, workload),
            workload)
        sched = FleetScheduler(cluster, profiles)
        sched.admit(TenantSpec("solo", model, config, quota_floor=2,
                               workload=workload))
        alloc = sched.schedule().allocation("solo")
        assert alloc.devices == cluster.total_devices
        assert alloc.plan_json == offline

    def test_admit_overcommit_typed_and_rolled_back(self, fleet_fixture):
        cluster, profiles, model, config = fleet_fixture
        sched = FleetScheduler(cluster, profiles)
        sched.admit(TenantSpec("a", model, config, quota_floor=6))
        with pytest.raises(FleetOverCommitError) as ei:
            sched.admit(TenantSpec("b", model, config, quota_floor=4))
        assert ei.value.required == 10
        assert ei.value.available == cluster.total_devices
        # the rejected tenant must not linger in the registry
        assert "b" not in sched.registry
        assert len(sched.registry) == 1

    def test_equal_priority_tie_break_is_name_deterministic(
            self, fleet_fixture):
        cluster, profiles, model, config = fleet_fixture

        def carve(order):
            sched = FleetScheduler(cluster, profiles)
            for name in order:
                sched.admit(TenantSpec(name, model, config, priority=1,
                                       quota_floor=2))
            return sched.schedule()

        first = carve(["beta", "alpha"])
        second = carve(["alpha", "beta"])
        # registration order must not matter; repeated runs byte-identical
        assert first.dump() == second.dump()
        a, b = first.allocation("alpha"), first.allocation("beta")
        # name ascending wins the tie: alpha draws first from the offer
        assert a.node_indices < b.node_indices

    def test_shrink_below_floors_raises_before_mutation(self, fleet_fixture):
        cluster, profiles, model, config = fleet_fixture
        sched = FleetScheduler(cluster, profiles)
        sched.admit(TenantSpec("a", model, config, priority=1,
                               quota_floor=4))
        sched.admit(TenantSpec("b", model, config, quota_floor=2))
        before = sched.schedule().dump()
        with pytest.raises(FleetOverCommitError):
            sched.apply_delta(removed={"T4": 4, "A100": 2})
        # failed delta left the fleet untouched
        assert sched.cluster.total_devices == cluster.total_devices
        assert sched.last_plan.dump() == before

    def test_shrink_grow_round_trip_byte_identical(self, fleet_fixture):
        cluster, profiles, model, config = fleet_fixture
        sched = FleetScheduler(cluster, profiles)
        sched.admit(TenantSpec("hi", model, config, priority=1,
                               quota_floor=2))
        sched.admit(TenantSpec("lo", model, config, quota_floor=2))
        baseline = sched.schedule().dump()
        shrunk, _ = sched.apply_delta(removed={"T4": 2})
        assert shrunk.dump() != baseline
        healed, _ = sched.apply_delta(added={"T4": 2})
        assert healed.dump() == baseline

    def test_preemption_hits_lowest_priority_first(self, fleet_fixture):
        cluster, profiles, model, config = fleet_fixture
        sched = FleetScheduler(cluster, profiles)
        sched.admit(TenantSpec("hi", model, config, priority=1,
                               quota_floor=2))
        sched.admit(TenantSpec("lo", model, config, priority=0,
                               quota_floor=2))
        before = sched.schedule()
        _, decisions = sched.apply_delta(removed={"T4": 2})
        lo = decisions["lo"]
        assert lo["preempted"] and lo["to_devices"] == 2
        # the high-priority tenant kept (at least) its share
        hi_before = before.allocation("hi").devices
        assert sched.last_plan.allocation("hi").devices >= min(hi_before, 4)
        # floors held for everyone
        for alloc in sched.last_plan.allocations:
            assert alloc.devices >= 2
            assert alloc.feasible

    def test_remove_purges_memo_for_reregistered_spec(self, fleet_fixture):
        """remove + re-register is the supported way to change a tenant's
        spec; the memo is keyed on (name, node shapes) only, so a stale
        entry would silently serve the OLD spec's plans."""
        cluster, profiles, model, config = fleet_fixture
        sched = FleetScheduler(cluster, profiles)
        sched.admit(TenantSpec("solo", model, config, quota_floor=2))
        training = sched.schedule().allocation("solo")
        assert training.kind == "training" and training.feasible
        sched.remove("solo")
        workload = _workload()
        sched.admit(TenantSpec("solo", model, config, quota_floor=2,
                               workload=workload))
        routed = sched.schedule().allocation("solo")
        assert routed.kind == "inference" and routed.feasible
        from metis_tpu_torch.inference.planner import (
            dump_inference_plans,
            plan_inference,
        )
        offline = dump_inference_plans(
            plan_inference(cluster, profiles, model, config, workload),
            workload)
        assert routed.plan_json == offline
        assert routed.plan_json != training.plan_json

    def test_granularity_rejected_delta_leaves_state_untouched(
            self, fleet_fixture):
        """Floors 3+3 on 2-device nodes: a shrink to 6 devices passes the
        floor-sum pre-check but node granularity defeats tenant b's floor
        inside _assign — the failed delta must not commit the shrunk
        cluster (stale last_plan indices would then break every tenant
        query)."""
        cluster, profiles, model, config = fleet_fixture
        sched = FleetScheduler(cluster, profiles)
        sched.admit(TenantSpec("a", model, config, quota_floor=3))
        sched.admit(TenantSpec("b", model, config, quota_floor=3))
        before = sched.schedule().dump()
        with pytest.raises(FleetOverCommitError):
            sched.apply_delta(removed={"T4": 2})
        assert sched.cluster.total_devices == cluster.total_devices
        assert sched.last_plan.dump() == before
        # the scheduler keeps working after the rejected delta
        assert sched.schedule().dump() == before

    def test_switch_decision_paths(self, fleet_fixture):
        cluster, profiles, model, config = fleet_fixture
        sched = FleetScheduler(cluster, profiles)
        sched.admit(TenantSpec("train", model, config, priority=1,
                               quota_floor=2))
        sched.admit(TenantSpec("serve", model, config, quota_floor=4,
                               workload=_workload()))
        sched.schedule()
        _, decisions = sched.apply_delta(removed={"T4": 2})
        for name, d in decisions.items():
            kind = sched.registry.get(name).kind
            if kind == "inference":
                assert d["path"] == "reroute"
            else:
                assert d["path"] in ("migrate", "ckpt")
                if d["path"] == "migrate":
                    assert d["migration_ms"] > 0


# ---------------------------------------------------------------------------
# Serve-daemon tenant integration (in-process, no HTTP — transport is
# covered by the tenant drill)
# ---------------------------------------------------------------------------


class TestServeTenants:
    @pytest.fixture()
    def service(self, fleet_fixture):
        from metis_tpu_torch.serve.daemon import PlanService

        cluster, profiles, _, _ = fleet_fixture
        return PlanService(cluster, profiles)

    def test_tenant_plan_byte_identical_to_plan_query(self, fleet_fixture,
                                                      service):
        _, _, model, config = fleet_fixture
        direct = service.plan_query(model, config)
        service.tenant_register(TenantSpec("solo", model, config,
                                           quota_floor=2))
        routed = service.tenant_plan("solo")
        assert routed["plans"] == direct["plans"]
        assert routed["feasible"]
        # second call answers from the tenant-tagged cache entry
        assert service.tenant_plan("solo")["cached"]

    def test_identical_reregister_is_idempotent(self, fleet_fixture,
                                                service):
        """The HTTP client retries POSTs on connection errors, so a
        register whose response was dropped must answer the retry from
        the current fleet plan instead of 400ing."""
        _, _, model, config = fleet_fixture
        spec = TenantSpec("solo", model, config, priority=1, quota_floor=2)
        first = service.tenant_register(spec)
        again = service.tenant_register(TenantSpec("solo", model, config,
                                                   priority=1,
                                                   quota_floor=2))
        assert again["devices"] == first["devices"]
        assert again["feasible"] == first["feasible"]
        assert again["tenants_changed"] == []
        # a DIFFERENT spec under the same name is a conflict, not a retry
        with pytest.raises(TenantSpecError, match="already registered"):
            service.tenant_register(TenantSpec("solo", model, config,
                                               priority=2, quota_floor=2))

    def test_unknown_tenant_typed_error(self, service):
        with pytest.raises(TenantSpecError, match="no such tenant"):
            service.tenant_plan("ghost")
        with pytest.raises(TenantSpecError, match="no such tenant"):
            service.tenant_status("ghost")

    def test_delta_reports_and_invalidates_changed_tenants(
            self, fleet_fixture, service):
        _, _, model, config = fleet_fixture
        service.tenant_register(TenantSpec("hi", model, config, priority=1,
                                           quota_floor=2))
        service.tenant_register(TenantSpec("lo", model, config,
                                           quota_floor=2))
        service.tenant_plan("hi")
        service.tenant_plan("lo")
        out = service.apply_cluster_delta(removed={"T4": 2})
        assert out["tenants_changed"]
        assert set(out["tenants_changed"]) <= {"hi", "lo"}
        status = service.tenant_status()
        assert status["cluster_devices"] == 6
        for alloc in status["allocations"]:
            assert alloc["feasible"] and alloc["devices"] >= 2

    def test_overcommitting_delta_rejected_without_mutation(
            self, fleet_fixture, service):
        _, _, model, config = fleet_fixture
        service.tenant_register(TenantSpec("a", model, config,
                                           quota_floor=4))
        service.tenant_register(TenantSpec("b", model, config,
                                           quota_floor=2))
        with pytest.raises(FleetOverCommitError):
            service.apply_cluster_delta(removed={"T4": 4, "A100": 2})
        # daemon cluster and fleet plan survived the rejected delta
        assert service.cluster.total_devices == 8
        assert service.tenant_status()["cluster_devices"] == 8

    def test_granularity_rejected_delta_keeps_tenants_serving(
            self, fleet_fixture, service):
        """The shrink passes the floor-sum pre-check but fails on node
        granularity inside the scheduler: both the daemon cluster AND
        the scheduler cluster must survive, so tenant queries keep
        resolving against the topology their plan was carved from."""
        _, _, model, config = fleet_fixture
        service.tenant_register(TenantSpec("a", model, config,
                                           quota_floor=3))
        service.tenant_register(TenantSpec("b", model, config,
                                           quota_floor=3))
        before = service.tenant_plan("a")
        with pytest.raises(FleetOverCommitError):
            service.apply_cluster_delta(removed={"T4": 2})
        assert service.cluster.total_devices == 8
        assert service.sched.cluster.total_devices == 8
        after = service.tenant_plan("a")
        assert after["plans"] == before["plans"]
        assert after["node_indices"] == before["node_indices"]

    def test_register_rolled_back_when_granularity_defeats_floor(
            self, fleet_fixture, service):
        """Floors 3+5 sum to exactly the fleet's 8 devices, so admission
        control accepts tenant b — but 2-device nodes leave b at 4.  The
        400 must roll the admission back, or every later schedule and
        delta would keep failing on the half-admitted tenant."""
        _, _, model, config = fleet_fixture
        service.tenant_register(TenantSpec("a", model, config,
                                           quota_floor=3))
        with pytest.raises(FleetOverCommitError):
            service.tenant_register(TenantSpec("b", model, config,
                                               quota_floor=5))
        assert "b" not in service.sched.registry
        status = service.tenant_status()
        assert status["tenants"] == ["a"]
        # the fleet keeps accepting satisfiable tenants afterwards
        out = service.tenant_register(TenantSpec("b", model, config,
                                                 quota_floor=4))
        assert out["feasible"]

    def test_empty_carve_cache_key_never_fingerprints_full_fleet(
            self, fleet_fixture, service):
        """A tenant whose allocation is empty used to fingerprint its
        query against the WHOLE cluster, colliding with a hypothetical
        full-cluster grant; the key now carries an explicit carve
        marker."""
        _, _, model, config = fleet_fixture
        service.tenant_register(TenantSpec("big", model, config,
                                           quota_floor=8, quota_ceiling=8))
        service.tenant_register(TenantSpec("tiny", model, config))
        starved = service.tenant_plan("tiny")
        assert starved["devices"] == 0 and not starved["feasible"]
        assert starved["plans"] is None
        tiny_keys = [k for k in service.cache.keys()
                     if k.startswith("tenant/tiny/")]
        assert tiny_keys and all("/empty/" in k for k in tiny_keys)
        # once the starving tenant leaves, tiny's full grant must not be
        # served from the stale empty-carve entry
        service.tenant_remove("big")
        granted = service.tenant_plan("tiny")
        assert granted["devices"] == 8 and granted["feasible"]
        assert granted["plans"] is not None


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

JAX = dict(sched=jsched, cluster=jcluster, workload=jworkload)
PORT = dict(sched=tsched, cluster=tcluster, workload=tworkload)


@pytest.fixture(scope="module")
def shared_profiles(tmp_path_factory):
    """One profile directory of the fleet fixture's model, read by both
    packages."""
    root = tmp_path_factory.mktemp("sched_profiles")
    dump_synthetic(tiny_test_model(num_layers=4), ["A100", "T4"], root,
                   tps=[1, 2], bss=[1, 2, 4])
    return both_stores(root)


def _spec(pkg, name, workload=False, **kw):
    model = tiny_test_model(num_layers=4)
    config = SearchConfig(gbs=16, max_profiled_tp=2, max_profiled_bs=4)
    if pkg is JAX:
        model, config = ref_model(model), ref_config(config)
    wl = pkg["workload"].InferenceWorkload(**PARITY_INFERENCE) \
        if workload else None
    return pkg["sched"].TenantSpec(name, model, config, workload=wl, **kw)


SCENARIOS = {
    "solo_training": [("admit", "solo", False, dict(quota_floor=2))],
    "solo_inference": [("admit", "solo", True, dict(quota_floor=2))],
    "tie_break": [("admit", "beta", False, dict(priority=1, quota_floor=2)),
                  ("admit", "alpha", False, dict(priority=1, quota_floor=2))],
    "shrink_grow": [("admit", "hi", False, dict(priority=1, quota_floor=2)),
                    ("admit", "lo", False, dict(quota_floor=2)),
                    ("delta", {"removed": {"T4": 2}}),
                    ("delta", {"added": {"T4": 2}})],
    "mixed_preemption": [
        ("admit", "train", False, dict(priority=1, quota_floor=2)),
        ("admit", "serve", True, dict(quota_floor=4)),
        ("delta", {"removed": {"T4": 2}}),
        ("remove", "serve"),
        ("delta", {"added": {"T4": 2}})],
    "three_tenants_ceiling": [
        ("admit", "a", False, dict(priority=2, quota_floor=2,
                                   quota_ceiling=4)),
        ("admit", "b", True, dict(priority=1)),
        ("admit", "c", False, dict(quota_floor=2)),
        ("delta", {"removed": {"A100": 2}})],
}


def _run_scenario(pkg, stores, steps):
    """Every fleet plan's dump and every switch decision of ``steps``."""
    cluster = pkg["cluster"].ClusterSpec.of(("A100", 2, 2), ("T4", 2, 2))
    sched = pkg["sched"].FleetScheduler(
        cluster, stores[0] if pkg is JAX else stores[1])
    out = []
    for step in steps:
        if step[0] == "admit":
            _, name, wl, kw = step
            sched.admit(_spec(pkg, name, wl, **kw))
            out.append(sched.schedule().dump())
        elif step[0] == "remove":
            sched.remove(step[1])
            out.append(sched.schedule().dump())
        else:
            plan, decisions = sched.apply_delta(**step[1])
            out.append(plan.dump())
            out.append(json.dumps(decisions, sort_keys=True))
    return out, sched


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fleet_plans_byte_identical_to_the_reference(shared_profiles, name):
    want, jsch = _run_scenario(JAX, shared_profiles, SCENARIOS[name])
    got, tsch = _run_scenario(PORT, shared_profiles, SCENARIOS[name])
    assert got == want
    assert json.dumps(tsch.export_state(), sort_keys=True) == \
        json.dumps(jsch.export_state(), sort_keys=True)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_exported_state_restores_across_packages(shared_profiles,
                                                 direction):
    """A fleet state exported by one package restores in the other: the
    same last plan, and the same plans after the next shrink."""
    steps = SCENARIOS["shrink_grow"][:2]
    src, dst = (JAX, PORT) if direction == "jax_to_port" else (PORT, JAX)
    _, source = _run_scenario(src, shared_profiles, steps)
    state = json.loads(json.dumps(source.export_state()))
    cluster = dst["cluster"].ClusterSpec.of(("A100", 2, 2), ("T4", 2, 2))
    restored = dst["sched"].FleetScheduler(
        cluster, shared_profiles[0] if dst is JAX else shared_profiles[1])
    restored.restore_state(state)
    assert restored.last_plan.dump() == source.last_plan.dump()
    assert json.dumps(restored.export_state(), sort_keys=True) == \
        json.dumps(source.export_state(), sort_keys=True)
    want, _ = source.apply_delta(removed={"T4": 2})
    got, _ = restored.apply_delta(removed={"T4": 2})
    assert got.dump() == want.dump()


def test_scheduler_events_pass_the_reference_schema(shared_profiles,
                                                    tmp_path):
    from check_events_schema import EVENT_SCHEMA, validate_events

    from metis_tpu_torch.core.events import EventLog, read_events

    path = tmp_path / "sched_events.jsonl"
    log = EventLog(path)
    cluster = tcluster.ClusterSpec.of(("A100", 2, 2), ("T4", 2, 2))
    sched = tsched.FleetScheduler(cluster, shared_profiles[1], events=log)
    sched.admit(_spec(PORT, "hi", priority=1, quota_floor=2))
    sched.admit(_spec(PORT, "lo", quota_floor=2))
    sched.schedule()
    sched.apply_delta(removed={"T4": 2})
    log.close()
    events = read_events(path)
    kinds = {e["event"] for e in events}
    assert {"tenant_admit", "tenant_preempt", "tenant_replan",
            "fleet_objective"} <= kinds <= set(EVENT_SCHEMA)
    assert validate_events(events) == []


# ---------------------------------------------------------------------------
# The multi-tenant chaos drill
# ---------------------------------------------------------------------------

TENANT_DRILL = dict(tenants=3, devices=16, chips_per_node=2, ticks=3,
                    spot_rate_per_hr=0.9, return_rate_per_hr=0.9, seed=0)


class TestTenantDrill:
    def test_tenant_drill_smoke(self, tmp_path):
        from metis_tpu_torch.resilience.fleet_drill import run_tenant_drill

        rep = run_tenant_drill(tmp_path, **TENANT_DRILL)
        assert rep["preempted_nodes"] > 0
        assert rep["tenant_preempt_events"] > 0
        assert rep["closing_state_identical"]
        assert rep["tenant_slo_attainment_min"] > 0.0
        assert 0.0 < rep["fleet_utilization_frac"] <= 1.0

    def test_tenant_drill_deterministic(self, tmp_path):
        from metis_tpu_torch.resilience.fleet_drill import run_tenant_drill

        a = run_tenant_drill(tmp_path / "a", **TENANT_DRILL)
        b = run_tenant_drill(tmp_path / "b", **TENANT_DRILL)
        assert json.dumps(a, sort_keys=True) == json.dumps(b,
                                                           sort_keys=True)

    def test_tenant_drill_equals_reference(self, tmp_path):
        from fleet_drill import run_tenant_drill as ref_drill
        from metis_tpu_torch.resilience.fleet_drill import run_tenant_drill

        want = ref_drill(tmp_path / "ref", **TENANT_DRILL)
        got = run_tenant_drill(tmp_path / "port", **TENANT_DRILL)
        assert got == want

    def test_tenant_drill_refuses_too_few_tenants(self, tmp_path):
        from metis_tpu_torch.resilience.fleet_drill import run_tenant_drill

        with pytest.raises(AssertionError, match=">= 3 tenants"):
            run_tenant_drill(tmp_path, **{**TENANT_DRILL, "tenants": 2})
