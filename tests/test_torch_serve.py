"""The port's plan daemon core (``metis_tpu_torch/serve/``: the plan
cache, the query fingerprint, ``PlanService`` in-process) — the
reference's ``tests/test_serve.py`` run on the port.

Its contracts:
- PlanCache: LRU eviction order, capacity bound, serve.cache.* counters,
  invalidation, sharding, pre-encoded bodies.
- query_fingerprint: inequality across every cost-relevant SearchConfig
  toggle (the stale-cache regression), equality across processes,
  neutrality of result-neutral fields.
- PlanService in-process: hit/miss semantics, byte-identity with the
  offline path, warm-state reuse, drift-alarm replan + notification,
  ClusterDelta invalidation and the incremental replan, encoded
  responses.

The HTTP transport and the client are in ``test_torch_serve_http.py``,
the end-to-end smoke and the cross-package parity of the ``/plan`` body
in ``test_torch_serve_smoke.py``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

from metis_tpu_torch.cluster import ClusterSpec
from metis_tpu_torch.core.config import ModelSpec, SearchConfig
from metis_tpu_torch.core.trace import Counters
from metis_tpu_torch.obs.ledger import calibration_fingerprint, query_fingerprint
from metis_tpu_torch.serve.cache import PlanCache


# ---------------------------------------------------------------------------
# PlanCache
# ---------------------------------------------------------------------------


class TestPlanCache:
    def test_hit_miss_and_counters(self):
        c = Counters()
        cache = PlanCache(capacity=4, counters=c)
        assert cache.get("a") is None
        cache.put("a", {"v": 1})
        assert cache.get("a") == {"v": 1}
        assert c.get("serve.cache.miss") == 1
        assert c.get("serve.cache.hit") == 1

    def test_lru_eviction_order(self):
        c = Counters()
        cache = PlanCache(capacity=2, counters=c)
        cache.put("a", {"v": 1})
        cache.put("b", {"v": 2})
        cache.get("a")  # refresh a: b becomes LRU
        cache.put("c", {"v": 3})  # evicts b
        assert "b" not in cache
        assert cache.get("a") == {"v": 1}
        assert cache.get("c") == {"v": 3}
        assert c.get("serve.cache.evict") == 1

    def test_capacity_bound(self):
        cache = PlanCache(capacity=3)
        for i in range(10):
            cache.put(f"k{i}", {"v": i})
        assert len(cache) == 3
        assert cache.keys() == ["k7", "k8", "k9"]

    def test_put_refreshes_recency(self):
        cache = PlanCache(capacity=2)
        cache.put("a", {"v": 1})
        cache.put("b", {"v": 2})
        cache.put("a", {"v": 10})  # refresh: b is now LRU
        cache.put("c", {"v": 3})
        assert "b" not in cache
        assert cache.get("a") == {"v": 10}

    def test_invalidate_single_and_counters(self):
        c = Counters()
        cache = PlanCache(capacity=4, counters=c)
        cache.put("a", {"v": 1})
        assert cache.invalidate("a") is True
        assert cache.invalidate("a") is False  # already gone: no counter
        assert c.get("serve.cache.invalidate") == 1
        assert cache.get("a") is None

    def test_invalidate_where_and_all(self):
        c = Counters()
        cache = PlanCache(capacity=8, counters=c)
        for i in range(4):
            cache.put(f"k{i}", {"fingerprint": "x" if i < 2 else "y"})
        dropped = cache.invalidate_where(
            lambda _k, v: v["fingerprint"] == "x")
        assert sorted(dropped) == ["k0", "k1"]
        assert len(cache) == 2
        assert cache.invalidate_all() == 2
        assert len(cache) == 0
        assert c.get("serve.cache.invalidate") == 4

    def test_rejects_nonpositive_capacity(self):
        with pytest.raises(ValueError):
            PlanCache(capacity=0)

    def test_stats_shape(self):
        cache = PlanCache(capacity=4, counters=Counters())
        cache.put("a", {})
        cache.get("a")
        cache.get("zz")
        s = cache.stats()
        assert s["size"] == 1 and s["capacity"] == 4
        assert s["hits"] == 1 and s["misses"] == 1


# ---------------------------------------------------------------------------
# query_fingerprint
# ---------------------------------------------------------------------------


def _mini_model(**over) -> ModelSpec:
    base = dict(name="m", num_layers=4, hidden_size=256,
                sequence_length=128, vocab_size=1000, num_heads=4)
    base.update(over)
    return ModelSpec(**base)


def _mini_cluster() -> ClusterSpec:
    return ClusterSpec.of(("A100", 1, 4))


class TestQueryFingerprint:
    def test_stable_for_identical_inputs(self):
        a = query_fingerprint(_mini_model(), _mini_cluster(),
                              SearchConfig(gbs=16))
        b = query_fingerprint(_mini_model(), _mini_cluster(),
                              SearchConfig(gbs=16))
        assert a == b
        assert len(a) == 12

    @pytest.mark.parametrize("flip", [
        {"use_overlap_model": False},
        {"use_batch_eval": False},
        {"strict_compat": True},
        {"gbs": 32},
        {"max_profiled_tp": 2},
        {"max_profiled_bs": 8},
        {"mem_coef": 1.0},
        {"enable_sp": True},
        {"enable_zero": True},
        {"enable_schedule_search": True},
        {"dp_overlap_fraction": 0.5},
        {"prune_to_top_k": 10},
    ])
    def test_cost_relevant_toggle_changes_fingerprint(self, flip):
        """The stale-cache regression: flipping ANY cost-relevant config
        field must produce a different cache key."""
        base = SearchConfig(gbs=16)
        flipped = dataclasses.replace(base, **flip)
        assert (query_fingerprint(_mini_model(), _mini_cluster(), base)
                != query_fingerprint(_mini_model(), _mini_cluster(),
                                     flipped))

    @pytest.mark.parametrize("flip", [
        {"workers": 4},
        {"progress_every": 17},
    ])
    def test_result_neutral_fields_do_not_change_fingerprint(self, flip):
        """Fields that by construction cannot change the ranked result
        (serial/parallel byte-identity, heartbeat cadence) share a key."""
        base = SearchConfig(gbs=16)
        flipped = dataclasses.replace(base, **flip)
        assert (query_fingerprint(_mini_model(), _mini_cluster(), base)
                == query_fingerprint(_mini_model(), _mini_cluster(),
                                     flipped))

    def test_model_and_cluster_change_fingerprint(self):
        cfg = SearchConfig(gbs=16)
        base = query_fingerprint(_mini_model(), _mini_cluster(), cfg)
        assert query_fingerprint(_mini_model(num_layers=8),
                                 _mini_cluster(), cfg) != base
        bigger = ClusterSpec.of(("A100", 2, 4))
        assert query_fingerprint(_mini_model(), bigger, cfg) != base

    def test_calibration_identity(self):
        cfg = SearchConfig(gbs=16)
        none = query_fingerprint(_mini_model(), _mini_cluster(), cfg)
        cal = {"platform": "tpu", "device_kind": "v5e", "group_size": 8,
               "fits": {"all_reduce": [1.0, 2.0]},
               "samples": [[1, 2, 3]]}
        with_cal = query_fingerprint(_mini_model(), _mini_cluster(), cfg,
                                     calibration=cal)
        assert with_cal != none
        # samples are measurement noise, not pricing: excluded
        cal2 = dict(cal, samples=[[9, 9, 9]])
        assert query_fingerprint(_mini_model(), _mini_cluster(), cfg,
                                 calibration=cal2) == with_cal
        cal3 = dict(cal, fits={"all_reduce": [9.0, 9.0]})
        assert query_fingerprint(_mini_model(), _mini_cluster(), cfg,
                                 calibration=cal3) != with_cal
        assert calibration_fingerprint(None) is None

    def test_equal_across_processes(self):
        """sha1-of-canonical-JSON, not hash(): a daemon restart (new
        PYTHONHASHSEED) must produce the same cache keys."""
        local = query_fingerprint(_mini_model(), _mini_cluster(),
                                  SearchConfig(gbs=16))
        script = (
            "from metis_tpu_torch.cluster import ClusterSpec\n"
            "from metis_tpu_torch.core.config import ModelSpec, SearchConfig\n"
            "from metis_tpu_torch.obs.ledger import query_fingerprint\n"
            "m = ModelSpec(name='m', num_layers=4, hidden_size=256,\n"
            "              sequence_length=128, vocab_size=1000,\n"
            "              num_heads=4)\n"
            "print(query_fingerprint(m, ClusterSpec.of(('A100', 1, 4)),\n"
            "                        SearchConfig(gbs=16)))\n"
        )
        out = subprocess.run(
            [sys.executable, "-c", script],
            capture_output=True, text=True, check=True,
            cwd=Path(__file__).resolve().parent.parent,
            env={**os.environ, "PYTHONHASHSEED": "12345",
                 "JAX_PLATFORMS": "cpu"},
        )
        assert out.stdout.strip() == local


# ---------------------------------------------------------------------------
# PlanService (in-process, no HTTP — transport is covered by the smoke)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_workload():
    from torch_serve_reference import synthesize_profiles, tiny_test_model

    model = tiny_test_model(num_layers=4)
    profiles = synthesize_profiles(model, ["A100", "T4"], tps=[1, 2],
                                   bss=[1, 2, 4])
    cluster = ClusterSpec.of(("A100", 1, 4), ("T4", 1, 4))
    config = SearchConfig(gbs=16, max_profiled_tp=2, max_profiled_bs=4)
    return cluster, profiles, model, config


@pytest.fixture()
def service(small_workload):
    from metis_tpu_torch.serve.daemon import PlanService

    cluster, profiles, model, config = small_workload
    return PlanService(cluster, profiles, drift_min_samples=5)


class TestPlanService:
    def test_miss_then_hit_byte_identical_to_offline(self, small_workload,
                                                     service):
        from metis_tpu_torch.core.types import dump_ranked_plans
        from metis_tpu_torch.planner.api import plan_hetero

        cluster, profiles, model, config = small_workload
        offline = dump_ranked_plans(
            plan_hetero(cluster, profiles, model, config, top_k=5).plans)
        cold = service.plan_query(model, config, top_k=5)
        assert cold["cached"] is False
        assert cold["plans"] == offline
        hit = service.plan_query(model, config, top_k=5)
        assert hit["cached"] is True
        assert hit["plans"] == offline
        assert service.counters.get("serve.cache.hit") == 1
        assert service.counters.get("serve.cache.miss") == 1

    def test_distinct_config_distinct_entry(self, small_workload, service):
        _, _, model, config = small_workload
        a = service.plan_query(model, config, top_k=5)
        flipped = dataclasses.replace(config, use_overlap_model=False)
        b = service.plan_query(model, flipped, top_k=5)
        assert b["cached"] is False
        assert a["fingerprint"] != b["fingerprint"]
        assert len(service.cache) == 2

    def test_warm_state_reuse_is_byte_identical(self, small_workload,
                                                service):
        _, _, model, config = small_workload
        first = service.plan_query(model, config, top_k=5)
        service.invalidate()  # drop cache, KEEP warm state
        assert service.stats()["warm_states"] == 1
        again = service.plan_query(model, config, top_k=5)
        assert again["cached"] is False
        assert again["plans"] == first["plans"]

    def test_drift_alarm_replans_and_notifies(self, small_workload,
                                              service):
        _, _, model, config = small_workload
        cold = service.plan_query(model, config, top_k=5)
        fp = cold["plan_fingerprint"]
        status = None
        for step in range(8):
            status = service.post_accuracy_sample(
                fp, measured_ms=cold["best_cost_ms"] * 2.0, step=step)
        assert status["in_drift"] is True
        assert status["alarms"] == 1
        notes = service.notifications(since=0, timeout_s=5.0)
        pushes = [n for n in notes if n["kind"] == "replan_push"]
        assert len(pushes) == 1
        assert pushes[0]["fingerprint"] == fp
        # same topology: identical ranking re-primed under the same key
        refreshed = service.plan_query(model, config, top_k=5)
        assert refreshed["cached"] is True
        assert refreshed["plans"] == cold["plans"]
        # hysteresis: more bad samples fire no second alarm/replan
        before = service.stats()["note_seq"]
        for step in range(8, 12):
            service.post_accuracy_sample(
                fp, measured_ms=cold["best_cost_ms"] * 2.0, step=step)
        assert service.notifications(since=before) == []

    def test_in_band_samples_do_not_replan(self, small_workload, service):
        _, _, model, config = small_workload
        cold = service.plan_query(model, config, top_k=5)
        fp = cold["plan_fingerprint"]
        for step in range(10):
            out = service.post_accuracy_sample(
                fp, measured_ms=cold["best_cost_ms"] * 1.01, step=step)
            assert out["replanning"] is False
        assert service.notifications(since=0) == []

    def test_cluster_delta_invalidates_and_rekeys(self, small_workload,
                                                  service):
        _, _, model, config = small_workload
        cold = service.plan_query(model, config, top_k=5)
        out = service.apply_cluster_delta({"T4": 4})
        assert out["invalidated"] == 1
        assert out["devices"] == 4
        assert service.stats()["warm_states"] == 0
        notes = service.notifications(since=0)
        assert notes and notes[-1]["kind"] == "cluster_delta"
        shrunk = service.plan_query(model, config, top_k=5)
        assert shrunk["cached"] is False
        assert shrunk["fingerprint"] != cold["fingerprint"]
        assert shrunk["plans"] != cold["plans"]

    def test_empty_cluster_delta_is_a_cheap_noop(self, small_workload,
                                                 service):
        """A delta that changes nothing (no args, or a remove cancelled by
        an add in the same call) must keep warm search state and the plan
        cache, and push no note — regression for the path that used to
        clear both on EMPTY deltas."""
        _, _, model, config = small_workload
        cold = service.plan_query(model, config, top_k=5)
        before = service.stats()
        service.apply_cluster_delta()
        out = service.apply_cluster_delta(removed={"T4": 2},
                                          added={"T4": 2}, replan=True)
        assert out["invalidated"] == 0
        assert out["removed"] == {} and out["added"] == {}
        assert out["replanning"] is False
        after = service.stats()
        assert after["warm_states"] == before["warm_states"] == 1
        assert after["cache"]["size"] == before["cache"]["size"] == 1
        assert after["note_seq"] == before["note_seq"] == out["seq"]
        assert service.notifications(since=0) == []
        warm = service.plan_query(model, config, top_k=5)
        assert warm["cached"] is True
        assert warm["plans"] == cold["plans"]

    def test_cluster_delta_rejects_overdraw(self, service):
        from metis_tpu_torch.core.errors import ClusterSpecError

        with pytest.raises(ClusterSpecError):
            service.apply_cluster_delta({"T4": 99})

    def test_close_wakes_blocked_long_poll(self, service):
        """Regression: daemon shutdown must wake a client blocked in the
        notifications long-poll immediately instead of holding it until
        its timeout expires."""
        import threading
        import time

        out = {}

        def poll():
            t0 = time.monotonic()
            out["notes"] = service.notifications(since=0, timeout_s=4.0)
            out["waited_s"] = time.monotonic() - t0

        t = threading.Thread(target=poll)
        t.start()
        time.sleep(0.05)  # let the poller block on the condition
        service.close()
        t.join(timeout=5.0)
        assert not t.is_alive(), "close() left the long-poll blocked"
        assert out["notes"] == []
        assert out["waited_s"] < 2.0
        # closed service answers further polls immediately, and close()
        # is idempotent
        t0 = time.monotonic()
        assert service.notifications(since=0, timeout_s=4.0) == []
        assert time.monotonic() - t0 < 1.0
        service.close()

    def test_stats_shape(self, small_workload, service):
        _, _, model, config = small_workload
        service.plan_query(model, config, top_k=5)
        s = service.stats()
        assert s["cluster_devices"] == 8
        assert s["cache"]["size"] == 1
        assert s["warm_states"] == 1
        assert s["queries"] == 1
        assert json.dumps(s)  # JSON-serializable end to end


# ---------------------------------------------------------------------------
# incremental replanning (ClusterDelta keep/drop of warm state + cache)
# ---------------------------------------------------------------------------


class TestIncrementalReplan:
    def test_changed_node_ids_partial_and_full(self, service):
        """Shrinks peel from the END of a type's node run; a partial loss
        narrows the last matching node — only that node id changes."""
        from metis_tpu_torch.planner.replan import grow_cluster, shrink_cluster

        full = service.cluster  # A100 node 0, T4 node 1 (4 devices each)
        half = shrink_cluster(full, {"T4": 2})
        assert service._full_node_ids(half) == (0, 1)
        assert service._changed_node_ids(full, half) == frozenset({1})
        gone = shrink_cluster(full, {"T4": 4})
        assert service._full_node_ids(gone) == (0,)
        assert service._changed_node_ids(full, gone) == frozenset({1})
        assert service._changed_node_ids(full, full) == frozenset()
        back = grow_cluster(gone, full, {"T4": 4})
        assert service._changed_node_ids(gone, back) == frozenset({1})

    def test_full_cluster_queries_are_recosted_not_reused(
            self, small_workload, service):
        """A single-job search lays stages over every node, so a delta
        touching any node drops its warm state — and the reused/recosted
        counters reconcile exactly with the pre-delta candidate tags."""
        _, _, model, config = small_workload
        service.plan_query(model, config, top_k=5)
        flipped = dataclasses.replace(config, use_overlap_model=False)
        service.plan_query(model, flipped, top_k=5)
        tagged = sum(s.tagged_candidates for s in service._states.values())
        assert tagged > 0
        out = service.apply_cluster_delta({"T4": 4})
        assert service.stats()["warm_states"] == 0
        c = service.counters
        assert c.get("replan.incremental.reused") == 0
        assert c.get("replan.incremental.recosted") == tagged
        assert out["invalidated"] == 2

    def test_shrink_grow_round_trip_byte_identical(self, small_workload,
                                                   service):
        """After a delta the daemon's answer must equal a cold full search
        on the new topology, and the grow-back must reproduce the original
        full-fleet ranking byte-identically under the original key."""
        from metis_tpu_torch.core.types import dump_ranked_plans
        from metis_tpu_torch.planner.api import plan_hetero

        _, profiles, model, config = small_workload
        cold = service.plan_query(model, config, top_k=5)
        service.apply_cluster_delta(removed={"T4": 4})
        shrunk = service.plan_query(model, config, top_k=5)
        assert shrunk["cached"] is False
        assert shrunk["fingerprint"] != cold["fingerprint"]
        offline = dump_ranked_plans(
            plan_hetero(service.cluster, profiles, model, config,
                        top_k=5).plans)
        assert shrunk["plans"] == offline
        service.apply_cluster_delta(added={"T4": 4})
        restored = service.plan_query(model, config, top_k=5)
        assert restored["fingerprint"] == cold["fingerprint"]
        assert restored["plans"] == cold["plans"]

    def test_tenant_carve_untouched_by_delta_stays_warm(self,
                                                        small_workload,
                                                        service):
        """The satellite-1 regression: a delta that misses a tenant's
        carve must keep that tenant's warm search state AND its cached
        answer; only intersecting states are re-costed."""
        from metis_tpu_torch.sched.tenant import TenantSpec

        _, _, model, config = small_workload
        service.tenant_register(
            TenantSpec("a", model, config, priority=1, quota_ceiling=4))
        service.tenant_register(
            TenantSpec("b", model, config, quota_ceiling=4))
        a0 = service.tenant_plan("a")
        b0 = service.tenant_plan("b")
        assert a0["node_indices"] == [0]  # A100 node: lowest hazard first
        assert b0["node_indices"] == [1]
        tagged = {k: s.tagged_candidates
                  for k, s in service._states.items()}
        assert tagged
        service.apply_cluster_delta(removed={"T4": 4})
        # tenant a's carve (node 0) missed the delta (node 1): cached
        # answer survives, warm state survives
        a1 = service.tenant_plan("a")
        assert a1["cached"] is True
        assert a1["plans"] == a0["plans"]
        kept = [k for k in tagged if k in service._states]
        assert kept, "delta dropped the untouched tenant's warm state"
        assert all(service._states[k].touched_nodes == {0} for k in kept)
        c = service.counters
        reused = c.get("replan.incremental.reused")
        recosted = c.get("replan.incremental.recosted")
        assert reused == sum(tagged[k] for k in kept) > 0
        assert recosted > 0
        assert reused + recosted == sum(tagged.values())
        # grow back: tenant b's carve recurs with a byte-identical ranking
        service.apply_cluster_delta(added={"T4": 4})
        b2 = service.tenant_plan("b")
        assert b2["node_indices"] == [1]
        assert b2["plans"] == b0["plans"]

    def test_incremental_replan_event_schema(self, small_workload,
                                             tmp_path):
        from metis_tpu_torch.core.events import EventLog
        from metis_tpu_torch.serve.daemon import PlanService
        from check_events_schema import validate_events

        cluster, profiles, model, config = small_workload
        path = tmp_path / "events.jsonl"
        with EventLog(path) as log:
            svc = PlanService(cluster, profiles, events=log)
            svc.plan_query(model, config, top_k=5)
            tagged = sum(s.tagged_candidates
                         for s in svc._states.values())
            svc.apply_cluster_delta(removed={"T4": 2})
            svc.close()
        evs = [json.loads(line)
               for line in path.read_text().splitlines()]
        assert validate_events(evs) == []
        ir = [e for e in evs if e["event"] == "incremental_replan"]
        assert len(ir) == 1
        ev = ir[0]
        assert ev["changed_nodes"] == [1]
        assert ev["states_kept"] == 0 and ev["states_dropped"] == 1
        assert ev["reused"] == 0
        assert ev["recosted"] == tagged
        assert ev["invalidated"] == 1


# ---------------------------------------------------------------------------
# sharded cache invariants
# ---------------------------------------------------------------------------


class TestPlanCacheSharding:
    def test_shard_counters_reconcile_with_global(self):
        """sum(per-shard hits/misses) == the serve.cache.* counters —
        the reconciliation invariant /stats consumers depend on."""
        c = Counters()
        cache = PlanCache(capacity=64, counters=c, shards=4)
        for i in range(32):
            cache.put(f"k{i}", {"v": i})
        for i in range(32):
            assert cache.get(f"k{i}") == {"v": i}
        for i in range(10):
            assert cache.get(f"absent{i}") is None
        stats = cache.shard_stats()
        assert len(stats) == 4
        assert sum(s["hits"] for s in stats) == c.get("serve.cache.hit")
        assert sum(s["misses"] for s in stats) == \
            c.get("serve.cache.miss")
        assert sum(s["size"] for s in stats) == len(cache) == 32
        # keys spread over more than one shard (crc32 on this keyset)
        assert sum(1 for s in stats if s["size"]) > 1

    def test_global_lru_bound_under_concurrent_fill(self):
        """8 threads racing puts through different shards must never
        leave the cache over its GLOBAL capacity."""
        import threading as _threading

        c = Counters()
        cache = PlanCache(capacity=32, counters=c, shards=4)

        def _fill(tid: int) -> None:
            for i in range(100):
                cache.put(f"t{tid}-k{i}", {"t": tid, "i": i})
                cache.get(f"t{tid}-k{i % 7}")

        threads = [_threading.Thread(target=_fill, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(cache) <= 32
        assert sum(s["size"] for s in cache.shard_stats()) == len(cache)
        # accounting reconciles after the race: inserts - evictions -
        # invalidations == residents
        assert 8 * 100 - c.get("serve.cache.evict") == len(cache)

    def test_invalidate_where_visits_every_shard(self):
        cache = PlanCache(capacity=256, counters=Counters(), shards=8)
        for i in range(64):
            cache.put(f"k{i}", {"doomed": i % 2 == 0})
        populated = sum(1 for s in cache.shard_stats() if s["size"])
        assert populated == 8  # every shard holds keys on this keyset
        dropped = cache.invalidate_where(lambda _k, v: v["doomed"])
        assert len(dropped) == 32
        assert len(cache) == 32
        for k in dropped:
            assert k not in cache

    def test_single_shard_export_matches_pre_shard_semantics(self):
        """shards=1 must dump byte-identically to the pre-shard cache:
        items()/keys() in exact LRU order for the same op sequence, and
        any shard count reproduces the same global order."""
        def _ops(cache):
            for i in range(6):
                cache.put(f"k{i}", {"v": i})
            cache.get("k1")
            cache.put("k2", {"v": 22})  # refresh
            cache.get("k0")
            cache.invalidate("k3")
            return cache

        # the pre-shard implementation was one OrderedDict with
        # move_to_end on access — its export order for this op sequence:
        expected_keys = ["k4", "k5", "k1", "k2", "k0"]
        one = _ops(PlanCache(capacity=16, shards=1))
        assert one.keys() == expected_keys
        dump_one = json.dumps(one.items())
        many = _ops(PlanCache(capacity=16, shards=4))
        assert json.dumps(many.items()) == dump_one
        # restore round-trip: re-putting the export into a different
        # shard count reproduces contents AND eviction order
        restored = PlanCache(capacity=16, shards=2)
        for k, payload in one.items():
            restored.put(k, payload)
        assert restored.keys() == expected_keys
        assert json.dumps(restored.items()) == dump_one

    def test_get_with_body_pre_encoded_bytes(self):
        cache = PlanCache(capacity=4, counters=Counters())
        payload = {"plans": "x" * 50, "best_cost_ms": 1.25}
        cache.put("a", payload)
        got, body = cache.get_with_body("a")
        assert got == payload
        assert body == json.dumps(payload).encode("utf-8")
        # unserializable payloads carry no body; the parsed form works
        cache.put("b", {"bad": object()})
        got_b, body_b = cache.get_with_body("b")
        assert body_b is None and got_b["bad"] is not None

    def test_rejects_nonpositive_shards(self):
        with pytest.raises(ValueError):
            PlanCache(capacity=4, shards=0)


# ---------------------------------------------------------------------------
# zero-copy encoded responses
# ---------------------------------------------------------------------------


class TestEncodedResponses:
    def test_encoded_hit_byte_identical_to_dumps_of_plan_query(
            self, small_workload, service):
        """The spliced cache-hit bytes must be EXACTLY what
        ``json.dumps(plan_query(...))`` would have produced — proven by
        round-tripping: parse the bytes, re-dumps, compare bytes (key
        order and float repr both survive), then compare the parsed dict
        field-by-field against the classic path modulo serve_ms."""
        _, _, model, config = small_workload
        cold_bytes = service.plan_query_encoded(model, config, top_k=5)
        cold = json.loads(cold_bytes)
        assert cold["cached"] is False
        assert json.dumps(cold).encode("utf-8") == cold_bytes

        hit_bytes = service.plan_query_encoded(model, config, top_k=5)
        hit = json.loads(hit_bytes)
        assert hit["cached"] is True
        assert json.dumps(hit).encode("utf-8") == hit_bytes

        plain = service.plan_query(model, config, top_k=5)
        assert set(plain) == set(hit)
        for k in plain:
            if k != "serve_ms":
                assert plain[k] == hit[k], f"field {k} differs"

    def test_encoded_with_trace_id_and_tail_order(self, small_workload,
                                                  service):
        _, _, model, config = small_workload
        service.plan_query(model, config, top_k=5)  # prime
        body = service.plan_query_encoded(model, config, top_k=5,
                                          trace_id="t-123")
        parsed = json.loads(body)
        assert parsed["trace_id"] == "t-123"
        assert json.dumps(parsed).encode("utf-8") == body
        # tail keys land last, in insertion order, like _respond's dict
        assert list(parsed)[-3:] == ["cached", "serve_ms", "trace_id"]

    def test_tail_keys_never_collide_with_entries(self, small_workload,
                                                  service):
        """The splice is only sound while cache entries never contain the
        tail keys — pin that invariant on a real entry."""
        _, _, model, config = small_workload
        service.plan_query(model, config, top_k=5)
        key = next(iter(service.cache.keys()))
        entry = service.cache.get(key)
        assert not {"cached", "serve_ms", "trace_id"} & set(entry)


# ---------------------------------------------------------------------------
# keep-alive transport + bounded worker pool
# ---------------------------------------------------------------------------


