"""The port's cold-search worker pool (``metis_tpu_torch/serve/pool.py``):
the reference's ``tests/test_serve_pool.py`` run on the port, whose
workers start with ``spawn`` (each imports the planner and torch afresh;
the profiles travel pickled), plus the port's pool against the reference
daemon's serial answers on the same files.

The reference's contracts that make the pool safe to put behind the
daemon:
- ranking byte-identity: a pool search's merged ranking is exactly the
  serial search's (same stable tie-break key, same truncation), proven
  at the daemon level — plan_query responses from a pooled service are
  byte-identical to a serial service AND to offline plan_hetero;
- warm reuse: repeat searches for the same query fingerprint answer from
  warm per-worker evaluators (outcome.warm flips true);
- incremental-replan bridge: workers ship touched_nodes /
  tagged_candidates home and the daemon merges them into its parent
  state, so apply_cluster_delta's keep/drop pivot still works;
- fallback: any pool failure degrades to the serial path with a
  parallel_fallback event — never an error to the client, and the
  response is byte-identical either way.
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from metis_tpu_torch.cluster import ClusterSpec
from metis_tpu_torch.core.config import SearchConfig
from metis_tpu_torch.serve.pool import SearchPoolError, SearchWorkerPool

pytestmark = pytest.mark.skipif(
    __import__("metis_tpu_torch.search.parallel", fromlist=["_mp_context"])
    ._mp_context() is None,
    reason="no multiprocessing start method available")


@pytest.fixture(scope="module")
def workload():
    from torch_serve_reference import synthesize_profiles, tiny_test_model

    model = tiny_test_model(num_layers=4)
    profiles = synthesize_profiles(model, ["A100", "T4"], tps=[1, 2],
                                   bss=[1, 2, 4])
    cluster = ClusterSpec.of(("A100", 1, 4), ("T4", 1, 4))
    config = SearchConfig(gbs=16, max_profiled_tp=2, max_profiled_bs=4)
    return cluster, profiles, model, config


@pytest.fixture(scope="module")
def pool(workload):
    cluster, profiles, _model, _config = workload
    p = SearchWorkerPool(cluster, profiles, 2)
    yield p
    p.close()


class TestSearchWorkerPool:
    def test_merged_ranking_matches_serial(self, workload, pool):
        from metis_tpu_torch.obs.ledger import (fingerprint_ranked_plan,
                                          query_fingerprint)
        from metis_tpu_torch.planner.api import plan_hetero

        cluster, profiles, model, config = workload
        serial = plan_hetero(cluster, profiles, model, config, top_k=5)
        qfp = query_fingerprint(model, cluster, config)
        out = pool.search(qfp, cluster, model, config, 5,
                          range(len(cluster.nodes)))
        assert [fingerprint_ranked_plan(p) for p in out.plans] == \
            [fingerprint_ranked_plan(p) for p in serial.plans]
        assert [p.cost.total_ms for p in out.plans] == \
            [p.cost.total_ms for p in serial.plans]
        assert out.num_costed == serial.num_costed
        assert out.num_pruned == serial.num_pruned
        assert out.num_bound_pruned == serial.num_bound_pruned

    def test_warm_reuse_and_identical_repeat(self, workload, pool):
        from metis_tpu_torch.obs.ledger import (fingerprint_ranked_plan,
                                          query_fingerprint)

        cluster, profiles, model, config = workload
        qfp = query_fingerprint(model, cluster, config)
        first = pool.search(qfp, cluster, model, config, 5,
                            range(len(cluster.nodes)))
        again = pool.search(qfp, cluster, model, config, 5,
                            range(len(cluster.nodes)))
        assert again.warm is True
        assert [fingerprint_ranked_plan(p) for p in again.plans] == \
            [fingerprint_ranked_plan(p) for p in first.plans]

    def test_ships_incremental_replan_state_home(self, workload, pool):
        from metis_tpu_torch.obs.ledger import query_fingerprint

        cluster, profiles, model, config = workload
        qfp = query_fingerprint(model, cluster, config)
        out = pool.search(qfp, cluster, model, config, 5,
                          range(len(cluster.nodes)))
        assert out.touched_nodes, "workers shipped no touched_nodes"
        assert out.tagged_candidates > 0
        assert out.counters, "workers shipped no counter deltas"

    def test_prewarm(self, workload):
        from metis_tpu_torch.obs.ledger import query_fingerprint

        cluster, profiles, model, config = workload
        p = SearchWorkerPool(cluster, profiles, 2)
        try:
            qfp = query_fingerprint(model, cluster, config)
            p.prewarm(qfp, cluster, model, config,
                      range(len(cluster.nodes)))
            out = p.search(qfp, cluster, model, config, 5,
                           range(len(cluster.nodes)))
            assert out.warm is True
        finally:
            p.close()

    def test_close_is_idempotent_and_rejects_searches(self, workload):
        cluster, profiles, model, config = workload
        p = SearchWorkerPool(cluster, profiles, 1)
        p.close()
        p.close()
        with pytest.raises(SearchPoolError):
            p.search("qfp", cluster, model, config, 5, (0, 1))

    def test_rejects_zero_workers(self, workload):
        cluster, profiles, _model, _config = workload
        with pytest.raises(ValueError):
            SearchWorkerPool(cluster, profiles, 0)


class TestDaemonPoolIntegration:
    def test_pooled_daemon_byte_identical_to_serial_and_offline(
            self, workload):
        from metis_tpu_torch.core.types import dump_ranked_plans
        from metis_tpu_torch.planner.api import plan_hetero
        from metis_tpu_torch.serve.daemon import PlanService

        cluster, profiles, model, config = workload
        offline = dump_ranked_plans(
            plan_hetero(cluster, profiles, model, config, top_k=5).plans)
        serial_svc = PlanService(cluster, profiles)
        pooled_svc = PlanService(cluster, profiles, search_pool=2)
        try:
            assert pooled_svc.search_pool is not None, \
                "pool failed to boot"
            serial = serial_svc.plan_query(model, config, top_k=5)
            pooled = pooled_svc.plan_query(model, config, top_k=5)
            assert pooled["plans"] == serial["plans"] == offline
            assert pooled["num_costed"] == serial["num_costed"]
            assert pooled["num_pruned"] == serial["num_pruned"]
            assert pooled["plan_fingerprint"] == \
                serial["plan_fingerprint"]
            assert pooled_svc.counters.get("serve.pool_search") == 1
            # encoded path over the pool: still canonical dumps bytes
            body = pooled_svc.plan_query_encoded(model, config, top_k=5)
            import json as _json
            assert _json.dumps(_json.loads(body)).encode() == body
        finally:
            pooled_svc.close()
            serial_svc.close()

    def test_pool_search_primes_parent_state_for_replan(self, workload):
        from metis_tpu_torch.serve.daemon import PlanService

        cluster, profiles, model, config = workload
        svc = PlanService(cluster, profiles, search_pool=2)
        try:
            assert svc.search_pool is not None
            svc.plan_query(model, config, top_k=5)
            assert svc.stats()["warm_states"] == 1
            state = next(iter(svc._states.values()))
            # the workers' touch tags landed in the parent state, so the
            # incremental-replan keep/drop pivot sees this query
            assert state.touched_nodes
            assert state.tagged_candidates > 0
            out = svc.apply_cluster_delta({"T4": 4})
            assert out["invalidated"] == 1
            # shrunk topology still answers (pool handles the new
            # fingerprint; ranking contract re-checked by byte-identity
            # tests above)
            shrunk = svc.plan_query(model, config, top_k=5)
            assert shrunk["cached"] is False
        finally:
            svc.close()

    def test_pool_failure_falls_back_to_serial(self, workload, tmp_path):
        from metis_tpu_torch.core.events import EventLog
        from metis_tpu_torch.core.types import dump_ranked_plans
        from metis_tpu_torch.planner.api import plan_hetero
        from metis_tpu_torch.serve.daemon import PlanService

        cluster, profiles, model, config = workload
        events_path = tmp_path / "events.jsonl"
        events = EventLog(events_path)
        svc = PlanService(cluster, profiles, search_pool=2,
                          events=events)
        try:
            assert svc.search_pool is not None
            # kill the pool out from under the daemon: the next cold
            # query must fall back to the serial path, not error
            svc.search_pool.close()
            out = svc.plan_query(model, config, top_k=5)
            offline = dump_ranked_plans(
                plan_hetero(cluster, profiles, model, config,
                            top_k=5).plans)
            assert out["plans"] == offline
            assert svc.counters.get("serve.pool_fallback") == 1
        finally:
            svc.close()
            events.close()
        import json as _json
        evs = [_json.loads(ln)
               for ln in events_path.read_text().splitlines()]
        falls = [e for e in evs if e["event"] == "parallel_fallback"]
        assert falls and "search pool" in falls[0]["reason"]

    def test_standby_never_boots_a_pool(self, workload):
        from metis_tpu_torch.serve.daemon import PlanService

        cluster, profiles, _model, _config = workload
        svc = PlanService(cluster, profiles, search_pool=2,
                          read_only=True)
        try:
            assert svc.search_pool is None
            assert svc.stats()["search_pool_workers"] == 0
        finally:
            svc.close()


def test_workers_start_with_spawn_and_take_pickled_profiles(workload):
    """The port keeps ``spawn`` (a forked child would inherit torch's
    threads): the pool's context is spawn, and the profile store it ships
    to every worker survives pickling with equal tables."""
    import pickle

    from metis_tpu_torch.search.parallel import _mp_context

    _cluster, profiles, _model, _config = workload
    assert _mp_context().get_start_method() == "spawn"
    back = pickle.loads(pickle.dumps(profiles))
    assert back.configs() == profiles.configs()
    for key in profiles.configs():
        assert back.get(*key) == profiles.get(*key)
    assert back.model == profiles.model


def test_pooled_port_daemon_matches_the_reference_serial_daemon(tmp_path):
    """The port's daemon behind a pool of 2 answers the reference's
    serial daemon's dump, fingerprints and costs on the same files."""
    import dataclasses

    import metis_tpu.cluster.spec as jcluster
    import metis_tpu.serve.daemon as jdaemon
    from metis_tpu_torch.serve.daemon import PlanService
    from torch_serve_reference import (
        both_stores,
        dump_synthetic,
        ref_config,
        ref_model,
        tiny_test_model,
    )

    model = tiny_test_model(num_layers=4)
    dump_synthetic(model, ["A100", "T4"], tmp_path, tps=[1, 2],
                   bss=[1, 2, 4])
    jstore, tstore = both_stores(tmp_path)
    config = SearchConfig(gbs=16, max_profiled_tp=2, max_profiled_bs=4)
    want = jdaemon.PlanService(
        jcluster.ClusterSpec.of(("A100", 1, 4), ("T4", 1, 4)),
        jstore).plan_query(ref_model(model), ref_config(config), top_k=5)
    pooled = PlanService(ClusterSpec.of(("A100", 1, 4), ("T4", 1, 4)),
                         tstore, search_pool=2)
    try:
        assert pooled.search_pool is not None
        got = pooled.plan_query(model, config, top_k=5)
    finally:
        pooled.close()
    for key in ("plans", "fingerprint", "plan_fingerprint", "best_cost_ms",
                "num_costed", "num_pruned", "num_bound_pruned",
                "decision_seq"):
        assert got[key] == want[key], key
    assert dataclasses.asdict(model) == dataclasses.asdict(ref_model(model))
