"""The port daemon's ``/metrics`` surface against the documented contract
and against the reference daemon's: the reference's
``tests/test_metrics_names.py`` (via ``tools/check_metrics_names.py``'s
exposition lint and README reader) on a live port daemon, and the name,
kind and label sets that the two packages' daemons export after the same
requests, held equal — what ``top`` and any scraper read.
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import check_metrics_names  # noqa: E402

import metis_tpu.cluster.spec as jcluster  # noqa: E402
import metis_tpu.obs.metrics as jmetrics  # noqa: E402
import metis_tpu.sched.tenant as jtenant  # noqa: E402
import metis_tpu.serve.client as jclient  # noqa: E402
import metis_tpu.serve.daemon as jdaemon  # noqa: E402
import metis_tpu_torch.cluster.spec as tcluster  # noqa: E402
import metis_tpu_torch.obs.metrics as tmetrics  # noqa: E402
import metis_tpu_torch.sched.tenant as ttenant  # noqa: E402
import metis_tpu_torch.serve.client as tclient  # noqa: E402
import metis_tpu_torch.serve.daemon as tdaemon  # noqa: E402
from metis_tpu_torch.core.config import SearchConfig  # noqa: E402
from torch_serve_reference import (  # noqa: E402
    both_stores,
    dump_synthetic,
    parity_inputs,
    ref_config,
    ref_model,
    tiny_test_model,
)

# what a daemon must export after one served plan query
SERVE_CORE = ("metis_serve_requests_total", "metis_serve_request_latency_ms",
              "metis_serve_cache_hits_total", "metis_search_duration_seconds")


def test_live_scrape_and_readme_contract(tmp_path):
    """The reference's ``run_check`` on the port's daemon: healthz live
    then ready, a valid exposition, only cataloged names, the serve core
    present, and the README Metrics table equal to the catalog."""
    documented = check_metrics_names.readme_metric_names()
    assert documented == set(tmetrics.METRIC_CATALOG)
    cluster, profiles, model, config = parity_inputs(tmp_path)
    service = tdaemon.PlanService(cluster, profiles)
    server, thread, address = tdaemon.serve_in_thread(service)
    try:
        client = tclient.PlanServiceClient(address, timeout=300.0)
        assert client.healthz(timeout=10.0)["live"]
        client.plan(model, config, top_k=10)
        client.plan(model, config, top_k=10)
        assert client.healthz(timeout=10.0)["ready"]
        text = client.metrics(timeout=10.0)
    finally:
        server.shutdown()
        thread.join(10)
        server.server_close()
    assert check_metrics_names.validate_exposition(text) == []
    exported = {n for n in tmetrics.parse_exposition(text)
                if n.startswith("metis_")}
    assert exported <= set(tmetrics.METRIC_CATALOG)
    assert set(SERVE_CORE) <= exported


@pytest.fixture(scope="module")
def shared_store(tmp_path_factory):
    root = tmp_path_factory.mktemp("metrics_names_profiles")
    dump_synthetic(tiny_test_model(num_layers=4), ["A100", "T4"], root,
                   tps=[1, 2], bss=[1, 2, 4])
    return both_stores(root)


def _families(pkg: str, stores) -> dict:
    """name -> (kind, label-name sets) exported after one request script:
    health, a cold and a cached plan, an accuracy sample, a tenant, a
    cluster delta with its replan, the read endpoints and a 404."""
    daemon, client_mod, cluster_mod, tenant, metrics = (
        (jdaemon, jclient, jcluster, jtenant, jmetrics) if pkg == "jax"
        else (tdaemon, tclient, tcluster, ttenant, tmetrics))
    model = tiny_test_model(num_layers=4)
    config = SearchConfig(gbs=16, max_profiled_tp=2, max_profiled_bs=4)
    if pkg == "jax":
        model, config = ref_model(model), ref_config(config)
    service = daemon.PlanService(
        cluster_mod.ClusterSpec.of(("A100", 1, 4), ("T4", 1, 4)),
        stores[0] if pkg == "jax" else stores[1])
    server, thread, address = daemon.serve_in_thread(service)
    try:
        client = client_mod.PlanServiceClient(address)
        client.healthz()
        cold = client.plan(model, config, top_k=5)
        client.plan(model, config, top_k=5)
        client.accuracy_sample(cold["plan_fingerprint"],
                               measured_ms=cold["best_cost_ms"])
        client.tenant_register(tenant.TenantSpec("solo", model, config,
                                                 quota_floor=2))
        client.tenant_plan("solo")
        seq = client.cluster_delta(removed={"T4": 4}, replan=True)["seq"]
        for _ in range(15):
            if any(n["kind"] == "replan_push"
                   for n in client.notifications(since=seq, timeout_s=2.0)):
                break
        client.decisions()
        client.oplog(since=0)
        client.stats()
        with pytest.raises(client_mod.ServeClientError):
            client._request("GET", "/nope")
        text = client.metrics()
    finally:
        server.shutdown()
        thread.join(10)
        server.server_close()
    return {name: (fam["type"],
                   sorted({tuple(sorted(set(lab) - {"le"}))
                           for _, lab, _ in fam["samples"]}))
            for name, fam in metrics.parse_exposition(text).items()}


def test_exported_names_and_labels_equal_the_reference(shared_store):
    want = _families("jax", shared_store)
    got = _families("port", shared_store)
    assert got == want
    assert set(got) <= set(tmetrics.METRIC_CATALOG)
    for name, (kind, label_sets) in got.items():
        cat_kind, _help, cat_labels = tmetrics.METRIC_CATALOG[name]
        assert kind == cat_kind
        assert all(set(ls) <= set(cat_labels) for ls in label_sets), name
