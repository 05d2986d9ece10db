"""End to end: the port's plan daemon on the parity workload, and its
``/plan`` body against the reference daemon's.

``run_smoke`` is the reference's ``tools/serve_smoke.run_smoke`` on the
port's daemon and client (the tier-1 gate of the reference's
``tests/test_serve.py``): the cold answer byte-identical to the offline
``dump_ranked_plans``, the cached p50 under the 10 ms budget, >= 64
concurrent queries and a coalesced cold wave with no dropped or corrupt
answer, keep-alive reuse, a drift replan pushed to the notification
stream, a clean shutdown and an event log that passes the reference's
schema check — over TCP here, over a unix socket in
``test_torch_serve_http.py``.

The parity cases hold the raw ``/plan`` response of the port's daemon to
the reference daemon's on the same files, query by query, every key but
the per-request tail (``cached``, ``serve_ms``, ``trace_id``) and the
search's wall time (``search_seconds``): the dump, both fingerprints,
the costs, the search accounting and the decision seq.
"""
from __future__ import annotations

import json
import shutil
import statistics
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

from check_events_schema import validate_file  # noqa: E402

import metis_tpu.serve.daemon as jdaemon  # noqa: E402
import metis_tpu_torch.serve.daemon as tdaemon  # noqa: E402
from metis_tpu.testing import (  # noqa: E402
    PARITY_GBS,
    PARITY_INFERENCE,
    PARITY_MAX_BS,
    PARITY_MAX_TP,
    write_parity_fixture,
)
from metis_tpu_torch.cluster.spec import ClusterSpec  # noqa: E402
from metis_tpu_torch.core.config import SearchConfig  # noqa: E402
from metis_tpu_torch.core.events import EventLog  # noqa: E402
from metis_tpu_torch.core.types import dump_ranked_plans  # noqa: E402
from metis_tpu_torch.planner.api import plan_hetero  # noqa: E402
from metis_tpu_torch.profiles.store import ProfileStore  # noqa: E402
from metis_tpu_torch.serve.client import PlanServiceClient  # noqa: E402
from torch_serve_reference import (  # noqa: E402
    parity_inputs,
    ref_config,
    ref_model,
    tiny_test_model,
)

SMOKE_TOP_K = 10
P50_BUDGET_MS = 10.0
# the per-request tail and the search's wall time: everything else of a
# /plan body is a function of the query and the daemon's history
VOLATILE = ("cached", "serve_ms", "trace_id", "search_seconds")


def wait_note(client, since: int, kind: str, polls: int = 15) -> list:
    """The ``kind`` notes after ``since``, long-polling 2 s at a time."""
    for _ in range(polls):
        notes = [n for n in client.notifications(since=since, timeout_s=2.0)
                 if n.get("kind") == kind]
        if notes:
            return notes
    return []


def run_smoke(work_dir: Path, threads: int = 64, per_thread: int = 2,
              cached_queries: int = 50, unix_socket: bool = False) -> dict:
    """The reference smoke's seven steps on the port; raises
    AssertionError on any broken contract."""
    out: dict = {"threads": threads, "p50_budget_ms": P50_BUDGET_MS}
    cluster, profiles, model, config = parity_inputs(work_dir)

    # 1. offline reference: the byte-identity oracle
    offline = plan_hetero(cluster, profiles, model, config, top_k=SMOKE_TOP_K)
    offline_json = dump_ranked_plans(offline.plans)
    assert offline.plans, "offline search produced no plans"

    # 2. daemon in-process (a short socket path: AF_UNIX allows 107 bytes)
    events_path = work_dir / "serve_events.jsonl"
    events = EventLog(events_path)
    service = tdaemon.PlanService(cluster, profiles, events=events,
                                  drift_min_samples=5)
    sock_dir = tempfile.mkdtemp(dir="/tmp") if unix_socket else None
    server, thread, address = tdaemon.serve_in_thread(
        service, socket_path=f"{sock_dir}/s.sock" if sock_dir else None)
    out["address"] = address
    client = PlanServiceClient(address)
    try:
        # 3. cold query: byte-identical to offline
        cold = client.plan(model, config, top_k=SMOKE_TOP_K)
        assert cold["cached"] is False, "first query must be a miss"
        assert cold["plans"] == offline_json
        assert cold["num_costed"] == offline.num_costed

        # 4. cached p50
        lat_ms = []
        for _ in range(cached_queries):
            t0 = time.perf_counter()
            hit = client.plan(model, config, top_k=SMOKE_TOP_K)
            lat_ms.append((time.perf_counter() - t0) * 1e3)
            assert hit["cached"] is True and hit["plans"] == offline_json
        out["serve_cache_hit_p50_ms"] = statistics.median(lat_ms)
        assert out["serve_cache_hit_p50_ms"] < P50_BUDGET_MS

        # 5a. concurrent cached queries: none dropped, none corrupt
        def _one_query(_i: int) -> str:
            return client.plan(model, config, top_k=SMOKE_TOP_K)["plans"]

        n_queries = threads * per_thread
        with ThreadPoolExecutor(max_workers=threads) as pool:
            got = list(pool.map(_one_query, range(n_queries)))
        assert len(got) == n_queries
        assert sum(1 for g in got if g != offline_json) == 0
        out["concurrent_queries"] = n_queries

        # 5b. concurrent cold wave, coalesced onto one search
        client.invalidate()
        searches = service.counters.get("serve.cache.miss")
        with ThreadPoolExecutor(max_workers=threads) as pool:
            got = list(pool.map(_one_query, range(threads)))
        assert all(g == offline_json for g in got)
        out["cold_wave_misses"] = (service.counters.get("serve.cache.miss")
                                   - searches)

        # 5c. keep-alive: pooled clients, byte-identity over reused sockets
        ka_clients = [PlanServiceClient(address) for _ in range(8)]
        try:
            with ThreadPoolExecutor(max_workers=128) as pool:
                got = list(pool.map(
                    lambda i: ka_clients[i % 8].plan(
                        model, config, top_k=SMOKE_TOP_K)["plans"],
                    range(256)))
            assert len(got) == 256
            assert sum(1 for g in got if g != offline_json) == 0
            reuse = [ln for ln in client.metrics().splitlines()
                     if ln.startswith("metis_serve_keepalive_reuse_total ")]
            assert reuse and float(reuse[0].split()[-1]) > 0
        finally:
            for c in ka_clients:
                c.close()

        # 6. drift: out-of-band samples until the replan is pushed
        seq_before = client.stats()["note_seq"]
        for step in range(8):
            client.accuracy_sample(cold["plan_fingerprint"],
                                   measured_ms=cold["best_cost_ms"] * 2.0,
                                   step=step)
        assert wait_note(client, seq_before, "replan_push")
        refreshed = client.plan(model, config, top_k=SMOKE_TOP_K)
        assert refreshed["cached"] is True
        assert refreshed["plans"] == offline_json
    finally:
        # 7. clean shutdown
        try:
            client.shutdown()
        except Exception:
            server.shutdown()
        thread.join(10)
        alive = thread.is_alive()
        server.server_close()
        events.close()
        if sock_dir is not None:
            shutil.rmtree(sock_dir, ignore_errors=True)
    assert not alive, "server thread survived shutdown"
    n_events, problems = validate_file(events_path)
    assert not problems, problems[:5]
    out["events"] = n_events
    out["ok"] = True
    return out


def test_serve_smoke_tcp(tmp_path):
    out = run_smoke(tmp_path)
    assert out["ok"] is True
    assert out["serve_cache_hit_p50_ms"] < P50_BUDGET_MS
    assert out["concurrent_queries"] >= 64
    assert out["cold_wave_misses"] >= 1


# ---------------------------------------------------------------------------
# the /plan body against the reference daemon's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def twin_daemons(tmp_path_factory):
    """The reference's and the port's daemon on the same parity files,
    each behind its own HTTP server; yields {"jax": addr, "port": addr}."""
    import metis_tpu.cluster.spec as jcluster
    import metis_tpu.profiles.store as jstore

    root = tmp_path_factory.mktemp("serve_parity")
    write_parity_fixture(root)
    services = {
        "jax": jdaemon.PlanService(
            jcluster.ClusterSpec.from_files(root / "hostfile",
                                            root / "clusterfile.json"),
            jstore.ProfileStore.from_dir(root / "profiles")),
        "port": tdaemon.PlanService(
            ClusterSpec.from_files(root / "hostfile",
                                   root / "clusterfile.json"),
            ProfileStore.from_dir(root / "profiles")),
    }
    servers = {"jax": jdaemon.serve_in_thread(services["jax"]),
               "port": tdaemon.serve_in_thread(services["port"])}
    yield {k: v[2] for k, v in servers.items()}
    for server, thread, _ in servers.values():
        server.shutdown()
        thread.join(10)
        server.server_close()


def _raw_plan(address: str, body: dict) -> dict:
    import http.client

    host, port = address[len("http://"):].rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    try:
        conn.request("POST", "/plan", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        return json.loads(resp.read())
    finally:
        conn.close()


QUERIES = {
    "training_top5": dict(top_k=5),
    "training_all": dict(top_k=None),
    "inference": dict(top_k=5, workload=dict(PARITY_INFERENCE)),
    "training_top5_again": dict(top_k=5),
}


def test_plan_body_equals_the_reference_daemons(twin_daemons, tmp_path):
    """The same sequence of raw /plan requests to both daemons: equal
    bodies but the volatile keys, training dumps equal to the port's
    ``dump_ranked_plans``, and the repeat a cache hit on both."""
    import dataclasses

    model = tiny_test_model()
    config = SearchConfig(gbs=PARITY_GBS, max_profiled_tp=PARITY_MAX_TP,
                          max_profiled_bs=PARITY_MAX_BS)
    cluster, profiles, _, _ = parity_inputs(tmp_path)
    for name, q in QUERIES.items():
        body = {"model": dataclasses.asdict(model),
                "config": dataclasses.asdict(config), **q,
                "trace_id": f"parity-{name}"}
        got = {k: _raw_plan(addr, body) for k, addr in twin_daemons.items()}
        assert got["port"]["trace_id"] == got["jax"]["trace_id"] == \
            f"parity-{name}"
        assert got["port"]["cached"] == got["jax"]["cached"] == \
            name.endswith("again")
        assert list(got["port"]) == list(got["jax"])
        strip = [{k: v for k, v in g.items() if k not in VOLATILE}
                 for g in (got["port"], got["jax"])]
        assert strip[0] == strip[1], name
        if "workload" not in q and not name.endswith("again"):
            offline = plan_hetero(cluster, profiles, model, config,
                                  top_k=q["top_k"])
            assert got["port"]["plans"] == dump_ranked_plans(offline.plans)
    # the reference's models and configs rebuild to the same query keys
    assert ref_model(model) == jdaemon.model_spec_from_dict(
        dataclasses.asdict(model))
    assert ref_config(config) == jdaemon.search_config_from_dict(
        dataclasses.asdict(config))
