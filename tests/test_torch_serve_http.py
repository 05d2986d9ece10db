"""The port's daemon over HTTP (``serve/daemon.py``'s handler and
servers, ``serve/client.py``) — the transport cases of the reference's
``tests/test_serve.py`` run on the port — and the two packages across the
wire: the port's client against the reference's daemon and the
reference's client against the port's daemon, both in-process
(``serve_in_thread``), give the same answers, endpoint by endpoint.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from metis_tpu_torch.cluster import ClusterSpec
from metis_tpu_torch.core.config import SearchConfig


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
def http_service(small_workload):
    """Service + live TCP server; yields (service, server, host, port)."""
    from metis_tpu_torch.serve.daemon import PlanService, serve_in_thread

    cluster, profiles, _model, _config = small_workload
    service = PlanService(cluster, profiles, drift_min_samples=5)
    server, thread, address = serve_in_thread(service)
    host, port = address[len("http://"):].rsplit(":", 1)
    yield service, server, host, int(port)
    server.shutdown()
    thread.join(10)
    server.server_close()


class TestKeepAliveTransport:
    def test_connection_reuse_over_one_socket(self, http_service):
        import http.client as hc

        service, _server, host, port = http_service
        conn = hc.HTTPConnection(host, port, timeout=10)
        try:
            for i in range(3):
                conn.request("GET", "/stats")
                resp = conn.getresponse()
                body = resp.read()
                assert resp.status == 200
                assert not resp.will_close, (
                    f"server closed the keep-alive connection on "
                    f"request {i + 1}")
                assert json.loads(body)["cluster_devices"] == 8
        finally:
            conn.close()
        reuse = service.metrics.counter(
            "metis_serve_keepalive_reuse_total").value
        assert reuse >= 2

    def test_pool_metrics_exported(self, http_service):
        service, server, _host, _port = http_service
        text = service.render_metrics()
        assert f"metis_serve_pool_threads {server.pool_threads}" in text
        assert "metis_serve_pool_backlog" in text

    def test_overload_sheds_with_503_retry_after(self, small_workload):
        """threads=1 + backlog=1: with the lone worker parked on a
        long-poll, the next connection queues and the one after that
        must get an immediate 503 + Retry-After + Connection: close."""
        import http.client as hc

        from metis_tpu_torch.serve.daemon import (_Handler, _TCPServer,
                                            PlanService)

        cluster, profiles, _model, _config = small_workload
        service = PlanService(cluster, profiles)
        server = _TCPServer(("127.0.0.1", 0), _Handler)
        server.service = service
        server.pool_backlog = 1
        server.init_pool(threads=1)
        host, port = server.server_address[:2]
        import threading as _threading
        thread = _threading.Thread(target=server.serve_forever,
                                   daemon=True)
        thread.start()
        conns = []
        try:
            # park the only worker on a long-poll
            busy = hc.HTTPConnection(host, port, timeout=30)
            conns.append(busy)
            busy.request("GET", "/notifications?timeout=8")
            time.sleep(0.3)  # let the worker pick it up
            # fill the backlog (accepted, never served while parked)
            filler = hc.HTTPConnection(host, port, timeout=30)
            conns.append(filler)
            filler.request("GET", "/stats")
            time.sleep(0.2)
            # overload: must be shed, not queued
            shed = hc.HTTPConnection(host, port, timeout=10)
            conns.append(shed)
            shed.request("GET", "/stats")
            resp = shed.getresponse()
            assert resp.status == 503
            assert resp.getheader("Retry-After") == "1"
            assert resp.getheader("Connection") == "close"
            body = json.loads(resp.read())
            assert "overloaded" in body["error"]
            assert service.counters.get("serve.overload") >= 1
            assert service.metrics.counter(
                "metis_serve_overload_total").value >= 1
        finally:
            for c in conns:
                c.close()
            server.shutdown()
            thread.join(10)
            server.server_close()


class TestClientConnectionPool:
    def test_pool_reuses_sockets(self, http_service):
        from metis_tpu_torch.serve.client import PlanServiceClient

        _service, _server, host, port = http_service
        with PlanServiceClient(f"http://{host}:{port}") as client:
            for _ in range(4):
                client.stats()
            ps = client.pool_stats()
            assert ps["opened"] == 1
            assert ps["reused"] == 3
            assert ps["idle"] == 1

    def test_reconnects_when_pooled_socket_dies(self, http_service):
        """A pooled socket the daemon closed between requests must be
        retried transparently on a fresh connection (idempotent
        endpoints), not surfaced as an error."""
        import socket as _socket

        from metis_tpu_torch.serve.client import PlanServiceClient

        _service, _server, host, port = http_service
        with PlanServiceClient(f"http://{host}:{port}") as client:
            client.stats()
            # simulate a server-side idle close of the pooled socket
            with client._pool_lock:
                stale = client._idle[0][0]
            stale.sock.shutdown(_socket.SHUT_RDWR)
            out = client.stats()
            assert out["cluster_devices"] == 8
            assert client.pool_stats()["opened"] == 2

    def test_long_poll_and_monitoring_get_dedicated_sockets(
            self, http_service):
        from metis_tpu_torch.serve.client import PlanServiceClient

        _service, _server, host, port = http_service
        with PlanServiceClient(f"http://{host}:{port}") as client:
            assert client.healthz()["live"] is True
            assert "metis_serve_requests_total" in client.metrics()
            client.notifications(since=0, timeout_s=0.0)
            # none of those went through (or into) the pool
            ps = client.pool_stats()
            assert ps == {"opened": 0, "reused": 0, "idle": 0}

    def test_pooling_can_be_disabled(self, http_service):
        from metis_tpu_torch.serve.client import PlanServiceClient

        _service, _server, host, port = http_service
        client = PlanServiceClient(f"http://{host}:{port}",
                                   pool_connections=False)
        client.stats()
        client.stats()
        assert client.pool_stats() == {"opened": 0, "reused": 0,
                                       "idle": 0}


# ---------------------------------------------------------------------------
# the two packages across the wire
# ---------------------------------------------------------------------------

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
from torch_serve_reference import (  # noqa: E402
    both_stores,
    dump_synthetic,
    tiny_test_model,
)

JAX = dict(client=jclient, daemon=jdaemon, cluster=jcluster, tenant=jtenant,
           metrics=jmetrics)
PORT = dict(client=tclient, daemon=tdaemon, cluster=tcluster, tenant=ttenant,
            metrics=tmetrics)
# per-request and per-process values: times, uptimes, request ids
_VOLATILE = {"serve_ms", "trace_id", "search_seconds", "ts", "uptime_s",
             "wall_s", "restore_s", "elapsed_s"}


def _norm(x):
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items() if k not in _VOLATILE}
    if isinstance(x, list):
        return [_norm(v) for v in x]
    return x


@pytest.fixture(scope="module")
def shared_store(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_wire_profiles")
    dump_synthetic(tiny_test_model(num_layers=4), ["A100", "T4"], root,
                   tps=[1, 2], bss=[1, 2, 4])
    return both_stores(root)


def _pushes(client, since: int) -> list:
    """The notes after ``since`` once a ``replan_push`` is among them (the
    daemon replans in a background thread), long-polling 2 s at a time."""
    for _ in range(15):
        notes = client.notifications(since=since, timeout_s=2.0)
        if any(n["kind"] == "replan_push" for n in notes):
            return notes
    raise AssertionError(f"no replan_push after seq {since}")


def _session(client_pkg, daemon_pkg, stores) -> list:
    """One client session against a fresh daemon, every answer kept:
    cold and cached plans, a drift alarm's replan push, the decision log,
    a tenant, a cluster delta with its replan, an invalidation, stats,
    health and the metric names."""
    store = stores[0] if daemon_pkg is JAX else stores[1]
    cluster = daemon_pkg["cluster"].ClusterSpec.of(("A100", 1, 4),
                                                   ("T4", 1, 4))
    service = daemon_pkg["daemon"].PlanService(cluster, store,
                                               drift_min_samples=3)
    server, thread, address = daemon_pkg["daemon"].serve_in_thread(service)
    client = client_pkg["client"].PlanServiceClient(address)
    model = tiny_test_model(num_layers=4)
    config = SearchConfig(gbs=16, max_profiled_tp=2, max_profiled_bs=4)
    out = []
    try:
        cold = client.plan(model, config, top_k=5, trace_id="wire-1")
        out += [cold, client.plan(model, config, top_k=5)]
        fp = cold["plan_fingerprint"]
        for step in range(4):
            out.append(client.accuracy_sample(
                fp, measured_ms=cold["best_cost_ms"] * 2.0, step=step))
        out += [_pushes(client, 0), client.decisions()]
        out.append(client.tenant_register(client_pkg["tenant"].TenantSpec(
            "solo", model, config, quota_floor=2)))
        out += [client.tenant_plan("solo"), client.tenant_status()]
        delta = client.cluster_delta(removed={"T4": 4}, replan=True,
                                     delta_id="wire-delta")
        out += [delta, client.cluster_delta(removed={"T4": 4}, replan=True,
                                            delta_id="wire-delta")]
        out.append(_pushes(client, delta["seq"]))
        out += [client.plan(model, config, top_k=5),
                client.invalidate(), client.stats(), client.healthz(),
                client.oplog(since=0)["last_seq"]]
        families = client_pkg["metrics"].parse_exposition(client.metrics())
        out.append(sorted(
            (name, fam["type"], sorted({tuple(sorted(set(lab) - {"le"}))
                                        for _, lab, _ in fam["samples"]}))
            for name, fam in families.items()))
    finally:
        client.shutdown()
        thread.join(10)
        server.server_close()
    return _norm(out)


@pytest.mark.parametrize("client_pkg,daemon_pkg",
                         [(PORT, JAX), (JAX, PORT), (PORT, PORT)],
                         ids=["port_client_jax_daemon",
                              "jax_client_port_daemon", "port_port"])
def test_client_and_daemon_across_packages(shared_store, client_pkg,
                                           daemon_pkg):
    want = _session(JAX, JAX, shared_store)
    got = _session(client_pkg, daemon_pkg, shared_store)
    assert got == want


def test_trace_ids_are_echoed_across_packages(shared_store):
    model = tiny_test_model(num_layers=4)
    config = SearchConfig(gbs=16, max_profiled_tp=2, max_profiled_bs=4)
    cluster = tcluster.ClusterSpec.of(("A100", 1, 4), ("T4", 1, 4))
    service = tdaemon.PlanService(cluster, shared_store[1])
    server, thread, address = tdaemon.serve_in_thread(service)
    try:
        for client in (jclient.PlanServiceClient(address),
                       tclient.PlanServiceClient(address)):
            assert client.plan(model, config, top_k=3,
                               trace_id="t-echo")["trace_id"] == "t-echo"
            minted = client.plan(model, config, top_k=3)["trace_id"]
            assert len(minted) == 16
    finally:
        server.shutdown()
        thread.join(10)
        server.server_close()


def test_serve_smoke_unix_socket(tmp_path):
    """The end-to-end smoke (``test_torch_serve_smoke.run_smoke``) over
    AF_UNIX, the transport the CLI's ``--socket`` flag serves on."""
    from test_torch_serve_smoke import run_smoke

    out = run_smoke(tmp_path, threads=16, per_thread=1, cached_queries=20,
                    unix_socket=True)
    assert out["ok"] is True
    assert out["address"].startswith("unix:")
