"""The port's durable control plane (``metis_tpu_torch/serve/persist.py``,
``serve/standby.py``, the daemon's durable wiring) — the reference's
``tests/test_ha.py`` run on the port, its two drills (the reference's
``tools/ha_drill.py``) against ``python -m metis_tpu_torch serve``
processes — and the state directory as a contract between the packages:
a state directory written by either package's daemon (snapshot and
oplog, after a clean shutdown or a kill) restores in the other with the
same cache hits, the same snapshot digest and the same op and decision
seqs.

The reference's contracts:

- SnapshotStore: atomic write + ``.prev`` retention; a truncated file, a
  bit-flipped digest, or a leftover mid-write ``.tmp`` each fall back to
  the previous generation — partial state is never served; both
  generations corrupt raises SnapshotCorruptError (never a silent cold
  start).
- Oplog: append/replay, torn trailing line skipped, seq resume.
- Snapshot/restore round-trip: a restarted service answers the same
  cache entries byte-identically, resumes the op + decision cursors, and
  keeps the cluster-delta dedup window.
- /oplog + /notifications gap metadata: ``truncated`` flags exactly when
  a reader's cursor predates what the daemon still holds.
- ``delta_id`` dedup: a retried POST /cluster_delta is answered from the
  dedup window instead of double-applying the (relative) delta.
- Client failover across an address list; standby read-only 503s.
- StandbyTailer replication + promotion.
- the drills: kill -9 restore under the 1 s budget; standby promotion
  with zero lost tenant plans.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

from metis_tpu_torch.cluster import ClusterSpec
from metis_tpu_torch.core.config import SearchConfig
from metis_tpu_torch.core.errors import SnapshotCorruptError
from metis_tpu_torch.serve.persist import Oplog, SnapshotStore


# ---------------------------------------------------------------------------
# SnapshotStore
# ---------------------------------------------------------------------------


class TestSnapshotStore:
    def test_write_load_round_trip(self, tmp_path):
        store = SnapshotStore(tmp_path)
        store.write({"a": 1, "nested": {"b": [1, 2]}})
        doc = store.load()
        assert doc["payload"] == {"a": 1, "nested": {"b": [1, 2]}}
        assert doc["source"] == "latest"

    def test_prev_generation_retained(self, tmp_path):
        store = SnapshotStore(tmp_path)
        store.write({"gen": 1})
        store.write({"gen": 2})
        assert store.prev.exists()
        assert json.loads(store.prev.read_text())["payload"] == {"gen": 1}
        assert store.load()["payload"] == {"gen": 2}

    def test_truncated_latest_falls_back_to_prev(self, tmp_path):
        store = SnapshotStore(tmp_path)
        store.write({"gen": 1})
        store.write({"gen": 2})
        body = store.path.read_text()
        store.path.write_text(body[: len(body) // 2])  # torn write
        doc = SnapshotStore(tmp_path).load()
        assert doc["payload"] == {"gen": 1}
        assert doc["source"] == "prev"

    def test_bad_digest_falls_back_to_prev(self, tmp_path):
        store = SnapshotStore(tmp_path)
        store.write({"gen": 1})
        store.write({"gen": 2, "value": 100})
        doc = json.loads(store.path.read_text())
        doc["payload"]["value"] = 999  # bit-flip: digest now stale
        store.path.write_text(json.dumps(doc))
        loaded = SnapshotStore(tmp_path).load()
        assert loaded["payload"] == {"gen": 1}
        assert loaded["source"] == "prev"

    def test_leftover_tmp_is_ignored(self, tmp_path):
        store = SnapshotStore(tmp_path)
        store.write({"gen": 1})
        store.tmp.write_text('{"version": 1, "payl')  # mid-write crash
        doc = SnapshotStore(tmp_path).load()
        assert doc["payload"] == {"gen": 1}
        assert doc["source"] == "latest"

    def test_all_generations_corrupt_raises_never_partial(self, tmp_path):
        store = SnapshotStore(tmp_path)
        store.write({"gen": 1})
        store.write({"gen": 2})
        store.path.write_text(store.path.read_text()[:40])
        store.prev.write_text("not json at all")
        with pytest.raises(SnapshotCorruptError):
            SnapshotStore(tmp_path).load()

    def test_empty_dir_loads_none(self, tmp_path):
        assert SnapshotStore(tmp_path).load() is None

    def test_future_version_rejected(self, tmp_path):
        store = SnapshotStore(tmp_path)
        store.write({"gen": 1})
        doc = json.loads(store.path.read_text())
        doc["version"] = 99
        store.path.write_text(json.dumps(doc))
        with pytest.raises(SnapshotCorruptError):
            SnapshotStore(tmp_path).load()


# ---------------------------------------------------------------------------
# Oplog
# ---------------------------------------------------------------------------


class TestOplog:
    def test_append_reload_resume(self, tmp_path):
        path = tmp_path / "oplog.jsonl"
        log = Oplog(path)
        log.append({"seq": 1, "op": "a"})
        log.append({"seq": 2, "op": "b"})
        log.close()
        again = Oplog(path)
        assert again.last_seq == 2
        assert [e["op"] for e in again.entries(since=0)] == ["a", "b"]
        assert again.entries(since=1) == [{"seq": 2, "op": "b"}]
        assert again.first_seq == 1

    def test_torn_trailing_line_skipped(self, tmp_path):
        path = tmp_path / "oplog.jsonl"
        log = Oplog(path)
        log.append({"seq": 1, "op": "a"})
        log.close()
        with open(path, "a") as fh:
            fh.write('{"seq": 2, "op": "b"}\n{"seq": 3, "o')  # kill -9 tear
        again = Oplog(path)
        assert again.last_seq == 2
        assert len(again.entries(since=0)) == 2


# ---------------------------------------------------------------------------
# in-process service round-trips
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


def _make_service(small_workload, state_dir=None, **kw):
    from metis_tpu_torch.serve.daemon import PlanService

    cluster, profiles, _model, _config = small_workload
    return PlanService(cluster, profiles, drift_min_samples=5,
                       state_dir=state_dir, snapshot_interval=0, **kw)


def _strip(resp: dict) -> str:
    trimmed = {k: v for k, v in resp.items()
               if k not in ("cached", "serve_ms", "trace_id")}
    return json.dumps(trimmed, sort_keys=True, default=str)


class TestServiceRestore:
    def test_sigkill_style_restore_from_oplog_only(self, small_workload,
                                                   tmp_path):
        """No close(), no snapshot — exactly the kill -9 case: the whole
        state comes back from oplog replay, byte-identical."""
        _, _, model, config = small_workload
        svc = _make_service(small_workload, state_dir=tmp_path)
        cold = svc.plan_query(model, config, top_k=5)
        # abandoned without close(): the durable state is whatever the
        # line-buffered oplog already holds
        svc._oplog.close()  # release the fd only (test hygiene)

        svc2 = _make_service(small_workload, state_dir=tmp_path)
        assert svc2.restore_s is not None
        hit = svc2.plan_query(model, config, top_k=5)
        assert hit["cached"] is True
        assert _strip(hit) == _strip(cold)
        assert svc2._note_seq == svc._note_seq
        svc2.close()

    def test_snapshot_restore_round_trip(self, small_workload, tmp_path):
        _, _, model, config = small_workload
        svc = _make_service(small_workload, state_dir=tmp_path)
        svc.plan_query(model, config, top_k=5)
        out = svc.apply_cluster_delta({"T4": 2}, delta_id="drill-1")
        # the delta invalidated the full-cluster entry; the post-delta
        # answer is what must survive the restart
        warm = svc.plan_query(model, config, top_k=5)
        svc.close()  # clean shutdown: final snapshot written

        svc2 = _make_service(small_workload, state_dir=tmp_path)
        # clean shutdown means zero replay: everything from the snapshot
        assert svc2._last_snapshot_seq == svc2._note_seq
        assert svc2.cluster.total_devices == out["devices"]
        hit = svc2.plan_query(model, config, top_k=5)
        assert hit["cached"] is True
        assert _strip(hit) == _strip(warm)
        # dedup window survives the restart: the same delta_id does not
        # shrink the cluster a second time
        again = svc2.apply_cluster_delta({"T4": 2}, delta_id="drill-1")
        assert again["deduplicated"] is True
        assert svc2.cluster.total_devices == out["devices"]
        svc2.close()

    def test_decision_seq_resumes(self, small_workload, tmp_path):
        from metis_tpu_torch.obs.provenance import DecisionLog

        _, _, model, config = small_workload
        log_path = tmp_path / "decisions.jsonl"
        svc = _make_service(small_workload, state_dir=tmp_path,
                            decisions=DecisionLog(log_path))
        svc.plan_query(model, config, top_k=5)
        pre = svc.decisions.last_seq
        assert pre > 0
        svc.close()
        svc2 = _make_service(small_workload, state_dir=tmp_path,
                             decisions=DecisionLog(log_path))
        assert svc2.decisions.last_seq >= pre
        svc2.plan_query(model, dataclasses.replace(config, gbs=32),
                        top_k=5)
        assert svc2.decisions.last_seq > pre
        svc2.close()

    def test_drift_monitor_state_survives(self, small_workload, tmp_path):
        _, _, model, config = small_workload
        svc = _make_service(small_workload, state_dir=tmp_path)
        cold = svc.plan_query(model, config, top_k=5)
        fp = cold["plan_fingerprint"]
        for step in range(3):
            svc.post_accuracy_sample(
                fp, measured_ms=cold["best_cost_ms"] * 2.0, step=step)
        svc.close()
        svc2 = _make_service(small_workload, state_dir=tmp_path)
        # min_samples=5: 3 pre-restart samples + 2 post-restart samples
        # must trip the alarm — the drift window rode the snapshot
        status = None
        for step in range(3, 5):
            status = svc2.post_accuracy_sample(
                fp, measured_ms=cold["best_cost_ms"] * 2.0, step=step)
        assert status["in_drift"] is True
        svc2.close()

    def test_corrupt_latest_restores_prev_state(self, small_workload,
                                                tmp_path):
        _, _, model, config = small_workload
        svc = _make_service(small_workload, state_dir=tmp_path)
        cold = svc.plan_query(model, config, top_k=5)
        svc.snapshot_now()   # generation 1 (the good one)
        svc.snapshot_now()   # generation 2 -> parks 1 at .prev
        svc.close()
        store = SnapshotStore(tmp_path)
        store.path.write_text(store.path.read_text()[:64])
        # the oplog would re-apply everything anyway; drop it to prove
        # the state really comes from the .prev snapshot
        (tmp_path / "oplog.jsonl").unlink()
        svc2 = _make_service(small_workload, state_dir=tmp_path)
        hit = svc2.plan_query(model, config, top_k=5)
        assert hit["cached"] is True
        assert _strip(hit) == _strip(cold)
        svc2.close()

    def test_both_generations_corrupt_refuses_to_boot(self, small_workload,
                                                      tmp_path):
        _, _, model, config = small_workload
        svc = _make_service(small_workload, state_dir=tmp_path)
        svc.plan_query(model, config, top_k=5)
        svc.snapshot_now()
        svc.snapshot_now()
        svc.close()
        store = SnapshotStore(tmp_path)
        store.path.write_text(store.path.read_text()[:64])
        store.prev.write_text("garbage")
        with pytest.raises(SnapshotCorruptError):
            _make_service(small_workload, state_dir=tmp_path)


# ---------------------------------------------------------------------------
# gap metadata + dedup
# ---------------------------------------------------------------------------


class TestGapDetection:
    def test_oplog_window_exact_truncation(self, small_workload,
                                           monkeypatch):
        from metis_tpu_torch.serve.daemon import PlanService

        monkeypatch.setattr(PlanService, "OP_TAIL_WINDOW", 3)
        _, _, model, config = small_workload
        svc = _make_service(small_workload)
        for i in range(6):
            svc._push_note({"kind": "tenant_replan", "tenant": f"t{i}"})
        win = svc.oplog_window(since=0)
        assert win["last_seq"] == 6
        assert win["oldest_seq"] == 4
        assert win["truncated"] is True          # ops 1..3 are gone
        assert svc.oplog_window(since=3)["truncated"] is False
        assert svc.oplog_window(since=2)["truncated"] is True
        svc.close()

    def test_durable_oplog_never_truncates(self, small_workload, tmp_path,
                                           monkeypatch):
        from metis_tpu_torch.serve.daemon import PlanService

        monkeypatch.setattr(PlanService, "OP_TAIL_WINDOW", 3)
        svc = _make_service(small_workload, state_dir=tmp_path)
        for i in range(6):
            svc._push_note({"kind": "tenant_replan", "tenant": f"t{i}"})
        win = svc.oplog_window(since=0)
        assert win["truncated"] is False
        assert len(win["entries"]) == 6
        svc.close()

    def test_notifications_window_reports_gap(self, small_workload,
                                              monkeypatch):
        from metis_tpu_torch.serve.daemon import PlanService

        monkeypatch.setattr(PlanService, "NOTES_WINDOW", 4)
        svc = _make_service(small_workload)
        for i in range(6):
            svc._push_note({"kind": "tenant_replan", "tenant": f"t{i}"})
        win = svc.notifications_window(since=0)
        assert win["truncated"] is True          # notes 1, 2 dropped
        assert win["oldest_seq"] == 3
        assert [n["seq"] for n in win["notifications"]] == [3, 4, 5, 6]
        # a reader whose cursor is past the drop watermark sees no gap
        assert svc.notifications_window(since=2)["truncated"] is False
        assert svc.notifications_window(since=1)["truncated"] is True
        svc.close()

    def test_delta_id_dedup_does_not_double_apply(self, small_workload):
        svc = _make_service(small_workload)
        devices = svc.cluster.total_devices
        out = svc.apply_cluster_delta({"T4": 2}, delta_id="d1")
        assert out["devices"] == devices - 2
        again = svc.apply_cluster_delta({"T4": 2}, delta_id="d1")
        assert again["deduplicated"] is True
        assert again["devices"] == devices - 2
        assert svc.cluster.total_devices == devices - 2  # NOT -4
        # a different id is a genuinely new delta
        more = svc.apply_cluster_delta({"T4": 2}, delta_id="d2")
        assert more["devices"] == devices - 4
        svc.close()


# ---------------------------------------------------------------------------
# standby + client failover
# ---------------------------------------------------------------------------


class TestStandby:
    def test_replicates_promotes_and_rejects_writes(self, small_workload):
        from metis_tpu_torch.serve.client import PlanServiceClient
        from metis_tpu_torch.serve.daemon import serve_in_thread
        from metis_tpu_torch.serve.standby import StandbyTailer

        _, _, model, config = small_workload
        primary = _make_service(small_workload)
        server, thread, address = serve_in_thread(primary)
        try:
            client = PlanServiceClient(address)
            cold = client.plan(model, config, top_k=5)

            standby = _make_service(small_workload, read_only=True)
            tailer = StandbyTailer(standby, address, client_timeout_s=5.0)
            applied = tailer.sync_once()
            assert applied >= 1
            assert standby._note_seq == primary._note_seq
            hit = standby.plan_query(model, config, top_k=5)
            assert hit["cached"] is True
            assert _strip(hit) == _strip(cold)

            # mutations 503 over HTTP while read-only
            sserver, sthread, saddress = serve_in_thread(standby)
            try:
                import http.client as hc
                from urllib.parse import urlparse

                u = urlparse(saddress)
                conn = hc.HTTPConnection(u.hostname, u.port, timeout=10)
                conn.request("POST", "/cluster_delta",
                             body=json.dumps({"removed": {"T4": 2}}),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = json.loads(resp.read())
                assert resp.status == 503
                assert body["standby"] is True
                conn.close()

                out = tailer.promote(reason="drill")
                assert standby.read_only is False
                assert out["last_seq"] == primary._note_seq
                notes = standby.notifications(since=out["last_seq"])
                assert notes and notes[-1]["kind"] == "failover"
                # promoted: mutations now apply
                delta = standby.apply_cluster_delta({"T4": 2})
                assert delta["devices"] == primary.cluster.total_devices - 2
            finally:
                sserver.shutdown()
                sserver.server_close()
                sthread.join(10)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(10)

    def test_rejects_writable_service(self, small_workload):
        from metis_tpu_torch.serve.standby import StandbyTailer

        svc = _make_service(small_workload)
        with pytest.raises(ValueError):
            StandbyTailer(svc, "http://127.0.0.1:1")
        svc.close()


class TestClientFailover:
    def test_dead_primary_falls_over_to_live_address(self, small_workload):
        from metis_tpu_torch.serve.client import PlanServiceClient
        from metis_tpu_torch.serve.daemon import serve_in_thread

        svc = _make_service(small_workload)
        server, thread, address = serve_in_thread(svc)
        try:
            dead = "http://127.0.0.1:9"  # discard port: nothing listens
            client = PlanServiceClient([dead, address], timeout=30.0)
            assert client.active_address == dead
            stats = client.stats()
            assert stats["cluster_devices"] == svc.cluster.total_devices
            assert client.active_address == address  # sticky preference
        finally:
            server.shutdown()
            server.server_close()
            thread.join(10)

    def test_standby_503_routes_mutation_to_primary(self, small_workload):
        from metis_tpu_torch.serve.client import PlanServiceClient
        from metis_tpu_torch.serve.daemon import serve_in_thread

        primary = _make_service(small_workload)
        standby = _make_service(small_workload, read_only=True)
        pserver, pthread, paddress = serve_in_thread(primary)
        sserver, sthread, saddress = serve_in_thread(standby)
        try:
            # standby listed FIRST: the 503 must bounce the write onward
            client = PlanServiceClient([saddress, paddress], timeout=30.0)
            out = client.cluster_delta(removed={"T4": 2})
            assert out["devices"] == primary.cluster.total_devices
            assert standby.cluster.total_devices != out["devices"]
            assert client.active_address == paddress
        finally:
            for server, thread in ((pserver, pthread), (sserver, sthread)):
                server.shutdown()
                server.server_close()
                thread.join(10)

    def test_all_addresses_dead_raises(self):
        from metis_tpu_torch.serve.client import PlanServiceClient, \
            ServeClientError

        client = PlanServiceClient(
            ["http://127.0.0.1:9", "http://127.0.0.1:10"], timeout=5.0)
        with pytest.raises(ServeClientError):
            client.stats()


# ---------------------------------------------------------------------------
# end-to-end drills: the reference's tools/ha_drill.py on the port's daemon
# ---------------------------------------------------------------------------

import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

from torch_serve_reference import parity_inputs  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
RESTORE_BUDGET_S = 1.0
BOOT_TIMEOUT_S = 180.0


def canonical(payload: dict) -> str:
    """A response minus its per-request fields, canonical JSON."""
    return _strip(payload)


def spawn_daemon(fixture_dir: Path, state_dir: Path, extra=()):
    """``python -m metis_tpu_torch serve --state-dir`` as a process:
    ``(proc, boot)``, the boot line parsed."""
    cmd = [sys.executable, "-m", "metis_tpu_torch", "serve",
           "--hostfile", str(fixture_dir / "hostfile"),
           "--clusterfile", str(fixture_dir / "clusterfile.json"),
           "--profile-dir", str(fixture_dir / "profiles"),
           "--port", "0", "--state-dir", str(state_dir), *extra]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=str(REPO),
                            env={**os.environ, "PYTHONPATH": str(REPO)})
    deadline = time.monotonic() + BOOT_TIMEOUT_S
    boot = None
    while boot is None and time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        if line.strip().startswith("{"):
            boot = json.loads(line)
    if boot is None:
        proc.kill()
        _, err = proc.communicate(timeout=30)
        raise AssertionError(f"no boot line: {err[-2000:]}")
    return proc, boot


def sigkill(proc) -> None:
    proc.kill()  # SIGKILL: no atexit, no flush
    proc.communicate(timeout=30)


def run_restore_drill(work_dir: Path) -> dict:
    """kill -9, reboot on the same --state-dir, byte-identical cache (a
    beam and an exact-backend query, whose certificate must survive)."""
    from metis_tpu_torch.serve.client import PlanServiceClient

    _cluster, _profiles, model, config = parity_inputs(work_dir)
    exact_config = dataclasses.replace(config, backend="exact")
    state_dir = work_dir / "state"
    out: dict = {}
    proc, boot = spawn_daemon(work_dir, state_dir)
    try:
        client = PlanServiceClient(boot["serving"], timeout=300.0)
        beam = client.plan(model, config, top_k=5)
        exact = client.plan(model, exact_config, top_k=5)
        assert exact.get("certificate")
        pre = client.stats()
    finally:
        sigkill(proc)
    out["primed_decision_seq"] = pre["decision_seq"]
    proc2, boot2 = spawn_daemon(work_dir, state_dir)
    try:
        out["restore_s"] = boot2["restore_s"]
        assert boot2["restored_seq"] == pre["note_seq"]
        client2 = PlanServiceClient(boot2["serving"], timeout=300.0)
        beam2 = client2.plan(model, config, top_k=5)
        exact2 = client2.plan(model, exact_config, top_k=5)
        for a, b in ((beam, beam2), (exact, exact2)):
            assert b["cached"] is True and canonical(a) == canonical(b)
        assert exact2["certificate"] == exact["certificate"]
        post = client2.stats()
        assert post["decision_seq"] >= pre["decision_seq"]
        assert post["note_seq"] >= pre["note_seq"]
        out["restored_decision_seq"] = post["decision_seq"]
        client2.shutdown()
    finally:
        sigkill(proc2)
    out["ok"] = True
    return out


def run_failover_drill(work_dir: Path, tenants: int = 2) -> dict:
    """kill -9 the primary, the standby promotes, a failover client's
    tenant plans stay byte-identical (zero lost)."""
    from metis_tpu_torch.sched.tenant import TenantSpec
    from metis_tpu_torch.serve.client import PlanServiceClient
    from metis_tpu_torch.serve.daemon import PlanService, serve_in_thread
    from metis_tpu_torch.serve.standby import StandbyTailer

    cluster, profiles, model, config = parity_inputs(work_dir)
    out: dict = {"tenants": tenants}
    proc, boot = spawn_daemon(work_dir, work_dir / "primary_state")
    primary = boot["serving"]
    standby_server = tailer = None
    try:
        served = {}
        try:
            client = PlanServiceClient(primary, timeout=300.0)
            for i in range(tenants):
                client.tenant_register(TenantSpec(
                    name=f"tenant{i}", model=model, config=config,
                    priority=i))
            for i in range(tenants):
                served[f"tenant{i}"] = canonical(
                    client.tenant_plan(f"tenant{i}"))
            primary_seq = client.stats()["note_seq"]
            standby = PlanService(cluster, profiles, read_only=True)
            tailer = StandbyTailer(standby, primary, poll_interval_s=0.1,
                                   promote_after=3, client_timeout_s=2.0)
            standby_server, _thread, standby_addr = serve_in_thread(standby)
            tailer.start()
            deadline = time.monotonic() + 60.0
            while standby._note_seq < primary_seq:
                assert time.monotonic() < deadline, "standby never caught up"
                time.sleep(0.05)
        finally:
            sigkill(proc)
        deadline = time.monotonic() + 30.0
        while not tailer.promoted:
            assert time.monotonic() < deadline, "standby did not promote"
            time.sleep(0.05)
        ha = PlanServiceClient([primary, standby_addr], timeout=60.0)
        lost = [name for name, before in served.items()
                if canonical(ha.tenant_plan(name)) != before]
        out["lost_plans"] = len(lost)
        assert ha.active_address == standby_addr
        assert any(n.get("kind") == "failover"
                   for n in ha.notifications(since=0))
        out["ok"] = not lost
        return out
    finally:
        if tailer is not None:
            tailer.stop()
        if standby_server is not None:
            standby_server.shutdown()
            standby_server.server_close()


class TestHaDrill:
    def test_restore_drill(self, tmp_path):
        out = run_restore_drill(tmp_path)
        assert out["ok"] is True
        assert out["restore_s"] < RESTORE_BUDGET_S
        assert out["restored_decision_seq"] >= out["primed_decision_seq"]

    def test_failover_drill(self, tmp_path):
        out = run_failover_drill(tmp_path, tenants=2)
        assert out["ok"] is True
        assert out["lost_plans"] == 0


# ---------------------------------------------------------------------------
# the state directory across the packages
# ---------------------------------------------------------------------------

import metis_tpu.cluster.spec as jcluster  # noqa: E402
import metis_tpu.obs.provenance as jprov  # noqa: E402
import metis_tpu.sched.tenant as jtenant  # noqa: E402
import metis_tpu.serve.daemon as jdaemon  # noqa: E402
import metis_tpu.serve.persist as jpersist  # noqa: E402
import metis_tpu_torch.cluster.spec as tcluster  # noqa: E402
import metis_tpu_torch.obs.provenance as tprov  # noqa: E402
import metis_tpu_torch.sched.tenant as ttenant  # noqa: E402
import metis_tpu_torch.serve.daemon as tdaemon  # noqa: E402
import metis_tpu_torch.serve.persist as tpersist  # noqa: E402
from torch_serve_reference import (  # noqa: E402
    both_stores,
    dump_synthetic,
    ref_config,
    ref_model,
)

JAX = dict(daemon=jdaemon, cluster=jcluster, tenant=jtenant, prov=jprov,
           persist=jpersist)
PORT = dict(daemon=tdaemon, cluster=tcluster, tenant=ttenant, prov=tprov,
            persist=tpersist)


def _daemon(pkg, stores, state_dir):
    cluster = pkg["cluster"].ClusterSpec.of(("A100", 1, 4), ("T4", 1, 4))
    return pkg["daemon"].PlanService(
        cluster, stores[0] if pkg is JAX else stores[1],
        drift_min_samples=5, state_dir=state_dir, snapshot_interval=0,
        decisions=pkg["prov"].DecisionLog(state_dir / "decisions.jsonl"))


def _queries(pkg):
    from metis_tpu.testing import PARITY_INFERENCE

    from metis_tpu_torch.inference.workload import InferenceWorkload

    model = tiny_test_model_port(4)
    config = SearchConfig(gbs=16, max_profiled_tp=2, max_profiled_bs=4)
    wl = InferenceWorkload(**PARITY_INFERENCE)
    if pkg is JAX:
        import metis_tpu.inference.workload as jw

        model, config = ref_model(model), ref_config(config)
        wl = jw.InferenceWorkload(**PARITY_INFERENCE)
    return model, config, wl


def tiny_test_model_port(num_layers):
    from torch_serve_reference import tiny_test_model

    return tiny_test_model(num_layers=num_layers)


def _prime(pkg, svc):
    """Fill a daemon's state: a tenant, a cluster delta, then queries
    (training at two batch sizes, inference, the tenant's) and drift
    samples below the alarm."""
    model, config, wl = _queries(pkg)
    svc.tenant_register(pkg["tenant"].TenantSpec("solo", model, config,
                                                 quota_floor=2))
    svc.plan_query(model, config, top_k=5)
    svc.apply_cluster_delta(removed={"T4": 2}, delta_id="x-1")
    answers = _replay(pkg, svc)
    fp = answers[0]["plan_fingerprint"]
    for step in range(3):
        svc.post_accuracy_sample(fp, measured_ms=answers[0]["best_cost_ms"]
                                 * 1.5, step=step)
    return answers


def _replay(pkg, svc):
    model, config, wl = _queries(pkg)
    return [svc.plan_query(model, config, top_k=5),
            svc.plan_query(model, dataclasses.replace(config, gbs=32),
                           top_k=3),
            svc.plan_query(model, config, top_k=5, workload=wl),
            svc.tenant_plan("solo")]


@pytest.fixture(scope="module")
def wire_stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("ha_wire_profiles")
    dump_synthetic(tiny_test_model_port(4), ["A100", "T4"], root,
                   tps=[1, 2], bss=[1, 2, 4])
    return both_stores(root)


@pytest.mark.parametrize("clean", [True, False], ids=["snapshot", "oplog"])
@pytest.mark.parametrize("src,dst", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_state_dir_restores_across_packages(wire_stores, tmp_path, src, dst,
                                            clean):
    """Written by ``src``'s daemon (closed cleanly, or abandoned as after a
    kill -9), restored by ``dst``'s: the post-delta cache answers as
    hits with equal payloads, the same op and decision seqs, the same
    snapshot digest, and the same dedup window."""
    state = tmp_path / "state"
    svc = _daemon(src, wire_stores, state)
    answers = _prime(src, svc)
    seq, dseq = svc._note_seq, svc.decisions.last_seq
    if clean:
        svc.close()
        digest = json.loads((state / "state.json").read_text())["digest"]
    else:
        svc._oplog.close()  # the fd only: nothing flushed beyond the log
        svc.decisions.close()
        # an oplog replay does not bring back what the oplog never held
        # (the drift monitors ride snapshots only), in either package:
        # the digest to meet is that of ``src`` restoring its own state
        shutil.copytree(state, tmp_path / "self")
        own = _daemon(src, wire_stores, tmp_path / "self")
        digest = src["persist"].payload_digest(
            src["persist"].capture_state(own))
        own.close()
    back = _daemon(dst, wire_stores, state)
    try:
        assert back.restore_s is not None and back.restore_s < 1.0
        assert back._note_seq == seq
        assert back.decisions.last_seq == dseq
        assert back.cluster.total_devices == 6
        assert dst["persist"].payload_digest(
            dst["persist"].capture_state(back)) == digest
        for got, before in zip(_replay(dst, back), answers):
            assert got["cached"] is True
            assert _strip(got) == _strip(before)
        assert back.apply_cluster_delta(
            removed={"T4": 2}, delta_id="x-1")["deduplicated"] is True
    finally:
        back.close()
