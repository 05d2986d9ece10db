"""The port's traffic replay (``metis_tpu_torch/inference/replay.py``) and
its ``replay`` subcommand against the reference's.

The replay cases of the reference's ``tests/test_inference.py`` run on
the port (the diurnal curve, a full cycle with elastic deltas through the
daemon, a cluster delta replanning a cached serving query), and the two
packages are held to each other: the curve and the forecast agree at
every tick; ``replay_traffic`` against each package's daemon gives the
same report under both policies; the ``replay`` subcommand prints the
reference CLI's report, booted in-process or against a daemon
(``--remote``), with the same exit codes.

``replan_pushes`` counts the pushes that have reached the client by each
tick's poll; the daemon replans in a background thread, so the count
depends on timing in both packages, and it is compared as "at least
one" rather than equal.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

from check_events_schema import validate_events  # noqa: E402

import metis_tpu.inference.replay as jreplay  # noqa: E402
import metis_tpu.inference.workload as jworkload  # noqa: E402
import metis_tpu.serve.client as jclient  # noqa: E402
import metis_tpu.serve.daemon as jdaemon  # noqa: E402
import metis_tpu_torch.inference as tinference  # noqa: E402
import metis_tpu_torch.inference.replay as treplay  # noqa: E402
from metis_tpu.planner import cli as jcli  # noqa: E402
from metis_tpu.testing import (  # noqa: E402
    PARITY_GBS,
    PARITY_INFERENCE,
    PARITY_MAX_BS,
    PARITY_MAX_TP,
    write_parity_fixture,
)
from metis_tpu_torch import cli as tcli  # noqa: E402
from metis_tpu_torch.cluster.spec import ClusterSpec  # noqa: E402
from metis_tpu_torch.core.config import SearchConfig  # noqa: E402
from metis_tpu_torch.inference.workload import InferenceWorkload  # noqa: E402
from metis_tpu_torch.profiles.store import ProfileStore  # noqa: E402
from metis_tpu_torch.serve.client import PlanServiceClient  # noqa: E402
from metis_tpu_torch.serve.daemon import PlanService, serve_in_thread  # noqa: E402
from torch_serve_reference import (  # noqa: E402
    ref_config,
    ref_model,
    tiny_test_model,
)


def _parity_config() -> SearchConfig:
    return SearchConfig(gbs=PARITY_GBS, max_profiled_tp=PARITY_MAX_TP,
                        max_profiled_bs=PARITY_MAX_BS)


def _parity_workload(**over) -> InferenceWorkload:
    return InferenceWorkload(**{**PARITY_INFERENCE, **over})


@pytest.fixture(scope="module")
def parity_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("replay_parity")
    write_parity_fixture(d)
    return d


@pytest.fixture(scope="module")
def parity_inputs(parity_dir):
    cluster = ClusterSpec.from_files(parity_dir / "hostfile",
                                     parity_dir / "clusterfile.json")
    store = ProfileStore.from_dir(parity_dir / "profiles")
    return cluster, store, tiny_test_model()


# ---------------------------------------------------------------------------
# the reference's cases on the port
# ---------------------------------------------------------------------------


class TestTrafficReplay:
    def test_diurnal_rate_shape(self):
        from metis_tpu_torch.inference.replay import diurnal_rate

        ticks = 24
        rates = [diurnal_rate(t, ticks, 2.0, 50.0) for t in range(ticks)]
        assert rates[0] == pytest.approx(2.0)
        assert max(rates) == pytest.approx(50.0)
        assert rates[ticks // 2] == pytest.approx(50.0)
        # symmetric about the peak
        assert rates[1] == pytest.approx(rates[-1])

    def test_full_cycle_with_elastic_deltas(self, parity_inputs, tmp_path):
        from metis_tpu_torch.core.events import EventLog, read_events
        from metis_tpu_torch.inference.replay import replay_traffic

        cluster, store, model = parity_inputs
        path = tmp_path / "replay_events.jsonl"
        log = EventLog(path)
        service = PlanService(cluster, store, events=log)
        server, _thread, address = serve_in_thread(service)
        try:
            client = PlanServiceClient(address)
            report = replay_traffic(
                client, cluster, model, _parity_config(),
                _parity_workload(),
                base_rps=4.0, peak_rps=40.0, ticks_per_cycle=6, cycles=1,
                events=log)
        finally:
            server.shutdown()
            server.server_close()
        log.close()

        assert report.cycles == 1
        assert len(report.ticks) == 6
        assert 0.0 <= report.slo_attainment <= 1.0
        assert any(t.scaled == "down" for t in report.ticks)
        assert report.replan_pushes >= 1
        assert min(report.device_trajectory) >= 8
        d = report.to_json_dict()
        assert d["slo_attainment"] == report.slo_attainment
        assert len(d["ticks"]) == 6
        assert json.dumps(d)

        events = read_events(path)
        names = {e["event"] for e in events}
        assert "replay_tick" in names
        assert "plan_request" in names
        assert validate_events(events) == []

    def test_cluster_delta_during_replay_replans_cached_query(
            self, parity_inputs):
        cluster, store, model = parity_inputs
        service = PlanService(cluster, store)
        wl = _parity_workload()
        cold = service.plan_query(model, _parity_config(), top_k=3,
                                  workload=wl)
        out = service.apply_cluster_delta({"T4": 4}, replan=True)
        assert out["replanning"] is True
        pushes: list[dict] = []
        deadline = time.monotonic() + 30.0
        while not pushes and time.monotonic() < deadline:
            notes = service.notifications(since=0, timeout_s=1.0)
            pushes = [n for n in notes if n["kind"] == "replan_push"]
        assert len(pushes) == 1
        assert pushes[0]["reason"] == "cluster_delta"
        assert pushes[0]["query_fingerprint"] != cold["fingerprint"]
        out = service.apply_cluster_delta(added={"T4": 4}, replan=True)
        assert out["devices"] == 16


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------


def test_curve_and_forecast_equal_the_reference():
    assert tinference.diurnal_rate is treplay.diurnal_rate
    assert tinference.replay_traffic is treplay.replay_traffic
    for ticks in (6, 24):
        for t in range(2 * ticks):
            assert treplay.diurnal_rate(t, ticks, 4.0, 40.0) == \
                jreplay.diurnal_rate(t, ticks, 4.0, 40.0)
    history = [4.0, 9.0, 22.0, 31.0, 40.0, 33.0, 18.0]
    for n in range(len(history) + 1):
        for window, horizon in ((4, 2), (3, 1), (6, 3)):
            assert treplay.forecast_rate(history[:n], window, horizon) == \
                jreplay.forecast_rate(history[:n], window, horizon)


def _report(pkg: str, parity_dir: Path, policy: str) -> dict:
    """``replay_traffic`` of ``pkg`` against ``pkg``'s daemon, one cycle
    of 6 ticks; the report's JSON."""
    if pkg == "jax":
        import metis_tpu.cluster.spec as jcluster
        import metis_tpu.profiles.store as jstore

        cluster = jcluster.ClusterSpec.from_files(
            parity_dir / "hostfile", parity_dir / "clusterfile.json")
        service = jdaemon.PlanService(
            cluster, jstore.ProfileStore.from_dir(parity_dir / "profiles"))
        serve, client_cls, run = (jdaemon.serve_in_thread,
                                  jclient.PlanServiceClient,
                                  jreplay.replay_traffic)
        model, config = ref_model(tiny_test_model()), ref_config(
            _parity_config())
        wl = jworkload.InferenceWorkload(**PARITY_INFERENCE)
    else:
        cluster = ClusterSpec.from_files(parity_dir / "hostfile",
                                         parity_dir / "clusterfile.json")
        service = PlanService(
            cluster, ProfileStore.from_dir(parity_dir / "profiles"))
        serve, client_cls, run = (serve_in_thread, PlanServiceClient,
                                  treplay.replay_traffic)
        model, config, wl = tiny_test_model(), _parity_config(), \
            _parity_workload()
    server, thread, address = serve(service)
    try:
        report = run(client_cls(address), cluster, model, config, wl,
                     base_rps=4.0, peak_rps=40.0, ticks_per_cycle=6,
                     cycles=1, policy=policy)
    finally:
        server.shutdown()
        thread.join(10)
        server.server_close()
    return report.to_json_dict()


@pytest.mark.parametrize("policy", ["hysteresis", "predictive"])
def test_replay_reports_equal_the_reference(parity_dir, policy):
    want = _report("jax", parity_dir, policy)
    got = _report("port", parity_dir, policy)
    assert got["replan_pushes"] >= 1 and want["replan_pushes"] >= 1
    assert {k: v for k, v in got.items() if k != "replan_pushes"} == \
        {k: v for k, v in want.items() if k != "replan_pushes"}


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def _replay_argv(parity_dir: Path, *extra) -> list[str]:
    return ["replay", "--hostfile", str(parity_dir / "hostfile"),
            "--clusterfile", str(parity_dir / "clusterfile.json"),
            "--profile-dir", str(parity_dir / "profiles"),
            "--model-name", "gpt-test", "--model-size", "1.5B",
            "--gbs", str(PARITY_GBS), "--max-tp", str(PARITY_MAX_TP),
            "--max-bs", str(PARITY_MAX_BS), "--top-k", "5",
            "--arrival-rate", "4", "--prompt-len", "512",
            "--output-len", "128", "--slo-ttft", "2000", "--slo-tpot", "100",
            "--base-rps", "4", "--peak-rps", "40", "--ticks-per-cycle", "6",
            "--cycles", "1", *extra]


def _summary(text: str) -> dict:
    report = json.loads(text)
    report.pop("replan_pushes")
    return report


def test_replay_cli_prints_the_reference_report(parity_dir):
    """In-process (the subcommand boots a daemon of its own) and with
    ``--remote`` against a running port daemon: the reference CLI's
    report and exit code."""
    jrc, jout, jerr = _run(jcli.main, _replay_argv(parity_dir))
    trc, tout, terr = _run(tcli.main, _replay_argv(parity_dir))
    assert trc == jrc == 0
    assert _summary(tout) == _summary(jout)
    assert terr.split(", devices")[0] == jerr.split(", devices")[0]
    assert terr.split(", devices")[1].split("), ")[0] == \
        jerr.split(", devices")[1].split("), ")[0]

    service = PlanService(
        ClusterSpec.from_files(parity_dir / "hostfile",
                               parity_dir / "clusterfile.json"),
        ProfileStore.from_dir(parity_dir / "profiles"))
    server, thread, address = serve_in_thread(service)
    try:
        rrc, rout, _ = _run(tcli.main, _replay_argv(parity_dir, "--remote",
                                                     address))
    finally:
        server.shutdown()
        thread.join(10)
        server.server_close()
    assert rrc == 0
    assert _summary(rout) == _summary(tout)


def test_replay_cli_refuses_a_bad_policy_as_the_reference(parity_dir):
    argv = _replay_argv(parity_dir, "--policy", "psychic")
    codes = []
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit) as e, \
                contextlib.redirect_stderr(io.StringIO()):
            main(argv)
        codes.append(e.value.code)
    assert codes[0] == codes[1] == 2
    assert dataclasses.is_dataclass(treplay.ReplayReport)
