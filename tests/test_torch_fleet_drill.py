"""The port's fleet drill (``metis_tpu_torch/resilience/fleet_drill.py``,
``chaos --fleet``) against the reference's (``tools/fleet_drill.py``).

Both drills run in this process on the same arguments: the port's over its
own plan daemon, scheduler and synthetic profiles, the reference's over the
JAX package's.  Their reports must be equal key for key (the drills keep no
wall-clock field; the counts of background replans, ``RACY``, depend on
thread timing in both), and so must the events the drills emit themselves,
times aside.  The sizes are the reference tests' (``tests/test_resilience.py``
``TestFleetDrill``, ``tests/test_provenance.py``'s rotation case, which
``tests/test_torch_provenance.py`` runs) and the defaults, whose headline
counts the reference's own run gives.  The fleet's TPU device specs, built
from scalars in the port, equal ``cluster/tpu.slice_from_name``'s; the CLI
prints the reference CLI's lines and report (``RACY`` aside).  The supervisor leg is in
``tests/test_torch_fleet_supervisor.py``."""
import dataclasses
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from metis_tpu.cluster.tpu import slice_from_name  # noqa: E402
from metis_tpu.planner.cli import main as ref_main  # noqa: E402
import metis_tpu_torch.resilience.fleet_drill as tdrill  # noqa: E402
from metis_tpu_torch.cli import main as port_main  # noqa: E402
from metis_tpu_torch.core.events import read_events_rotated  # noqa: E402
import tools.fleet_drill as jdrill  # noqa: E402

#: the events the drills emit themselves, in their own order; the daemon's
#: request and search events interleave with its background replans as
#: the threads run, in either package
DRILL_EVENTS = ("preemption", "spot_return", "fleet_tick", "recovery_cost",
                "reshard_plan", "reshard_step", "migration_complete",
                "migration_fallback", "tenant_admit", "tenant_preempt",
                "tenant_replan", "fleet_objective")


def _events(path: Path) -> list[dict]:
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in read_events_rotated(path) if e["event"] in DRILL_EVENTS]


#: report keys that count the daemon's background replans: the drill stops
#: draining notifications once every delta has pushed one, and whether a
#: later replan has landed by then is thread timing, in either package
RACY = ("replan_pushes", "provenance_chains_verified", "decision_records")


def _settled(report: dict) -> dict:
    return {k: v for k, v in report.items() if k not in RACY}


def _both(fn: str, tmp_path: Path, **kw) -> tuple[dict, dict]:
    ref = getattr(jdrill, fn)(tmp_path / "ref", **kw)
    port = getattr(tdrill, fn)(tmp_path / "port", **kw)
    for rep in (ref, port):
        if "replan_pushes" in rep:
            assert rep["provenance_chains_verified"] == rep["replan_pushes"] \
                >= rep["cluster_deltas"]
        assert rep["decision_records"] > 0
    return _settled(ref), _settled(port)


# -- device specs --------------------------------------------------------------

@pytest.mark.parametrize("chips", [2, 4, 8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("gen", ["v5e", "v6e"])
def test_slice_device_spec_equals_reference(gen, chips):
    want = slice_from_name(f"{gen}-{chips}").as_device_spec()
    got = tdrill.slice_device_spec(f"tpu_{gen}", chips)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_slice_device_specs_at_every_chip_count():
    for gen in ("v5e", "v6e"):
        for chips in range(2, 257):
            want = slice_from_name(f"{gen}-{chips}").as_device_spec()
            got = tdrill.slice_device_spec(f"tpu_{gen}", chips)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (gen, chips)


@pytest.mark.parametrize("devices, per_node, rate", [(256, 32, 0.05), (32, 4, 0.35),
                                                      (16, 2, 0.9)])
def test_fleet_cluster_equals_reference(devices, per_node, rate):
    want = jdrill.fleet_cluster(devices, per_node, rate)
    got = tdrill.fleet_cluster(devices, per_node, rate)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for fn in ("fleet_model", "tenant_model"):
        assert dataclasses.asdict(getattr(tdrill, fn)()) == \
            dataclasses.asdict(getattr(jdrill, fn)())
    assert dataclasses.asdict(tdrill.fleet_search_config(12.0)) == \
        dataclasses.asdict(jdrill.fleet_search_config(12.0))


def test_fleet_cluster_refuses_a_slice_that_does_not_split_into_nodes():
    with pytest.raises(Exception, match="not divisible"):
        jdrill.fleet_cluster(48, 32)
    with pytest.raises(Exception, match="not divisible"):
        tdrill.fleet_cluster(48, 32)


# -- the fleet and tenant drills -------------------------------------------------

FLEET_CASES = {
    "smoke": dict(ticks=12, seed=2, spot_rate_per_hr=0.15),
    "deterministic": dict(ticks=8, seed=7, spot_rate_per_hr=0.2),
    "no_migrate": dict(ticks=12, seed=2, spot_rate_per_hr=0.15, migrate=False),
}


@pytest.mark.parametrize("case", sorted(FLEET_CASES))
def test_fleet_drill_equals_reference(tmp_path, case):
    ref, port = _both("run_fleet_drill", tmp_path, **FLEET_CASES[case])
    assert port == ref
    assert port["preempted_nodes"] > 0
    assert port["trajectory"][-1]["devices"] == port["devices"]
    assert _events(tmp_path / "port" / "fleet_events.jsonl") == \
        _events(tmp_path / "ref" / "fleet_events.jsonl")


def test_fleet_drill_defaults_equal_reference(tmp_path):
    """The default run, seed 0, equals the reference's: 2 evictions, 2
    returns, goodput 0.8698, 2 live migrations, 1 fault-driven fallback."""
    ref, rep = _both("run_fleet_drill", tmp_path)
    assert rep == ref
    assert _events(tmp_path / "port" / "fleet_events.jsonl") == \
        _events(tmp_path / "ref" / "fleet_events.jsonl")
    assert (rep["devices"], rep["ticks"]) == (256, 24)
    assert (rep["preempted_nodes"], rep["returned_nodes"]) == (2, 2)
    assert f"{rep['fleet_goodput_frac']:.4f}" == "0.8698"
    assert (rep["migrations"], rep["migration_fallbacks"]) == (2, 1)


def test_fleet_drill_deterministic(tmp_path):
    """Same seed, same trajectory (``TestFleetDrill`` of the reference)."""
    reps = [tdrill.run_fleet_drill(tmp_path / str(i), ticks=8, seed=7,
                                   spot_rate_per_hr=0.2) for i in range(2)]
    assert reps[0]["trajectory"] == reps[1]["trajectory"]
    assert reps[0]["fleet_goodput_frac"] == reps[1]["fleet_goodput_frac"]


def test_tenant_drill_defaults_equal_reference(tmp_path):
    """The tenant drill at its defaults (3 tenants, 32 devices, 8 ticks):
    4 evictions, utilization 1.0000, minimum SLO attainment 1.0000."""
    ref, port = _both("run_tenant_drill", tmp_path, tenants=3)
    assert port == ref
    assert port["preempted_nodes"] == 4
    assert f"{port['fleet_utilization_frac']:.4f}" == "1.0000"
    assert f"{port['tenant_slo_attainment_min']:.4f}" == "1.0000"
    assert _events(tmp_path / "port" / "tenant_events.jsonl") == \
        _events(tmp_path / "ref" / "tenant_events.jsonl")


def test_drill_events_are_in_the_ports_schema_copy():
    """The port's schema copy is the reference checker's."""
    from metis_tpu_torch.obs import decisions_schema, events_schema
    import tools.check_decisions_schema as jdec
    import tools.check_events_schema as jev

    assert events_schema.EVENT_SCHEMA == jev.EVENT_SCHEMA
    assert events_schema.REQUEST_SCOPED_EVENTS == jev.REQUEST_SCOPED_EVENTS
    assert decisions_schema.RANKING_KINDS == jdec.RANKING_KINDS
    bad = [{"ts": 1.0, "event": "fleet_tick", "tick": 0},
           {"ts": "x", "event": "nope"}, {"event": 3}]
    assert events_schema.validate_events(bad) == jev.validate_events(bad)
    recs = [{"seq": 2, "ts": 0.0, "kind": "cold_search"},
            {"seq": 1, "ts": 0.0, "kind": "bogus", "parent_seq": 5}]
    assert decisions_schema.validate_decisions(recs) == jdec.validate_decisions(recs)


# -- the CLI ---------------------------------------------------------------------

CLI_CASES = {
    "fleet": ["--skip-supervisor", "--ticks", "8", "--seed", "7", "--spot-rate", "0.2"],
    "tenants": ["--tenants", "3", "--devices", "16", "--chips-per-node", "2",
                "--ticks", "3", "--spot-rate", "0.9", "--return-rate", "0.9"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_chaos_fleet_cli_equals_reference(tmp_path, capsys, case):
    outs = {}
    for side, main in (("ref", ref_main), ("port", port_main)):
        report = tmp_path / f"{side}.json"
        assert main(["chaos", "--fleet", *CLI_CASES[case], "--keep",
                     str(tmp_path / side), "--report", str(report)]) == 0
        out = capsys.readouterr().out
        reports = {k: v and _settled(v) for k, v in json.loads(report.read_text()).items()}
        outs[side] = ([line for line in out.splitlines()
                       if not any(f'"{k}"' in line for k in RACY)], reports)
    assert outs["port"] == outs["ref"]
    assert any("drill OK" in line for line in outs["port"][0])


def test_chaos_fleet_without_evictions_fails_as_reference(tmp_path, capsys):
    """``chaos --fleet --skip-supervisor --ticks 8`` at seed 0 draws no
    eviction: both drills refuse with the same assertion."""
    errs = []
    for main in (ref_main, port_main):
        with pytest.raises(AssertionError) as err:
            main(["chaos", "--fleet", "--skip-supervisor", "--ticks", "8"])
        errs.append(str(err.value))
    assert errs[0] == errs[1] and "no evictions" in errs[0]
    assert capsys.readouterr().out == ""


def test_tool_script_runs_the_drill(tmp_path):
    import subprocess

    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, str(root / "tools" / "torch_fleet_drill.py"),
         *CLI_CASES["fleet"]], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "fleet drill OK" in proc.stdout
