"""The port's ``report`` and ``accuracy`` subcommands against the reference
CLI's (``metis_tpu/planner/cli.py``'s ``_cmd_report`` and
``_cmd_accuracy``) on the same files: an event log of the port's planner
(plain, with ``--top`` and ``--json``), a rotated one, trace-filtered logs
and missing files; an accuracy ledger written by the port's ``train
--ledger`` and one with component-attributed, per-device and per-stage
samples of several plans.  Standard output, the ``--json`` payloads and
the exit codes are held equal byte for byte (mirroring the reference's
``tests/test_cli.py`` accuracy and report cases, ``tests/test_trace.py``'s
report round trip and ``tests/test_provenance.py``'s rotated-log
regression)."""
import json

import pytest
import torch

from metis_tpu.planner.cli import main as ref_main
from metis_tpu_torch.cli import main as port_main
from metis_tpu_torch.core.events import EventLog, read_events, read_events_rotated
from metis_tpu_torch.core.trace import Tracer
from metis_tpu_torch.obs.ledger import AccuracyLedger

torch.set_num_threads(1)

MODEL_ARGS = [
    "--model-name", "cli-test", "--num-layers", "4", "--hidden-size", "32",
    "--seq-len", "16", "--vocab-size", "64", "--num-heads", "2",
]


def _both(capsys, argv):
    """``(rc, stdout)`` of the reference's CLI and of the port's."""
    out = []
    for main in (ref_main, port_main):
        capsys.readouterr()
        rc = main(list(argv))
        out.append((rc, capsys.readouterr().out))
    return out


def _same(capsys, argv, rc=0):
    (ref_rc, ref_out), (port_rc, port_out) = _both(capsys, argv)
    assert (port_rc, ref_rc) == (rc, rc)
    assert port_out == ref_out
    return port_out


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    """Synthetic A100 profiles of the test model and a one-card cluster
    (as ``tests/test_torch_train_cli.py``), the port's ``hetero --events``
    log, and the port's ``train --ledger`` ledger of 4 steps."""
    from metis_tpu.core.config import ModelSpec
    from metis_tpu.profiles import synthesize_profiles

    tmp = tmp_path_factory.mktemp("report_accuracy")
    model = ModelSpec(name="cli-test", num_layers=4, hidden_size=32,
                      sequence_length=16, vocab_size=64, num_heads=2)
    synthesize_profiles(model, ["A100"], tps=[1, 2],
                        bss=[1, 2, 4, 8]).dump_to_dir(tmp / "profiles")
    (tmp / "hostfile").write_text("10.0.0.1 slots=1\n")
    (tmp / "cluster.json").write_text(json.dumps({
        "10.0.0.1": {"instance_type": "A100", "inter_bandwidth": 10,
                     "intra_bandwidth": 46, "memory": 80}}))
    common = ["--hostfile", str(tmp / "hostfile"),
              "--clusterfile", str(tmp / "cluster.json"),
              "--profile-dir", str(tmp / "profiles"), *MODEL_ARGS,
              "--gbs", "8", "--max-bs", "8"]
    assert port_main(["hetero", *common, "--top-k", "2",
                      "--events", str(tmp / "plan_events.jsonl"),
                      "--output", str(tmp / "plans.json")]) == 0
    assert port_main(["train", *common, "--device", "cpu", "--steps", "4",
                      "--ledger", str(tmp / "train_ledger.jsonl"),
                      "--events", str(tmp / "train_events.jsonl"),
                      "--output", str(tmp / "summary.json")]) == 0
    return tmp


# -- report ------------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--json"], ["--top", "1"],
                                   ["--top", "2", "--json"]],
                         ids=["table", "json", "top1", "top2_json"])
def test_report_of_planner_events_equals_reference(fixture_dir, capsys, flags):
    out = _same(capsys, ["report", str(fixture_dir / "plan_events.jsonl"),
                         *flags])
    if "--json" in flags:
        assert json.loads(out)["spans"][0]["name"] == "plan_hetero"
    else:
        assert "plan_hetero" in out


def test_report_of_train_events_has_step_spans(fixture_dir, capsys):
    """The train loop's log: its step spans and counters, rendered as the
    reference renders them."""
    out = json.loads(_same(capsys, ["report",
                                    str(fixture_dir / "train_events.jsonl"),
                                    "--json"]))
    assert out["spans"]


def test_report_output_file_equals_reference(fixture_dir, tmp_path):
    ref, port = tmp_path / "ref.txt", tmp_path / "port.txt"
    ev = str(fixture_dir / "plan_events.jsonl")
    assert ref_main(["report", ev, "--output", str(ref)]) == 0
    assert port_main(["report", ev, "--output", str(port)]) == 0
    assert port.read_bytes() == ref.read_bytes()


def _sample_events(tracer: Tracer) -> None:
    with tracer.span("root", mode="test"):
        with tracer.span("setup"):
            pass
        acc = tracer.accum("work")
        for _ in range(3):
            with acc:
                pass
        acc.close()
    tracer.inc("costed", 7)
    tracer.emit_counters(scope="root")


def test_report_round_trip_as_reference(tmp_path, capsys):
    """The reference's ``test_cli_report_round_trip``: a root span with a
    child, an accumulated span and a counter."""
    ev = tmp_path / "ev.jsonl"
    with EventLog(ev) as events:
        _sample_events(Tracer(events))
    text = _same(capsys, ["report", str(ev)])
    assert "root" in text and "costed = 7" in text
    parsed = json.loads(_same(capsys, ["report", str(ev), "--json"]))
    assert parsed["spans"][0]["name"] == "root"
    assert parsed["counters"]["root"]["costed"] == 7


def test_report_reads_rotated_log_as_reference(tmp_path, capsys):
    """A log rolled once to ``<name>.1`` (the port's ``EventLog``
    ``max_bytes``): both CLIs read the roll first, so the rolled half's
    spans reach the report."""
    def write_spans(events):
        tracer = Tracer(events)
        for i in range(12):
            with tracer.span(f"step_{i:02d}"):
                with tracer.span("inner"):
                    pass

    probe = tmp_path / "probe.jsonl"
    with EventLog(probe) as events:
        write_spans(events)
    path = tmp_path / "ev.jsonl"
    with EventLog(path, max_bytes=int(probe.stat().st_size * 0.6)) as events:
        write_spans(events)
    assert (tmp_path / "ev.jsonl.1").exists()
    merged = read_events_rotated(path)
    assert len([e for e in merged if e["event"] == "event_log_rotated"]) == 1
    assert len(read_events(path)) < len(merged)
    payload = json.loads(_same(capsys, ["report", str(path), "--json"]))
    assert "step_00" in {s["name"] for s in payload["spans"]}
    _same(capsys, ["report", str(path)])


def test_report_trace_filter_as_reference(tmp_path, capsys):
    """``--trace ID`` keeps one trace's events; an ID no event carries
    exits 1 with nothing printed."""
    lines = []
    for trace in ("t-1", "t-2"):
        for name, kind, ts in (("request", "span_start", 1.0),
                               ("request", "span_end", 2.5)):
            rec = {"event": kind, "ts": ts, "name": name, "trace_id": trace,
                   "span_id": f"{trace}-0"}
            if kind == "span_end":
                rec["dur_ms"] = 1500.0 if trace == "t-1" else 700.0
            lines.append(json.dumps(rec))
    ev = tmp_path / "traced.jsonl"
    ev.write_text("\n".join(lines) + "\n")
    _same(capsys, ["report", str(ev), "--trace", "t-1", "--json"])
    _same(capsys, ["report", str(ev), "--trace", "t-2"])
    assert _same(capsys, ["report", str(ev), "--trace", "nope"], rc=1) == ""


def test_report_without_spans_as_reference(tmp_path, capsys):
    ev = tmp_path / "plain.jsonl"
    ev.write_text(json.dumps({"event": "search_started", "ts": 1.0}) + "\n")
    _same(capsys, ["report", str(ev)])
    _same(capsys, ["report", str(ev), "--json"])


def test_report_missing_file_exits_1(tmp_path, capsys):
    assert _same(capsys, ["report", str(tmp_path / "nope.jsonl")], rc=1) == ""


# -- accuracy ------------------------------------------------------------------

@pytest.fixture(scope="module")
def rich_ledger(tmp_path_factory):
    """Two plans, components (one absent from a sample), device types,
    stage times, an unmatched measurement and a drift excursion."""
    path = tmp_path_factory.mktemp("ledger") / "rich.jsonl"
    with AccuracyLedger(path) as led:
        led.record_prediction("fpA", 10.0,
                              components={"compute": 6.0, "optimizer": 4.0},
                              stage_ms=(6.0, 4.0), device_type="A100",
                              model="m", schedule="gpipe")
        led.record_prediction("fpB", 20.0, components={"compute": 20.0},
                              device_type="T4")
        for step, ms in enumerate((10.5, 11.0, 14.0, 15.0, 16.0, 9.0)):
            led.record_measurement(
                "fpA", ms, step=step, device_type="A100",
                stage_ms=(ms * 0.6, ms * 0.4),
                components=({"compute": ms - 4.0, "optimizer": 4.0}
                            if step % 2 else None))
        led.record_measurement("fpB", 18.0, step=0, device_type="T4",
                               source="validate")
        led.record_measurement("fpC", 5.0, step=0)  # no prediction
    return path


LEDGER_FLAGS = {
    "text": [],
    "json": ["--json"],
    "components": ["--components"],
    "components_json": ["--components", "--json"],
    "by_device": ["--by-device"],
    "by_device_json": ["--by-device", "--json"],
    "fingerprint": ["--fingerprint", "fpA", "--top", "2"],
    "fingerprint_json": ["--fingerprint", "fpB", "--json"],
    "band": ["--band", "5"],
    "band_json": ["--band", "5", "--json"],
    "unknown_fingerprint": ["--fingerprint", "nope"],
}


@pytest.mark.parametrize("case", LEDGER_FLAGS)
def test_accuracy_equals_reference(rich_ledger, capsys, case):
    out = _same(capsys, ["accuracy", str(rich_ledger), *LEDGER_FLAGS[case]])
    if case == "json":
        payload = json.loads(out)
        assert payload["n_matched"] == 7 and payload["drift"]["band_pct"] == 20.0


@pytest.mark.parametrize("flags", [[], ["--json"], ["--components"]],
                         ids=["text", "json", "components"])
def test_accuracy_of_train_ledger_equals_reference(fixture_dir, capsys, flags):
    """The port's ``train --ledger`` (the reference's
    ``test_train_ledger_and_accuracy_subcommand``): 4 steps, the first
    (the warm-up) unmeasured, read back by both CLIs."""
    out = _same(capsys, ["accuracy", str(fixture_dir / "train_ledger.jsonl"),
                         *flags])
    if flags == ["--json"]:
        payload = json.loads(out)
        assert payload["n_samples"] == 3 and payload["n_matched"] == 3
    elif not flags:
        assert "samples" in out and "MAPE" in out and "drift:" in out


def test_accuracy_output_file_equals_reference(rich_ledger, tmp_path):
    ref, port = tmp_path / "ref.json", tmp_path / "port.json"
    assert ref_main(["accuracy", str(rich_ledger), "--json",
                     "--output", str(ref)]) == 0
    assert port_main(["accuracy", str(rich_ledger), "--json",
                      "--output", str(port)]) == 0
    assert port.read_bytes() == ref.read_bytes()


def test_accuracy_missing_ledger_exits_1(tmp_path, capsys):
    assert _same(capsys, ["accuracy", str(tmp_path / "nope.jsonl")],
                 rc=1) == ""
