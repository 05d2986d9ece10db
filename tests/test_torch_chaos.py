"""The port's supervisor against the JAX package's in the scenarios of the
canned chaos drill, the anomaly guards and the recovery budget (the device
loss and spot scenarios are in ``tests/test_torch_supervisor.py``, with
the same comparisons: ``tests/torch_supervisor_reference.py``); then the
port's command line: ``chaos`` end to end on four gloo ranks, its report
the reference's, and ``train --resilient`` on two gloo ranks drained by a
real SIGTERM to the command's process, then resumed to the end with the
losses of an uninterrupted run bit for bit."""
import json
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import torch_supervisor_reference as sref

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SCENARIOS = {
    # the reference's canned drill: the step-2 checkpoint write fails twice
    # (retried), then the last node drops at step 5
    "canned": ("checkpoint_write@2x2,device_loss@5",
               dict(checkpoint_every=2, retry_attempts=3)),
    # a NaN loss at step 5: rollback to the step-4 checkpoint, in place
    "loss_nan": ("loss_nan@5", dict(checkpoint_every=2)),
    # a spike at step 5: reported, survived
    "loss_spike": ("loss_spike@5", dict(checkpoint_every=2)),
    # the spot return at step 5 would be the second recovery of one allowed
    "max_recoveries": ("spot_preemption@3,spot_return@5",
                       dict(checkpoint_every=2, max_recoveries=1)),
}
NAMES = sorted(SCENARIOS)
MODEL_ARGS = ["--model-name", "gpt-drill", "--num-layers", "4", "--hidden-size", "32",
              "--seq-len", "16", "--vocab-size", "128", "--num-heads", "2",
              "--gbs", "8", "--max-tp", "2", "--max-bs", "8"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("chaos")


@pytest.fixture(scope="module")
def runs(root):
    return sref.run_scenarios(root, SCENARIOS)


@pytest.mark.parametrize("name", NAMES)
def test_report_matches_reference(runs, name):
    sref.check_report(*runs[name])


@pytest.mark.parametrize("name", NAMES)
def test_losses_match_reference(runs, name):
    sref.check_losses(*runs[name])


@pytest.mark.parametrize("name", NAMES)
def test_plans_match_reference(runs, name):
    sref.check_plans(*runs[name])


@pytest.mark.parametrize("name", NAMES)
def test_resilience_event_order_matches_reference(runs, name):
    sref.check_event_order(*runs[name])


@pytest.mark.parametrize("name", NAMES)
def test_every_rank_reports_the_same(runs, name):
    sref.check_ranks_agree(runs[name][1])


@pytest.mark.parametrize("name", NAMES)
def test_events_schema_clean(runs, name):
    sref.check_schema(runs[name][1])


def test_scenario_outcomes(runs):
    rep = {name: port["ranks"][0]["report"] for name, (_, port) in runs.items()}
    assert rep["canned"]["outcome"] == "completed" and rep["canned"]["retries"] >= 2
    names = sref.resilience_names(runs["canned"][1]["events"])
    assert names.index("fault_injected") < names.index("retry_attempt") \
        < names.index("recovery_complete")
    (nan,) = rep["loss_nan"]["recoveries"]
    assert nan["kind"] == "anomaly_rollback" and nan["step"] == 5
    assert nan["resumed_step"] == 4 and rep["loss_nan"]["outcome"] == "completed"
    assert "anomaly_detected" in sref.resilience_names(runs["loss_spike"][1]["events"])
    assert rep["loss_spike"]["recoveries"] == []
    assert rep["max_recoveries"]["outcome"] == "failed"
    assert "max_recoveries=1" in rep["max_recoveries"]["detail"]


def _cluster_files(root: Path, nodes: int, per_node: int) -> list[str]:
    """Hostfile and clusterfile of ``nodes`` A100 nodes at the registry's
    A100 figures (``ClusterSpec.of``'s)."""
    ips = [f"10.0.0.{i + 1}" for i in range(nodes)]
    host = root / f"hostfile_{nodes}x{per_node}"
    host.write_text("".join(f"{ip} slots={per_node}\n" for ip in ips))
    cfile = root / f"cluster_{nodes}x{per_node}.json"
    cfile.write_text(json.dumps({ip: {"instance_type": "A100", "memory": 80,
                                      "intra_bandwidth": 50, "inter_bandwidth": 10}
                                 for ip in ips}))
    return ["--hostfile", str(host), "--clusterfile", str(cfile),
            "--profile-dir", str(root / "profiles"), *MODEL_ARGS, "--device", "cpu"]


def _cli(args: list[str]) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", "metis_tpu_torch", *args],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_chaos_cli_end_to_end(runs, root):
    """``chaos`` with the canned script on four gloo ranks: the reference's
    report (its own seed-0 weights, so the final loss is not compared)."""
    ckpt = root / "cli_chaos_ckpt"
    proc = _cli(["chaos", *_cluster_files(root, 2, 2), "--devices", "cpu,cpu,cpu,cpu",
                 "--fault-script", "checkpoint_write@2x2,device_loss@5",
                 "--checkpoint-dir", str(ckpt), "--retry-attempts", "3"])
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err
    got, want = json.loads(out), dict(runs["canned"][0]["report"])
    for rep in (got, want):
        rep.pop("final_loss")
        rep["recoveries"] = [{k: v for k, v in r.items() if k != "recover_s"}
                             for r in rep["recoveries"]]
    assert got == want
    assert "supervised run completed: 8/8 steps, 1 recoveries, 2 retries" in err


def _train_steps(events: Path) -> list[dict]:
    if not events.exists():
        return []
    return [e for e in map(json.loads, events.read_text().splitlines())
            if e["event"] == "train_step"]


def test_train_resilient_drains_on_sigterm_and_resumes(runs, root):
    """A real SIGTERM to ``train --resilient`` on two gloo ranks, once its
    second step is logged: both ranks drain at the same step (a final
    checkpoint of that step, outcome ``preempted``, exit 0); the same
    command then completes from the checkpoint with the losses of an
    uninterrupted run, bit for bit."""
    from metis_tpu_torch.execution.checkpoint import load_meta

    steps = 40
    base = ["train", "--resilient", *_cluster_files(root, 1, 2), "--devices", "cpu,cpu",
            "--steps", str(steps)]

    def run(name, stop=False):
        events = root / f"{name}.jsonl"
        proc = _cli([*base, "--checkpoint-dir", str(root / name), "--events", str(events)])
        if stop:
            deadline = time.monotonic() + 120
            while len(_train_steps(events)) < 2 and proc.poll() is None:
                assert time.monotonic() < deadline, "no second train_step event"
                time.sleep(0.01)
            proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        return json.loads(out), err, events

    report, err, events = run("sigterm", stop=True)
    assert report["outcome"] == "preempted" and report["detail"] == "sigterm", err
    done = report["steps_done"]
    assert 2 <= done < steps
    assert load_meta(root / "sigterm").step == done
    drains = [e for e in map(json.loads, events.read_text().splitlines())
              if e["event"] == "preempt_drain"]
    assert [d["step"] for d in drains] == [done]

    resumed, _, _ = run("sigterm")
    assert resumed["outcome"] == "completed" and resumed["steps_done"] == steps
    straight, _, straight_events = run("straight")
    want = {e["step"]: e["loss"] for e in _train_steps(straight_events)}
    got = {e["step"]: e["loss"] for e in _train_steps(events)}
    assert sorted(got) == list(range(1, steps + 1)) and got == want
    assert resumed["final_loss"] == straight["final_loss"]
