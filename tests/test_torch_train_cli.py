"""The port's ``train`` subcommand (``python -m metis_tpu_torch train``) on
the CPU (``--device cpu``): the reference's ``tests/test_cli.py`` cases of
its ``train`` (end to end with resume; refusing a block-layout mismatch on
resume), resume held bit for bit against a straight run on one device and
on gloo ranks (a pinned dp 2 plan at ZeRO 1, and a pinned two-stage hetero
plan), ``--ledger``, ``--replan-on-resume`` (the reference's elastic
resume onto fewer devices, and its refusal across route families), the
resilience flags (``--resilient`` and its knobs, run or refused as the
reference does), and the flags of later ROADMAP items, which exit 2
naming their item."""
import json

import pytest
import torch

from metis_tpu_torch.cli import LATER_TRAIN_FLAGS, main
from metis_tpu_torch.execution.checkpoint import CheckpointMeta, load_meta
from metis_tpu_torch.execution.mesh import PlanArtifact

torch.set_num_threads(1)

MODEL_ARGS = [
    "--model-name", "cli-test", "--num-layers", "4", "--hidden-size", "32",
    "--seq-len", "16", "--vocab-size", "64", "--num-heads", "2",
]


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    """Synthetic A100 profiles of the test model (the JAX package's
    synthesizer) and a one-card cluster: the planner's best plan runs on one
    device."""
    from metis_tpu.core.config import ModelSpec
    from metis_tpu.profiles import synthesize_profiles

    tmp = tmp_path_factory.mktemp("train_cli")
    model = ModelSpec(name="cli-test", num_layers=4, hidden_size=32,
                      sequence_length=16, vocab_size=64, num_heads=2)
    synthesize_profiles(model, ["A100"], tps=[1, 2],
                        bss=[1, 2, 4, 8]).dump_to_dir(tmp / "profiles")
    (tmp / "hostfile").write_text("10.0.0.1 slots=1\n")
    (tmp / "cluster.json").write_text(json.dumps({
        "10.0.0.1": {"instance_type": "A100", "inter_bandwidth": 10,
                     "intra_bandwidth": 46, "memory": 80}}))
    return tmp


def _base(fixture_dir, ckpt, out, *extra):
    return ["train", "--hostfile", str(fixture_dir / "hostfile"),
            "--clusterfile", str(fixture_dir / "cluster.json"),
            "--profile-dir", str(fixture_dir / "profiles"),
            *MODEL_ARGS, "--gbs", "8", "--max-bs", "8", "--device", "cpu",
            "--checkpoint-dir", str(ckpt), "--output", str(out), *extra]


def _summary(path):
    return json.loads(path.read_text())


def test_train_subcommand_end_to_end(fixture_dir, tmp_path):
    """plan -> executable -> pipeline -> train loop -> checkpoint, then a
    second invocation resumes on the pinned plan from the saved step; 3 + 2
    steps equal 5 straight steps bit for bit (the last loss and every
    leaf's digest)."""
    out, ckpt = tmp_path / "summary.json", tmp_path / "ckpt"
    assert main([*_base(fixture_dir, ckpt, out), "--steps", "3",
                 "--checkpoint-every", "2"]) == 0
    summary = _summary(out)
    assert summary["steps"] == 3 and summary["executable"] == "single_device"
    assert summary["final_loss"] is not None and summary["tokens_per_s"] > 0
    assert summary["plan_cost_ms"] > 0
    assert load_meta(ckpt).step == 3
    assert main([*_base(fixture_dir, ckpt, out), "--steps", "2"]) == 0
    resumed = _summary(out)
    assert resumed["plan_cost_ms"] is None  # the pinned plan, no search
    assert load_meta(ckpt).step == 5

    straight = tmp_path / "straight"
    assert main([*_base(fixture_dir, straight, out), "--steps", "5"]) == 0
    assert _summary(out)["final_loss"] == resumed["final_loss"]
    assert load_meta(straight).digests == load_meta(ckpt).digests
    assert set(_summary(out)) == {
        "executable", "plan_cost_ms", "steps", "first_loss", "final_loss",
        "mean_step_ms", "tokens_per_s", "checkpoint"}


def test_train_refuses_layout_mismatch_resume(fixture_dir, tmp_path):
    """A checkpoint written under one block layout must not resume under
    another (the interleaved schedule permutes the physical block order)."""
    ckpt, out = tmp_path / "ckpt", tmp_path / "out.json"
    assert main([*_base(fixture_dir, ckpt, out), "--steps", "1"]) == 0
    meta = load_meta(ckpt)
    (ckpt / "meta.json").write_text(CheckpointMeta(
        step=meta.step, mesh_axes=meta.mesh_axes, mesh_shape=meta.mesh_shape,
        block_layout="interleaved:2x2").to_json())
    assert main([*_base(fixture_dir, ckpt, out), "--steps", "1"]) == 1


def test_train_ledger_records_prediction_and_steps(fixture_dir, tmp_path):
    """``--ledger``: the chosen plan's prediction once, then every synced
    step after the first; the summary carries the accuracy block."""
    from metis_tpu_torch.obs.ledger import AccuracyLedger

    out, ledger = tmp_path / "out.json", tmp_path / "ledger.jsonl"
    assert main([*_base(fixture_dir, tmp_path / "ckpt", out), "--steps", "4",
                 "--ledger", str(ledger)]) == 0
    acc = _summary(out)["accuracy"]
    assert acc["n"] == 3 and acc["ledger"] == str(ledger)
    led = AccuracyLedger(ledger)
    assert acc["fingerprint"] in led.predictions
    led.close()


@pytest.mark.parametrize("flag,dest,item", LATER_TRAIN_FLAGS,
                         ids=[f for f, _, _ in LATER_TRAIN_FLAGS])
def test_later_flags_exit_2_naming_their_item(fixture_dir, tmp_path, capsys,
                                              flag, dest, item):
    rc = main([*_base(fixture_dir, tmp_path / "ckpt", tmp_path / "o.json"),
               flag, "1"])
    assert rc == 2
    assert item.split()[0] in capsys.readouterr().err
    assert not (tmp_path / "ckpt").exists()


RESILIENT_CASES = {
    # the reference's refusals: no checkpoint to recover from; a
    # multi-controller run (whose flags name their later item first)
    "without_checkpoint_dir": (["--resilient"], None, 2, "requires --checkpoint-dir"),
    "with_coordinator": (["--resilient", "--coordinator", "h:1"], "ckpt", 2, "§A.7"),
    # the flags now run: a supervised run to the end, and one whose
    # script fails a checkpoint write once (retried) and injects a loss
    # spike, with the retry budget and spike factor set
    "runs": (["--resilient"], "ckpt", 0, "supervised run completed: 3/3 steps"),
    "fault_script_retry_spike": (
        ["--resilient", "--fault-script", "loss_spike@2,checkpoint_write@1",
         "--retry-attempts", "2", "--spike-factor", "5"], "ckpt", 0,
        "supervised run completed: 3/3 steps, 0 recoveries, 1 retries"),
}


@pytest.mark.parametrize("case", RESILIENT_CASES)
def test_resilience_flags_run_or_refuse_as_the_reference(fixture_dir, tmp_path,
                                                         capsys, case):
    """``--resilient``, ``--fault-script``, ``--retry-attempts`` and
    ``--spike-factor`` (the reference's ``_run_supervisor`` and its
    refusals, ``metis_tpu/planner/cli.py:2038-2050``)."""
    extra, ckpt, want_rc, said = RESILIENT_CASES[case]
    out = tmp_path / "o.json"
    args = _base(fixture_dir, tmp_path / "ckpt", out, "--steps", "3", *extra)
    if ckpt is None:
        i = args.index("--checkpoint-dir")
        del args[i:i + 2]
    assert main(args) == want_rc
    assert said in capsys.readouterr().err
    if want_rc == 0:
        report = json.loads(out.read_text())
        assert report["outcome"] == "completed" and report["steps_done"] == 3
        assert load_meta(tmp_path / "ckpt").step == 3
    else:
        assert not (tmp_path / "ckpt").exists()


PINNED = {
    "dp2_zero1": PlanArtifact(
        mesh_axes=("pp", "dp", "ep", "sp", "tp"), mesh_shape=(1, 2, 1, 1, 1),
        layer_partition=(0, 4),
        strategies=({"dp": 2, "tp": 1, "cp": 1, "ep": 1, "zero": 1, "sp": False},),
        gbs=8, microbatches=1),
    "hetero_two_stage": PlanArtifact(
        mesh_axes=(), mesh_shape=(), layer_partition=(0, 2, 4),
        strategies=({"dp": 1, "tp": 1}, {"dp": 1, "tp": 1}), gbs=8,
        microbatches=2),
}


@pytest.mark.parametrize("name", PINNED)
def test_gloo_ranks_resume_bit_for_bit(fixture_dir, tmp_path, name):
    """A pinned plan of two devices on two gloo ranks (``--devices
    cpu,cpu``): 2 steps with a checkpoint, 2 more resumed, equal 4 straight
    steps bit for bit, every rank's leaves' digests included; the hetero
    plan checkpoints through ``save_hetero_checkpoint``."""
    art = PINNED[name]
    runs = {}
    for run in ("resumed", "straight"):
        ckpt = tmp_path / run
        ckpt.mkdir()
        (ckpt / "plan.json").write_text(art.to_json())
        runs[run] = ckpt
    out = tmp_path / "out.json"
    ranks = ["--devices", "cpu,cpu"]
    assert main([*_base(fixture_dir, runs["resumed"], out), *ranks, "--steps", "2",
                 "--checkpoint-every", "1"]) == 0
    first = _summary(out)
    assert first["executable"] == ("hetero" if art.layer_partition[1:-1] else "gspmd")
    assert main([*_base(fixture_dir, runs["resumed"], out), *ranks,
                 "--steps", "2"]) == 0
    resumed = _summary(out)
    assert main([*_base(fixture_dir, runs["straight"], out), *ranks,
                 "--steps", "4"]) == 0
    straight = _summary(out)
    assert resumed["final_loss"] == straight["final_loss"]
    got, want = load_meta(runs["resumed"]), load_meta(runs["straight"])
    assert got.step == want.step == 4
    assert got.digests == want.digests
    assert {k[:9] for k in got.digests} == {"rank00000", "rank00001"}
    if name == "hetero_two_stage":
        assert (got.mesh_axes, got.mesh_shape) == (("stage",), (2,))


def _pinned(tmp_path, name, art):
    ckpt = tmp_path / name
    ckpt.mkdir()
    (ckpt / "plan.json").write_text(art.to_json())
    return ckpt


def test_train_replan_on_resume_elastic(fixture_dir, tmp_path, capsys):
    """Elastic recovery through the CLI, as the reference's
    ``test_train_replan_on_resume_elastic``: train a pinned dp 2 plan at
    ZeRO 1 on two gloo ranks, then resume with ``--replan-on-resume`` on
    the fixture's one-card cluster — a fresh search picks one device and
    the state is restored onto it through the checkpoint's slice maps.
    The resumed run starts at the saved step, continues the data stream
    (its losses are the dp 2 run's own continuation's, within the
    trajectory tolerance) and pins its new plan."""
    from metis_tpu_torch.execution.checkpoint import load_plan

    art = PINNED["dp2_zero1"]
    ckpt, straight = _pinned(tmp_path, "ckpt", art), _pinned(tmp_path, "straight", art)
    out = tmp_path / "out.json"
    ranks = ["--devices", "cpu,cpu"]
    assert main([*_base(fixture_dir, ckpt, out), *ranks, "--steps", "2"]) == 0
    assert main([*_base(fixture_dir, ckpt, out), "--steps", "2",
                 "--replan-on-resume"]) == 0
    resumed = _summary(out)
    err = capsys.readouterr().err
    assert "--replan-on-resume: ignoring the pinned plan" in err
    assert "resumed from" in err and "at step 2" in err
    assert resumed["executable"] == "single_device"
    assert resumed["plan_cost_ms"] > 0  # searched, not pinned
    assert load_meta(ckpt).step == 4
    assert load_plan(ckpt).num_devices == 1
    assert main([*_base(fixture_dir, straight, out), *ranks, "--steps", "4"]) == 0
    want = _summary(out)
    assert resumed["final_loss"] == pytest.approx(want["final_loss"], rel=1e-4,
                                                  abs=2e-5)


def test_train_replan_on_resume_refuses_another_route(fixture_dir, tmp_path,
                                                     capsys):
    """A two-stage hetero checkpoint does not restore onto the one-device
    plan the search picks (per-stage state against one tree): the
    reference's message, exit 1, the checkpoint left as it was."""
    ckpt = _pinned(tmp_path, "ckpt", PINNED["hetero_two_stage"])
    out = tmp_path / "out.json"
    assert main([*_base(fixture_dir, ckpt, out), "--devices", "cpu,cpu",
                 "--steps", "1"]) == 0
    before = load_meta(ckpt)
    capsys.readouterr()
    assert main([*_base(fixture_dir, ckpt, out), "--steps", "1",
                 "--replan-on-resume"]) == 1
    assert "state structure does not fit the re-planned single_device" in \
        capsys.readouterr().err
    assert load_meta(ckpt) == before
