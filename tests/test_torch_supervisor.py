"""The port's fault-tolerant training supervisor
(``metis_tpu_torch/resilience/supervisor.py``) against the JAX package's,
on the reference's migration drill (``tools/chaos_drill.py``: 2 x 2 A100,
so four gloo ranks on the host), scenarios of device loss and spot
eviction (the others are in ``tests/test_torch_chaos.py``).

Each scenario runs once per side (``tests/torch_supervisor_reference.py``)
and is held to the reference: the report field by field (``recover_s``
aside), the losses within 1e-4 relative / 2e-5 absolute (fp32), the plan
artifact before and after each replan byte for byte, and the ordered names
of the resilience events.  Every rank's report equals rank 0's, and the
port's event stream is clean under ``tools/check_events_schema.py``.
"""
import pytest
import torch

import torch_supervisor_reference as sref

torch.set_num_threads(1)

SCENARIOS = {
    # a device loss absorbed by a live reshard: pp 2 x dp 2 -> pp 2 on the
    # first two ranks, no rollback
    "migrate": ("device_loss@4:A100=2", dict(checkpoint_every=2)),
    # the same switch with a digest fault: migration_fallback, then the
    # restore of the step-4 checkpoint onto the new plan
    "fallback": ("device_loss@4:A100=2,reshard_verify@4", dict(checkpoint_every=2)),
    # a spot eviction (the last node by default), then its return: the
    # ranks outside the shrunk plan come back into the grown one
    "spot": ("spot_preemption@3,spot_return@5", dict(checkpoint_every=2)),
    # a drain at step 3: a final checkpoint, outcome preempted
    "preempt": ("preempt@3", dict(checkpoint_every=2)),
}
NAMES = sorted(SCENARIOS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return sref.run_scenarios(tmp_path_factory.mktemp("supervisor"), SCENARIOS)


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
    """What each scenario must show, beside the equality with the
    reference."""
    rep = {name: port["ranks"][0]["report"] for name, (_, port) in runs.items()}
    (mig,) = rep["migrate"]["recoveries"]
    assert rep["migrate"]["outcome"] == "completed" and mig["migrated"]
    assert mig["kind"] == "device_loss" and mig["resumed_step"] == 4
    names = sref.resilience_names(runs["migrate"][1]["events"])
    assert names.index("reshard_plan") < names.index("reshard_step") \
        < names.index("migration_complete") < names.index("recovery_complete")
    (fb,) = rep["fallback"]["recoveries"]
    assert not fb["migrated"] and fb["resumed_step"] == 4
    assert "migration_fallback" in sref.resilience_names(runs["fallback"][1]["events"])
    kinds = [r["kind"] for r in rep["spot"]["recoveries"]]
    assert kinds == ["spot_preemption", "spot_return"]
    assert rep["spot"]["steps_done"] == sref.STEPS
    assert rep["preempt"]["outcome"] == "preempted"
    assert rep["preempt"]["steps_done"] == 3


def test_hetero_plan_on_the_first_ranks_of_a_larger_group():
    """After a shrink the supervisor's new plan runs on the process group's
    first ranks: a two-stage hetero plan on ranks 0-1 of three trains as
    on a group of two, and rank 2 holds no executable."""
    import numpy as np

    from metis_tpu_torch.execution import dist as tdist
    from metis_tpu_torch.execution.hetero import StageSpec
    from metis_tpu_torch.models.gpt import GPTConfig
    from metis_tpu_torch.testing import run_plans_rank

    cfg = GPTConfig(vocab_size=64, seq_len=16, hidden=32, num_heads=2, num_blocks=2,
                    dtype=torch.float32)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        b = torch.from_numpy(rng.integers(0, 64, (4, 17), dtype=np.int64))
        batches.append((b[:, :-1], b[:, 1:]))
    job = dict(artifact_json=None, cfg=cfg, init=0, batches=batches, microbatches=2,
               stages=(StageSpec((0, 1), True, False, dp=1, tp=1),
                       StageSpec((1, 2), False, True, dp=1, tp=1)))
    (two,) = zip(*tdist.spawn(run_plans_rank, 2, "gloo", ["cpu"] * 2, [job]))
    (three,) = zip(*tdist.spawn(run_plans_rank, 3, "gloo", ["cpu"] * 3, [job]))
    assert [r["kind"] for r in three] == ["hetero", "hetero", None]
    assert [r["losses"] for r in three[:2]] == [r["losses"] for r in two]
