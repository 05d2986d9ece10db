"""The rank pool of ``execution.dist``: ranks started once that run jobs in
turn over one process group, against a fresh launch per job.

Two jobs (a dp 2 and a tp 2 plan of a small GPT, 3 steps each) on one
pool of two gloo ranks give, bit for bit, the losses and leaves two
``spawn`` launches (a pool each) give; a job starts from the state a fresh
rank has; a job that raises on one rank stops the pool and raises in the
caller with that rank's traceback.  Failures across ranks: a rank outside
a hetero plan that asks for its step is refused by name; a search that
raises on rank 0 raises on every rank; a supervised run that fails on
every rank together reports ``failed`` on each, and one that fails on one
rank alone fails the launch instead of leaving its peer waiting.
"""
import numpy as np
import pytest
import torch

from metis_tpu_torch.core.errors import MetisError
from metis_tpu_torch.core.types import UniformPlan
from metis_tpu_torch.execution import dist as tdist
from metis_tpu_torch.execution.mesh import PlanArtifact
from metis_tpu_torch.models.gpt import GPTConfig
from metis_tpu_torch.testing import failure_paths_rank, pool_probe_rank, run_plan_rank

torch.set_num_threads(1)

CFG = GPTConfig(vocab_size=128, seq_len=16, hidden=32, num_heads=2, num_blocks=2,
                dtype=torch.float32)
GBS = 4


def _jobs():
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(3):
        b = torch.from_numpy(rng.integers(0, CFG.vocab_size, (GBS, CFG.seq_len + 1),
                                          dtype=np.int64))
        batches.append((b[:, :-1], b[:, 1:]))
    return [(PlanArtifact.from_uniform_plan(UniformPlan(dp, 1, tp, GBS, GBS)).to_json(),
             CFG, 5, batches, None, True) for dp, tp in ((2, 1), (1, 2))]


@pytest.fixture(scope="module")
def runs():
    jobs = _jobs()
    spawned = [tdist.spawn(run_plan_rank, 2, "gloo", ["cpu"] * 2, *job) for job in jobs]
    with tdist.RankPool(2, "gloo", ["cpu"] * 2) as pool:
        pooled = [pool.run(run_plan_rank, *job) for job in jobs]
        probes = [pool.run(pool_probe_rank) for _ in range(2)]
        assert pool.jobs == 4
    return spawned, pooled, probes


@pytest.mark.parametrize("job", [0, 1], ids=["dp2", "tp2"])
def test_pool_jobs_equal_spawns(runs, job):
    spawned, pooled, _ = runs
    for want, got in zip(spawned[job], pooled[job]):
        assert got["kind"] == want["kind"] and got["slots"] == want["slots"]
        assert got["losses"] == want["losses"]
        for g, sub in want["params"].items():
            for n, leaf in sub.items():
                np.testing.assert_array_equal(got["params"][g][n], leaf,
                                              err_msg=f"{g}.{n}")


def test_pool_job_starts_fresh(runs):
    """Each job sees the default generator's first draw and the launch
    counts at 0, though the probe before it drew and counted."""
    _, _, probes = runs
    first, second = probes
    assert first == second
    for r in first:
        assert r["launches"] == {"fa_fwd": 0, "fa_bwd_dq": 0, "fa_bwd_dkv": 0}


def test_pool_rank_failure_raises_and_stops():
    pool = tdist.RankPool(2, "gloo", ["cpu"] * 2)
    with pytest.raises(MetisError, match="(?s)rank 1 of 2 failed.*rank 1 fails on purpose"):
        pool.run(pool_probe_rank, 1)
    with pytest.raises(MetisError, match="closed"):
        pool.run(pool_probe_rank)
    pool.close()


def test_failures_across_ranks():
    ranks = tdist.spawn(failure_paths_rank, 2, "gloo", ["cpu"] * 2)
    assert ranks[0]["outside_plan"] is None
    assert "rank 1 of a group of 2, outside the plan" in ranks[1]["outside_plan"]
    for r in ranks:
        assert r["on_rank0"] == ("ValueError", "the search fails on rank 0", True)
        assert r["agreed"] == ("failed", "TrainingAnomalyError: recoveries exhausted")


def test_failure_of_one_rank_fails_the_launch():
    with pytest.raises(MetisError, match="(?s)rank 1 of 2 failed.*rank 1 fails alone"):
        tdist.spawn(failure_paths_rank, 2, "gloo", ["cpu"] * 2, True)
