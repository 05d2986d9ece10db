"""Restore onto another plan, the hetero route, and its refusals: the port
against the JAX package (orbax on the virtual CPU mesh), as
``tests/test_torch_checkpoint_elastic.py`` holds the gspmd route.

Restored, losses within the trajectory tolerance of the reference's and
the state the checkpoint's one-device state bit for bit: a two-stage
hetero plan onto the same stages and layer partition with the stages' dp
and tp swapped.

Refused where the reference refuses, with ``MetisError`` before any state
is written: another stage partition, and the hetero route's per-stage
state against the gspmd route's one tree, both ways (the reference's
refusal of gspmd -> hetero is held in
``test_torch_checkpoint_elastic_pipeline.py``, whose pipeline checkpoint
is the same tree).
"""
import shutil

import pytest
import torch

from metis_tpu_torch.execution import checkpoint as tckpt
from metis_tpu_torch.execution import dist as tdist
from metis_tpu_torch.testing import elastic_rank
from tests.torch_elastic_reference import (
    check_pair,
    configs,
    gspmd,
    hetero,
    run_jobs,
)

torch.set_num_threads(1)

HETERO_A = hetero((0, 3, 6), {"dp": 2, "tp": 1}, {"dp": 1, "tp": 2})
HETERO_B = hetero((0, 3, 6), {"dp": 1, "tp": 2}, {"dp": 2, "tp": 1})
# the same stages on two ranks: stage 1 whole on rank 1
HETERO_ONE_EACH = hetero((0, 3, 6), {"dp": 1, "tp": 1}, {"dp": 1, "tp": 1})
OTHER_PARTITION = hetero((0, 2, 6), {"dp": 2, "tp": 1}, {"dp": 1, "tp": 2})
# (job, plan, checkpoint it restores from or None)
JOBS = [
    ("hetero_a", HETERO_A, None),
    ("hetero_swapped", HETERO_B, "hetero_a"),
    ("hetero_other_partition", OTHER_PARTITION, "hetero_a"),
    ("hetero_to_gspmd", gspmd(dp=4), "hetero_a"),
    ("gspmd_a", gspmd(dp=4), None),
    ("gspmd_to_hetero", HETERO_A, "gspmd_a"),
]
# the reference's side: plan A, its plans B, the plans it refuses
REFERENCE = {"hetero_a": (HETERO_A, [HETERO_B], (OTHER_PARTITION, gspmd(dp=4)))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic_stages")
    return tmp, *run_jobs(tmp, JOBS, REFERENCE)


def test_restore_onto_another_plan_matches_the_reference(runs):
    tmp, port, ref = runs
    assert port["hetero_swapped"]["kind"] == "hetero"
    check_pair("hetero_swapped", ref["hetero_a"]["a"], ref["hetero_a"]["b"][0],
               port["hetero_a"], port["hetero_swapped"],
               tckpt.logical_digests(tmp / "hetero_a"))


@pytest.mark.parametrize("name,reason,ref_index", [
    ("hetero_other_partition", "another stage partition", 0),
    ("hetero_to_gspmd", "another structure", 1),
    ("gspmd_to_hetero", "another structure", None),
])
def test_restore_is_refused_where_the_reference_refuses(runs, name, reason,
                                                        ref_index):
    _, port, ref = runs
    assert port[name]["refused"] is not None and reason in port[name]["refused"]
    assert port[name]["losses"] == []
    if ref_index is not None:
        assert ref["hetero_a"]["refused"][ref_index] is not None, name


def test_restore_onto_another_plan_verifies_every_source(runs, tmp_path):
    """Plan A's stage 1 (tp 2 on ranks 2 and 3) onto one rank reads both
    tp halves: a parameter changed in rank 3's file makes the restore fall
    back to the retained ``.prev`` generation, and refuses it without one."""
    src, _, _ = runs
    for case in ("with_prev", "alone"):
        shutil.copytree(src / "hetero_a", tmp_path / case / "ckpt")
        f = tmp_path / case / "ckpt" / "state" / "rank00003.pt"
        snap = torch.load(f, weights_only=True)
        assert snap["stage"] == 1
        snap["params"]["blocks"]["qkv"].view(-1)[0] += 1.0
        torch.save(snap, f)
    shutil.copytree(src / "hetero_a", tmp_path / "with_prev" / "ckpt.prev")
    cfg = configs("gpt")[1]
    got = tdist.spawn(elastic_rank, 2, "gloo", ["cpu"] * 2, [
        dict(cfg=cfg, artifact=HETERO_ONE_EACH.to_json(), init=1,
             restore=str(tmp_path / case / "ckpt"))
        for case in ("with_prev", "alone")])[0]
    assert got[0]["refused"] is None and got[0]["step"] == 2
    assert got[0]["digests"] == tckpt.logical_digests(src / "hetero_a")
    assert "digest mismatch" in got[1]["refused"]

