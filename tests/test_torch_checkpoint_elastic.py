"""Restore onto another plan, the gspmd route (one device included): the
port (``execution/checkpoint.py`` through its slice maps) against the JAX
package (orbax resharding on read on the virtual CPU mesh).  Each package
trains plan A two steps from the same numpy parameters, checkpoints it,
restores it onto plan B and trains two more; the losses agree within the
trajectory tests' tolerance, and the port's restored state is the
checkpoint's one-device state bit for bit.  Pairs: dp 2 x tp 2 -> dp 2
(four ranks to two, the reference's shrink), dp 2 + ZeRO 1 -> one device,
and tp 2 -> ZeRO 3 dp 2 (the columns split over tp, then each leaf whole
and split over dp along its ZeRO dim).

The MoE and LLaMA pairs are in ``test_torch_checkpoint_elastic_families.py``,
the hetero route in ``test_torch_checkpoint_elastic_stages.py`` and the
pipeline route in ``test_torch_checkpoint_elastic_pipeline.py``, with the
refusals across routes (each file stays short: the reference compiles two
executables per pair).  A checkpoint without slice maps is held in
``tests/test_torch_checkpoint.py``.
"""
import pytest
import torch

from metis_tpu_torch.execution import checkpoint as tckpt
from tests.torch_elastic_reference import check_pair, gspmd, run_pairs

torch.set_num_threads(1)

# (name, family, plan A, [plan B], ranks of plan A)
PAIRS = [
    ("dp2xtp2_to_dp2", "gpt", gspmd(dp=2, tp=2), [gspmd(dp=2)], 4),
    ("dp2_zero1_to_one", "gpt", gspmd(dp=2, zero=1), [gspmd()], 2),
    ("tp2_to_zero3_dp2", "gpt", gspmd(tp=2), [gspmd(dp=2, zero=3)], 2),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    return tmp, *run_pairs(tmp, PAIRS)


@pytest.mark.parametrize("name", [p[0] for p in PAIRS])
def test_restore_onto_another_plan_matches_the_reference(runs, name):
    tmp, port, ref = runs
    got_a, (got_b,) = port[name]
    assert got_a["kind"] == got_b["kind"] == "gspmd"
    check_pair(name, ref[name]["a"], ref[name]["b"][0], got_a, got_b,
               tckpt.logical_digests(tmp / name))
