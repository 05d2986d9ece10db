"""Restore onto another plan of the MoE and LLaMA families on the gspmd
route: the port against the JAX package, as
``tests/test_torch_checkpoint_elastic.py`` holds the GPT.  Pairs: an MoE
ep 2 -> ep 1 on one device (the experts split over ep, then whole), and a
LLaMA tp 2 whose one KV head does not split over tp (``wkv`` kept whole
on both ranks, read from the lowest) -> one device."""
import pytest
import torch

from metis_tpu_torch.execution import checkpoint as tckpt
from tests.torch_elastic_reference import check_pair, gspmd, run_pairs

torch.set_num_threads(1)

# (name, family, plan A, [plan B], ranks of plan A)
PAIRS = [
    ("moe_ep2_to_ep1", "moe", gspmd(dp=2, ep=2, blocks=2), [gspmd(blocks=2)], 2),
    ("llama_tp2_kv_whole_to_one", "llama", gspmd(tp=2, blocks=2),
     [gspmd(blocks=2)], 2),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic_families")
    return tmp, *run_pairs(tmp, PAIRS)


@pytest.mark.parametrize("name", [p[0] for p in PAIRS])
def test_restore_onto_another_plan_matches_the_reference(runs, name):
    tmp, port, ref = runs
    got_a, (got_b,) = port[name]
    assert got_a["kind"] == got_b["kind"] == "gspmd"
    check_pair(name, ref[name]["a"], ref[name]["b"][0], got_a, got_b,
               tckpt.logical_digests(tmp / name))
