"""Restore onto another plan, the pipeline route, and its refusals: the
port against the JAX package (orbax on the virtual CPU mesh), as
``tests/test_torch_checkpoint_elastic.py`` holds the gspmd route.

Restored, losses within the trajectory tolerance of the reference's and
the state the checkpoint's one-device state bit for bit: a pipeline of
pp 2 x dp 2 onto pp 2 x dp 1 (the same block layout), and onto gspmd dp 2
(the reference's pipeline and gspmd states are the same tree at the
canonical block layout, and orbax restores one onto the other).

Refused where the reference refuses, with ``MetisError`` before any state
is written: another block layout (the canonical layout onto the
interleaved schedule's, which the reference's ``train`` refuses by
``block_layouts_compatible``; orbax alone would restore the permuted
blocks silently), and the pipeline's one tree onto the hetero route's
per-stage state.
"""
import pytest
import torch

from metis_tpu.execution import checkpoint as jckpt
from metis_tpu_torch.execution import checkpoint as tckpt
from tests.torch_elastic_reference import (
    check_pair,
    gspmd,
    hetero,
    pipeline,
    run_jobs,
)

torch.set_num_threads(1)

HETERO = hetero((0, 3, 6), {"dp": 2, "tp": 1}, {"dp": 1, "tp": 2})
# (job, plan, checkpoint it restores from or None)
JOBS = [
    ("pipe_a", pipeline(2, 2), None),
    ("pipe_dp1", pipeline(2, 1), "pipe_a"),
    ("pipe_to_gspmd", gspmd(dp=2), "pipe_a"),
    ("pipe_to_interleaved", pipeline(2, 2, "interleaved", 2), "pipe_a"),
    ("pipe_to_hetero", HETERO, "pipe_a"),
]
REFERENCE = {"pipe_a": (pipeline(2, 2), [pipeline(2, 1), gspmd(dp=2)], (HETERO,))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic_pipeline")
    return tmp, *run_jobs(tmp, JOBS, REFERENCE)


@pytest.mark.parametrize("name,index,kind", [
    ("pipe_dp1", 0, "pipeline"),
    ("pipe_to_gspmd", 1, "gspmd"),
])
def test_restore_onto_another_plan_matches_the_reference(runs, name, index, kind):
    tmp, port, ref = runs
    assert port[name]["kind"] == kind
    check_pair(name, ref["pipe_a"]["a"], ref["pipe_a"]["b"][index],
               port["pipe_a"], port[name], tckpt.logical_digests(tmp / "pipe_a"))


def test_restore_is_refused_where_the_reference_refuses(runs):
    tmp, port, ref = runs
    layout = port["pipe_to_interleaved"]["refused"]
    assert layout is not None and "another block layout" in layout
    meta = jckpt.load_meta(tmp / "ref" / "pipe_a")
    assert not jckpt.block_layouts_compatible(meta, "interleaved:2x2")
    route = port["pipe_to_hetero"]["refused"]
    assert route is not None and "another structure" in route
    assert ref["pipe_a"]["refused"][0] is not None
    assert port["pipe_to_interleaved"]["losses"] == port["pipe_to_hetero"]["losses"] == []
