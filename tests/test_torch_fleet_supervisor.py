"""The fleet drill's supervisor leg on the port
(``metis_tpu_torch.resilience.fleet_drill.run_supervisor_spot_drill``)
against the reference's (``tools/fleet_drill.py``), on the CPU.

The reference trains the drill's tiny GPT (``drill_setup``: 2 nodes x 4
A100, gbs 8) on its 8 virtual CPU devices; the port on eight gloo ranks,
one per device, from the reference's ``PRNGKey(0)`` parameters.  The
script ``spot_preemption@3:A100=4,spot_return@5`` must give the same
report (``recover_s`` aside, the final loss within fp32 tolerance), the
same order of resilience events, and every assertion of the drill's own
(completed, eviction then return, the cluster grown back, the events
causally ordered and in the schema).  The port runs in a thread while the
reference runs."""
import copy
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import tools.fleet_drill as jdrill  # noqa: E402
from tools.chaos_drill import drill_model, drill_setup  # noqa: E402
from metis_tpu.models import config_for_model_spec  # noqa: E402
from metis_tpu.models.gpt import init_params  # noqa: E402
import metis_tpu_torch.resilience.fleet_drill as tdrill  # noqa: E402
from metis_tpu_torch.core.events import read_events  # noqa: E402
from metis_tpu_torch.models.convert import from_numpy_tree  # noqa: E402
from torch_supervisor_reference import LOSS_TOL, resilience_names  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("spot")
    (root / "ref").mkdir()
    (root / "port").mkdir()
    params = jax.tree.map(np.asarray, init_params(
        jax.random.PRNGKey(0), config_for_model_spec(drill_model())))
    with ThreadPoolExecutor(1) as threads:
        port = threads.submit(tdrill.run_supervisor_spot_drill, root / "port",
                              device="cpu", init=from_numpy_tree(params, device="cpu"))
        ref = jdrill.run_supervisor_spot_drill(root / "ref")
        port = port.result()
    return dict(ref=ref, port=port, root=root)


def test_setup_equals_reference():
    import dataclasses

    (rc, rp, rm, rcfg), (pc, pp, pm, pcfg) = drill_setup(), tdrill.drill_setup()
    assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
    assert dataclasses.asdict(pm) == dataclasses.asdict(rm)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(rcfg)
    assert pm.attn == "dense"  # head dim 16: the drill trains dense attention


def test_report_equals_reference(runs):
    want, got = copy.deepcopy(runs["ref"]), copy.deepcopy(runs["port"])
    for rec in (*want["recoveries"], *got["recoveries"]):
        rec.pop("recover_s")
    wl, gl = want.pop("final_loss"), got.pop("final_loss")
    assert got == want
    np.testing.assert_allclose(gl, wl, **LOSS_TOL)
    assert [r["kind"] for r in got["recoveries"]] == ["spot_preemption", "spot_return"]


def test_event_order_equals_reference(runs):
    ref = read_events(runs["root"] / "ref" / "spot_events.jsonl")
    port = read_events(runs["root"] / "port" / "spot_events.jsonl")
    assert resilience_names(port) == resilience_names(ref)
    assert "preemption" in resilience_names(port)
