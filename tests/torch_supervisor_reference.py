"""The JAX package's ``TrainingSupervisor`` as the reference of the port's —
a helper of ``tests/test_torch_supervisor.py`` and
``tests/test_torch_chaos.py``, which split the scenarios so that each file
stays short (the reference compiles every executable it builds).

Both sides run the reference's migration drill setup
(``tools/chaos_drill.migration_drill_setup``: its tiny GPT, 2 nodes x 2
A100, gbs 8, the synthesized profiles, here written to a directory the
port reads): the reference on its virtual CPU mesh, the port on four gloo
ranks of one ``execution.dist.RankPool``, one per device, every rank
running ``resilience.supervisor.supervised_rank``.  The port's fresh
states are the reference's ``PRNGKey(0)`` parameters
(``models.convert.from_numpy_tree``).  ``run_scenarios`` runs a list of
scenarios on both sides at once: the port's in a thread while the
reference runs.
"""
import copy
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from metis_tpu.core.config import ResilienceConfig as JResilienceConfig  # noqa: E402
from metis_tpu.core.events import EventLog as JEventLog, read_events  # noqa: E402
from metis_tpu.models import config_for_model_spec  # noqa: E402
from metis_tpu.models.gpt import init_params  # noqa: E402
from metis_tpu.resilience import FaultInjector as JFaultInjector  # noqa: E402
from metis_tpu.resilience import TrainingSupervisor as JTrainingSupervisor  # noqa: E402
from metis_tpu_torch.cluster.spec import ClusterSpec  # noqa: E402
from metis_tpu_torch.core.config import ModelSpec, ResilienceConfig, SearchConfig  # noqa: E402
from metis_tpu_torch.execution import dist as tdist  # noqa: E402
from metis_tpu_torch.models.convert import from_numpy_tree  # noqa: E402
from metis_tpu_torch.resilience.supervisor import supervised_rank  # noqa: E402
from tools.chaos_drill import _no_sleep, migration_drill_setup  # noqa: E402

STEPS = 8
WORLD = 4  # 2 nodes x 2 A100
# fp32 on both sides: the trajectory tests' tolerance
LOSS_TOL = dict(rtol=1e-4, atol=2e-5)
#: the events of the resilience paths (the other events are the planner's
#: and the executors', which the two packages emit each their own way)
RESILIENCE_EVENTS = ("fault_injected", "retry_attempt", "anomaly_detected",
                     "preempt_drain", "preemption", "spot_return",
                     "reshard_plan", "reshard_step", "migration_complete",
                     "migration_fallback", "recovery_complete")


class _Recording(JTrainingSupervisor):
    """The reference's supervisor, recording the artifact of every plan it
    builds."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.artifacts = []

    def _build(self, art):
        self.artifacts.append(art.to_json())
        return super()._build(art)


def resilience_names(events: list[dict]) -> list[str]:
    """The ordered names of the resilience events, each run of
    ``reshard_step`` as one: one such event per moved tensor, and the two
    packages' states hold other tensors (optax's moment trees and count
    against ``torch.optim``'s per-leaf state; the port moves only the
    tensors a rank does not hold already)."""
    out = []
    for e in events:
        name = e["event"]
        if name in RESILIENCE_EVENTS and not (name == "reshard_step" and out
                                              and out[-1] == name):
            out.append(name)
    return out


def setup(root: Path) -> dict:
    """The drill setup, its profiles written under ``root``, and the
    reference's initial parameters as numpy arrays."""
    cluster, profiles, model, config = migration_drill_setup()
    profiles.dump_to_dir(root / "profiles")
    params = jax.tree.map(np.asarray, init_params(
        jax.random.PRNGKey(0), config_for_model_spec(model)))
    return dict(cluster=cluster, profiles=profiles, model=model, config=config,
                params=params, root=root)


def _reference(s: dict, name: str, script: str, res: dict) -> dict:
    path = s["root"] / f"ref_{name}.jsonl"
    with JEventLog(path) as events:
        sup = _Recording(
            s["cluster"], s["profiles"], s["model"], s["config"],
            checkpoint_dir=s["root"] / f"ref_ckpt_{name}", steps=STEPS,
            resilience=JResilienceConfig(**res),
            faults=JFaultInjector(script, seed=0, events=events),
            events=events, sleep=_no_sleep)
        report = sup.run()
    return dict(report=report.to_json_dict(), losses=list(report.losses),
                artifacts=sup.artifacts, events=read_events(path))


def port_job(s: dict, name: str, script: str, res: dict) -> dict:
    m, c = s["model"], s["config"]
    return dict(
        cluster=ClusterSpec.of(("A100", 2, 2)), profile_dir=str(s["root"] / "profiles"),
        model=ModelSpec(**m.__dict__),
        config=SearchConfig(gbs=c.gbs, max_profiled_tp=c.max_profiled_tp,
                            max_profiled_bs=c.max_profiled_bs),
        resilience=ResilienceConfig(**res), fault_script=script, seed=0,
        checkpoint_dir=str(s["root"] / f"port_ckpt_{name}"), steps=STEPS,
        events=str(s["root"] / f"port_{name}.jsonl"), no_sleep=True,
        init=from_numpy_tree(s["params"], device="cpu"))


def _port(s: dict, scenarios: dict) -> dict:
    out = {}
    with tdist.RankPool(WORLD, "gloo", ["cpu"] * WORLD) as pool:
        for name, (script, res) in scenarios.items():
            ranks = pool.run(supervised_rank, port_job(s, name, script, res))
            out[name] = dict(ranks=ranks, events=read_events(
                s["root"] / f"port_{name}.jsonl"))
    return out


def run_scenarios(root: Path, scenarios: dict) -> dict:
    """``{name: (reference, port)}`` for ``scenarios`` (``{name: (fault
    script, ResilienceConfig keywords)}``): the reference's report,
    losses, artifacts and events; the port's per-rank outputs and rank 0's
    events."""
    s = setup(root)
    with ThreadPoolExecutor(1) as threads:
        port = threads.submit(_port, s, scenarios)
        ref = {name: _reference(s, name, script, res)
               for name, (script, res) in scenarios.items()}
        port = port.result()
    return {name: (ref[name], port[name]) for name in scenarios}


# -- the comparisons both test files make -----------------------------------------

def check_report(ref: dict, port: dict) -> None:
    """The report field by field (``recover_s`` aside; the final loss
    within ``LOSS_TOL``)."""
    want, got = copy.deepcopy(ref["report"]), copy.deepcopy(port["ranks"][0]["report"])
    for rec in (*want["recoveries"], *got["recoveries"]):
        rec.pop("recover_s")
    wl, gl = want.pop("final_loss"), got.pop("final_loss")
    assert got == want
    assert (gl is None) == (wl is None)
    if wl is not None:
        np.testing.assert_allclose(gl, wl, **LOSS_TOL)


def check_losses(ref: dict, port: dict) -> None:
    want, got = ref["losses"], port["ranks"][0]["losses"]
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, **LOSS_TOL)


def check_plans(ref: dict, port: dict) -> None:
    """The artifact of every plan built, before and after each replan,
    byte for byte, on every rank."""
    assert len(ref["artifacts"]) >= 1
    for rank in port["ranks"]:
        assert rank["artifacts"] == ref["artifacts"]


def check_event_order(ref: dict, port: dict) -> None:
    assert resilience_names(port["events"]) == resilience_names(ref["events"])


def check_ranks_agree(port: dict) -> None:
    """Every rank's report, losses and fired faults are rank 0's."""
    first = port["ranks"][0]
    for rank in port["ranks"][1:]:
        for key in ("report", "losses", "fired"):
            assert rank[key] == first[key], key


def check_schema(port: dict) -> None:
    from tools.check_events_schema import validate_events

    assert validate_events(port["events"]) == []
