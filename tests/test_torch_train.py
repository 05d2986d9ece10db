"""The port's training step (metis_tpu_torch.execution) against the JAX
package's: a 3-step AdamW loss trajectory from the same converted weights
and numpy tokens, the PlanArtifact JSON contract both ways, the routing of
``build_executable``, and the step-loop helpers.

Tolerance for the trajectory: 1e-4 relative / 2e-5 absolute on each loss in
fp32 (summation order differs between the frameworks; AdamW is applied the
same way, decay on every leaf).
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metis_tpu.core.types import UniformPlan as JUniformPlan
from metis_tpu.execution import mesh as jmesh
from metis_tpu.execution import train as jtrain
from metis_tpu.models import gpt as jgpt
from metis_tpu_torch.core.errors import MetisError
from metis_tpu_torch.core.events import EventLog, read_events
from metis_tpu_torch.core.types import UniformPlan
from metis_tpu_torch.execution import mesh as tmesh
from metis_tpu_torch.execution import train as ttrain
from metis_tpu_torch.execution.builder import build_executable
from metis_tpu_torch.models import convert
from metis_tpu_torch.models import gpt as tgpt

# the suite runs in several workers at once; one intra-op thread keeps these
# tiny tensors from contending with the other workers' timing tests
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=2e-5)
SHAPE = dict(vocab_size=128, seq_len=32, hidden=64, num_heads=4, num_blocks=2)


@pytest.mark.parametrize("attn", ["flash", "dense"])
def test_three_step_trajectory_matches_jax(attn):
    jcfg = jgpt.GPTConfig(**SHAPE, dtype=jnp.float32, attn=attn)
    tcfg = tgpt.GPTConfig(**SHAPE, dtype=torch.float32, attn=attn)
    jparams = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.from_numpy_tree(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, SHAPE["vocab_size"], (2, SHAPE["seq_len"] + 1),
                            dtype=np.int32) for _ in range(3)]

    mesh = jmesh.mesh_dp_tp(1, 1, jax.devices()[:1])
    opt = jtrain.build_optimizer()
    jstate = jtrain.TrainState(params=jparams, opt_state=opt.init(jparams),
                               step=jnp.zeros((), jnp.int32))
    jstep = jtrain.make_train_step(jcfg, mesh, optimizer=opt)

    exe = build_executable(
        tcfg, tmesh.PlanArtifact.from_uniform_plan(UniformPlan(1, 1, 1, 2, 2)),
        device="cpu")
    tstate = ttrain.train_state_from_params(tparams)

    for b in batches:
        jstate, jloss = jstep(jstate, jnp.asarray(b[:, :-1]), jnp.asarray(b[:, 1:]))
        tstate, tloss = exe.step(tstate, torch.from_numpy(b[:, :-1]),
                                 torch.from_numpy(b[:, 1:]))
        np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    assert tstate.step == 3
    # AdamW's first steps move each weight by ~lr: the updated weights agree
    # to a small fraction of that
    np.testing.assert_allclose(tstate.params["head"]["out"].detach().numpy(),
                               np.asarray(jstate.params["head"]["out"]),
                               rtol=0, atol=1e-6)


def test_optimizer_matches_optax_adamw():
    """One AdamW update on fixed gradients: decay on every leaf, optax's
    betas, eps and bias correction."""
    import optax

    rng = np.random.default_rng(2)
    p0 = rng.standard_normal((4, 5), dtype=np.float32)
    grads = [rng.standard_normal((4, 5), dtype=np.float32) for _ in range(3)]
    jp, opt = jnp.asarray(p0), jtrain.build_optimizer()
    st = opt.init(jp)
    tp = torch.from_numpy(p0.copy()).requires_grad_()
    topt = ttrain.build_optimizer()([tp])
    for g in grads:
        upd, st = opt.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        topt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=1e-6, atol=1e-7)


PLANS = [(1, 1, 1, 4, 4), (2, 1, 2, 2, 8), (1, 2, 1, 1, 8)]


@pytest.mark.parametrize("dp,pp,tp,mbs,gbs", PLANS)
def test_plan_artifact_json_round_trips_both_ways(dp, pp, tp, mbs, gbs):
    jart = jmesh.PlanArtifact.from_uniform_plan(JUniformPlan(dp, pp, tp, mbs, gbs))
    tart = tmesh.PlanArtifact.from_uniform_plan(UniformPlan(dp, pp, tp, mbs, gbs))
    assert tart.to_json() == jart.to_json()
    assert jmesh.PlanArtifact.from_json(tart.to_json()) == jart
    assert tmesh.PlanArtifact.from_json(jart.to_json()) == tart


def test_hetero_artifact_round_trips_and_is_refused(tmp_path):
    jart = jmesh.PlanArtifact(
        mesh_axes=(), mesh_shape=(), layer_partition=(0, 2, 4),
        strategies=({"dp": 2, "tp": 2}, {"dp": 4, "tp": 1}), gbs=8,
        microbatches=2, node_sequence=("A100", "T4"), device_groups=(4, 4),
        schedule="1f1b", virtual_stages=1)
    path = tmp_path / "plan.json"
    jart.save(path)
    tart = tmesh.PlanArtifact.load(path)
    assert tart.to_json() == jart.to_json()
    cfg = tgpt.GPTConfig(**SHAPE, dtype=torch.float32)
    # the hetero route runs one rank per device: outside a process group
    # it names the launcher
    with pytest.raises(MetisError, match="through the launcher"):
        build_executable(cfg, tart, device="cpu")


@pytest.mark.parametrize("plan,error,match", [
    (UniformPlan(2, 1, 1, 1, 2), MetisError, "through the launcher"),
    (UniformPlan(1, 1, 2, 1, 1), MetisError, "through the launcher"),
    (UniformPlan(1, 2, 1, 1, 2), MetisError, "through the launcher")],
    ids=["dp2", "tp2", "pp2"])
def test_multi_device_plans_raise(plan, error, match):
    """Outside a process group a dp x tp plan, and a pipeline, names the
    launcher that runs it."""
    cfg = tgpt.GPTConfig(**SHAPE, dtype=torch.float32)
    with pytest.raises(error, match=match):
        build_executable(cfg, tmesh.PlanArtifact.from_uniform_plan(plan),
                         device="cpu")


def test_unknown_schedule_and_strategy_axes_are_refused():
    import dataclasses

    cfg = tgpt.GPTConfig(**SHAPE, dtype=torch.float32)
    art = tmesh.PlanArtifact.from_uniform_plan(UniformPlan(1, 1, 1, 1, 1))
    with pytest.raises(ValueError):
        build_executable(cfg, dataclasses.replace(art, schedule="zigzag"),
                         device="cpu")
    for axes in ({"zero": 4}, {"cp_mode": "zigzag"}):
        with pytest.raises(ValueError):
            build_executable(cfg, dataclasses.replace(
                art, strategies=({"dp": 1, "tp": 1, **axes},)), device="cpu")
    # ZeRO on a pipeline stage takes the hetero route, whose two ranks need
    # the launcher
    from metis_tpu_torch.core.errors import MetisError

    staged = tmesh.PlanArtifact.from_uniform_plan(UniformPlan(1, 2, 1, 2, 2))
    with pytest.raises(MetisError, match="launcher"):
        build_executable(cfg, dataclasses.replace(
            staged, strategies=({"dp": 1, "tp": 1, "zero": 1},)), device="cpu")


def test_executable_init_is_seeded_and_trains():
    cfg = tgpt.GPTConfig(**SHAPE, dtype=torch.float32, attn="flash")
    exe = build_executable(
        cfg, tmesh.PlanArtifact.from_uniform_plan(UniformPlan(1, 1, 1, 2, 2)),
        device="cpu")
    a, b = exe.init(3), exe.init(3)
    torch.testing.assert_close(a.params["blocks"]["qkv"], b.params["blocks"]["qkv"])
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, SHAPE["vocab_size"], (2, SHAPE["seq_len"]), dtype=np.int64))
    losses = []
    for _ in range(3):
        a, loss = exe.step(a, tokens, tokens.roll(-1, 1))
        losses.append(loss.item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert abs(losses[0] - np.log(SHAPE["vocab_size"])) < 0.5


def test_loss_anomaly_detector_matches_jax():
    losses = [5.0, 4.0, 4.5, 3.9, 80.0, float("nan"), 4.1, 4.0, 60.0,
              float("inf"), 3.5]
    jd, td = jtrain.LossAnomalyDetector(window=4), ttrain.LossAnomalyDetector(window=4)
    assert [td.observe(x) for x in losses] == [jd.observe(x) for x in losses]
    with pytest.raises(ValueError):
        ttrain.LossAnomalyDetector(spike_factor=1.0)


def test_step_timer_emits_train_step_events(tmp_path):
    stream = io.StringIO()
    timer = ttrain.StepTimer(EventLog(stream=stream), tokens_per_step=64)
    rec = timer.record(loss=2.5, lr=1e-4)
    assert rec["step"] == 1 and rec["loss"] == 2.5 and rec["lr"] == 1e-4
    path = tmp_path / "ev.jsonl"
    log = EventLog(path)
    ttrain.StepTimer(log).record(loss=1.0)
    log.close()
    (ev,) = read_events(path)
    assert ev["event"] == "train_step" and ev["step"] == 1
    assert '"train_step"' in stream.getvalue()
