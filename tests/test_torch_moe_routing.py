"""MoE routing in the reference's groups on every route, against the JAX
package.

The reference routes in groups of ``g`` consecutive tokens of the whole
flattened batch, whatever rows and block of the sequence a device holds
(``metis_tpu/models/moe.py``, GSPMD inserting the gathers).  The port's
ranks route their own groups where ``g`` divides their token runs, and
otherwise share the groups that straddle them (``models.moe.SharedGroups``).
These plans share their groups (a tiny MoE: 2 blocks, 4 experts, top 2,
seq 16, gbs 4, fp32, the preset's 4096-token groups, so one group of the
batch's 64 tokens):

- tp 2 + Megatron sp (the FFN gathers the tp ranks' sequence blocks);
- cp 2 ring and cp 2 Ulysses (each rank 8 of the 16 positions);
- dp 2 (each rank 2 of the 4 rows) and dp 2 x ep 2 (each rank 1 row);
- on the hetero route, an MoE stage of rows (3, 1) padded to 3 + 3 rows
  in groups of 32 tokens, without and with ep 2, and one of even rows
  (2, 2) in groups of 64 (no pad row).

For every plan, as ``tests/test_torch_zero_sp.py`` and
``tests/test_torch_stage_axes.py`` hold theirs: each rank's losses and the
first step's gradient of every leaf it holds (1e-4 relative / 2e-5
absolute) and every leaf after three steps (1e-6 absolute; ``TOL`` with cp:
the ring and Ulysses sum in another order).  The gspmd references are the
reference's ``make_train_step`` on its virtual CPU mesh (its first-step
gradients plan-independent: the one-device gradient); the hetero ones its
``make_hetero_train_step`` with an identity transformation chained before
AdamW that keeps the first gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metis_tpu.execution import hetero as jhetero
from metis_tpu.execution import train as jtrain
from metis_tpu.models import moe as jmoe
from metis_tpu_torch.execution import dist as tdist
from metis_tpu_torch.execution import hetero as thetero
from metis_tpu_torch.execution import mesh as tmesh
from metis_tpu_torch.models import moe as tmoe
from metis_tpu_torch.testing import run_plans_rank
from torch_gspmd_reference import (
    SEED,
    expected,
    port_plan,
    reference_run,
    reference_start,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=2e-5)
LEAF_ATOL = 1e-6
STEPS, GBS = 3, 4
SHAPE = dict(vocab_size=128, seq_len=16, hidden=32, num_heads=2, num_blocks=2,
             ffn_multiplier=2, num_experts=4, top_k=2)
# gspmd plans: (world, plan)
GSPMD = {
    "tp2_sp": (2, dict(tp=2, sp=True)),
    "cp2_ring": (2, dict(cp=2)),
    "cp2_a2a": (2, dict(cp=2, cp_mode="a2a")),
    "dp2": (2, dict(dp=2)),
    "dp2_ep2": (4, dict(dp=2, ep=2)),
}
# hetero plans over 4 ranks: (layer partition, per-stage strategies, replica
# rows, route_group_size)
HETERO = {
    "stage_rows31": ((0, 2, 4), [dict(dp=2, tp=1), dict(dp=1, tp=2)],
                     [(3, 1), None], 32),
    "stage_rows31_ep2": ((0, 2, 4), [dict(dp=2, tp=1, ep=2), dict(dp=2, tp=1)],
                         [(3, 1), None], 32),
    "stage_rows22": ((0, 2, 4), [dict(dp=2, tp=1), dict(dp=1, tp=2)],
                     [(2, 2), None], 64),
}
NAMES = [*GSPMD, *HETERO]


def _cfgs(route_group_size=4096):
    shape = dict(SHAPE, route_group_size=route_group_size)
    return (jmoe.MoEConfig(**shape, dtype=jnp.float32),
            tmoe.MoEConfig(**shape, dtype=torch.float32))


def _batches():
    rng = np.random.default_rng(0)
    return [rng.integers(0, SHAPE["vocab_size"], (GBS, SHAPE["seq_len"] + 1),
                         dtype=np.int32) for _ in range(STEPS)]


def _host(batches):
    return [(torch.from_numpy(b[:, :-1]), torch.from_numpy(b[:, 1:]))
            for b in batches]


def _first_grads() -> optax.GradientTransformation:
    """An identity transformation whose state keeps the first update it
    sees: chained before AdamW, the gradient of the first step."""
    def init(params):
        return {"g": jax.tree.map(jnp.zeros_like, params),
                "n": jnp.zeros((), jnp.int32)}

    def update(updates, state, params=None):
        g = jax.tree.map(lambda s, u: jnp.where(state["n"] == 0, u, s),
                         state["g"], updates)
        return updates, {"g": g, "n": state["n"] + 1}

    return optax.GradientTransformation(init, update)


def _stages(pkg, cfg, name):
    bounds, strategies, rows, _ = HETERO[name]
    return pkg.stage_specs_from_plan(bounds, strategies, cfg,
                                     stage_replica_rows=rows)


def _hetero_reference(name, batches) -> dict:
    """The reference's hetero run: losses, and per stage its leaves after
    the steps and its first step's gradients."""
    jcfg, _ = _cfgs(HETERO[name][3])
    opt = optax.chain(_first_grads(), jtrain.build_optimizer())
    init_fn, step = jhetero.make_hetero_train_step(
        jcfg, _stages(jhetero, jcfg, name), optimizer=opt)
    state, losses = init_fn(jax.random.PRNGKey(SEED)), []
    for b in batches:
        state, loss = step(state, jnp.asarray(b[:, :-1])[None],
                           jnp.asarray(b[:, 1:])[None])
        losses.append(float(loss))
    host = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return {"losses": losses, "final": [host(p) for p, _ in state],
            "grads": [host(o[0]["g"]) for _, o in state]}


@pytest.fixture(scope="module")
def runs():
    """Every plan: the reference's run and the port's ranks, one launch per
    world size."""
    batches = _batches()
    jcfg, tcfg = _cfgs()
    start = reference_start(jcfg, batches[0])
    refs, jobs = {}, {}
    for name, (world, plan) in GSPMD.items():
        refs[name] = {**start, **reference_run(jcfg, batches, **plan)}
        jobs.setdefault(world, []).append((name, dict(
            artifact_json=port_plan(gbs=GBS, **plan), cfg=tcfg,
            init=start["params"], batches=_host(batches), return_params=True,
            first_grads="arrays")))
    for name in HETERO:
        refs[name] = _hetero_reference(name, batches)
        _, cfg = _cfgs(HETERO[name][3])
        jobs[4].append((name, dict(
            artifact_json=None, stages=_stages(thetero, cfg, name),
            microbatches=1, cfg=cfg, init=start["params"],
            batches=_host(batches), return_params=True, first_grads="arrays")))
    out = {}
    for world, items in jobs.items():
        ranks = tdist.spawn(run_plans_rank, world, "gloo", ["cpu"] * world,
                            [job for _, job in items])
        for i, (name, _) in enumerate(items):
            out[name] = [r[i] for r in ranks]
    return refs, out


def _reference_for(name, ref, r):
    """(final leaves, first gradients, tp) of what rank ``r`` holds."""
    if name in GSPMD:
        return ref["final"], ref["grads"], GSPMD[name][1].get("tp", 1)
    stage = r["slots"]["pp"][0]
    return (ref["final"][stage], ref["grads"][stage],
            HETERO[name][1][stage].get("tp", 1))


@pytest.mark.parametrize("name", NAMES)
def test_losses_match_jax(runs, name):
    refs, out = runs
    for r in out[name]:
        assert r["kind"] == ("gspmd" if name in GSPMD else "hetero")
        np.testing.assert_allclose(r["losses"], refs[name]["losses"], **TOL,
                                   err_msg=f"{name} {r['slots']}")


@pytest.mark.parametrize("name", NAMES)
def test_first_gradients_match_jax(runs, name):
    """The gradient each rank's optimizer receives first: a router or token
    gradient counted once per sharer, or an aux weight off by the share,
    reads a factor of 2 off here (AdamW's update hides a gradient's scale,
    so the trajectory alone would not see it)."""
    refs, out = runs
    _, tcfg = _cfgs()
    for r in out[name]:
        _, grads, tp = _reference_for(name, refs[name], r)
        specs = tmesh.moe_param_specs(tcfg)
        assert r["grads"].keys() == grads.keys(), name
        for group, sub in r["grads"].items():
            for leaf, got in sub.items():
                want = expected(grads[group][leaf], specs[group][leaf], r,
                                (group, leaf), 0, grad=True)
                np.testing.assert_allclose(
                    got, want, **TOL, err_msg=f"{name}: {group}.{leaf} {r['slots']}")


@pytest.mark.parametrize("name", NAMES)
def test_every_leaf_after_three_steps_matches_jax(runs, name):
    refs, out = runs
    _, tcfg = _cfgs()
    cp = name in GSPMD and GSPMD[name][1].get("cp", 1) > 1
    tol = TOL if cp else dict(rtol=0, atol=LEAF_ATOL)
    for r in out[name]:
        final, _, tp = _reference_for(name, refs[name], r)
        specs = tmesh.moe_param_specs(tcfg)
        assert set(r["params"]) == set(final), name
        for group, sub in r["params"].items():
            for leaf, got in sub.items():
                want = expected(final[group][leaf], specs[group][leaf], r,
                                (group, leaf), 0)
                np.testing.assert_allclose(
                    got, want, **tol, err_msg=f"{name}: {group}.{leaf} {r['slots']}")


def test_the_hetero_route_still_refuses_cp_on_an_moe_stage():
    """The reference's own refusal, in its words: cp on an MoE stage of the
    hetero route has no execution path there."""
    jcfg, tcfg = _cfgs()
    with pytest.raises(NotImplementedError) as want:
        jhetero.stage_specs_from_plan((0, 2, 4), [dict(dp=1, tp=1),
                                                  dict(dp=1, tp=1, cp=2)], jcfg)
    with pytest.raises(NotImplementedError) as got:
        thetero.stage_specs_from_plan((0, 2, 4), [dict(dp=1, tp=1),
                                                  dict(dp=1, tp=1, cp=2)], tcfg)
    assert str(got.value) == str(want.value)


def test_forward_routing_reads_the_first_blocks_decisions():
    """``testing.forward_routing`` (the chip's routing comparison) captures
    the first block's decisions of the executor's own forward: on one
    device those of ``testing.moe_routing``, its groups the rank's own."""
    from metis_tpu_torch.core.types import UniformPlan
    from metis_tpu_torch.execution.builder import build_executable
    from metis_tpu_torch.testing import forward_routing, moe_routing

    _, tcfg = _cfgs(route_group_size=32)
    exe = build_executable(tcfg, tmesh.PlanArtifact.from_uniform_plan(
        UniformPlan(1, 1, 1, GBS, GBS)), device="cpu")
    state = exe.init(0)
    tokens = torch.from_numpy(_batches()[0][:, :-1])
    got = forward_routing(exe, state, tokens)
    want = moe_routing(state.params, tokens, tcfg, tmesh.ONE_DEVICE,
                       torch.device("cpu"))
    assert got["expert_idx"].shape == (2, 32, 2)
    for key in ("expert_idx", "position", "keep"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["shared"] is False and got["ties"] == 0
