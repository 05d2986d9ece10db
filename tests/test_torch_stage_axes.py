"""The hetero route's stage axes — ZeRO 1-3, context parallelism (ring and
Ulysses), expert parallelism and MoE stages — against the JAX package's
``make_hetero_train_step``.

The same numpy parameters and tokens go through the reference's executor on
the 8-device virtual CPU mesh and through the port's ranks (four gloo
processes on the host, every plan in one launch, ``testing.run_plans_rank``).
The cases mirror the reference's own tests in ``tests/test_hetero.py``, cut
to four ranks: ZeRO 3 on a stage, and ZeRO 1 and 2; a cp 2 ring stage
feeding a cp 2 Ulysses stage (LLaMA: RoPE at global positions), and a cp 2
stage feeding a cp 1 stage of dp 2; a two-stage MoE whose first stage has
ep 2, MoE with uneven replica rows (3, 1) without and with ep (then ZeRO 3
on the MoE stage after it), and a stage of two device-type groups each
routing its own tokens; a uniform pp 2 artifact at ZeRO 1 and a hetero plan
with Megatron sp through ``build_executable``.  The MoE routing groups of
the reference's tests (seq 16, groups up to 4096 tokens) would straddle
the replicas; ``route_group_size`` 16 on both sides keeps every group
inside one row, and in one more case 48 makes each group a replica's three
padded rows.  The MoE's capacity factor is the default 1.25, so tokens are
dropped and the capacity of each program's groups counts.

Compared, fp32, as ``tests/test_torch_hetero.py``: every rank's three
losses (1e-4 relative / 2e-5 absolute); the first step's gradient of every
leaf the rank holds (1e-4 / 2e-5; the rank's tp or ep block, at ZeRO 1 and
2 its flat chunk, at ZeRO 3 its shard), against the gradient the
reference's optimizer received, recorded by an identity transformation
chained before its AdamW; and every leaf after three steps (1e-6
absolute; with cp ``TOL``, ``test_every_leaf_matches_jax`` says why).  Then
the refusals that remain, by message.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metis_tpu.execution import builder as jbuilder
from metis_tpu.execution import hetero as jhetero
from metis_tpu.execution import mesh as jmesh
from metis_tpu.execution import train as jtrain
from metis_tpu.models import gpt as jgpt
from metis_tpu.models import llama as jllama
from metis_tpu.models import moe as jmoe
from metis_tpu_torch.core.types import UniformPlan
from metis_tpu_torch.execution import dist as tdist
from metis_tpu_torch.execution import hetero as thetero
from metis_tpu_torch.execution import mesh as tmesh
from metis_tpu_torch.execution.builder import build_executable, plan_route
from metis_tpu_torch.execution.stages import StageRunner, StageLayout, Unit
from metis_tpu_torch.execution.train import param_specs_for
from metis_tpu_torch.models import gpt as tgpt
from metis_tpu_torch.models import llama as tllama
from metis_tpu_torch.models import moe as tmoe
from metis_tpu_torch.testing import run_plans_rank
from torch_gspmd_reference import expected

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=2e-5)
LEAF_ATOL = 1e-6
STEPS, WORLD, SEED = 3, 4, 42
GPT = dict(vocab_size=256, seq_len=32, hidden=64, num_heads=4, num_blocks=4,
           ffn_multiplier=2)
LLAMA = dict(GPT, num_kv_heads=2)
MOE = dict(vocab_size=128, seq_len=16, hidden=32, num_heads=2, num_blocks=4,
           ffn_multiplier=2, num_experts=4, top_k=2, route_group_size=16)
FAMILIES = {"gpt": (jgpt.GPTConfig, tgpt.GPTConfig, GPT),
            "llama": (jllama.LlamaConfig, tllama.LlamaConfig, LLAMA),
            "moe": (jmoe.MoEConfig, tmoe.MoEConfig, MOE),
            "moe48": (jmoe.MoEConfig, tmoe.MoEConfig,
                      dict(MOE, route_group_size=48))}


def _st(dp, tp=1, **axes):
    return {"dp": dp, "tp": tp, **axes}


# name: (family, layer partition, per-stage strategies, replica rows,
# replica groups, gbs, microbatches); every plan takes 4 ranks
CASES = {
    "zero3": ("gpt", (0, 3, 6), [_st(2, zero=3), _st(1, 2)], None, None, 8, 2),
    "zero1_zero2": ("gpt", (0, 3, 6), [_st(2, zero=1), _st(2, zero=2)], None, None,
                    8, 2),
    "cp_ring_a2a": ("llama", (0, 3, 6), [_st(1, cp=2), _st(1, cp=2, cp_mode="a2a")],
                    None, None, 4, 2),
    "cp2_to_cp1": ("gpt", (0, 3, 6), [_st(1, cp=2), _st(2)], None, None, 4, 2),
    "moe_two_stage_ep2": ("moe", (0, 3, 6), [_st(2, ep=2), _st(1, 2)], None, None,
                          4, 2),
    "moe_uneven": ("moe", (0, 3, 6), [_st(2), _st(1, 2)], [(3, 1), None], None,
                   4, 1),
    "moe_uneven_ep2_zero3": ("moe", (0, 2, 6), [_st(2, ep=2), _st(2, zero=3)],
                             [(3, 1), None], None, 4, 1),
    "moe_grouped": ("moe", (0, 3, 6), [_st(2), _st(1, 2)], [(3, 1), None],
                    [(1, 1), None], 4, 1),
    # groups of 48 tokens: each replica's 3 padded rows on stage 0, where
    # stage 1 routes its 4 rows in groups of 32
    "moe_uneven_group48": ("moe48", (0, 3, 6), [_st(2), _st(1, 2)],
                           [(3, 1), None], None, 4, 1),
}
# artifacts through build_executable: a uniform pp 2 plan at ZeRO 1, and a
# non-uniform plan with Megatron sp on a tp stage (the reference's hetero
# executor reads no sp)
ARTIFACTS = {
    "pp2_zero1_artifact": ("gpt", dict(
        mesh_axes=("pp", "dp", "tp"), mesh_shape=(2, 2, 1), layer_partition=(),
        strategies=(_st(2, zero=1),), gbs=8, microbatches=2)),
    "sp_hetero_artifact": ("gpt", dict(
        mesh_axes=(), mesh_shape=(), layer_partition=(0, 3, 6),
        strategies=(_st(1, 2, sp=True), _st(2)), gbs=8, microbatches=2)),
}


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


def _batches(shape, gbs):
    rng = np.random.default_rng(0)
    return [rng.integers(0, shape["vocab_size"], (gbs, shape["seq_len"] + 1),
                         dtype=np.int32) for _ in range(STEPS)]


def _stages(pkg, cfg, name):
    _, bounds, strategies, rows, groups, _, _ = CASES[name]
    return pkg.stage_specs_from_plan(bounds, strategies, cfg,
                                     stage_replica_rows=rows,
                                     stage_replica_groups=groups)


def _jax_run(name):
    """The reference's losses, and per stage its leaves after the steps and
    its first step's gradients."""
    opt = optax.chain(_first_grads(), jtrain.build_optimizer())
    if name in CASES:
        fam, *_, gbs, M = CASES[name]
        jcls, _, shape = FAMILIES[fam]
        jcfg = jcls(**shape, dtype=jnp.float32)
        init_fn, step = jhetero.make_hetero_train_step(
            jcfg, _stages(jhetero, jcfg, name), optimizer=opt)

        def run(state, b):
            return step(state, jnp.asarray(b[:, :-1]).reshape(M, gbs // M, -1),
                        jnp.asarray(b[:, 1:]).reshape(M, gbs // M, -1))
    else:
        fam, fields = ARTIFACTS[name]
        jcls, _, shape = FAMILIES[fam]
        jcfg, gbs = jcls(**shape, dtype=jnp.float32), fields["gbs"]
        exe = jbuilder.build_executable(jcfg, jmesh.PlanArtifact(**fields),
                                        optimizer=opt)
        assert exe.kind == "hetero"
        init_fn = exe.init

        def run(state, b):
            return exe.step(state, jnp.asarray(b[:, :-1]), jnp.asarray(b[:, 1:]))
    state, losses = init_fn(jax.random.PRNGKey(SEED)), []
    for b in _batches(shape, gbs):
        state, loss = run(state, b)
        losses.append(float(loss))
    host = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return losses, [host(p) for p, _ in state], [host(o[0]["g"]) for _, o in state]


def _port_job(name, params):
    if name in CASES:
        fam, *_, gbs, M = CASES[name]
        _, tcls, shape = FAMILIES[fam]
        tcfg = tcls(**shape, dtype=torch.float32)
        plan = dict(artifact_json=None, stages=_stages(thetero, tcfg, name),
                    microbatches=M)
    else:
        fam, fields = ARTIFACTS[name]
        _, tcls, shape = FAMILIES[fam]
        tcfg, gbs = tcls(**shape, dtype=torch.float32), fields["gbs"]
        plan = dict(artifact_json=tmesh.PlanArtifact(**fields).to_json())
    host = [(torch.from_numpy(b[:, :-1]), torch.from_numpy(b[:, 1:]))
            for b in _batches(shape, gbs)]
    return dict(plan, cfg=tcfg, init=params[fam], batches=host,
                return_params=True, first_grads="arrays")


NAMES = [*CASES, *ARTIFACTS]


@pytest.fixture(scope="module")
def runs():
    params = {fam: jax.tree.map(np.asarray, jtrain.init_params_for(
        jax.random.PRNGKey(SEED), jcls(**shape, dtype=jnp.float32)))
        for fam, (jcls, _, shape) in FAMILIES.items()}
    ranks = tdist.spawn(run_plans_rank, WORLD, "gloo", ["cpu"] * WORLD,
                        [_port_job(name, params) for name in NAMES])
    return {name: [r[i] for r in ranks] for i, name in enumerate(NAMES)}


@pytest.fixture(scope="module", params=NAMES)
def case(request, runs):
    return request.param, _jax_run(request.param), runs[request.param]


def _stage_axes(name, stage):
    """(tp, zero) of a stage of a case."""
    if name in CASES:
        st = CASES[name][2][stage]
    else:
        st = ARTIFACTS[name][1]["strategies"]
        st = st[stage] if len(st) > 1 else st[0]
    return st.get("tp", 1), st.get("zero", 0)


def _specs(name, tp):
    fam = CASES[name][0] if name in CASES else ARTIFACTS[name][0]
    _, tcls, shape = FAMILIES[fam]
    return param_specs_for(tcls(**shape), tp)


def test_losses_match_jax(case):
    name, (jlosses, _, _), ranks = case
    assert {r["kind"] for r in ranks} == {"hetero"}
    for r in ranks:  # every rank reports the global loss
        np.testing.assert_allclose(r["losses"], jlosses, **TOL, err_msg=name)


def test_first_gradients_match_jax(case):
    """The gradient each rank's optimizer receives first, against the one
    the reference's optimizer received for that stage: AdamW's update
    hides a gradient's scale, so the trajectory alone would not see a
    gradient summed over one group too many or too few."""
    name, (_, _, jgrads), ranks = case
    for r in ranks:
        stage = r["slots"]["pp"][0]
        tp, zero = _stage_axes(name, stage)
        specs = _specs(name, tp)
        assert r["grads"].keys() == jgrads[stage].keys(), name
        for group, sub in r["grads"].items():
            for leaf, got in sub.items():
                want = expected(jgrads[stage][group][leaf], specs[group][leaf], r,
                                (group, leaf), zero, grad=True)
                np.testing.assert_allclose(
                    got, want, **TOL, err_msg=f"{name}: {group}.{leaf} {r['slots']}")


def test_every_leaf_matches_jax(case):
    """Each rank's stored leaves after three steps (ZeRO 3: its shards)
    against its stage's leaves in the reference: within 1e-6 absolute, and
    on plans with cp within ``TOL``, as ``tests/test_torch_context_parallel.py``
    holds them: the ring and Ulysses sum a stage's gradients in another
    order than the reference, and AdamW's normalized update turns that into
    2e-6 on an element whose gradient cancels to 1e-8 (5 orders below the
    leaf's RMS; its first-step gradient still agrees within ``TOL``)."""
    name, (_, jstages, _), ranks = case
    cp = name in CASES and any(st.get("cp", 1) > 1 for st in CASES[name][2])
    tol = TOL if cp else dict(rtol=0, atol=LEAF_ATOL)
    for r in ranks:
        stage = r["slots"]["pp"][0]
        tp, zero = _stage_axes(name, stage)
        specs = _specs(name, tp)
        assert set(r["params"]) == set(jstages[stage]), name
        for group, sub in r["params"].items():
            for leaf, got in sub.items():
                want = expected(jstages[stage][group][leaf], specs[group][leaf], r,
                                (group, leaf), zero)
                np.testing.assert_allclose(
                    got, want, **tol, err_msg=f"{name}: {group}.{leaf} {r['slots']}")


def test_stage_meshes_follow_the_reference_layout(runs):
    """ep rides inside dp (a ``(dp / ep, ep, tp)`` grid, rows over the
    ``(dp, ep)`` pairs), cp takes its own axis (``(dp, cp, tp)``), each
    stage's ranks after the previous stage's, row-major."""
    got = [r["slots"] for r in runs["moe_two_stage_ep2"]]
    assert [s["ep"] for s in got[:2]] == [(0, 2), (1, 2)]
    assert [s["tp"] for s in got[2:]] == [(0, 2), (1, 2)]
    got = [r["slots"] for r in runs["cp2_to_cp1"]]
    assert [s["sp"] for s in got[:2]] == [(0, 2), (1, 2)]
    assert "sp" not in got[2]


def test_zero_stages_split_their_state(runs):
    """ZeRO on a stage splits over that stage's dp group only: at ZeRO 3
    stage 0 stores half of each wrapped leaf, stage 1 (no ZeRO) whole
    leaves."""
    ranks = runs["zero3"]
    assert ranks[0]["zero_dims"][("blocks", "qkv")] is not None
    full = 2 * 3 * GPT["hidden"] ** 2  # profile layers 0-2: embed, blocks 0, 1
    assert ranks[0]["params"]["blocks"]["qkv"].size == full // 2
    assert "zero_dims" not in ranks[2]


# -- routing and refusals --------------------------------------------------------

def test_plans_with_stage_axes_take_the_hetero_route():
    cfg = tgpt.GPTConfig(**GPT)
    for name, (_, fields) in ARTIFACTS.items():
        assert plan_route(cfg, tmesh.PlanArtifact(**fields)) == "hetero", name


REFUSED = {  # family, per-stage strategies
    "cp_moe": ("moe", (_st(1), _st(1, cp=2))),
    "cp_seq": ("gpt", (_st(1), _st(1, cp=3))),
    "ep_dense": ("gpt", (_st(2), _st(2, ep=2))),
    "ep_dp": ("moe", (_st(1), _st(3, ep=2))),
    "ep_experts": ("moe", (_st(1), _st(3, ep=3))),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_remaining_refusals_match_jax(name):
    """The reference's refusals of stage axes: ``build_executable`` of a
    two-stage plan raises what the reference's raises, in its words, before
    any process group is needed."""
    fam, strategies = REFUSED[name]
    jcls, tcls, shape = FAMILIES[fam]
    fields = dict(mesh_axes=(), mesh_shape=(), layer_partition=(0, 3, 6),
                  strategies=strategies, gbs=8, microbatches=2)
    with pytest.raises((ValueError, NotImplementedError)) as want:
        jbuilder.build_executable(jcls(**shape), jmesh.PlanArtifact(**fields))
    with pytest.raises(want.type) as got:
        build_executable(tcls(**shape), tmesh.PlanArtifact(**fields), device="cpu")
    assert str(got.value) == str(want.value)


def test_routing_groups_that_straddle_replicas_raise():
    """The port's own refusal: an MoE stage whose routing groups would
    straddle its replicas (here rows (3, 1) padded to 3 + 3 rows of 16
    tokens, in groups of 32) raises naming ROADMAP §A.3; groups of 16 fit
    one row each."""
    cfg = tmoe.MoEConfig(**dict(MOE, route_group_size=32), dtype=torch.float32)
    mesh = tmesh.ProcessMesh(("pp", "dp", "tp"), (1, 2, 1), (0, 0, 0))

    def runner(c):
        return StageRunner(c, mesh, [tmesh.StageGrid(2, 1)], lambda rows: [(3, 1)],
                           [Unit(0, 4, True, True, None, None)], range(4),
                           None, True, torch.device("cpu"), None, None, False,
                           False)

    lay = StageLayout(0, 2, 1, 1, (0, 3, 4), MOE["seq_len"])
    with pytest.raises(NotImplementedError, match="§A.3"):
        runner(cfg)._step_of(lay, 1, 4)
    step = runner(dataclasses.replace(cfg, route_group_size=16))._step_of(lay, 1, 4)
    assert (step.rows, step.real, step.cfg.route_group_size) == (3, 3, 16)
    assert step.valid.tolist() == [1.0, 1.0, 1.0]


def test_uniform_pp2_artifacts_with_zero_or_cp_leave_the_pipeline_route():
    """A uniform pp 2 artifact keeps the pipeline route without the stage
    axes and takes the hetero route with them, whose ranks need a launcher."""
    from metis_tpu_torch.core.errors import MetisError

    cfg = tgpt.GPTConfig(**GPT, dtype=torch.float32)
    art = tmesh.PlanArtifact.from_uniform_plan(UniformPlan(1, 2, 1, 4, 8))
    assert plan_route(cfg, art) == "pipeline"
    for axes in ({"zero": 3}, {"cp": 2}, {"cp": 2, "cp_mode": "a2a"}):
        staged = dataclasses.replace(art, strategies=(_st(1, **axes),))
        assert plan_route(cfg, staged) == "hetero"
        with pytest.raises(MetisError, match="launcher"):
            build_executable(cfg, staged, device="cpu")


def test_validate_hetero_choice_measures_a_plan_with_stage_axes():
    """``validate_hetero_choice`` runs a two-stage plan with cp 2 on one
    stage and ZeRO 1 on the other on four CPU ranks, and reports the
    planner's stage demand (capacity less ``memory_state``) beside the
    ranks' peaks (not measured on the CPU)."""
    import math

    from metis_tpu_torch.cluster.spec import ClusterSpec, DeviceSpec, NodeSpec
    from metis_tpu_torch.core.config import ModelSpec
    from metis_tpu_torch.core.types import (
        InterStagePlan,
        IntraStagePlan,
        PlanCost,
        RankedPlan,
        Strategy,
    )
    from metis_tpu_torch.validation import validate_hetero_choice

    ranked = RankedPlan(
        inter=InterStagePlan(("CPU",), (2, 2), batches=2, gbs=4),
        intra=IntraStagePlan((Strategy(dp=1, tp=1, cp=2), Strategy(dp=2, tp=1, zero=1)),
                             (0, 3, 6), (10000.0, 12000.0), 1),
        cost=PlanCost(total_ms=7.0))
    cluster = ClusterSpec(nodes=(NodeSpec("CPU", 4),),
                          devices={"CPU": DeviceSpec("CPU", 16, 100, 25)})
    model = ModelSpec(name="tiny", num_layers=6, hidden_size=32,
                      sequence_length=16, vocab_size=64, num_heads=2)
    (report,) = validate_hetero_choice([ranked], model, device="cpu",
                                       devices=["cpu"] * 4, cluster=cluster,
                                       steps=1, warmup=0)
    assert report.measured_ms > 0 and math.isfinite(report.measured_ms)
    assert report.predicted_ms == 7.0
    assert report.stage_memory_mb == (2 * 16384 - 10000, 2 * 16384 - 12000)
    assert report.peak_memory_mb is None
    assert report.to_json_dict()["stage_memory_mb"] == list(report.stage_memory_mb)
