"""The port's hetero executor and the hetero half of validation against the
JAX package's.

Executor: the same numpy parameters and tokens go through
``metis_tpu.execution.hetero.make_hetero_train_step`` on the virtual CPU mesh
and through the port's ranks (gloo processes on the host, one launch for
every plan, ``testing.run_plans_rank``) for non-uniform two- and three-stage
plans, the data balancer's uneven replica rows, and a stage of two
device-type groups of which one gets 0 rows.  Compared after three steps:
every loss (1e-4 relative / 2e-5 absolute) and every leaf of every rank
against its stage's leaves in the reference (1e-6 absolute), fp32, as in
``tests/test_torch_dist.py``.

Pure functions, equal to the JAX package's: ``stage_specs_from_plan``,
``plan_replica_rows`` and ``plan_replica_groups`` on the plans both planners
rank on ``metis_tpu.testing.write_parity_fixture`` (2 A100 + 2 T4 nodes, so
stages mix device types), and the calibration fits on the same synthetic
reports.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metis_tpu.cluster.spec as jcluster
import metis_tpu.core.config as jconfig
import metis_tpu.planner.api as japi
import metis_tpu.profiles.store as jstore
import metis_tpu.validation as jval
from metis_tpu.execution import hetero as jhetero
from metis_tpu.execution import mesh as jmesh
from metis_tpu.models import gpt as jgpt
from metis_tpu.models import llama as jllama
from metis_tpu.profiles import tiny_test_model
from metis_tpu.testing import (
    PARITY_GBS,
    PARITY_MAX_BS,
    PARITY_MAX_TP,
    write_parity_fixture,
)
import metis_tpu_torch.cluster.spec as tcluster
import metis_tpu_torch.core.config as tconfig
import metis_tpu_torch.planner.api as tapi
import metis_tpu_torch.profiles.store as tstore
import metis_tpu_torch.validation as tval
from metis_tpu_torch.core.errors import MetisError
from metis_tpu_torch.core.sharding import slice_leaf
from metis_tpu_torch.core.types import (
    InterStagePlan,
    IntraStagePlan,
    PlanCost,
    RankedPlan,
    Strategy,
)
from metis_tpu_torch.execution import dist as tdist
from metis_tpu_torch.execution import hetero as thetero
from metis_tpu_torch.execution import mesh as tmesh
from metis_tpu_torch.models import gpt as tgpt
from metis_tpu_torch.models import llama as tllama
from metis_tpu_torch.models import moe as tmoe
from metis_tpu_torch.testing import run_plans_rank

torch.set_num_threads(1)

SHAPE = dict(vocab_size=256, seq_len=32, hidden=64, num_heads=4, num_blocks=4,
             ffn_multiplier=2)
GBS, STEPS = 8, 3
TOL = dict(rtol=1e-4, atol=2e-5)
LEAF_ATOL = 1e-6

# name: (layer partition, per-stage (dp, tp, replica rows, replica groups),
# microbatches); every plan takes 4 ranks
CASES = {
    "two_stage": ((0, 2, 6), [(2, 1, None, None), (1, 2, None, None)], 2),
    "three_stage": ((0, 2, 3, 6), [(1, 1, None, None), (2, 1, None, None),
                                   (1, 1, None, None)], 2),
    "uneven_rows": ((0, 3, 6), [(2, 1, (3, 1), None), (1, 2, None, None)], 2),
    "groups_zero_row": ((0, 3, 6), [(3, 1, (2, 2, 0), (2, 1)),
                                    (1, 1, None, None)], 2),
}


def _stages(pkg, cfg, name):
    bounds, strategies, _ = CASES[name]
    return pkg.stage_specs_from_plan(
        bounds, [{"dp": dp, "tp": tp} for dp, tp, _, _ in strategies], cfg,
        stage_replica_rows=[s[2] for s in strategies],
        stage_replica_groups=[s[3] for s in strategies])


@pytest.fixture(scope="module")
def data():
    jcfg = jgpt.GPTConfig(**SHAPE, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jgpt.init_params(jax.random.PRNGKey(42), jcfg))
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, SHAPE["vocab_size"], (GBS, SHAPE["seq_len"] + 1),
                            dtype=np.int32) for _ in range(STEPS)]
    return jcfg, params, batches


def _jax_run(jcfg, batches, name):
    stages = _stages(jhetero, jcfg, name)
    M = CASES[name][2]
    init_fn, step = jhetero.make_hetero_train_step(jcfg, stages)
    state = init_fn(jax.random.PRNGKey(42))
    losses = []
    for b in batches:
        tok = jnp.asarray(b[:, :-1]).reshape(M, GBS // M, -1)
        tgt = jnp.asarray(b[:, 1:]).reshape(M, GBS // M, -1)
        state, loss = step(state, tok, tgt)
        losses.append(float(loss))
    return losses, [jax.tree.map(np.asarray, s[0]) for s in state]


@pytest.fixture(scope="module")
def port_runs(data):
    _, params, batches = data
    tcfg = tgpt.GPTConfig(**SHAPE, dtype=torch.float32)
    host = [(torch.from_numpy(b[:, :-1]), torch.from_numpy(b[:, 1:])) for b in batches]
    jobs = [dict(artifact_json=None, stages=_stages(thetero, tcfg, name),
                 microbatches=CASES[name][2], cfg=tcfg, init=params,
                 batches=host, return_params=True) for name in CASES]
    ranks = tdist.spawn(run_plans_rank, 4, "gloo", ["cpu"] * 4, jobs)
    return {name: [r[i] for r in ranks] for i, name in enumerate(CASES)}


@pytest.fixture(scope="module", params=list(CASES))
def case(request, data, port_runs):
    jcfg, _, batches = data
    return request.param, _jax_run(jcfg, batches, request.param), \
        port_runs[request.param]


def test_losses_match_jax(case):
    name, (jlosses, _), ranks = case
    assert {r["kind"] for r in ranks} == {"hetero"}
    for r in ranks:  # every rank reports the global loss
        np.testing.assert_allclose(r["losses"], jlosses, **TOL, err_msg=name)


def test_every_leaf_matches_jax(case):
    """Each rank's tp block of its stage's leaves, against that stage's
    leaves in the reference (which hold the stage's blocks, and the
    embedding or head where the stage has them)."""
    name, (_, jstages), ranks = case
    specs = tmesh.gpt_param_specs(tgpt.GPTConfig(**SHAPE))
    for r in ranks:
        want_tree = jstages[r["slots"]["pp"][0]]
        assert set(r["params"]) == set(want_tree), name
        for group, sub in r["params"].items():
            for leaf, got in sub.items():
                want = slice_leaf(want_tree[group][leaf], specs[group][leaf],
                                  r["slots"])
                np.testing.assert_allclose(
                    got, want, rtol=0, atol=LEAF_ATOL,
                    err_msg=f"{name}: {group}.{leaf} {r['slots']}")


def test_single_stage_plan_runs_without_a_process_group(data):
    """A one-device plan needs no launcher: the hetero executor with one
    stage of dp = tp = 1 in this process, against the reference's."""
    jcfg, params, batches = data
    tcfg = tgpt.GPTConfig(**SHAPE, dtype=torch.float32)
    stages = [thetero.StageSpec((0, 4), True, True, dp=1, tp=1)]
    init_fn, step = thetero.make_hetero_train_step(tcfg, stages, device="cpu")
    state = init_fn(params)
    jinit, jstep = jhetero.make_hetero_train_step(
        jcfg, [jhetero.StageSpec((0, 4), True, True, dp=1, tp=1)],
        devices=jax.devices()[:1])
    jstate = jinit(jax.random.PRNGKey(42))
    for b in batches:
        tok, tgt = b[:, :-1].reshape(2, 4, -1), b[:, 1:].reshape(2, 4, -1)
        state, loss = step(state, torch.from_numpy(tok), torch.from_numpy(tgt))
        jstate, jloss = jstep(jstate, jnp.asarray(tok), jnp.asarray(tgt))
        np.testing.assert_allclose(loss.item(), jloss, **TOL)
    got = state.params["blocks"]["qkv"].detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jstate[0][0]["blocks"]["qkv"]),
                               rtol=0, atol=LEAF_ATOL)


def test_bf16_weights_cast_once_per_step_equal_per_microbatch_casts(data):
    """At bf16 the stage casts its matrices once per step and every
    microbatch's backward goes through that one cast: one SGD step (lr 1)
    of the one-stage executor at M = 2 equals, bit for bit, the one-device
    loss run per microbatch (each casting its own weights) with each loss
    over M and the fp32 gradients summed."""
    from functools import partial

    _, params, batches = data
    cfg = tgpt.GPTConfig(**SHAPE, dtype=torch.bfloat16)
    M = 2
    sgd = partial(torch.optim.SGD, lr=1.0)
    init_fn, step = thetero.make_hetero_train_step(
        cfg, [thetero.StageSpec((0, 4), True, True, dp=1, tp=1)], device="cpu",
        optimizer=sgd)
    state = init_fn(params)
    tok = torch.from_numpy(batches[0][:, :-1]).reshape(M, GBS // M, -1)
    tgt = torch.from_numpy(batches[0][:, 1:]).reshape(M, GBS // M, -1)
    state, loss = step(state, tok, tgt)

    ref = {g: {n: torch.tensor(a, requires_grad=True) for n, a in sub.items()}
           for g, sub in params.items()}
    losses = []
    for m in reversed(range(M)):  # the drain's order
        part = tgpt.next_token_loss(ref, tok[m], tgt[m], cfg) / M
        part.backward()
        losses.append(part.detach())
    assert loss.item() == sum(losses).item()
    for g, sub in ref.items():
        for n, leaf in sub.items():
            torch.testing.assert_close(state.params[g][n].detach(),
                                       leaf.detach() - leaf.grad, rtol=0, atol=0,
                                       msg=f"{g}.{n}")


# -- pure functions on the parity fixture ------------------------------------

@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    d = tmp_path_factory.mktemp("hetero_parity")
    write_parity_fixture(d)
    out = {}
    for tag, (api, config, cluster, store) in {
            "jax": (japi, jconfig, jcluster, jstore),
            "port": (tapi, tconfig, tcluster, tstore)}.items():
        model = config.ModelSpec(**dataclasses.asdict(tiny_test_model()))
        c = cluster.ClusterSpec.from_files(d / "hostfile", d / "clusterfile.json")
        p = store.ProfileStore.from_dir(d / "profiles")
        result = api.plan_hetero(c, p, model, config.SearchConfig(
            gbs=PARITY_GBS, max_profiled_tp=PARITY_MAX_TP,
            max_profiled_bs=PARITY_MAX_BS), top_k=10)
        out[tag] = (result.plans, c, p, model)
    return out


@pytest.mark.parametrize("rank", range(10))
def test_plan_glue_matches_jax_on_the_parity_fixture(parity, rank):
    """``stage_specs_from_plan`` with the balancer's rows and groups, for
    the rank-th plan of both planners' rankings (mixed-type stages)."""
    jplans, jc, jp, jmodel = parity["jax"]
    tplans, tc, tp, tmodel = parity["port"]
    jr, tr = jplans[rank], tplans[rank]
    assert tr.to_json_dict() == jr.to_json_dict()
    jrows = jhetero.plan_replica_rows(jr.inter, jr.intra.strategies, jc, jp)
    trows = thetero.plan_replica_rows(tr.inter, tr.intra.strategies, tc, tp)
    jgroups = jhetero.plan_replica_groups(jr.inter, jr.intra.strategies, jc)
    tgroups = thetero.plan_replica_groups(tr.inter, tr.intra.strategies, tc)
    assert trows == jrows and tgroups == jgroups
    jspecs = jhetero.stage_specs_from_plan(
        jr.intra.layer_partition, jr.intra.strategies,
        jgpt.GPTConfig.from_model_spec(jmodel), jrows, jgroups)
    tspecs = thetero.stage_specs_from_plan(
        tr.intra.layer_partition, tr.intra.strategies,
        tgpt.GPTConfig.from_model_spec(tmodel), trows, tgroups)
    assert [dataclasses.asdict(s) for s in tspecs] == \
        [dataclasses.asdict(s) for s in jspecs]


def test_the_parity_rankings_hold_mixed_stages(parity):
    """The fixture exercises the balancer: some ranked plan has uneven rows
    or type groups."""
    plans, c, p, _ = parity["port"]
    assert any(any(r is not None for r in thetero.plan_replica_rows(
        pl.inter, pl.intra.strategies, c, p)) for pl in plans)


@pytest.mark.parametrize("bad", ["span", "count", "rows", "groups", "cp_seq"])
def test_stage_spec_errors_match_jax(bad):
    jcfg = jgpt.GPTConfig(**SHAPE)
    tcfg = tgpt.GPTConfig(**SHAPE)
    args = {
        "span": ((0, 5), [{"dp": 1, "tp": 1}], None, None),
        "count": ((0, 2, 6), [{"dp": 1, "tp": 1}], None, None),
        "rows": ((0, 6), [{"dp": 2, "tp": 1}], [(1, 2, 3)], None),
        "groups": ((0, 6), [{"dp": 2, "tp": 1}], None, [(1, 2)]),
        "cp_seq": ((0, 6), [{"dp": 1, "tp": 1, "cp": 3}], None, None),
    }[bad]
    with pytest.raises(ValueError) as want:
        jhetero.stage_specs_from_plan(args[0], args[1], jcfg, args[2], args[3])
    with pytest.raises(ValueError) as got:
        thetero.stage_specs_from_plan(args[0], args[1], tcfg, args[2], args[3])
    assert str(got.value) == str(want.value)


# -- the LLaMA family ------------------------------------------------------------

# stage 0 at dp 2 over rows (3, 1), stage 1 at tp 2 with one KV head (its
# wkv is replicated over the stage's tp ranks)
LLAMA_SHAPE = dict(SHAPE, num_kv_heads=1)
LLAMA_PLAN = ((0, 3, 6), [(2, 1, (3, 1), None), (1, 2, None, None)], 2)


@pytest.fixture(scope="module")
def llama_runs():
    jcfg = jllama.LlamaConfig(**LLAMA_SHAPE, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig(**LLAMA_SHAPE, dtype=torch.float32)
    params = jax.tree.map(np.asarray, jllama.init_llama_params(
        jax.random.PRNGKey(42), jcfg))
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, SHAPE["vocab_size"], (GBS, SHAPE["seq_len"] + 1),
                            dtype=np.int32) for _ in range(STEPS)]
    bounds, strategies, M = LLAMA_PLAN

    def stages(pkg, cfg):
        return pkg.stage_specs_from_plan(
            bounds, [{"dp": dp, "tp": tp} for dp, tp, _, _ in strategies], cfg,
            stage_replica_rows=[st[2] for st in strategies])

    init_fn, step = jhetero.make_hetero_train_step(jcfg, stages(jhetero, jcfg))
    state, jlosses = init_fn(jax.random.PRNGKey(42)), []
    for b in batches:
        state, loss = step(state, jnp.asarray(b[:, :-1]).reshape(M, GBS // M, -1),
                           jnp.asarray(b[:, 1:]).reshape(M, GBS // M, -1))
        jlosses.append(float(loss))
    host = [(torch.from_numpy(b[:, :-1]), torch.from_numpy(b[:, 1:])) for b in batches]
    ranks = tdist.spawn(run_plans_rank, 4, "gloo", ["cpu"] * 4, [dict(
        artifact_json=None, stages=stages(thetero, tcfg), microbatches=M,
        cfg=tcfg, init=params, batches=host, return_params=True)])
    return tcfg, jlosses, [jax.tree.map(np.asarray, st[0]) for st in state], \
        [r[0] for r in ranks]


def test_llama_two_stage_plan_matches_jax(llama_runs):
    """A two-stage LLaMA plan (uneven replica rows, a tp stage with a
    replicated KV projection) against ``metis_tpu.execution.hetero``: every
    loss and every leaf of every rank."""
    tcfg, jlosses, jstages, ranks = llama_runs
    assert {r["kind"] for r in ranks} == {"hetero"}
    for r in ranks:
        np.testing.assert_allclose(r["losses"], jlosses, **TOL)
        stage = r["slots"]["pp"][0]
        specs = tmesh.llama_param_specs(tcfg, tp_size=LLAMA_PLAN[1][stage][1])
        assert set(r["params"]) == set(jstages[stage])
        for group, sub in r["params"].items():
            for leaf, got in sub.items():
                want = slice_leaf(jstages[stage][group][leaf], specs[group][leaf],
                                  r["slots"])
                np.testing.assert_allclose(got, want, rtol=0, atol=LEAF_ATOL,
                                           err_msg=f"{group}.{leaf} {r['slots']}")


# -- refusals ------------------------------------------------------------------

def test_artifact_device_groups_must_match_the_strategies():
    """``make_hetero_train_step_from_artifact`` refuses an artifact whose
    device groups disagree with its strategies, as the reference does."""
    fields = dict(mesh_axes=(), mesh_shape=(), layer_partition=(0, 2, 6),
                  strategies=({"dp": 1, "tp": 1}, {"dp": 2, "tp": 1}), gbs=8,
                  microbatches=2, device_groups=(1, 1))
    with pytest.raises(ValueError) as want:
        jhetero.make_hetero_train_step_from_artifact(
            jgpt.GPTConfig(**SHAPE), jmesh.PlanArtifact(**fields))
    with pytest.raises(ValueError) as got:
        thetero.make_hetero_train_step_from_artifact(
            tgpt.GPTConfig(**SHAPE), tmesh.PlanArtifact(**fields), device="cpu")
    assert str(got.value) == str(want.value)


def test_moe_config_raises():
    """MoE runs on the hetero route (``tests/test_torch_stage_axes.py``);
    an MoE stage with cp raises what the reference raises."""
    moe = tmoe.MoEConfig(vocab_size=128, seq_len=16, hidden=32, num_heads=2,
                         num_blocks=4, ffn_multiplier=2, num_experts=2, top_k=1)
    with pytest.raises(NotImplementedError, match="cp\\+MoE stages have no "
                       "execution path"):
        thetero.make_hetero_train_step(
            moe, [thetero.StageSpec((0, 4), True, True, dp=1, tp=1, cp=2)],
            device="cpu")


# -- validation ----------------------------------------------------------------

def _ranked(schedule="gpipe", batches=2):
    """A two-stage plan of 1 + 1 CPU devices over a 6-profile-layer model."""
    return RankedPlan(
        inter=InterStagePlan(node_sequence=("CPU",), device_groups=(1, 1),
                             batches=batches, gbs=4),
        intra=IntraStagePlan(strategies=(Strategy(dp=1, tp=1),) * 2,
                             layer_partition=(0, 3, 6), memory_state=(0.0, 0.0),
                             num_repartition=1, schedule=schedule),
        cost=PlanCost(total_ms=10.0))


VAL_MODEL = tconfig.ModelSpec(name="tiny", num_layers=6, hidden_size=64,
                              sequence_length=32, vocab_size=128, num_heads=4)


def test_measure_ranked_plan_ms_on_two_cpu_ranks():
    """A two-stage hetero plan measured on two CPU ranks, rank 0's time;
    ``validate_hetero_choice`` wraps it in reports; a plan of more devices
    than the list holds raises."""
    ms = tval.measure_ranked_plan_ms(_ranked(), VAL_MODEL, device="cpu",
                                     devices=["cpu"] * 2, steps=1, warmup=0)
    assert ms > 0 and math.isfinite(ms)
    reports = tval.validate_hetero_choice(
        [_ranked(batches=1), _ranked()], VAL_MODEL, device="cpu",
        devices=["cpu"] * 2, top_k=1, steps=1, warmup=0)
    assert len(reports) == 1 and reports[0].predicted_ms == 10.0
    assert reports[0].measured_ms > 0
    assert reports[0].to_json_dict()["plan"]["batches"] == 1
    with pytest.raises(MetisError, match="needs 2 devices, have 1"):
        tval.measure_ranked_plan_ms(_ranked(), VAL_MODEL, device="cpu",
                                    devices=["cpu"])


def test_validate_hetero_choice_on_a_rank_pool():
    """The same validation as a job of a rank pool of the plan's size, in
    place of a launch of its own."""
    with tdist.RankPool(2, "gloo", ["cpu"] * 2) as pool:
        reports = tval.validate_hetero_choice(
            [_ranked()], VAL_MODEL, device="cpu", top_k=1, steps=1, warmup=0,
            pool=pool)
        assert pool.jobs == 1
    assert len(reports) == 1 and reports[0].predicted_ms == 10.0
    assert reports[0].measured_ms > 0 and math.isfinite(reports[0].measured_ms)


def _reports(pkg, n=5):
    """Synthetic hetero reports: stage counts 1-3, batch counts 1-4."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        stages, batches = 1 + i % 3, 1 + i % 4
        pred = float(50 + 30 * i)
        meas = float(pred * (1.2 + 0.1 * stages) + 3 * batches + rng.normal())
        out.append(pkg.HeteroValidationReport(
            plan_dict={"num_stages": stages, "batches": batches},
            predicted_ms=pred, measured_ms=meas, steps=5))
    return out


@pytest.mark.parametrize("n", [2, 3, 5, 8])
@pytest.mark.parametrize("fit", ["dispatch_affine", "features_loo",
                                 "select_loo", "frozen"])
def test_calibration_fits_match_jax(fit, n):
    jr, tr = _reports(jval, n), _reports(tval, n)
    if fit == "dispatch_affine":
        (jf, jo), (tf, to) = (pkg.dispatch_affine_calibrated(
            r, lambda rep: rep.plan_dict["batches"]) for pkg, r in
            ((jval, jr), (tval, tr)))
    elif fit == "features_loo":
        feats = tval.HETERO_FIT_CANDIDATES["stage_contention"]
        (jf, jo), (tf, to) = (pkg.features_loo_calibrated(r, *feats)
                              for pkg, r in ((jval, jr), (tval, tr)))
    elif fit == "select_loo":
        (jf, jo), (tf, to) = (pkg.select_loo_calibrated(r)
                              for pkg, r in ((jval, jr), (tval, tr)))
    else:
        frozen, _ = jval.select_loo_calibrated(_reports(jval, 8))
        jf = tf = frozen
        jo, to = jval.apply_frozen_fit(frozen, jr), tval.apply_frozen_fit(frozen, tr)
    # the same numpy arithmetic on the same numbers: equal, not close
    assert tf == jf
    assert [r.to_json_dict() for r in to] == [r.to_json_dict() for r in jo]
