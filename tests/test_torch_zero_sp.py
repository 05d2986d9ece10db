"""Megatron sequence parallelism and ZeRO 1-3 of the port against the JAX
package's GSPMD route, and the routing of plans that use them.

The same seeded numpy parameters and tokens go through the reference's
``build_train_state(zero=...)`` / ``make_train_step(megatron_sp=...)`` on
its virtual CPU mesh and through ``build_executable``'s gspmd route on
gloo ranks.  For every plan: each rank's logits, the three losses, the
first step's gradient of every leaf (what the optimizer applies: at ZeRO 1
and 2 the rank's chunk, at ZeRO 3 its shard) and every leaf after three
steps.  fp32; tolerance 1e-4 relative / 2e-5 absolute (logits 1e-4 /
1e-4).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metis_tpu.models import gpt as jgpt
from metis_tpu.models import llama as jllama
from metis_tpu.models import moe as jmoe
from metis_tpu_torch.core.sharding import slice_leaf
from metis_tpu_torch.core.types import UniformPlan
from metis_tpu_torch.execution import dist as tdist
from metis_tpu_torch.execution import mesh as tmesh
from metis_tpu_torch.execution.builder import build_executable, plan_route
from metis_tpu_torch.models import gpt as tgpt
from metis_tpu_torch.models import llama as tllama
from metis_tpu_torch.models import moe as tmoe
from metis_tpu_torch.testing import run_plans_rank
from torch_gspmd_reference import (
    expected,
    port_plan,
    reference_run,
    reference_start,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=2e-5)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
SHAPE = dict(vocab_size=128, seq_len=32, hidden=64, num_heads=4, num_blocks=2,
             ffn_multiplier=2)
MOE_SHAPE = dict(vocab_size=128, seq_len=16, hidden=32, num_heads=2,
                 num_blocks=2, ffn_multiplier=2, num_experts=4, top_k=2,
                 route_group_size=16)
GBS, STEPS = 8, 3
PLANS = {"tp2_sp": dict(tp=2, sp=True), "dp2_zero1": dict(dp=2, zero=1),
         "dp2_zero2": dict(dp=2, zero=2), "dp2_zero3": dict(dp=2, zero=3),
         "dp2_tp2_zero3": dict(dp=2, tp=2, zero=3)}
FAMILIES = {
    "gpt": (jgpt.GPTConfig, tgpt.GPTConfig, SHAPE),
    "llama": (jllama.LlamaConfig, tllama.LlamaConfig,
              dict(SHAPE, num_kv_heads=2)),
    "moe": (jmoe.MoEConfig, tmoe.MoEConfig, MOE_SHAPE),
}
CASES = [(fam, name) for fam in ("gpt", "llama") for name in PLANS]
CASES.append(("moe", "dp2_zero1"))


def _batches(shape):
    rng = np.random.default_rng(0)
    return [rng.integers(0, shape["vocab_size"], (GBS, shape["seq_len"] + 1),
                         dtype=np.int32) for _ in range(STEPS)]


@pytest.fixture(scope="module")
def trained():
    """Every case: the reference's run and the port's ranks, one launch per
    world size."""
    refs, jobs, starts, runs = {}, {}, {}, {}
    for fam, name in CASES:
        jcls, tcls, shape = FAMILIES[fam]
        jcfg = jcls(**shape, dtype=jnp.float32)
        tcfg = tcls(**shape, dtype=torch.float32)
        batches = _batches(shape)
        if fam not in starts:
            starts[fam] = reference_start(jcfg, batches[0])
        plan = PLANS[name]
        # the reference's build_train_state runs ZeRO 1 and 2 alike
        run = (fam, *sorted(dict(plan, zero=min(plan.get("zero", 0), 1)).items()))
        if run not in runs:
            runs[run] = reference_run(jcfg, batches, **plan)
        refs[fam, name] = (tcfg, {**starts[fam], **runs[run]})
        host = [(torch.from_numpy(b[:, :-1]), torch.from_numpy(b[:, 1:]))
                for b in batches]
        world = plan.get("dp", 1) * plan.get("tp", 1)
        jobs.setdefault(world, []).append(((fam, name), dict(
            artifact_json=port_plan(gbs=GBS, **plan), cfg=tcfg,
            init=starts[fam]["params"], batches=host, forward_tokens=host[0][0],
            return_params=True, first_grads="arrays")))
    out = {}
    for world, items in jobs.items():
        ranks = tdist.spawn(run_plans_rank, world, "gloo", ["cpu"] * world,
                            [job for _, job in items])
        for i, (key, _) in enumerate(items):
            out[key] = [r[i] for r in ranks]
    return refs, out


def _specs(tcfg, tp):
    if isinstance(tcfg, tllama.LlamaConfig):
        return tmesh.llama_param_specs(tcfg, tp_size=tp)
    if isinstance(tcfg, tmoe.MoEConfig):
        return tmesh.moe_param_specs(tcfg)
    return tmesh.gpt_param_specs(tcfg)


@pytest.mark.parametrize("fam,name", CASES)
def test_logits_and_losses_match_jax(trained, fam, name):
    refs, out = trained
    _, ref = refs[fam, name]
    for r in out[fam, name]:
        assert r["kind"] == "gspmd"
        np.testing.assert_allclose(
            r["logits"], slice_leaf(ref["logits"], ("dp", None, "tp"), r["slots"]),
            **LOGITS_TOL, err_msg=f"{fam} {name} {r['slots']}")
        np.testing.assert_allclose(r["losses"], ref["losses"], **TOL)


@pytest.mark.parametrize("fam,name", CASES)
def test_first_gradients_match_jax(trained, fam, name):
    """The gradient the first optimizer step applies to each leaf: under sp
    the norms' and row-parallel biases' summed over tp (each tp rank sees
    its block of the sequence), at ZeRO 1 and 2 the rank's chunk of the
    dp-reduced gradient, at ZeRO 3 its reduce-scattered shard.  AdamW's
    first update is nearly blind to a gradient's scale, so the trajectory
    tests cannot see a gradient off by a factor of tp."""
    refs, out = trained
    tcfg, ref = refs[fam, name]
    plan = PLANS[name]
    specs = _specs(tcfg, plan.get("tp", 1))
    for r in out[fam, name]:
        assert r["grads"].keys() == ref["grads"].keys()
        for group, sub in r["grads"].items():
            for leaf, got in sub.items():
                want = expected(ref["grads"][group][leaf], specs[group][leaf], r,
                                (group, leaf), plan.get("zero", 0), grad=True)
                np.testing.assert_allclose(
                    got, want, **TOL, err_msg=f"{fam} {name} {group}.{leaf} {r['slots']}")


@pytest.mark.parametrize("fam,name", CASES)
def test_every_leaf_after_three_steps_matches_jax(trained, fam, name):
    """Each rank's stored leaves after three AdamW steps: whole leaves at
    ZeRO 1 and 2 (rebuilt from the ranks' chunks), shards at ZeRO 3."""
    refs, out = trained
    tcfg, ref = refs[fam, name]
    plan = PLANS[name]
    specs = _specs(tcfg, plan.get("tp", 1))
    for r in out[fam, name]:
        for group, sub in r["params"].items():
            for leaf, got in sub.items():
                want = expected(ref["final"][group][leaf], specs[group][leaf], r,
                                (group, leaf), plan.get("zero", 0))
                np.testing.assert_allclose(
                    got, want, **TOL, err_msg=f"{fam} {name} {group}.{leaf} {r['slots']}")


def test_zero_splits_what_the_reference_rule_wraps(trained):
    """ZeRO splits each leaf of two or more dims along its largest dim left
    whole by tp that divides by dp (``fsdp_wrap_specs``); 1-D leaves stay
    whole.  At ZeRO 3 a rank stores half of each split leaf."""
    refs, out = trained
    for name in ("dp2_zero1", "dp2_zero3", "dp2_tp2_zero3"):
        _, ref = refs["gpt", name]
        r = out["gpt", name][0]
        dims = r["zero_dims"]
        # embed.tok [v, h] and blocks.mlp_in [L, h, f]: the dims the tp spec
        # names (the vocabulary, the ffn) are tp's even at tp 1, as in the
        # reference, so the hidden dims take dp
        assert (dims[("embed", "tok")], dims[("blocks", "mlp_in")]) == (1, 1)
        assert dims[("head", "ln_scale")] is None   # 1-D
        if PLANS[name]["zero"] == 3:
            tp = PLANS[name].get("tp", 1)
            full = ref["params"]["blocks"]["qkv"]
            assert r["params"]["blocks"]["qkv"].size == full.size // (2 * tp)


# -- routing and refusals ---------------------------------------------------------

def _cfg():
    return tgpt.GPTConfig(**SHAPE, dtype=torch.float32)


@pytest.mark.parametrize("axes", [dict(cp=2), dict(cp=2, cp_mode="a2a"),
                                  dict(tp=2, sp=True), dict(dp=2, zero=1),
                                  dict(dp=2, zero=3)],
                         ids=("cp_ring", "cp_a2a", "sp", "zero1", "zero3"))
def test_pp1_plans_route_to_gspmd(axes):
    art = tmesh.PlanArtifact.from_json(port_plan(gbs=GBS, **axes))
    assert plan_route(_cfg(), art) == "gspmd"


@pytest.mark.parametrize("axes", [{"cp": 2}, {"zero": 1}, {"sp": True, "tp": 2}],
                         ids=("cp2", "zero1", "sp"))
def test_pp2_plans_go_to_the_hetero_route_and_raise(axes):
    """A uniform pp 2 plan with any of these axes takes the hetero route,
    as in the reference, which runs them (``tests/test_torch_stage_axes.py``);
    outside a process group its ranks raise for the launcher."""
    from metis_tpu_torch.core.errors import MetisError

    art = tmesh.PlanArtifact.from_uniform_plan(UniformPlan(1, 2, 1, 4, GBS))
    art = dataclasses.replace(art, strategies=({"dp": 1, "tp": 1, **axes},))
    assert plan_route(_cfg(), art) == "hetero"
    with pytest.raises(MetisError, match="launcher"):
        build_executable(_cfg(), art, device="cpu")


@pytest.mark.parametrize("axes", [dict(cp=2), dict(tp=2, sp=True)],
                         ids=("cp", "sp"))
def test_moe_with_cp_or_sp_raises(axes):
    """MoE with cp or sp takes the gspmd route, as in the reference, which
    trains it (``tests/test_torch_moe_routing.py``); outside a process
    group its ranks raise only for the launcher."""
    from metis_tpu_torch.core.errors import MetisError

    cfg = tmoe.MoEConfig(**MOE_SHAPE, dtype=torch.float32)
    art = tmesh.PlanArtifact.from_json(port_plan(gbs=GBS, **axes))
    assert plan_route(cfg, art) == "gspmd"
    with pytest.raises(MetisError, match="launcher"):
        build_executable(cfg, art, device="cpu")


def test_validation_measures_a_one_stage_cp_plan_on_the_gspmd_route():
    """``measure_ranked_plan_ms`` keeps the mesh of a one-stage plan with cp,
    sp or ZeRO, so ``build_executable`` runs it on the gspmd route (a
    multi-stage one would take the hetero route, which refuses them)."""
    from metis_tpu_torch.core.config import ModelSpec
    from metis_tpu_torch.core.types import (
        InterStagePlan,
        IntraStagePlan,
        PlanCost,
        RankedPlan,
        Strategy,
    )
    from metis_tpu_torch.validation import measure_ranked_plan_ms

    spec = ModelSpec(name="t", num_layers=4, hidden_size=32, sequence_length=16,
                     vocab_size=64, num_heads=2)
    ranked = RankedPlan(
        inter=InterStagePlan(("CPU",), (2,), batches=1, gbs=2),
        intra=IntraStagePlan((Strategy(dp=1, tp=1, cp=2, zero=1),), (0, 4), (0.0,), 1),
        cost=PlanCost(total_ms=1.0))
    ms = measure_ranked_plan_ms(ranked, spec, device="cpu", devices=["cpu"] * 2,
                                steps=1, warmup=0)
    assert ms > 0 and np.isfinite(ms)


def test_zero3_saves_a_gathered_leaf_for_the_backward_as_its_shard(tmp_path):
    """``ShardGather``'s hooks: a product that saves a gathered leaf (or a
    view of it) keeps the shard instead and re-gathers it in the backward;
    the gradient reaches the shard.  One gloo rank in this process."""
    import torch.distributed as dist

    from metis_tpu_torch.models.parallel import ShardGather

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        gather = ShardGather(dist.group.WORLD)
        packed = []
        pack = gather._pack
        gather._pack = lambda t: packed.append(pack(t)) or packed[-1]
        shard = torch.randn(4, 3, requires_grad=True)
        x = torch.randn(2, 4, requires_grad=True)
        with gather.hooks():
            w = gather(shard, 1, torch.float32)
            loss = (x @ w.t().t()).sum()    # the product saves a view of w
        del w
        loss.backward()
    finally:
        dist.destroy_process_group()
    assert any(not isinstance(p, torch.Tensor) for p in packed)
    torch.testing.assert_close(shard.grad, x.detach().sum(0)[:, None].expand(4, 3))
