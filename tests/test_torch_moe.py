"""The port's MoE family (metis_tpu_torch.models.moe) and its expert
parallelism against metis_tpu.models.moe and the JAX package's GSPMD route.

The same numpy parameters and tokens go through both packages in fp32 on
the CPU (JAX's flash kernels in interpret mode, the port's plain kernel
versions).  Routing decisions (each token's experts, its slot in each
expert's buffer, whether it was kept) are compared directly, from a seed
whose router probabilities have no near-ties; the reference's decisions are
the lines of ``metis_tpu.models.moe._route_tokens`` that make them.  The
expert-parallel plans run on four gloo ranks (``execution.dist.spawn``)
against ``make_train_step(dp_axis=(DP, EP))`` on the virtual mesh, as
``tests/test_moe.py`` runs it.

Tolerances: outputs, losses and gradients (the sharded runs' first-step
gradients too) 1e-4 relative / 2e-5 absolute; logits of the sharded runs
1e-4 / 1e-4 and every leaf after three AdamW steps 1e-6 absolute, as
``tests/test_torch_dist.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from metis_tpu.core.config import ModelSpec as JModelSpec
from metis_tpu.execution import mesh as jmesh
from metis_tpu.execution import train as jtrain
from metis_tpu.models import config_for_model_spec as jconfig_for
from metis_tpu.models import moe as jmoe
from metis_tpu_torch.core.config import ModelSpec
from metis_tpu_torch.core.sharding import slice_leaf
from metis_tpu_torch.core.types import UniformPlan
from metis_tpu_torch.execution import dist as tdist
from metis_tpu_torch.execution import hetero as thetero
from metis_tpu_torch.execution import mesh as tmesh
from metis_tpu_torch.execution import train as ttrain
from metis_tpu_torch.execution.builder import build_executable
from metis_tpu_torch.models import config_for_model_spec, convert
from metis_tpu_torch.models import moe as tmoe
from metis_tpu_torch.testing import run_plans_rank

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=2e-5)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
SHAPE = dict(vocab_size=128, seq_len=16, hidden=32, num_heads=2, num_blocks=2,
             ffn_multiplier=2, num_experts=4, top_k=2, route_group_size=16)
GBS, STEPS = 8, 3


def _cfgs(attn="dense", **kw):
    shape = {**SHAPE, **kw}
    return (jmoe.MoEConfig(**shape, dtype=jnp.float32, attn=attn),
            tmoe.MoEConfig(**shape, dtype=torch.float32, attn=attn))


@pytest.fixture(scope="module")
def params():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, jmoe.init_moe_params(jax.random.PRNGKey(0), jcfg))


def _batches():
    rng = np.random.default_rng(0)
    return [rng.integers(0, SHAPE["vocab_size"], (GBS, SHAPE["seq_len"] + 1),
                         dtype=np.int32) for _ in range(STEPS)]


def test_capacity_and_group_length_match_jax():
    jcfg, tcfg = _cfgs()
    for tokens in (1, 7, 16, 64, 100, 4096):
        assert tmoe.expert_capacity(tcfg, tokens) == jmoe.expert_capacity(jcfg, tokens)
    for tokens, target in ((128, 16), (96, 40), (4096, 4096), (8192, 4096),
                           (6000, 4096), (7, 4), (13, 4)):
        assert tmoe._route_group_len(tokens, target) == \
            jmoe._route_group_len(tokens, target)
    # the 1.5B MoE cell: one group of 4096 tokens, 1280 slots per expert
    big = tmoe.MoEConfig(vocab_size=51200, seq_len=1024, hidden=4096,
                         num_heads=32, num_blocks=2)
    assert tmoe._route_group_len(4 * 1024, big.route_group_size) == 4096
    assert tmoe.expert_capacity(big, 4096) == 1280


def _jax_decisions(tokens, router, cfg):
    """The routing decisions of ``metis_tpu.models.moe._route_tokens`` for
    one group (its own lines up to the capacity drop)."""
    T = tokens.shape[0]
    E, k = cfg.num_experts, cfg.top_k
    C = jmoe.expert_capacity(cfg, T)
    probs = jax.nn.softmax(tokens @ router, axis=-1)
    _, expert_idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(expert_idx, E, dtype=jnp.float32)
    flat = onehot.transpose(1, 0, 2).reshape(k * T, E)
    pos_flat = jnp.cumsum(flat, axis=0) - flat
    position = (pos_flat.reshape(k, T, E) * onehot.transpose(1, 0, 2)) \
        .sum(-1).transpose(1, 0).astype(jnp.int32)
    return (np.asarray(probs), np.asarray(expert_idx), np.asarray(position),
            np.asarray(position < C))


def test_routing_decisions_match_jax(params):
    jcfg, tcfg = _cfgs(capacity_factor=0.75)  # tight: some choices drop
    router = params["blocks"]["router"][0]
    x = np.random.default_rng(3).standard_normal((4, 16, 32)).astype(np.float32)
    groups = x.reshape(-1, 16, 32)
    got = tmoe.route(torch.from_numpy(groups), torch.from_numpy(router.copy()),
                     tcfg)
    dropped = 0
    for g in range(groups.shape[0]):
        probs, idx, pos, keep = _jax_decisions(jnp.asarray(groups[g]),
                                               jnp.asarray(router), jcfg)
        # a seed without near-ties, so both top-k orders are defined
        top = np.sort(probs, -1)[:, ::-1]
        assert np.min(top[:, :2] - top[:, 1:3]) > 1e-4
        np.testing.assert_array_equal(got["expert_idx"][g].numpy(), idx)
        np.testing.assert_array_equal(got["position"][g].numpy(), pos)
        np.testing.assert_array_equal(got["keep"][g].numpy(), keep)
        dropped += int((~keep).sum())
    assert dropped > 0


FFN_LEAVES = ("router", "expert_in", "expert_in_bias", "expert_out",
              "expert_out_bias")


def _layer(params, i=0):
    """Block i's router and experts (``moe_ffn``'s leaves)."""
    return {k: params["blocks"][k][i] for k in FFN_LEAVES}


@pytest.mark.parametrize("mask", ["none", "rows", "tokens"])
def test_ffn_outputs_aux_and_grads_match_jax(params, mask):
    """``moe_ffn`` with and without ``valid_mask`` (per row, per token):
    output, aux loss, and the gradients of the layer's leaves and input."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16, 32)).astype(np.float32)
    dy = rng.standard_normal((4, 16, 32)).astype(np.float32)
    valid = {"none": None, "rows": np.array([1, 1, 0, 1], np.float32),
             "tokens": (rng.random((4, 16)) > 0.3).astype(np.float32)}[mask]
    layer = _layer(params)

    def jfn(lyr, xx):
        out, aux = jmoe.moe_ffn(xx, lyr, jcfg,
                                valid_mask=None if valid is None else jnp.asarray(valid))
        return (out * dy).sum() + aux, (out, aux)

    (_, (jout, jaux)), jgrads = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, layer), jnp.asarray(x))
    tl = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in layer.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = tmoe.moe_ffn(tx, tl, tcfg, valid_mask=None if valid is None
                            else torch.from_numpy(valid))
    ((out * torch.from_numpy(dy)).sum() + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)
    for name, t in tl.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrads[0][name]),
                                   **TOL, err_msg=name)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrads[1]), **TOL)


@pytest.mark.parametrize("attn", ["flash", "dense"])
def test_loss_and_grads_match_jax(params, attn):
    jcfg, tcfg = _cfgs(attn)
    tokens = _batches()[0]
    tok, tgt = tokens[:, :-1], tokens[:, 1:]
    want, jgrads = jax.value_and_grad(jmoe.moe_next_token_loss)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tok), jnp.asarray(tgt), jcfg)
    jlogits, jaux = jmoe.moe_forward(jax.tree.map(jnp.asarray, params),
                                     jnp.asarray(tok), jcfg)
    leaves = {g: {n: v.requires_grad_() for n, v in sub.items()}
              for g, sub in convert.from_numpy_tree(params, device="cpu").items()}
    logits, aux = tmoe.moe_forward(leaves, torch.from_numpy(tok), tcfg)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)
    loss = tmoe.moe_next_token_loss(leaves, torch.from_numpy(tok),
                                    torch.from_numpy(tgt), tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    for g, sub in leaves.items():
        for n, t in sub.items():
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrads[g][n]),
                                       **TOL, err_msg=f"{g}.{n}")


def test_conversion_layout_and_init(params):
    _, tcfg = _cfgs()
    tparams = convert.from_numpy_tree(params, device="cpu")
    ours = tmoe.init_moe_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert {g: {n: tuple(v.shape) for n, v in sub.items()} for g, sub in ours.items()} \
        == {g: {n: tuple(v.shape) for n, v in sub.items()} for g, sub in tparams.items()}
    assert tparams["blocks"]["expert_in"].shape == (2, 4, 32, 64)
    specs = tmesh.moe_param_specs(tcfg)
    assert tmesh.expert_leaves(specs) == {
        ("blocks", n) for n in ("expert_in", "expert_in_bias", "expert_out",
                                "expert_out_bias")}
    # a rank's slices of the JAX tree are its block of each leaf
    slots = {"ep": (1, 2), "tp": (0, 2)}
    mine = convert.from_numpy_tree(params, device="cpu", specs=specs, slots=slots)
    np.testing.assert_array_equal(mine["blocks"]["expert_in"].numpy(),
                                  params["blocks"]["expert_in"][:, 2:, :, :32])
    np.testing.assert_array_equal(mine["blocks"]["expert_out_bias"].numpy(),
                                  params["blocks"]["expert_out_bias"][:, 2:])


@pytest.mark.parametrize("attn", ["flash", "dense"])
def test_three_step_trajectory_matches_jax(params, attn):
    jcfg, tcfg = _cfgs(attn)
    mesh = jmesh.mesh_dp_tp(1, 1, jax.devices()[:1])
    opt = jtrain.build_optimizer()
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jtrain.TrainState(params=jp, opt_state=opt.init(jp),
                               step=jnp.zeros((), jnp.int32))
    jstep = jtrain.make_train_step(jcfg, mesh, optimizer=opt)
    exe = build_executable(
        tcfg, tmesh.PlanArtifact.from_uniform_plan(UniformPlan(1, 1, 1, GBS, GBS)),
        device="cpu")
    assert exe.kind == "single_device"
    tstate = exe.init(params)
    for b in _batches():
        jstate, jloss = jstep(jstate, jnp.asarray(b[:, :-1]), jnp.asarray(b[:, 1:]))
        tstate, tloss = exe.step(tstate, torch.from_numpy(b[:, :-1]),
                                 torch.from_numpy(b[:, 1:]))
        np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    for g, sub in tstate.params.items():
        for n, t in sub.items():
            np.testing.assert_allclose(t.detach().numpy(),
                                       np.asarray(jstate.params[g][n]),
                                       rtol=0, atol=1e-6, err_msg=f"{g}.{n}")


# -- expert parallelism on gloo ranks ------------------------------------------

EP_CASES = [(2, 2, 1), (1, 2, 2)]  # (dp, ep, tp)


def _ep_artifact(dp, ep, tp):
    return tmesh.PlanArtifact(
        mesh_axes=("pp", "dp", "ep", "sp", "tp"), mesh_shape=(1, dp, ep, 1, tp),
        layer_partition=(0, SHAPE["num_blocks"] + 2),
        strategies=({"dp": dp * ep, "tp": tp, "cp": 1, "ep": ep, "zero": 0,
                     "sp": False},), gbs=GBS, microbatches=1)


def _jax_first_grads(jcfg, mesh, specs, params, batch, **step_kw):
    """The gradients the reference's GSPMD step applies on its first batch:
    one SGD step at learning rate 1 takes exactly the gradient off each
    leaf (AdamW's update would hide a gradient's scale)."""
    sharded = jmesh.shard_params(params, mesh, specs)
    opt = optax.sgd(1.0)
    state = jtrain.TrainState(params=sharded, opt_state=opt.init(sharded),
                              step=jnp.zeros((), jnp.int32))
    step = jtrain.make_train_step(jcfg, mesh, optimizer=opt, **step_kw)
    state, _ = step(state, jnp.asarray(batch[:, :-1]), jnp.asarray(batch[:, 1:]))
    return jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), params,
                        state.params)


def _jax_ep_run(params, batches, dp, ep, tp):
    jcfg, _ = _cfgs()
    devs = np.array(jax.devices()[:dp * ep * tp]).reshape(dp, ep, tp)
    mesh = Mesh(devs, (jmesh.DP, jmesh.EP, jmesh.TP))
    grads = _jax_first_grads(jcfg, mesh, jmesh.moe_param_specs(jcfg), params,
                             batches[0], dp_axis=(jmesh.DP, jmesh.EP))
    sharded = jmesh.shard_params(params, mesh, jmesh.moe_param_specs(jcfg))
    with mesh:
        logits, _ = jax.jit(lambda p, t: jmoe.moe_forward(p, t, jcfg))(
            sharded, jnp.asarray(batches[0][:, :-1]))
    opt = jtrain.build_optimizer()
    state = jtrain.TrainState(params=sharded, opt_state=opt.init(sharded),
                              step=jnp.zeros((), jnp.int32))
    step = jtrain.make_train_step(jcfg, mesh, optimizer=opt,
                                  dp_axis=(jmesh.DP, jmesh.EP))
    losses = []
    for b in batches:
        state, loss = step(state, jnp.asarray(b[:, :-1]), jnp.asarray(b[:, 1:]))
        losses.append(float(loss))
    return (np.asarray(logits), losses, jax.tree.map(np.asarray, state.params),
            grads)


@pytest.fixture(scope="module", params=EP_CASES,
                ids=[f"dp{d}_ep{e}_tp{t}" for d, e, t in EP_CASES])
def ep_case(request, params):
    dp, ep, tp = request.param
    _, tcfg = _cfgs()
    batches = _batches()
    host = [(torch.from_numpy(b[:, :-1]), torch.from_numpy(b[:, 1:])) for b in batches]
    ranks = tdist.spawn(run_plans_rank, 4, "gloo", ["cpu"] * 4, [dict(
        artifact_json=_ep_artifact(dp, ep, tp).to_json(), cfg=tcfg, init=params,
        batches=host, forward_tokens=host[0][0], return_params=True,
        first_grads="arrays")])
    return _jax_ep_run(params, batches, dp, ep, tp), [r[0] for r in ranks]


def test_ep_logits_and_losses_match_jax(ep_case):
    (jlogits, jlosses, _, _), ranks = ep_case
    assert {r["kind"] for r in ranks} == {"gspmd"}
    for r in ranks:
        want = slice_leaf(jlogits, (("dp", "ep"), None, "tp"), r["slots"])
        np.testing.assert_allclose(r["logits"], want, **LOGITS_TOL)
        np.testing.assert_allclose(r["losses"], jlosses, **TOL)


def test_ep_every_leaf_after_three_steps_matches_jax(ep_case):
    """Each rank's block of every leaf: its experts' (scaled 1 / (dp ep)
    after the dp sum) and the dense leaves (the dp x ep mean)."""
    (_, _, jparams, _), ranks = ep_case
    specs = tmesh.moe_param_specs(_cfgs()[1])
    for r in ranks:
        for group, sub in r["params"].items():
            for name, got in sub.items():
                want = slice_leaf(jparams[group][name], specs[group][name], r["slots"])
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                           err_msg=f"{group}.{name} {r['slots']}")


def test_ep_first_gradients_match_jax(ep_case):
    """Each rank's block of every leaf's gradient at the first optimizer
    step, against the reference's GSPMD gradient: the expert leaves' dp sum
    and 1 / (dp ep) scale, the dense leaves' dp x ep mean, and (at tp 2)
    the tp reductions.  AdamW's first update is nearly blind to a
    gradient's scale, so the trajectory test above cannot see these."""
    (_, _, _, jgrads), ranks = ep_case
    specs = tmesh.moe_param_specs(_cfgs()[1])
    for r in ranks:
        assert r["grads"].keys() == r["params"].keys()
        for group, sub in r["grads"].items():
            for name, got in sub.items():
                want = slice_leaf(jgrads[group][name], specs[group][name], r["slots"])
                np.testing.assert_allclose(got, want, **TOL,
                                           err_msg=f"{group}.{name} {r['slots']}")


def test_misaligned_routing_groups_raise():
    """Routing groups are those of the whole batch; rows whose tokens do
    not hold whole groups no longer raise: they share their groups with
    the ranks that hold the rest (``tests/test_torch_moe_routing.py``
    holds the shared routing against the reference)."""
    _, tcfg = _cfgs(route_group_size=48)  # 128 tokens -> groups of 32
    cfg, local = ttrain.aligned_routing(tcfg, 128, 64)  # 2 ranks' 64 tokens
    assert (cfg.route_group_size, local) == (32, True)
    cfg, local = ttrain.aligned_routing(tcfg, 128, 16)  # 8 ranks' 16 tokens
    assert (cfg.route_group_size, local) == (32, False)
    assert ttrain.aligned_routing(tcfg, 128, 32) == (cfg, True)


def test_ep_on_a_dense_config_and_on_stage_routes_raise():
    from metis_tpu_torch.models.gpt import GPTConfig

    dense = GPTConfig(**{k: SHAPE[k] for k in ("vocab_size", "seq_len", "hidden",
                                               "num_heads", "num_blocks")})
    art = _ep_artifact(1, 2, 1)
    with pytest.raises(ValueError, match="needs an MoE config"):
        build_executable(dense, art, device="cpu")
    # ep on stages runs on the hetero route (tests/test_torch_stage_axes.py),
    # whose four ranks need the launcher; an ep that does not divide the
    # experts raises as in the reference
    from metis_tpu_torch.core.errors import MetisError

    _, tcfg = _cfgs()
    staged = dataclasses.replace(art, mesh_shape=(2, 1, 2, 1, 1), layer_partition=())
    with pytest.raises(MetisError, match="launcher"):
        build_executable(tcfg, staged, device="cpu")
    _, three = _cfgs(num_experts=3)
    with pytest.raises(ValueError, match="must divide"):
        build_executable(three, staged, device="cpu")


def test_pipeline_and_hetero_routes_refuse_moe():
    """The pipeline route runs GPT blocks only, as the reference's; the
    hetero route runs MoE but refuses it with cp, as the reference's."""
    _, tcfg = _cfgs()
    pipe = tmesh.PlanArtifact.from_uniform_plan(UniformPlan(1, 2, 1, 4, GBS))
    with pytest.raises(NotImplementedError, match="GPT blocks only"):
        build_executable(tcfg, pipe, device="cpu")
    with pytest.raises(NotImplementedError, match="cp\\+MoE"):
        thetero.make_hetero_train_step(
            tcfg, [thetero.StageSpec((0, 2), True, True, dp=1, tp=1, cp=2)],
            device="cpu")


def test_config_for_model_spec_dispatches_like_jax():
    spec = dict(name="m", num_layers=4, hidden_size=32, sequence_length=16,
                vocab_size=128, num_heads=2, num_experts=4, expert_top_k=2)
    got = config_for_model_spec(ModelSpec(**spec))
    want = jconfig_for(JModelSpec(**spec))
    assert isinstance(got, tmoe.MoEConfig)
    assert (got.num_experts, got.top_k, got.num_blocks, got.route_group_size) == \
        (want.num_experts, want.top_k, want.num_blocks, want.route_group_size)
    with pytest.raises(NotImplementedError, match="GPT-family only"):
        config_for_model_spec(ModelSpec(**spec, family="llama"))
