"""The port's LLaMA family (metis_tpu_torch.models.llama) against
metis_tpu.models.llama on the same weights: the JAX tree converts leaf for
leaf (``models.convert``), the tokens come from numpy, both run in fp32 on
the CPU; with ``attn="flash"`` JAX runs its Pallas kernels in interpret mode
and the port its kernels' plain versions.  Grouped-query attention at MHA,
2 and 1 KV heads (of 4 query heads).

Tolerance: 1e-4 relative and 2e-5 absolute (summation order differs
between the frameworks), the leaves after three AdamW steps included (see
``test_three_step_trajectory_matches_jax``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metis_tpu.core.config import ModelSpec as JModelSpec
from metis_tpu.execution import mesh as jmesh
from metis_tpu.execution import train as jtrain
from metis_tpu.models import config_for_model_spec as jconfig_for
from metis_tpu.models import llama as jllama
from metis_tpu_torch.core.config import ModelSpec
from metis_tpu_torch.core.types import UniformPlan
from metis_tpu_torch.execution import mesh as tmesh
from metis_tpu_torch.execution.builder import build_executable
from metis_tpu_torch.models import config_for_model_spec, convert, param_count
from metis_tpu_torch.models import llama as tllama

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=2e-5)
SHAPE = dict(vocab_size=128, seq_len=32, hidden=64, num_heads=4, num_blocks=2)
KV_HEADS = [4, 2, 1]


def _setup(attn, kvh):
    jcfg = jllama.LlamaConfig(**SHAPE, num_kv_heads=kvh, dtype=jnp.float32, attn=attn)
    tcfg = tllama.LlamaConfig(**SHAPE, num_kv_heads=kvh, dtype=torch.float32, attn=attn)
    jparams = jllama.init_llama_params(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, SHAPE["vocab_size"], (2, SHAPE["seq_len"]),
                          dtype=np.int32)
    return jcfg, tcfg, jparams, np_params, tokens, np.roll(tokens, -1, axis=1)


@pytest.mark.parametrize("kvh", KV_HEADS)
def test_conversion_keeps_the_layout(kvh):
    _, tcfg, jparams, np_params, _, _ = _setup("dense", kvh)
    tparams = convert.from_numpy_tree(np_params, device="cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(jleaves) == sum(len(sub) for sub in tparams.values()) == 11
    for path, leaf in jleaves:
        keys = [p.key for p in path]
        np.testing.assert_array_equal(tparams[keys[0]][keys[1]].numpy(),
                                      np.asarray(leaf))
    assert tparams["blocks"]["wkv"].shape == (2, 2, 64, kvh * 16)
    ours = tllama.init_llama_params(torch.Generator().manual_seed(0), tcfg,
                                    device="cpu")
    assert {g: {n: tuple(v.shape) for n, v in sub.items()} for g, sub in ours.items()} \
        == {g: {n: tuple(v.shape) for n, v in sub.items()} for g, sub in tparams.items()}
    assert param_count(ours) == sum(np.asarray(x).size for x in jax.tree.leaves(jparams))


def test_full_width_parameter_count():
    """The LLaMA cell (1.5B preset widths, 8 KV heads): 2.366 B parameters."""
    cfg = tllama.LlamaConfig(vocab_size=51200, seq_len=1024, hidden=4096,
                             num_heads=32, num_blocks=8, num_kv_heads=8)
    h, f, v, L = 4096, 4 * 4096, 51200, 8
    per_block = 2 * h + h * h + 2 * h * 8 * 128 + h * h + 3 * h * f
    assert cfg.kv_heads == 8 and cfg.head_dim == 128
    assert 2 * v * h + h + L * per_block == 2_365_657_088


@pytest.mark.parametrize("kvh", KV_HEADS)
@pytest.mark.parametrize("attn", ["flash", "dense"])
def test_logits_match(attn, kvh):
    jcfg, tcfg, jparams, np_params, tokens, _ = _setup(attn, kvh)
    want = jllama.llama_forward(jparams, jnp.asarray(tokens), jcfg)
    got = tllama.llama_forward(convert.from_numpy_tree(np_params, device="cpu"),
                               torch.from_numpy(tokens), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kvh", KV_HEADS)
@pytest.mark.parametrize("attn", ["flash", "dense"])
def test_loss_and_grads_match(attn, kvh):
    jcfg, tcfg, jparams, np_params, tokens, targets = _setup(attn, kvh)
    want, jgrads = jax.value_and_grad(jllama.llama_next_token_loss)(
        jparams, jnp.asarray(tokens), jnp.asarray(targets), jcfg)
    leaves = {g: {n: v.requires_grad_() for n, v in sub.items()}
              for g, sub in convert.from_numpy_tree(np_params, device="cpu").items()}
    loss = tllama.llama_next_token_loss(leaves, torch.from_numpy(tokens),
                                        torch.from_numpy(targets), tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    for g, sub in leaves.items():
        for n, t in sub.items():
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrads[g][n]),
                                       **TOL, err_msg=f"{g}.{n}")


@pytest.mark.parametrize("offset", [0, 5])
def test_rope_and_rms_norm_match(offset):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 8, 16)).astype(np.float32) * 3.0
    np.testing.assert_allclose(
        tllama.rope(torch.from_numpy(x), 10000.0, offset).numpy(),
        np.asarray(jllama.rope(jnp.asarray(x), 10000.0, offset)), **TOL)
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        tllama.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jllama.rms_norm(jnp.asarray(x), jnp.asarray(scale))), **TOL)
    # bf16 in, bf16 out, computed in fp32 (the reference's cast back)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tllama.rms_norm(xb, torch.from_numpy(scale)).dtype == torch.bfloat16
    assert tllama.rope(xb, 10000.0, offset).dtype == torch.bfloat16


@pytest.mark.parametrize("kvh", [4, 1])
@pytest.mark.parametrize("attn", ["flash", "dense"])
def test_three_step_trajectory_matches_jax(attn, kvh):
    jcfg, tcfg, jparams, np_params, _, _ = _setup(attn, kvh)
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
    tstate = exe.init(np_params)
    for b in batches:
        jstate, jloss = jstep(jstate, jnp.asarray(b[:, :-1]), jnp.asarray(b[:, 1:]))
        tstate, tloss = exe.step(tstate, torch.from_numpy(b[:, :-1]),
                                 torch.from_numpy(b[:, 1:]))
        np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    # every leaf at the file's tolerance: AdamW moves each element by ~lr
    # (1e-4) a step, except where the gradient is near eps (1e-8), where a
    # 1e-4 relative difference of the gradient moves the update by a few
    # 1e-6 (one element of w_gate in this run)
    for g, sub in tstate.params.items():
        for n, t in sub.items():
            np.testing.assert_allclose(t.detach().numpy(),
                                       np.asarray(jstate.params[g][n]),
                                       **TOL, err_msg=f"{g}.{n}")


def test_config_for_model_spec_dispatches_like_jax():
    spec = dict(name="m", num_layers=4, hidden_size=64, sequence_length=32,
                vocab_size=128, num_heads=4, family="llama", num_kv_heads=2,
                attn="flash")
    got = config_for_model_spec(ModelSpec(**spec))
    want = jconfig_for(JModelSpec(**spec))
    assert isinstance(got, tllama.LlamaConfig)
    assert (got.kv_heads, got.num_blocks, got.rope_theta, got.attn) == \
        (want.kv_heads, want.num_blocks, want.rope_theta, want.attn)
    with pytest.raises(ValueError, match="must divide"):
        tllama.LlamaConfig(**SHAPE, num_kv_heads=3)


def test_kv_spec_rule_matches_jax():
    """``wkv`` splits over tp only when the KV heads do."""
    for kvh, tp in ((4, 2), (2, 2), (1, 2), (2, 4), (8, 4)):
        tcfg = tllama.LlamaConfig(**{**SHAPE, "num_heads": 8}, num_kv_heads=kvh)
        jcfg = jllama.LlamaConfig(**{**SHAPE, "num_heads": 8}, num_kv_heads=kvh)
        got = tmesh.llama_param_specs(tcfg, tp_size=tp)
        want = jmesh.llama_param_specs(jcfg, tp_size=tp)
        for group, sub in want.items():
            for name, spec in sub.items():
                assert got[group][name] == tuple(spec), (kvh, tp, name)


def test_pipeline_route_refuses_llama():
    """The reference's pipeline runs GPT blocks only; the port refuses a
    uniform pp > 1 LLaMA plan instead of training another model."""
    tcfg = tllama.LlamaConfig(**{**SHAPE, "num_blocks": 4})
    art = tmesh.PlanArtifact.from_uniform_plan(UniformPlan(1, 2, 1, 2, 4))
    with pytest.raises(NotImplementedError, match="GPT blocks only"):
        build_executable(tcfg, art, device="cpu")
