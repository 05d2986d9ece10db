"""dp x tp plans of the port over torch.distributed against the JAX
package's GSPMD route.

The same numpy parameters and tokens go through the reference's sharded
forward and train step on its virtual CPU mesh (``mesh_dp_tp``,
``make_train_step``) and through the port's ranks: gloo processes on the
host, joined through a file store (``execution.dist.spawn``), each running
``build_executable``'s ``gspmd`` route on its Megatron shards.  Tolerances:
logits 1e-4 relative and absolute (``tests/test_execution.py``), losses
1e-4 relative / 2e-5 absolute and every leaf after three AdamW steps 1e-6
absolute (``tests/test_torch_train.py``), all in fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metis_tpu.core.config import ModelSpec as JModelSpec
from metis_tpu.execution import mesh as jmesh
from metis_tpu.execution import train as jtrain
from metis_tpu.models import gpt as jgpt
from metis_tpu.models import llama as jllama
from metis_tpu.profiles import profiler as jprof
from metis_tpu.profiles import store as jstore
from metis_tpu_torch.core.config import ModelSpec
from metis_tpu_torch.core.errors import MetisError
from metis_tpu_torch.core.sharding import slice_leaf
from metis_tpu_torch.core.types import UniformPlan
from metis_tpu_torch.execution import dist as tdist
from metis_tpu_torch.execution import mesh as tmesh
from metis_tpu_torch.models import gpt as tgpt
from metis_tpu_torch.models import llama as tllama
from metis_tpu_torch.profiles import profiler as tprof
from metis_tpu_torch.profiles import store as tstore
from metis_tpu_torch.testing import run_plan_rank, run_plans_rank

torch.set_num_threads(1)

SHAPE = dict(vocab_size=256, seq_len=32, hidden=64, num_heads=4, num_blocks=4,
             ffn_multiplier=2)
GBS, STEPS = 8, 3
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-4, atol=2e-5)
CASES = [(1, 2), (2, 1), (2, 2)]


@pytest.fixture(scope="module")
def data():
    jcfg = jgpt.GPTConfig(**SHAPE, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jgpt.init_params(jax.random.PRNGKey(42), jcfg))
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, SHAPE["vocab_size"], (GBS, SHAPE["seq_len"] + 1),
                            dtype=np.int32) for _ in range(STEPS)]
    return jcfg, params, batches


def _jax_run(jcfg, params, batches, dp, tp):
    mesh = jmesh.mesh_dp_tp(dp, tp, jax.devices()[:dp * tp])
    sharded = jmesh.shard_params(params, mesh, jmesh.gpt_param_specs(jcfg))
    logits = jtrain.make_forward(jcfg, mesh)(sharded, jnp.asarray(batches[0][:, :-1]))
    opt = jtrain.build_optimizer()
    state = jtrain.TrainState(params=sharded, opt_state=opt.init(sharded),
                              step=jnp.zeros((), jnp.int32))
    step = jtrain.make_train_step(jcfg, mesh, optimizer=opt)
    losses = []
    for b in batches:
        state, loss = step(state, jnp.asarray(b[:, :-1]), jnp.asarray(b[:, 1:]))
        losses.append(float(loss))
    return (np.asarray(logits), losses,
            jax.tree.map(np.asarray, state.params))


@pytest.fixture(scope="module", params=CASES, ids=[f"dp{d}_tp{t}" for d, t in CASES])
def case(request, data):
    dp, tp = request.param
    jcfg, params, batches = data
    tcfg = tgpt.GPTConfig(**SHAPE, dtype=torch.float32)
    artifact = tmesh.PlanArtifact.from_uniform_plan(UniformPlan(dp, 1, tp, GBS, GBS))
    if dp > 1 and tp > 1:
        # the hetero planner's rectangular layout, (pp, dp, ep, sp, tp)
        artifact = tmesh.PlanArtifact(
            mesh_axes=("pp", "dp", "ep", "sp", "tp"), mesh_shape=(1, dp, 1, 1, tp),
            layer_partition=(0, SHAPE["num_blocks"] + 2),
            strategies=({"dp": dp, "tp": tp, "cp": 1, "ep": 1, "zero": 0,
                         "sp": False},), gbs=GBS, microbatches=1)
    host = [(torch.from_numpy(b[:, :-1]), torch.from_numpy(b[:, 1:])) for b in batches]
    ranks = tdist.spawn(run_plan_rank, dp * tp, "gloo", ["cpu"] * (dp * tp),
                        artifact.to_json(), tcfg, params, host, host[0][0], True)
    return (dp, tp), _jax_run(jcfg, params, batches, dp, tp), ranks


def test_sharded_forward_logits_match_jax(case):
    (dp, tp), (jlogits, _, _), ranks = case
    for r in ranks:
        want = slice_leaf(jlogits, ("dp", None, "tp"), r["slots"])
        np.testing.assert_allclose(r["logits"], want, **LOGITS_TOL)
    assert sum(r["logits"].size for r in ranks) == jlogits.size


def test_three_step_losses_match_jax(case):
    _, (_, jlosses, _), ranks = case
    assert {r["kind"] for r in ranks} == {"gspmd"}
    for r in ranks:  # every rank reports the global batch mean
        np.testing.assert_allclose(r["losses"], jlosses, **TOL)


def test_every_leaf_after_three_steps_matches_jax(case):
    """Each rank's shard of every leaf, replicated leaves (layer norms,
    ``pos``, the row-parallel biases) included on every tp rank."""
    _, (_, _, jparams), ranks = case
    specs = tmesh.gpt_param_specs(tgpt.GPTConfig(**SHAPE))
    for r in ranks:
        for group, sub in r["params"].items():
            for name, got in sub.items():
                want = slice_leaf(jparams[group][name], specs[group][name], r["slots"])
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                           err_msg=f"{group}.{name} {r['slots']}")


# -- LLaMA at tp 2: KV heads sharded and replicated ----------------------------

# (query heads, KV heads): 4 / 2 split over tp; 4 / 1 replicated, both
# ranks' query heads on the one KV head; 12 / 3 replicated, rank 0's six
# query heads on KV heads 0, 0, 0, 0, 1, 1 (uneven groups)
LLAMA_HEADS = [(4, 2), (4, 1), (12, 3)]


@pytest.fixture(scope="module", params=LLAMA_HEADS,
                ids=[f"h{h}_kvh{k}" for h, k in LLAMA_HEADS])
def llama_case(request):
    """tp 2 on two gloo ranks against the reference's GSPMD route on a
    (1, 2) mesh, where ``llama_param_specs`` replicates ``wkv`` when the KV
    heads do not split over tp: each rank then takes the KV heads its query
    heads use from the replicated weight."""
    heads, kvh = request.param
    shape = dict(SHAPE, num_heads=heads, num_kv_heads=kvh,
                 hidden=16 * heads)
    jcfg = jllama.LlamaConfig(**shape, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig(**shape, dtype=torch.float32)
    params = jax.tree.map(np.asarray, jllama.init_llama_params(
        jax.random.PRNGKey(42), jcfg))
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, SHAPE["vocab_size"], (GBS, SHAPE["seq_len"] + 1),
                            dtype=np.int32) for _ in range(STEPS)]
    mesh = jmesh.mesh_dp_tp(1, 2, jax.devices()[:2])
    specs = jmesh.llama_param_specs(jcfg, tp_size=2)
    sharded = jmesh.shard_params(params, mesh, specs)
    with mesh:
        jlogits = jax.jit(lambda p, t: jllama.llama_forward(p, t, jcfg))(
            sharded, jnp.asarray(batches[0][:, :-1]))
    opt = jtrain.build_optimizer()
    state = jtrain.TrainState(params=sharded, opt_state=opt.init(sharded),
                              step=jnp.zeros((), jnp.int32))
    step = jtrain.make_train_step(jcfg, mesh, optimizer=opt)
    jlosses = []
    for b in batches:
        state, loss = step(state, jnp.asarray(b[:, :-1]), jnp.asarray(b[:, 1:]))
        jlosses.append(float(loss))
    # the first step's gradients: one SGD step at learning rate 1 takes
    # exactly the gradient off each leaf
    sgd = optax.sgd(1.0)
    fresh = jmesh.shard_params(params, mesh, specs)
    sgd_state = jtrain.TrainState(params=fresh, opt_state=sgd.init(fresh),
                                  step=jnp.zeros((), jnp.int32))
    sgd_state, _ = jtrain.make_train_step(jcfg, mesh, optimizer=sgd)(
        sgd_state, jnp.asarray(batches[0][:, :-1]), jnp.asarray(batches[0][:, 1:]))
    jgrads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), params,
                          sgd_state.params)
    host = [(torch.from_numpy(b[:, :-1]), torch.from_numpy(b[:, 1:])) for b in batches]
    artifact = tmesh.PlanArtifact.from_uniform_plan(UniformPlan(1, 1, 2, GBS, GBS))
    ranks = tdist.spawn(run_plans_rank, 2, "gloo", ["cpu"] * 2, [dict(
        artifact_json=artifact.to_json(), cfg=tcfg, init=params, batches=host,
        forward_tokens=host[0][0], return_params=True, first_grads="arrays")])
    return tcfg, (np.asarray(jlogits), jlosses,
                  jax.tree.map(np.asarray, state.params), jgrads), [r[0] for r in ranks]


def test_llama_tp2_logits_and_losses_match_jax(llama_case):
    _, (jlogits, jlosses, _, _), ranks = llama_case
    assert {r["kind"] for r in ranks} == {"gspmd"}
    for r in ranks:
        want = slice_leaf(jlogits, ("dp", None, "tp"), r["slots"])
        np.testing.assert_allclose(r["logits"], want, **LOGITS_TOL)
        np.testing.assert_allclose(r["losses"], jlosses, **TOL)


def test_llama_tp2_every_leaf_after_three_steps_matches_jax(llama_case):
    """Each rank's shard of every leaf; a replicated ``wkv`` must be equal
    on both ranks, its gradient summed over their query heads.  At 1e-4
    relative / 2e-5 absolute, not the GPT cases' 1e-6: a SwiGLU weight
    whose gradient is near AdamW's eps moves by a few 1e-6 more or less
    (4 of 147456 elements of w_down at 12 / 3; see
    ``tests/test_torch_llama.py::test_three_step_trajectory_matches_jax``)."""
    tcfg, (_, _, jparams, _), ranks = llama_case
    specs = tmesh.llama_param_specs(tcfg, tp_size=2)
    for r in ranks:
        for group, sub in r["params"].items():
            for name, got in sub.items():
                want = slice_leaf(jparams[group][name], specs[group][name], r["slots"])
                np.testing.assert_allclose(got, want, **TOL,
                                           err_msg=f"{group}.{name} {r['slots']}")


def test_llama_tp2_first_gradients_match_jax(llama_case):
    """Each rank's shard of every leaf's gradient at the first optimizer
    step against the reference's GSPMD gradient: with KV heads replicated,
    ``wkv``'s gradient is the sum over both ranks' query heads
    (``copy_to_tp``), equal on both ranks.  AdamW's first update is nearly
    blind to a gradient's scale, so the trajectory test cannot see a
    gradient summed twice."""
    tcfg, (_, _, _, jgrads), ranks = llama_case
    specs = tmesh.llama_param_specs(tcfg, tp_size=2)
    for r in ranks:
        assert r["grads"].keys() == r["params"].keys()
        for group, sub in r["grads"].items():
            for name, got in sub.items():
                want = slice_leaf(jgrads[group][name], specs[group][name], r["slots"])
                np.testing.assert_allclose(got, want, **TOL,
                                           err_msg=f"{group}.{name} {r['slots']}")


def test_nccl_with_more_ranks_than_cards_raises():
    with pytest.raises(MetisError, match="one card per rank"):
        tdist.spawn(run_plan_rank, 2, "nccl", ["cuda:0", "cuda:0"])
    with pytest.raises(MetisError, match="CUDA devices only"):
        tdist.spawn(run_plan_rank, 2, "nccl", ["cpu", "cpu"])
    with pytest.raises(MetisError, match="2 ranks need 2 devices"):
        tdist.spawn(run_plan_rank, 2, "gloo", ["cpu"])


PROFILE_SPEC = dict(name="tiny", num_layers=4, hidden_size=64, sequence_length=32,
                    vocab_size=128, num_heads=4, attn="flash")


def test_profiler_tp2_on_two_ranks(tmp_path):
    """tp 1 in the calling process and tp 2 on two gloo ranks; the global
    parameter bytes equal the JAX profiler's at tp 2, and the tp-2 JSON
    round-trips through both packages' stores."""
    store = tprof.profile_model(
        ModelSpec(**PROFILE_SPEC), tps=(1, 2), bss=(1,), device="cpu",
        devices=["cpu", "cpu"], config=tprof.ProfilerConfig(warmup=1, iters=1))
    assert store.configs() == [("CPU", 1, 1), ("CPU", 2, 1)]
    tp2 = store.get("CPU", 2, 1)
    assert all(t > 0 for t in tp2.layer_times_ms) and len(tp2.layer_memory_mb) == 4

    jspec = JModelSpec(**PROFILE_SPEC)
    jp = jprof.LayerProfiler(jspec, devices=jax.devices()[:2])
    mesh = jmesh.mesh_dp_tp(1, 2, jax.devices()[:2])
    sharded = jmesh.shard_params(
        jgpt.init_params(jax.random.PRNGKey(0), jp.cfg), mesh,
        jmesh.gpt_param_specs(jp.cfg))
    assert store.model.params_per_layer_bytes == jp._params_per_layer_bytes(sharded)

    store.dump_to_dir(tmp_path / "port", {"model_name": "tiny", "attn": "flash"})
    loaded = jstore.ProfileStore.from_dir(tmp_path / "port")
    loaded.dump_to_dir(tmp_path / "jax", {"model_name": "tiny", "attn": "flash"})
    name = "DeviceType.CPU_tp2_bs1.json"
    assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()
    back = tstore.ProfileStore.from_dir(tmp_path / "jax")
    assert back.get("CPU", 2, 1).layer_times_ms == tp2.layer_times_ms


def test_llama_profile_tp2_with_replicated_kv():
    """``--tps 1,2`` for LLaMA with one KV head: the tp 2 ranks hold the
    whole ``wkv`` (the KV rule), and the global parameter bytes per layer
    equal the JAX profiler's at tp 2."""
    spec = dict(PROFILE_SPEC, name="tiny-llama", family="llama", num_kv_heads=1)
    store = tprof.profile_model(
        ModelSpec(**spec), tps=(1, 2), bss=(1,), device="cpu",
        devices=["cpu", "cpu"], config=tprof.ProfilerConfig(warmup=1, iters=1))
    assert store.configs() == [("CPU", 1, 1), ("CPU", 2, 1)]
    assert all(t > 0 for t in store.get("CPU", 2, 1).layer_times_ms)
    jp = jprof.LayerProfiler(JModelSpec(**spec), devices=jax.devices()[:2])
    mesh = jmesh.mesh_dp_tp(1, 2, jax.devices()[:2])
    sharded = jmesh.shard_params(
        jllama.init_llama_params(jax.random.PRNGKey(0), jp.cfg), mesh,
        jmesh.llama_param_specs(jp.cfg, tp_size=2))
    assert store.model.params_per_layer_bytes == jp._params_per_layer_bytes(sharded)


def test_profiler_frees_its_params_before_the_tp_job(monkeypatch):
    """Rank 0 of a tp job shares the first device with the calling process,
    so the caller holds no parameters while the job runs; the default
    backend is the device's (gloo on the CPU), and the full tree comes back
    from the seed for the global parameter bytes afterwards."""
    prof = tprof.LayerProfiler(ModelSpec(**PROFILE_SPEC), device="cpu",
                               devices=["cpu", "cpu"],
                               config=tprof.ProfilerConfig(warmup=1, iters=1))
    seen = []

    def fake_spawn(fn, world, backend, devices, *args):
        seen.append((prof._params, world, backend, list(devices)))
        return [[(tstore.LayerProfile((1.0,) * 4, (1.0,) * 4, 0.0), 0.0)]]

    monkeypatch.setattr(tdist, "spawn", fake_spawn)
    store = prof.run(tps=(1, 2), bss=(1,))
    assert seen == [(None, 2, "gloo", ["cpu", "cpu"])]
    full = tprof.LayerProfiler(ModelSpec(**PROFILE_SPEC), device="cpu")
    assert store.model.params_per_layer_bytes == full._params_per_layer_bytes(
        full._model_params())


def test_validation_measures_a_dp_tp_plan_on_ranks():
    """A dp x tp plan is measured on one rank per device (rank 0's time);
    one that needs more devices than the list holds raises."""
    from metis_tpu_torch.validation import validate_uniform_plan

    model = ModelSpec(**PROFILE_SPEC)
    report = validate_uniform_plan(UniformPlan(dp=2, pp=1, tp=1, mbs=2, gbs=4),
                                   1.0, model, device="cpu", steps=1, warmup=0,
                                   devices=["cpu"] * 2)
    assert report.measured_ms > 0 and np.isfinite(report.error_pct)
    with pytest.raises(MetisError, match="needs 4 devices, have 2"):
        validate_uniform_plan(UniformPlan(dp=2, pp=1, tp=2, mbs=2, gbs=4), 1.0,
                              model, device="cpu", devices=["cpu"] * 2)
