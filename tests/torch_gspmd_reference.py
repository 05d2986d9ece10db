"""The JAX package's GSPMD route on its virtual CPU mesh as the reference of
the port's context-parallel, sequence-parallel and ZeRO plans — a helper of
``tests/test_torch_context_parallel.py`` and ``tests/test_torch_zero_sp.py``.

``reference_start`` holds what every plan starts from (parameters, logits
and the first step's gradients, plan-independent), ``reference_run`` trains
the reference's ``build_train_state`` / ``make_train_step`` on a ``(dp,
ep, sp, tp)`` mesh (ep 1), ``port_plan`` is the port's
artifact of the same plan (the planner's rectangular ``(pp, dp, ep, sp,
tp)`` layout: the same rank order), and ``expected`` cuts a reference leaf
to what a port rank holds of it.
"""
import jax
import numpy as np
from jax.sharding import Mesh

from metis_tpu.execution import train as jtrain
from metis_tpu.execution.mesh import DP, EP, SP, TP
from metis_tpu.models.llama import LlamaConfig, llama_forward
from metis_tpu.models.gpt import forward
from metis_tpu.models.moe import MoEConfig, moe_forward
from metis_tpu_torch.core.sharding import slice_leaf
from metis_tpu_torch.execution import mesh as tmesh

SEED = 42


def _forward(jcfg):
    if isinstance(jcfg, MoEConfig):
        return lambda p, t: moe_forward(p, t, jcfg)[0]
    if isinstance(jcfg, LlamaConfig):
        return lambda p, t: llama_forward(p, t, jcfg)
    return lambda p, t: forward(p, t, jcfg)


def reference_start(jcfg, batch) -> dict:
    """What every plan starts from, plan-independent: ``params`` (the
    initial tree, numpy), the ``logits`` of the ``batch`` (``[gbs, seq +
    1]``) and the ``grads`` of its loss (the first step's)."""
    params = jtrain.init_params_for(jax.random.PRNGKey(SEED), jcfg)
    loss_fn = jtrain.loss_fn_for(jcfg)
    tokens, targets = batch[:, :-1], batch[:, 1:]
    logits = jax.jit(_forward(jcfg))(params, tokens)
    grads = jax.jit(jax.grad(lambda p: loss_fn(p, tokens, targets, jcfg)))(params)
    host = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return {"params": host(params), "logits": np.asarray(logits),
            "grads": host(grads)}


def reference_run(jcfg, batches, dp=1, cp=1, tp=1, sp=False, zero=0,
                  cp_mode="ring") -> dict:
    """The reference's plan trained on ``batches`` (``[gbs, seq + 1]`` int
    arrays) on a ``(dp, ep, sp, tp)`` mesh: ``losses`` and ``final``, every leaf
    after the steps."""
    mesh = Mesh(np.array(jax.devices()[:dp * cp * tp]).reshape(dp, 1, cp, tp),
                (DP, EP, SP, TP))
    opt = jtrain.build_optimizer()
    state, _ = jtrain.build_train_state(
        jax.random.PRNGKey(SEED), jcfg, mesh, optimizer=opt,
        ep_axis=EP if isinstance(jcfg, MoEConfig) else None, zero=zero)
    step = jtrain.make_train_step(
        jcfg, mesh, optimizer=opt, seq_axis=SP if cp > 1 else None,
        megatron_sp=sp, cp_mode=cp_mode)
    losses = []
    for b in batches:
        state, loss = step(state, b[:, :-1], b[:, 1:])
        losses.append(float(loss))
    return {"losses": losses, "final": jax.tree.map(np.asarray, state.params)}


def port_plan(dp=1, cp=1, tp=1, sp=False, zero=0, cp_mode="ring",
              gbs=8, num_blocks=2) -> str:
    """The port's artifact JSON of the same plan."""
    return tmesh.PlanArtifact(
        mesh_axes=("pp", "dp", "ep", "sp", "tp"), mesh_shape=(1, dp, 1, cp, tp),
        layer_partition=(0, num_blocks + 2),
        strategies=({"dp": dp, "tp": tp, "cp": cp, "ep": 1, "zero": zero,
                     "sp": sp, "cp_mode": cp_mode},),
        gbs=gbs, microbatches=1).to_json()


def expected(leaf, spec, rank: dict, key, zero: int, grad: bool = False):
    """What a port rank (``run_plan_rank``'s result) holds of the reference
    ``leaf`` of tp spec ``spec``: its tp block; at ZeRO 3 the dp shard along
    the leaf's ZeRO dim; a gradient at ZeRO 1 and 2 the rank's flat chunk
    of the tp block."""
    slots = rank["slots"]
    dim = rank.get("zero_dims", {}).get(key)
    if dim is None or zero == 0:
        return slice_leaf(leaf, spec, slots)
    if zero == 3:
        wrapped = list(spec) + [None] * (leaf.ndim - len(spec))
        wrapped[dim] = "dp"
        return slice_leaf(leaf, tuple(wrapped), slots)
    block = slice_leaf(leaf, spec, slots)
    if not grad:
        return block
    index, size = slots["dp"]
    n = block.size // size
    return block.reshape(-1)[index * n:(index + 1) * n]
