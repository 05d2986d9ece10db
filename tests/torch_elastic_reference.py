"""Restores onto another plan in the JAX package on its virtual CPU mesh
(orbax reshards on read) as the reference of the port's — a helper of the
``tests/test_torch_checkpoint_elastic*.py`` files, which split the pairs
so that each file stays short (the reference compiles two executables per
pair).

``reference_pair`` trains the reference's executable of plan A two steps,
checkpoints it, restores it onto the executables of plans B and trains
each two more; ``save_job`` and ``restore_job`` are the port's
``testing.elastic_rank`` jobs of the same runs, and ``run_pairs`` runs
both sides of a list of pairs.  Both start from the same numpy parameters
(the reference's ``init_params_for`` at ``SEED``) and the same batches.
"""
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from metis_tpu.execution import builder as jbuilder
from metis_tpu.execution import checkpoint as jckpt
from metis_tpu.execution import train as jtrain
from metis_tpu.execution.mesh import PlanArtifact as JPlanArtifact
from metis_tpu.models import gpt as jgpt
from metis_tpu.models import llama as jllama
from metis_tpu.models import moe as jmoe
from metis_tpu_torch.execution import dist as tdist
from metis_tpu_torch.execution.mesh import PlanArtifact
from metis_tpu_torch.models import gpt as tgpt
from metis_tpu_torch.models import llama as tllama
from metis_tpu_torch.models import moe as tmoe
from metis_tpu_torch.testing import elastic_rank

SEED = 42
GBS = 8
TOL = dict(rtol=1e-4, atol=2e-5)  # the trajectory tests' tolerance, fp32
SHAPE = dict(vocab_size=64, seq_len=16, hidden=32, num_heads=4, num_blocks=4)
FAMILIES = {
    "gpt": (jgpt.GPTConfig, tgpt.GPTConfig, {}),
    # 2 blocks: their pairs compile the reference's heavier steps
    "moe": (jmoe.MoEConfig, tmoe.MoEConfig, dict(num_experts=4, num_blocks=2)),
    # one KV head: LLaMA's wkv is whole on every rank of tp 2
    "llama": (jllama.LlamaConfig, tllama.LlamaConfig,
              dict(num_kv_heads=1, num_blocks=2)),
}


def configs(family: str):
    """(the reference's config, the port's) of a family at ``SHAPE``."""
    jax_cls, torch_cls, extra = FAMILIES[family]
    shape = {**SHAPE, **extra}
    return (jax_cls(**shape, dtype=jnp.float32), torch_cls(**shape, dtype=torch.float32))


def batches(n: int = 4) -> list[np.ndarray]:
    rng = np.random.default_rng(0)
    return [rng.integers(0, SHAPE["vocab_size"], (GBS, SHAPE["seq_len"] + 1),
                         dtype=np.int32) for _ in range(n)]


def torch_batches(arrays) -> list:
    return [(torch.from_numpy(b[:, :-1]), torch.from_numpy(b[:, 1:])) for b in arrays]


def params(jcfg) -> dict:
    """The numpy parameters both packages start from."""
    return jax.tree.map(np.asarray, jtrain.init_params_for(jax.random.PRNGKey(SEED), jcfg))


def gspmd(dp=1, tp=1, zero=0, ep=1, blocks=SHAPE["num_blocks"]) -> PlanArtifact:
    """A rectangular pp = 1 plan (``dp`` counts the dp x ep replicas)."""
    return PlanArtifact(
        mesh_axes=("pp", "dp", "ep", "sp", "tp"), mesh_shape=(1, dp // ep, ep, 1, tp),
        layer_partition=(0, blocks + 2),
        strategies=({"dp": dp, "tp": tp, "zero": zero, "ep": ep},), gbs=GBS,
        microbatches=1)


def pipeline(pp: int, dp: int, schedule: str = "gpipe", vs: int = 1) -> PlanArtifact:
    return PlanArtifact(
        mesh_axes=("pp", "dp", "tp"), mesh_shape=(pp, dp, 1), layer_partition=(),
        strategies=({"dp": dp, "tp": 1},), gbs=GBS, microbatches=2,
        schedule=schedule, virtual_stages=vs)


def hetero(partition, *strategies) -> PlanArtifact:
    return PlanArtifact(
        mesh_axes=(), mesh_shape=(), layer_partition=tuple(partition),
        strategies=tuple(strategies), gbs=GBS, microbatches=2)


def _run(exe, state, arrays):
    losses = []
    for b in arrays:
        out = exe.step(state, jnp.asarray(b[:, :-1]), jnp.asarray(b[:, 1:]))
        state = out[0] if len(out) == 2 else out[:-1]
        losses.append(float(out[-1]))
    return state, losses


def _restore(exe, directory):
    fresh = exe.init(jax.random.PRNGKey(SEED + 1))
    if exe.kind == "hetero":
        return jckpt.restore_hetero_checkpoint(directory, fresh)
    ts = jckpt.restore_checkpoint(
        directory, jbuilder.exec_state_to_train_state(exe.kind, fresh, 0))
    return jbuilder.train_state_to_exec_state(exe.kind, ts)


def reference_pair(jcfg, plan_a: PlanArtifact, plans_b: list, arrays,
                   directory: Path, refused: tuple = ()) -> dict:
    """The reference's plan A trained on ``arrays[:2]`` and checkpointed to
    ``directory``, then restored onto each of ``plans_b`` and trained on
    ``arrays[2:]``: ``{"a": losses, "b": [losses per plan B], "refused":
    [the error of each of ``refused``, plans it restores onto no state]}``."""
    a = JPlanArtifact.from_json(plan_a.to_json())
    exe = jbuilder.build_executable(jcfg, a)
    state, losses_a = _run(exe, exe.init(jax.random.PRNGKey(SEED)), arrays[:2])
    if exe.kind == "hetero":
        jckpt.save_hetero_checkpoint(directory, state, 2)
    else:
        jckpt.save_checkpoint(
            directory, jbuilder.exec_state_to_train_state(exe.kind, state, 2),
            a.build_mesh())
    out = {"a": losses_a, "b": [], "refused": []}
    for plan in plans_b:
        b = jbuilder.build_executable(jcfg, JPlanArtifact.from_json(plan.to_json()))
        out["b"].append(_run(b, _restore(b, directory), arrays[2:])[1])
    for plan in refused:
        b = jbuilder.build_executable(jcfg, JPlanArtifact.from_json(plan.to_json()))
        try:
            _restore(b, directory)
            out["refused"].append(None)
        except Exception as e:  # noqa: BLE001 — orbax's own error types
            out["refused"].append(f"{type(e).__name__}: {e}")
    return out


def save_job(cfg, init: dict, plan: PlanArtifact, arrays, directory) -> dict:
    """The port's ``testing.elastic_rank`` job of plan A: trained on
    ``arrays[:2]`` and checkpointed to ``directory``."""
    return dict(cfg=cfg, artifact=plan.to_json(), init=init,
                batches=torch_batches(arrays[:2]), save=str(directory))


def restore_job(cfg, plan: PlanArtifact, arrays, directory) -> dict:
    """The port's job of a plan B: a fresh state restored from
    ``directory`` and trained on ``arrays[2:]``."""
    return dict(cfg=cfg, artifact=plan.to_json(), init=SEED + 1,
                restore=str(directory), batches=torch_batches(arrays[2:]))


def check_pair(name: str, want_a: list, want_b: list, got_a: dict, got_b: dict,
               saved_digests: dict) -> None:
    """The port's plan A (``got_a``, rank 0's result) and its restore onto a
    plan B (``got_b``) against the reference's losses: within ``TOL``, the
    restored state the checkpoint's one-device state bit for bit, at step
    2."""
    assert got_b["refused"] is None, (name, got_b["refused"])
    assert got_b["step"] == 2, name
    assert got_b["digests"] == saved_digests, name
    np.testing.assert_allclose(got_a["losses"], want_a, **TOL, err_msg=name)
    np.testing.assert_allclose(got_b["losses"], want_b, **TOL, err_msg=name)


def _port_pairs(tmp: Path, pairs, arrays, inits) -> dict:
    """The port's side of ``pairs``, one launch per plan-A world size (a
    plan B of fewer ranks runs on the launch's first ones): ``{name: (A,
    [B, ...])}``, rank 0's results."""
    out = {}
    for world in sorted({p[4] for p in pairs}, reverse=True):
        jobs, spans = [], {}
        for name, family, a, bs, ranks in pairs:
            if ranks == world:
                cfg = configs(family)[1]
                spans[name] = len(jobs), len(bs)
                jobs += [save_job(cfg, inits[family], a, arrays, tmp / name)]
                jobs += [restore_job(cfg, b, arrays, tmp / name) for b in bs]
        res = tdist.spawn(elastic_rank, world, "gloo", ["cpu"] * world, jobs)[0]
        for name, (i, n) in spans.items():
            out[name] = res[i], res[i + 1:i + 1 + n]
    return out


def run_pairs(tmp: Path, pairs, refused: dict | None = None) -> tuple[dict, dict]:
    """Both sides of ``pairs``, ``(name, family, plan A, [plans B], ranks
    of plan A)``, the port's launches beside the reference's runs; the
    port's checkpoints under ``tmp / name``.  ``refused``: ``{name: [plans
    the reference is asked to restore the pair's checkpoint onto]}``.
    Returns ``(port, reference)``."""
    arrays = batches()
    (tmp / "ref").mkdir()
    inits = {f: params(configs(f)[0]) for f in {p[1] for p in pairs}}
    refused = refused or {}
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(_port_pairs, tmp, pairs, arrays, inits)
        ref = {name: reference_pair(configs(family)[0], a, bs, arrays,
                                    tmp / "ref" / name, refused.get(name, ()))
               for name, family, a, bs, _ in pairs}
        return port.result(), ref


def run_jobs(tmp: Path, jobs, reference: dict) -> tuple[dict, dict]:
    """The port's ``jobs``, ``(name, plan, name of the checkpoint it
    restores from, or None to train plan A and save it under ``tmp /
    name``)``, in one launch of four gloo ranks (a plan of fewer runs on
    the first ranks), beside the reference's ``reference``: ``{name: (plan
    A, [plans B], plans it refuses)}``, saved under ``tmp / "ref" /
    name``.  Returns ``(port, reference)``: ``{job: rank 0's result}``,
    ``{name: reference_pair's}``."""
    jcfg, cfg = configs("gpt")
    arrays, init = batches(), params(jcfg)
    (tmp / "ref").mkdir()
    port_jobs = [save_job(cfg, init, plan, arrays, tmp / name) if src is None
                 else restore_job(cfg, plan, arrays, tmp / src)
                 for name, plan, src in jobs]
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(tdist.spawn, elastic_rank, 4, "gloo", ["cpu"] * 4,
                           port_jobs)
        ref = {name: reference_pair(jcfg, a, bs, arrays, tmp / "ref" / name,
                                    refused)
               for name, (a, bs, refused) in reference.items()}
        ranks = port.result()
    return {name: ranks[0][i] for i, (name, *_) in enumerate(jobs)}, ref
