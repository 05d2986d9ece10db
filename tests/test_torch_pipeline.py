"""The port's pipeline route against the JAX package's shard_map pipeline.

The same numpy parameters and tokens go through
``metis_tpu.execution.pipeline.make_pipeline_train_step`` on the virtual CPU
mesh and through the port's ranks: gloo processes on the host
(``execution.dist.spawn``), each running ``build_executable``'s
``pipeline`` route for its stage.  Compared after three steps: every loss,
and every leaf of every rank against the reference's parameters mapped to
the canonical block order (``unpad_blocks_for_partition`` for the uneven
split, the inverse of ``interleave_block_order`` for the interleaved
layout) and cut as the rank holds them.  Tolerances as in
``tests/test_torch_dist.py``: losses 1e-4 relative / 2e-5 absolute, leaves
1e-6 absolute, fp32.  Several plans share one launch (``run_plans_rank``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from metis_tpu.core.types import UniformPlan as JUniformPlan
from metis_tpu.execution import builder as jbuilder
from metis_tpu.execution import mesh as jmesh
from metis_tpu.execution import pipeline as jpipe
from metis_tpu.models import gpt as jgpt
from metis_tpu_torch.core.config import ModelSpec
from metis_tpu_torch.core.errors import MetisError
from metis_tpu_torch.core.events import EventLog, read_events
from metis_tpu_torch.core.sharding import slice_leaf
from metis_tpu_torch.core.types import UniformPlan
from metis_tpu_torch.execution import builder as tbuilder
from metis_tpu_torch.execution import dist as tdist
from metis_tpu_torch.execution import mesh as tmesh
from metis_tpu_torch.execution import pipeline as tpipe
from metis_tpu_torch.models import gpt as tgpt
from metis_tpu_torch.testing import run_plans_rank

torch.set_num_threads(1)

SHAPE = dict(vocab_size=256, seq_len=32, hidden=64, num_heads=4, num_blocks=4,
             ffn_multiplier=2)
GBS, STEPS = 8, 3
TOL = dict(rtol=1e-4, atol=2e-5)
LEAF_ATOL = 1e-6

# name: (pp, dp, tp, microbatches, schedule, virtual stages, block counts)
CASES = {
    "gpipe": (2, 1, 1, 4, "gpipe", 1, None),
    "1f1b": (2, 1, 1, 4, "1f1b", 1, None),
    "interleaved": (2, 1, 1, 4, "interleaved", 2, None),
    "uneven_1f1b": (2, 1, 1, 4, "1f1b", 1, (3, 1)),
    "pp2_tp2": (2, 1, 2, 2, "gpipe", 1, None),
    "pp2_dp2_1f1b": (2, 2, 1, 2, "1f1b", 1, None),
}
# the overlap schedule (dp all-reduce in chunks of 1000 elements) against
# lockstep, on the dp case
LOCKSTEP = "pp2_dp2_1f1b_lockstep"
SMALL_CHUNK_ELEMS = 1000


def _run_with_small_chunks(rank, device, jobs):
    """``run_plans_rank`` with the overlap schedule's dp all-reduce in chunks
    of ``SMALL_CHUNK_ELEMS``, so that every leaf of the small model spans
    several chunks (set in the rank's own process)."""
    from metis_tpu_torch.execution import train

    train.DP_CHUNK_ELEMS = SMALL_CHUNK_ELEMS
    return run_plans_rank(rank, device, jobs)


def _partition(counts):
    """Profile-layer boundaries of a block split: embed on the first
    stage, head on the last."""
    bounds, off = [0], 0
    for c in counts[:-1]:
        off += c
        bounds.append(off + 1)
    return tuple(bounds) + (SHAPE["num_blocks"] + 2,)


def _artifact(pp, dp, tp, M, schedule, vs, counts) -> str:
    return tmesh.PlanArtifact(
        mesh_axes=("pp", "dp", "tp"), mesh_shape=(pp, dp, tp),
        layer_partition=_partition(counts) if counts else (),
        strategies=({"dp": dp, "tp": tp},), gbs=GBS, microbatches=M,
        schedule=schedule, virtual_stages=vs).to_json()


@pytest.fixture(scope="module")
def data():
    jcfg = jgpt.GPTConfig(**SHAPE, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jgpt.init_params(jax.random.PRNGKey(42), jcfg))
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, SHAPE["vocab_size"], (GBS, SHAPE["seq_len"] + 1),
                            dtype=np.int32) for _ in range(STEPS)]
    return jcfg, params, batches


def _jax_run(jcfg, batches, pp, dp, tp, M, schedule, vs, counts):
    devs = np.array(jax.devices()[:pp * dp * tp]).reshape(pp, dp, tp)
    mesh = Mesh(devs, ("pp", "dp", "tp"))
    init_fn, step = jpipe.make_pipeline_train_step(
        jcfg, mesh, M, schedule=schedule, virtual_stages=vs, block_counts=counts)
    params, opt_state = init_fn(jax.random.PRNGKey(42))
    losses = []
    for b in batches:
        tok = jpipe.microbatch_split(jnp.asarray(b[:, :-1]), M)
        tgt = jpipe.microbatch_split(jnp.asarray(b[:, 1:]), M)
        params, opt_state, loss = step(params, opt_state, tok, tgt)
        losses.append(float(loss))
    params = jax.tree.map(np.asarray, params)
    blocks = params["blocks"]
    if schedule == "interleaved":
        inv = np.argsort(tpipe.interleave_block_order(SHAPE["num_blocks"], pp, vs))
        blocks = {n: a[inv] for n, a in blocks.items()}
    elif counts:
        blocks = tpipe.unpad_blocks_for_partition(blocks, counts)
    return losses, {**params, "blocks": blocks}


@pytest.fixture(scope="module")
def port_runs(data):
    """Every case's ranks: the pp-only cases in one launch of 2 ranks, the
    tp and dp cases (and the lockstep run) in one of 4."""
    _, params, batches = data
    tcfg = tgpt.GPTConfig(**SHAPE, dtype=torch.float32)
    host = [(torch.from_numpy(b[:, :-1]), torch.from_numpy(b[:, 1:])) for b in batches]

    def job(name, **extra):
        return dict(artifact_json=_artifact(*CASES[name]), cfg=tcfg, init=params,
                    batches=host, return_params=True, **extra)

    out = {}
    for world in (2, 4):
        names = [n for n, c in CASES.items() if c[0] * c[1] * c[2] == world]
        jobs = [job(n) for n in names]
        body = run_plans_rank
        if world == 4:
            body = _run_with_small_chunks
            names.append(LOCKSTEP)
            jobs.append(job("pp2_dp2_1f1b", overlap=False))
        ranks = tdist.spawn(body, world, "gloo", ["cpu"] * world, jobs)
        for i, name in enumerate(names):
            out[name] = [r[i] for r in ranks]
    return out


@pytest.fixture(scope="module", params=list(CASES))
def case(request, data, port_runs):
    jcfg, _, batches = data
    return request.param, _jax_run(jcfg, batches, *CASES[request.param]), \
        port_runs[request.param]


def test_losses_match_jax(case):
    name, (jlosses, _), ranks = case
    assert {r["kind"] for r in ranks} == {"pipeline"}
    for r in ranks:  # every rank reports the global loss
        np.testing.assert_allclose(r["losses"], jlosses, **TOL, err_msg=name)


def test_every_leaf_matches_jax(case):
    """Each rank's blocks (its stage's, in its layout's order), its tp
    block of every leaf, the embedding on the first stage and the head on
    the last only."""
    name, (_, jparams), ranks = case
    pp = CASES[name][0]
    specs = tmesh.gpt_param_specs(tgpt.GPTConfig(**SHAPE))
    held = set()
    for r in ranks:
        stage = r["slots"]["pp"][0]
        assert ("embed" in r["params"]) == (stage == 0), name
        assert ("head" in r["params"]) == (stage == pp - 1), name
        held.update(r["block_ids"])
        for group, sub in r["params"].items():
            for leaf, got in sub.items():
                full = jparams[group][leaf]
                if group == "blocks":
                    full = full[list(r["block_ids"])]
                want = slice_leaf(full, specs[group][leaf], r["slots"])
                np.testing.assert_allclose(
                    got, want, rtol=0, atol=LEAF_ATOL,
                    err_msg=f"{name}: {group}.{leaf} {r['slots']}")
    assert held == set(range(SHAPE["num_blocks"]))


def test_overlap_schedule_equals_lockstep(port_runs):
    """Deferred send waits and the chunked dp all-reduce change no value:
    losses and leaves are equal, not close."""
    for a, b in zip(port_runs["pp2_dp2_1f1b"], port_runs[LOCKSTEP]):
        assert a["losses"] == b["losses"]
        for group, sub in a["params"].items():
            for leaf, got in sub.items():
                np.testing.assert_array_equal(got, b["params"][group][leaf])


@pytest.mark.parametrize("gbs,M", [(8, 1), (8, 2), (8, 4), (8, 8), (6, 3)])
def test_microbatch_split_matches_jax(gbs, M):
    toks = np.arange(gbs * 5, dtype=np.int32).reshape(gbs, 5)
    np.testing.assert_array_equal(
        tpipe.microbatch_split(torch.from_numpy(toks), M).numpy(),
        np.asarray(jpipe.microbatch_split(jnp.asarray(toks), M)))


def test_microbatch_split_refuses_a_remainder():
    with pytest.raises(ValueError, match="not divisible"):
        tpipe.microbatch_split(torch.zeros(6, 3), 4)


@pytest.mark.parametrize("blocks,pp,vs", [(4, 2, 2), (8, 2, 2), (8, 2, 4),
                                          (12, 3, 2), (16, 4, 2)])
def test_interleave_block_order_matches_jax(blocks, pp, vs):
    assert tpipe.interleave_block_order(blocks, pp, vs) == \
        jpipe.interleave_block_order(blocks, pp, vs)


@pytest.mark.parametrize("counts", [(3, 1), (1, 3), (2, 3, 1), (5, 3), (1, 1, 4)])
def test_uneven_pad_indices_and_padding_match_jax(counts):
    assert tpipe.uneven_pad_indices(counts) == jpipe.uneven_pad_indices(counts)
    rng = np.random.default_rng(1)
    blocks = {"w": rng.standard_normal((sum(counts), 3, 2)).astype(np.float32)}
    padded = tpipe.pad_blocks_for_partition(blocks, counts)
    jpadded = jpipe.pad_blocks_for_partition(
        {"w": jnp.asarray(blocks["w"])}, counts)
    np.testing.assert_array_equal(padded["w"], np.asarray(jpadded["w"]))
    back = tpipe.unpad_blocks_for_partition(
        {"w": torch.from_numpy(padded["w"])}, counts)
    np.testing.assert_array_equal(back["w"].numpy(), blocks["w"])


ROUTE_CFG = dict(vocab_size=256, seq_len=16, hidden=64, num_heads=4,
                 num_blocks=4, ffn_multiplier=2)
ROUTE_CFG3 = {**ROUTE_CFG, "num_blocks": 3}


def _routing_cases():
    """``tests/test_builder.py::TestRouting``'s cases without zero, cp or
    ep: (config, artifact fields, build keyword arguments)."""
    def uniform(dp, pp, tp, mbs, gbs):
        return ("uniform", (dp, pp, tp, mbs, gbs))

    def fields(**kw):
        return ("fields", kw)

    uneven = dict(mesh_axes=("pp", "dp", "tp"), mesh_shape=(2, 2, 1),
                  layer_partition=(0, 3, 5), strategies=({"dp": 2, "tp": 1},),
                  gbs=8, microbatches=2)
    return {
        "pp1_gspmd": (ROUTE_CFG, uniform(4, 1, 2, 2, 8), {}),
        "pp2_uniform": (ROUTE_CFG, uniform(2, 2, 2, 2, 8), {}),
        "pp2_1f1b": (ROUTE_CFG, uniform(2, 2, 2, 2, 8), {"schedule": "1f1b"}),
        "uneven_1f1b": (ROUTE_CFG3, fields(**uneven, schedule="1f1b"), {}),
        "uneven_gpipe": (ROUTE_CFG3, fields(**uneven), {}),
        "pp2_interleaved": (ROUTE_CFG, uniform(2, 2, 2, 2, 8),
                            {"schedule": "interleaved", "virtual_stages": 2}),
        "nonuniform": (ROUTE_CFG, fields(
            mesh_axes=(), mesh_shape=(), layer_partition=(0, 2, 6),
            strategies=({"dp": 2, "tp": 2}, {"dp": 4, "tp": 1}), gbs=8,
            microbatches=2), {}),
    }


@pytest.mark.parametrize("name", list(_routing_cases()))
def test_routing_matches_jax(name):
    shape, (how, spec), kw = _routing_cases()[name]
    if how == "uniform":
        jart = jmesh.PlanArtifact.from_uniform_plan(JUniformPlan(*spec))
        tart = tmesh.PlanArtifact.from_uniform_plan(UniformPlan(*spec))
    else:
        jart, tart = jmesh.PlanArtifact(**spec), tmesh.PlanArtifact(**spec)
    jcfg = jgpt.GPTConfig(**shape, dtype=jnp.float32)
    tcfg = tgpt.GPTConfig(**shape, dtype=torch.float32)
    jkind = jbuilder.build_executable(jcfg, jart, **kw).kind
    assert tbuilder.plan_route(tcfg, tart, **kw) == jkind
    schedule, vs = tbuilder.resolve_schedule(tart, kw.get("schedule"),
                                             kw.get("virtual_stages"))
    assert (schedule, vs) == jbuilder.resolve_schedule(
        jart, kw.get("schedule"), kw.get("virtual_stages"))
    assert tbuilder.checkpoint_block_layout(tart, tcfg, jkind, schedule, vs) == \
        jbuilder.checkpoint_block_layout(jart, jcfg, jkind, schedule, vs)


BAD_INPUTS = {
    "uneven_blocks_no_counts": dict(pp=3),
    "counts_wrong_sum": dict(block_counts=(2, 1)),
    "counts_zero_stage": dict(block_counts=(4, 0)),
    "interleaved_uneven": dict(schedule="interleaved", block_counts=(3, 1)),
    "unknown_schedule": dict(schedule="zigzag"),
    "interleaved_vs0": dict(schedule="interleaved", virtual_stages=0),
    "interleaved_blocks": dict(schedule="interleaved", virtual_stages=4),
    "interleaved_microbatches": dict(schedule="interleaved", microbatches=3),
}


@pytest.mark.parametrize("name", list(BAD_INPUTS))
def test_input_checks_match_jax_word_for_word(name):
    kw = dict(BAD_INPUTS[name])
    pp, M = kw.pop("pp", 2), kw.pop("microbatches", 2)
    jcfg = jgpt.GPTConfig(**SHAPE, dtype=jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:pp]).reshape(pp, 1, 1), ("pp", "dp", "tp"))
    with pytest.raises(ValueError) as want:
        jpipe.make_pipeline_train_step(jcfg, mesh, M, **kw)
    tmesh_ = tmesh.ProcessMesh(("pp", "dp", "tp"), (pp, 1, 1), (0, 0, 0))
    with pytest.raises(ValueError) as got:
        tpipe.make_pipeline_train_step(tgpt.GPTConfig(**SHAPE), tmesh_, M,
                                       device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_overlap_event_and_phase_spans(tmp_path):
    """One ``pipeline_overlap`` event when overlap is on, and the
    ``pipeline_init`` / ``pipeline_first_step`` spans around the first
    init and step only."""
    class Runner:
        mesh = tmesh.ProcessMesh(("pp", "dp", "tp"), (2, 1, 1), (0, 0, 0))

        def init(self, source):
            return source

        def step(self, state, tokens, targets):
            return state, torch.zeros(())

    path = tmp_path / "events.jsonl"
    with EventLog(path) as events:
        init, step = tpipe.traced_steps(Runner(), "1f1b", 2, events)
        state = init(0)
        for _ in range(2):
            state, _ = step(state, torch.zeros(2, 1, 4), torch.zeros(2, 1, 4))
        with pytest.raises(ValueError, match="expected 2 microbatches"):
            step(state, torch.zeros(3, 1, 4), torch.zeros(3, 1, 4))
    evs = read_events(path)
    overlap = [e for e in evs if e["event"] == "pipeline_overlap"]
    assert overlap == [dict(overlap[0], schedule="1f1b",
                            dp_chunk_elems=tpipe._train.DP_CHUNK_ELEMS)]
    spans = [e["name"] for e in evs if e["event"] == "span_end"]
    assert spans == ["pipeline_init", "pipeline_first_step"]


def test_validate_measures_a_pp2_plan_on_two_ranks():
    """``validate_uniform_plan`` runs a pp = 2 plan on the pipeline route,
    one rank per stage; a plan of more devices than the list raises."""
    from metis_tpu_torch.validation import validate_uniform_plan

    model = ModelSpec(name="tiny", num_layers=6, hidden_size=64,
                      sequence_length=32, vocab_size=128, num_heads=4)
    report = validate_uniform_plan(UniformPlan(dp=1, pp=2, tp=1, mbs=2, gbs=4),
                                   1.0, model, device="cpu", steps=1, warmup=0,
                                   devices=["cpu"] * 2)
    assert report.measured_ms > 0 and np.isfinite(report.error_pct)
    with pytest.raises(MetisError, match="needs 4 devices, have 2"):
        validate_uniform_plan(UniformPlan(dp=2, pp=2, tp=1, mbs=2, gbs=4), 1.0,
                              model, device="cpu", devices=["cpu"] * 2)
