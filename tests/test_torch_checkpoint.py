"""Checkpoints of the port (``metis_tpu_torch/execution/checkpoint.py``)
against the JAX package's: the cases of ``tests/test_checkpoint.py`` on
one device and on gloo ranks (dp 2 at ZeRO 1, tp 2, a two-stage hetero
plan), one restore onto another mesh, the format before slice maps, plus
the contracts shared with the reference: ``CheckpointMeta``'s JSON byte
for byte both ways, and a one-device checkpoint's ``params`` and ``step``
digests equal to the reference's on the same numpy parameters.  Resume is
held bit for bit: losses and every leaf of a run checkpointed and
restored mid-way equal an uninterrupted run's exactly.  The pairs of
plans against the reference's orbax restore are in
``tests/test_torch_checkpoint_elastic*.py``.
"""
import json
import shutil
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metis_tpu.execution import checkpoint as jckpt
from metis_tpu.execution import train as jtrain
from metis_tpu.models import gpt as jgpt
from metis_tpu_torch.core.errors import (
    CheckpointCorruptError,
    CheckpointWriteError,
    MetisError,
)
from metis_tpu_torch.core.types import UniformPlan
from metis_tpu_torch.execution import checkpoint as tckpt
from metis_tpu_torch.execution import dist as tdist
from metis_tpu_torch.execution import hetero as thetero
from metis_tpu_torch.execution.builder import build_executable
from metis_tpu_torch.execution.mesh import PlanArtifact
from metis_tpu_torch.execution.reshard import logical_digests
from metis_tpu_torch.models import gpt as tgpt
from metis_tpu_torch.testing import elastic_rank, resume_rank
from tests.torch_elastic_reference import (
    batches,
    configs,
    gspmd,
    params,
    torch_batches,
)

torch.set_num_threads(1)

SHAPE = dict(vocab_size=128, seq_len=16, hidden=32, num_heads=2, num_blocks=2)
GBS = 8
ONE = PlanArtifact.from_uniform_plan(UniformPlan(1, 1, 1, GBS, GBS))


def _cfg():
    return tgpt.GPTConfig(**SHAPE, dtype=torch.float32)


def _batches(n=4):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        b = torch.from_numpy(rng.integers(0, SHAPE["vocab_size"],
                                          (GBS, SHAPE["seq_len"] + 1),
                                          dtype=np.int32))
        out.append((b[:, :-1], b[:, 1:]))
    return out


def _exe():
    return build_executable(_cfg(), ONE, device="cpu")


def _run(exe, state, batches):
    losses = []
    for tokens, targets in batches:
        state, loss = exe.step(state, tokens, targets)
        losses.append(loss.item())
    return state, losses


def _assert_same_params(a, b):
    for g, sub in a.params.items():
        for n, leaf in sub.items():
            np.testing.assert_array_equal(leaf.detach().numpy(),
                                          b.params[g][n].detach().numpy(),
                                          err_msg=f"{g}.{n}")


class TestTrainStateCheckpoint:
    def test_resume_is_bit_identical(self, tmp_path):
        """2 steps + save + restore + 2 steps == 4 uninterrupted steps."""
        exe, batches = _exe(), _batches()
        state, want = _run(exe, exe.init(0), batches)
        state2, got = _run(exe, exe.init(0), batches[:2])
        tckpt.save_checkpoint(tmp_path / "ckpt", state2, ONE)
        resumed = tckpt.restore_checkpoint(tmp_path / "ckpt", exe.init(1), mesh=ONE)
        assert resumed.step == 2
        resumed, rest = _run(exe, resumed, batches[2:])
        assert resumed.step == state.step == 4
        assert got + rest == want
        _assert_same_params(state, resumed)

    def test_async_writer_resume_is_bit_identical(self, tmp_path):
        """Training goes on while the write is in flight; after close() the
        checkpoint restores the step-2 state bit for bit."""
        exe, batches = _exe(), _batches()
        state = exe.init(0)
        with tckpt.AsyncCheckpointWriter() as writer:
            state, _ = _run(exe, state, batches[:2])
            writer.save(tmp_path / "ckpt", state, ONE)
            state, _ = _run(exe, state, batches[2:])
        assert state.step == 4
        resumed = tckpt.restore_checkpoint(tmp_path / "ckpt", exe.init(1))
        assert resumed.step == 2
        resumed, _ = _run(exe, resumed, batches[2:])
        _assert_same_params(state, resumed)

    def test_async_writer_back_to_back_saves(self, tmp_path):
        """A second save waits for and swaps the first; the last one wins
        and no ``.tmp`` or ``.prev`` is left."""
        exe, batches = _exe(), _batches(2)
        state = exe.init(0)
        with tckpt.AsyncCheckpointWriter() as writer:
            state, _ = _run(exe, state, batches[:1])
            writer.save(tmp_path / "ckpt", state, ONE)
            state, _ = _run(exe, state, batches[1:])
            writer.save(tmp_path / "ckpt", state, ONE)
        assert tckpt.load_meta(tmp_path / "ckpt").step == 2
        assert not (tmp_path / "ckpt.tmp").exists()
        assert not (tmp_path / "ckpt.prev").exists()

    def test_async_writer_close_surfaces_write_failure(self, tmp_path):
        """close() surfaces a failed background write as
        ``CheckpointWriteError`` naming the checkpoint, and the failed write
        never swaps in."""
        exe = _exe()
        writer = tckpt.AsyncCheckpointWriter()

        def fail(*args):
            raise RuntimeError("disk on fire")

        with mock.patch.object(tckpt, "_write_rank", fail):
            writer.save(tmp_path / "ckpt", exe.init(0), ONE)
            with pytest.raises(CheckpointWriteError) as exc:
                writer.close()
        assert "ckpt" in str(exc.value) and "disk on fire" in str(exc.value)
        assert not (tmp_path / "ckpt").exists()

    def test_hetero_state_roundtrip(self, tmp_path):
        """A one-stage hetero plan's state checkpoints and restores bit for
        bit; the meta records the stage count in place of a mesh."""
        cfg = _cfg()
        stages = thetero.stage_specs_from_plan((0, 4), [dict(dp=1, tp=1)], cfg)
        run = resume_rank(0, torch.device("cpu"), None, cfg, _batches(), 2,
                          str(tmp_path / "ckpt"), stages=stages)
        assert run["losses"][0] == run["losses"][1]
        assert run["step"] == 2
        meta = run["meta"]
        assert (meta.step, meta.mesh_axes, meta.mesh_shape) == (2, ("stage",), (1,))
        for g, sub in run["params"][0].items():
            for n, leaf in sub.items():
                np.testing.assert_array_equal(leaf, run["params"][1][g][n])

    def test_overwrite_cycle_and_prev_fallback(self, tmp_path):
        """Repeated saves never lose the prior checkpoint: a crash that
        leaves only ``.prev`` still restores, and so does a primary whose
        state is corrupt while ``.prev`` is kept."""
        exe, batches = _exe(), _batches(2)
        state = exe.init(0)
        tckpt.save_checkpoint(tmp_path / "ckpt", state, ONE)
        state, _ = _run(exe, state, batches[:1])
        tckpt.save_checkpoint(tmp_path / "ckpt", state, ONE)  # overwrite
        assert tckpt.load_meta(tmp_path / "ckpt").step == 1
        # the crash window of a swap: the primary gone, .prev the last good
        (tmp_path / "ckpt").rename(tmp_path / "ckpt.prev")
        assert tckpt.load_meta(tmp_path / "ckpt").step == 1
        assert tckpt.restore_checkpoint(tmp_path / "ckpt", exe.init(1)).step == 1
        shutil.rmtree(tmp_path / "ckpt.prev")

        # a corrupted primary falls back to the retained .prev generation
        state = exe.init(0)
        tckpt.save_checkpoint(tmp_path / "ckpt", state, ONE)
        state, _ = _run(exe, state, batches[:1])
        tckpt.save_checkpoint(tmp_path / "ckpt", state, ONE, keep_prev=True)
        rank_file = tmp_path / "ckpt" / "state" / "rank00000.pt"
        snap = torch.load(rank_file, weights_only=True)
        snap["params"]["blocks"]["qkv"][0, 0, 0, 0] += 1.0
        torch.save(snap, rank_file)
        with pytest.raises(CheckpointCorruptError, match="digest mismatch"):
            tckpt._restore_verified(tmp_path / "ckpt", None)
        assert tckpt.restore_checkpoint(tmp_path / "ckpt", exe.init(1)).step == 0
        # corruption everywhere raises rather than passing for a fresh start
        shutil.rmtree(tmp_path / "ckpt.prev")
        with pytest.raises(CheckpointCorruptError):
            tckpt.restore_checkpoint(tmp_path / "ckpt", exe.init(1))

    def test_meta_sidecar(self, tmp_path):
        exe = _exe()
        tckpt.save_checkpoint(tmp_path / "ckpt", exe.init(0), ONE)
        meta = tckpt.load_meta(tmp_path / "ckpt")
        assert meta.step == 0
        assert (meta.mesh_axes, meta.mesh_shape) == (ONE.mesh_axes, ONE.mesh_shape)
        assert meta.block_layout == "canonical"
        assert "['params']['blocks']['qkv']" in meta.digests
        assert "['opt_state'][0]['exp_avg']" not in meta.digests  # no step yet
        assert "['step']" in meta.digests

    def test_checkpoint_carries_plan(self, tmp_path):
        exe = _exe()
        tckpt.save_checkpoint(tmp_path / "ckpt", exe.init(0), ONE, plan=ONE)
        assert tckpt.load_plan(tmp_path / "ckpt") == ONE
        assert tckpt.load_plan(tmp_path / "no-such-ckpt") is None

    def test_restore_onto_another_mesh(self, tmp_path):
        """A one-device checkpoint restores onto dp 2 at ZeRO 1 on two gloo
        ranks (the reference's orbax reshards on read): the restored state
        is the checkpoint's one-device state bit for bit, at its step, and
        trains on as the one device does."""
        exe, batches = _exe(), _batches()
        _, want = _run(exe, exe.init(0), batches)
        state, _ = _run(exe, exe.init(0), batches[:2])
        tckpt.save_checkpoint(tmp_path / "ckpt", state, ONE)
        other = PlanArtifact.from_uniform_plan(UniformPlan(2, 1, 1, GBS // 2, GBS))
        other = PlanArtifact(**{**other.__dict__, "strategies": (
            {"dp": 2, "tp": 1, "zero": 1},)})
        ranks = tdist.spawn(elastic_rank, 2, "gloo", ["cpu"] * 2, [dict(
            cfg=_cfg(), artifact=other.to_json(), init=1,
            restore=str(tmp_path / "ckpt"), batches=batches[2:])])
        saved = tckpt.logical_digests(tmp_path / "ckpt")
        for (r,) in ranks:
            assert r["kind"] == "gspmd" and r["step"] == 2
            assert r["digests"] == saved
            np.testing.assert_allclose(r["losses"], want[2:], rtol=1e-4, atol=2e-5)
        # with no slice map on the state, only the plan that wrote it
        bare = tckpt.TrainState(params=state.params, optimizer=state.optimizer)
        with pytest.raises(MetisError, match="slice map"):
            tckpt.restore_checkpoint(tmp_path / "ckpt", bare, mesh=other)

    def test_restore_refuses_another_block_layout(self, tmp_path):
        exe = _exe()
        tckpt.save_checkpoint(tmp_path / "ckpt", exe.init(0), ONE)
        with pytest.raises(ValueError, match="block layout"):
            tckpt.restore_checkpoint(tmp_path / "ckpt", exe.init(1),
                                     expected_block_layout="interleaved:2x2")


def test_block_layouts_compatible_legacy_format():
    """The reference's cases: a legacy "interleaved:<vs>" meta is accepted
    iff the vs matches and its own mesh's pp equals the expected pp."""
    for pkg in (jckpt, tckpt):
        meta = pkg.CheckpointMeta
        legacy = meta(step=1, mesh_axes=("pp", "dp"), mesh_shape=(2, 4),
                      block_layout="interleaved:3")
        assert pkg.block_layouts_compatible(legacy, "interleaved:2x3")
        assert not pkg.block_layouts_compatible(legacy, "interleaved:4x3")
        assert not pkg.block_layouts_compatible(legacy, "interleaved:2x2")
        assert not pkg.block_layouts_compatible(legacy, "canonical")
        nopp = meta(step=1, mesh_axes=("dp",), mesh_shape=(8,),
                    block_layout="interleaved:2")
        assert pkg.block_layouts_compatible(nopp, "interleaved:1x2")
        assert not pkg.block_layouts_compatible(nopp, "interleaved:2x2")
        new = meta(step=1, mesh_axes=("pp", "dp"), mesh_shape=(2, 4),
                   block_layout="interleaved:2x3")
        assert pkg.block_layouts_compatible(new, "interleaved:2x3")
        assert not pkg.block_layouts_compatible(new, "interleaved:2x2")
        canon = meta(step=1, mesh_axes=("dp",), mesh_shape=(8,))
        assert pkg.block_layouts_compatible(canon, "canonical")
        assert not pkg.block_layouts_compatible(canon, "interleaved:2x2")


@pytest.mark.parametrize("fields", [
    dict(step=3, mesh_axes=("pp", "dp", "ep", "sp", "tp"),
         mesh_shape=(1, 2, 1, 1, 1), block_layout="canonical",
         digests={"['params']['embed']['tok']": "ab" * 32, "['step']": "cd" * 32}),
    dict(step=0, mesh_axes=("stage",), mesh_shape=(2,)),
    dict(step=7, mesh_axes=("pp", "dp"), mesh_shape=(2, 4),
         block_layout="uneven:2x3-1"),
], ids=("gspmd", "hetero", "uneven"))
def test_checkpoint_meta_json_is_byte_identical(fields):
    """The meta's JSON round-trips between the packages byte for byte."""
    j, t = jckpt.CheckpointMeta(**fields), tckpt.CheckpointMeta(**fields)
    assert t.to_json() == j.to_json()
    assert tckpt.CheckpointMeta.from_json(j.to_json()).to_json() == j.to_json()
    assert jckpt.CheckpointMeta.from_json(t.to_json()) == j
    assert json.loads(t.to_json())["digests"] == fields.get("digests", {})


def test_one_device_params_digests_equal_the_reference():
    """The ``params`` and ``step`` digests of a one-device checkpoint equal
    the reference's ``_tree_digests`` on the same numpy parameters (bf16
    leaves included: the reference's dtype name and raw 2-byte words)."""
    jcfg = jgpt.GPTConfig(**SHAPE, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jtrain.init_params_for(jax.random.PRNGKey(0), jcfg))
    want = jckpt._tree_digests({"params": jax.tree.map(jnp.asarray, params),
                                "step": jnp.asarray(5, jnp.int32)})
    exe = _exe()
    state = exe.init(params)
    state.step = 5
    got = tckpt.tree_digests(tckpt._digest_tree(tckpt._snapshot(state)))
    ours = {k: v for k, v in got.items() if not k.startswith("['opt_state']")}
    assert ours == want
    bf = np.asarray(params["blocks"]["qkv"]).astype(jnp.bfloat16)
    assert (tckpt.leaf_digest(torch.from_numpy(np.array(params["blocks"]["qkv"])).bfloat16())
            == jckpt._tree_digests({"x": jnp.asarray(bf)})["['x']"])


# -- gloo ranks ------------------------------------------------------------------

RANKED = {
    "dp2_zero1": PlanArtifact(
        mesh_axes=("pp", "dp", "ep", "sp", "tp"), mesh_shape=(1, 2, 1, 1, 1),
        layer_partition=(0, 4), strategies=({"dp": 2, "tp": 1, "zero": 1},),
        gbs=GBS, microbatches=1),
    "tp2": PlanArtifact(
        mesh_axes=("pp", "dp", "ep", "sp", "tp"), mesh_shape=(1, 1, 1, 1, 2),
        layer_partition=(0, 4), strategies=({"dp": 1, "tp": 2},),
        gbs=GBS, microbatches=1),
}


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    cfg = _cfg()
    tmp = tmp_path_factory.mktemp("ckpt")
    jobs = {name: (art.to_json(), None, 1) for name, art in RANKED.items()}
    jobs["hetero_two_stage"] = (None, thetero.stage_specs_from_plan(
        (0, 2, 4), [dict(dp=1, tp=1), dict(dp=1, tp=1)], cfg), 2)
    return {name: tdist.spawn(resume_rank, 2, "gloo", ["cpu"] * 2, art, cfg,
                              _batches(), 2, str(tmp / name), stages, M)
            for name, (art, stages, M) in jobs.items()}


@pytest.mark.parametrize("name", [*RANKED, "hetero_two_stage"])
def test_gloo_resume_is_bit_identical(gloo_runs, name):
    """2 steps, a checkpoint of every rank's own state, a restore into a
    fresh state and 2 more steps equal 4 straight steps on every rank, bit
    for bit; the meta holds every rank's digests under its prefix."""
    ranks = gloo_runs[name]
    for r in ranks:
        assert r["losses"][0] == r["losses"][1], name
        assert r["step"] == 2
        for g, sub in r["params"][0].items():
            for n, leaf in sub.items():
                np.testing.assert_array_equal(leaf, r["params"][1][g][n],
                                              err_msg=f"{name} {g}.{n}")
    meta = ranks[0]["meta"]
    assert {k[:9] for k in meta.digests} == {"rank00000", "rank00001"}
    if name == "hetero_two_stage":
        assert (meta.mesh_axes, meta.mesh_shape) == (("stage",), (2,))
    else:
        art = RANKED[name]
        assert (meta.mesh_axes, meta.mesh_shape) == (art.mesh_axes, art.mesh_shape)


@pytest.mark.parametrize("kind", ["single_device", "gspmd", "pipeline", "hetero"])
def test_exec_state_adapters(kind):
    """The builder's adapters: the port's states are ``TrainState``s (the
    step set from the caller's count); hetero states checkpoint through
    the hetero pair and refuse, as the reference's."""
    from metis_tpu_torch.execution.builder import (
        exec_state_to_train_state,
        train_state_to_exec_state,
    )

    state = _exe().init(0)
    if kind == "hetero":
        with pytest.raises(ValueError, match="save_hetero_checkpoint"):
            exec_state_to_train_state(kind, state, 3)
        with pytest.raises(ValueError):
            train_state_to_exec_state(kind, state)
        return
    ts = exec_state_to_train_state(kind, state, 3)
    assert ts is state and ts.step == 3
    assert train_state_to_exec_state(kind, ts) is state


# -- the format before slice maps ---------------------------------------------

def _strip_maps(directory):
    """Rewrite a checkpoint in the format before slice maps (the digests
    cover no map, so they still hold)."""
    for f in (directory / "state").glob("rank*.pt"):
        snap = torch.load(f, weights_only=True)
        snap.pop("layout")
        torch.save(snap, f)


def test_checkpoint_without_slice_maps(tmp_path):
    """A checkpoint of the format before slice maps restores onto the plan
    that wrote it bit for bit (the resumed run equals a straight one), is
    refused into a state whose leaves are in another order, and is refused
    onto another plan, naming the map."""
    jcfg, cfg = configs("gpt")
    host = torch_batches(batches())
    exe = build_executable(cfg, gspmd(), device="cpu")
    init = params(jcfg)
    state = exe.init(init)
    want = [exe.step(state, t, g)[1].item() for t, g in host]
    state = exe.init(init)
    for t, g in host[:2]:
        state, _ = exe.step(state, t, g)
    tckpt.save_checkpoint(tmp_path / "one", state, gspmd())
    _strip_maps(tmp_path / "one")
    # that format's optimizer state is by position: restore into a state
    # made as the saved one was
    resumed = tckpt.restore_checkpoint(tmp_path / "one", exe.init(init),
                                       mesh=gspmd())
    assert resumed.step == 2
    assert [exe.step(resumed, t, g)[1].item() for t, g in host[2:]] == want[2:]
    # a state made from the seed orders its leaves otherwise: refused, where
    # a restore by position would feed moments to the wrong parameters
    with pytest.raises(MetisError, match="built as the saved one was"):
        tckpt.restore_checkpoint(tmp_path / "one", exe.init(1), mesh=gspmd())

    # onto another plan: dp 2 at ZeRO 1's checkpoint onto one device
    old = tmp_path / "dp2_zero1"
    tdist.spawn(elastic_rank, 2, "gloo", ["cpu"] * 2, [dict(
        cfg=cfg, artifact=gspmd(dp=2, zero=1).to_json(), init=0,
        save=str(old))])
    _strip_maps(old)
    with pytest.raises(MetisError, match="predates the slice map"):
        tckpt.restore_checkpoint(old, exe.init(1), mesh=gspmd())


# -- verification on the restore onto another plan ------------------------------

def _corrupt_moment(directory, rank, leaf="blocks/qkv"):
    """Change one element of a rank file's ``exp_avg`` of ``leaf`` (its
    digest in the meta stays the old one)."""
    f = directory / "state" / f"rank{rank:05d}.pt"
    snap = torch.load(f, weights_only=True)
    snap["optimizer"]["state"][snap["layout"]["opt"].index(leaf)][
        "exp_avg"].view(-1)[0] += 1.0
    torch.save(snap, f)


def test_restore_onto_another_plan_verifies_every_source(tmp_path):
    """dp 2 at ZeRO 1 onto one device reads each rank's moment chunks:
    one changed in rank 1's file makes the restore fall back to the
    retained ``.prev`` generation (step 1), and raise without it; a meta
    that records no digest for a tensor read raises too."""
    jcfg, cfg = configs("gpt")
    host, init = torch_batches(batches()), params(jcfg)
    plan = gspmd(dp=2, zero=1).to_json()
    tdist.spawn(elastic_rank, 2, "gloo", ["cpu"] * 2, [
        dict(cfg=cfg, artifact=plan, init=init, batches=host[:1],
             save=str(tmp_path / "step1")),
        dict(cfg=cfg, artifact=plan, init=init, batches=host[:2],
             save=str(tmp_path / "ckpt"))])
    # a save drops the .prev it parks unless told to keep it
    (tmp_path / "step1").rename(tmp_path / "ckpt.prev")
    shutil.copytree(tmp_path / "ckpt", tmp_path / "bare")
    prev = tckpt.logical_digests(tmp_path / "ckpt.prev")
    exe = build_executable(cfg, gspmd(), device="cpu")
    _corrupt_moment(tmp_path / "ckpt", 1)
    stats = {}
    state = tckpt.restore_checkpoint(tmp_path / "ckpt", exe.init(init),
                                     stats=stats)
    assert stats["resharded"] and state.step == 1
    assert logical_digests(state) == prev
    shutil.rmtree(tmp_path / "ckpt.prev")
    with pytest.raises(CheckpointCorruptError, match="digest mismatch"):
        tckpt.restore_checkpoint(tmp_path / "ckpt", exe.init(init))
    # a tensor the meta records no digest for
    meta = tckpt.load_meta(tmp_path / "bare")
    meta.digests.pop(next(k for k in meta.digests
                          if k.startswith("rank00001['opt_state']")))
    (tmp_path / "bare" / "meta.json").write_text(meta.to_json())
    with pytest.raises(CheckpointCorruptError, match="records no digest"):
        tckpt.restore_checkpoint(tmp_path / "bare", exe.init(init))

