"""One controller per stage (``metis_tpu_torch/execution/multihost2.py``)
against the single-controller hetero executor and the reference's
``metis_tpu/execution/multihost2.py``.

- The transport: odd shapes, bf16, int32, bool and 0-d arrays round-trip,
  and the port's frames are the reference's, both ways (bf16 included).
- The fixed parity workload (``PARTITION (0, 2, 5)``, dp 2 | tp 2, gbs 8,
  2 microbatches, 3 steps) in two controller processes of two gloo ranks
  each: the same losses, bit for bit, as the port's single-controller
  hetero executor on the same parameters and tokens, and within fp32
  tolerance (1e-4 relative, 2e-5 absolute, as the port's other executor
  tests) of the reference's ``run_single_controller_losses()``, run in a
  subprocess on 4 virtual CPU devices, whose parameters and tokens both
  sides start from.
- Three stages (the middle role relays activations forward and input
  gradients backward), one controller each, in threads of this process:
  bit-equal to the single-controller executor in fp32 and in bf16 (the
  bf16 boundary transport), and within the fp32 tolerance of the
  reference's hetero executor.
- Per-slice checkpoints: a resumed pair equals a straight run; a slice
  ahead of its neighbour rolls back to its ``.prev``; a torn chain no
  generation reaches is refused at the handshake.
- The refusals (MoE, non-gpipe, stage and link counts, addresses), and
  ``train --slice-controller`` refusing a stage that spans device types.

Every port is a free port (``multihost.free_port``), never a fixed one,
and every subprocess has a timeout of its own."""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from metis_tpu_torch.core.config import ModelSpec
from metis_tpu_torch.execution import dist as tdist
from metis_tpu_torch.execution import multihost2 as m2
from metis_tpu_torch.execution.hetero import stage_specs_from_plan
from metis_tpu_torch.execution.mesh import PlanArtifact
from metis_tpu_torch.execution.multihost import free_port, load_tree
from metis_tpu_torch.models import config_for_model_spec
from metis_tpu_torch.models.gpt import GPTConfig
from metis_tpu_torch.testing import run_plan_rank

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=2e-5)


# -- the transport ----------------------------------------------------------------

def _pair():
    a, b = socket.socketpair()
    return a, b


ARRAYS = {
    "int32_odd": np.arange(7, dtype=np.int32),
    "float32_3d": np.random.default_rng(0).normal(size=(3, 5, 2)).astype(np.float32),
    "bool": np.zeros((1,), np.bool_),
    "zero_d": np.asarray(3.5, np.float32),
    "int64_empty": np.zeros((0, 4), np.int64),
}


def _roundtrip(send, recv, items):
    a, b = _pair()
    got = []
    t = threading.Thread(target=lambda: got.extend(recv(b) for _ in items))
    t.start()
    for x in items:
        send(a, x)
    t.join(timeout=30)
    a.close(), b.close()
    return got


def test_transport_roundtrip():
    items = [*ARRAYS.values(),
             torch.randn(3, 17, 5).to(torch.bfloat16),
             torch.tensor(2.25, dtype=torch.bfloat16),
             torch.arange(6, dtype=torch.int32).reshape(2, 3)[:, ::2]]
    got = _roundtrip(m2.send_array, m2.recv_array, items)
    for want, have in zip(items, got):
        want = want if isinstance(want, torch.Tensor) else torch.from_numpy(want)
        assert have.dtype == want.dtype and have.shape == want.shape
        assert torch.equal(have, want.contiguous())


def test_frames_are_the_reference_frames():
    """The port's frames read in the reference and the reference's in the
    port, bf16 (``ml_dtypes``) included."""
    import ml_dtypes

    from metis_tpu.execution import multihost2 as j2

    x = torch.randn(4, 3, 2).to(torch.bfloat16)
    got = _roundtrip(m2.send_array, j2.recv_array, [*ARRAYS.values(), x])
    for want, have in zip(ARRAYS.values(), got):
        assert have.dtype == want.dtype
        np.testing.assert_array_equal(have, want)
    assert got[-1].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got[-1].view(np.int16),
                                  x.view(torch.int16).numpy())
    back = _roundtrip(j2.send_array, m2.recv_array, [*ARRAYS.values(), got[-1]])
    for want, have in zip(ARRAYS.values(), back):
        assert torch.equal(have, torch.from_numpy(want))
    assert back[-1].dtype == torch.bfloat16 and torch.equal(back[-1], x)


def test_parse_link_addrs():
    assert m2.parse_link_addrs("10.0.0.1:5000, h:6000,") == [
        ("10.0.0.1", 5000), ("h", 6000)]
    for bad in ("", "nohost", "h:port", ":12"):
        with pytest.raises(ValueError):
            m2.parse_link_addrs(bad)


# -- the fixed two-stage workload in two controller processes ------------------------

REFERENCE_SRC = """
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from metis_tpu.execution import multihost2 as j2
from metis_tpu.models import family_ops
cfg, _ = j2.workload_plan()
params = family_ops(cfg)[3](jax.random.PRNGKey(0), cfg)
np.savez(sys.argv[1], **{f"{g}/{n}": np.asarray(a) for g, sub in params.items()
                         for n, a in sub.items()})
np.save(sys.argv[2], j2.workload_batches())
print(json.dumps(j2.run_single_controller_losses()), flush=True)
"""


@pytest.fixture(scope="module")
def reference_workload(tmp_path_factory):
    """The reference's oracle losses, initial parameters and tokens, from a
    subprocess on 4 virtual CPU devices."""
    root = tmp_path_factory.mktemp("mh2_reference")
    params, tokens = root / "params.npz", root / "tokens.npy"
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE_SRC, str(params),
                             str(tokens)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-2000:]
    return json.loads(out.strip().splitlines()[-1]), params, tokens


def test_two_controllers_equal_single_controller(reference_workload):
    ref_losses, params, tokens = reference_workload
    outs = m2.spawn_hetero_workers(free_port(), params=str(params),
                                   tokens=str(tokens), timeout_s=300)
    by_stage = {o["stage"]: o for o in outs}
    # each controller ran only its stage's two ranks
    assert by_stage[0]["local_devices"] == by_stage[1]["local_devices"] == 2
    assert by_stage[0]["losses"] == []
    losses = by_stage[1]["losses"]
    assert len(losses) == m2.STEPS and all(np.isfinite(losses))
    oracle = m2.run_single_controller_losses(load_tree(str(params)),
                                             np.load(tokens))
    assert losses == oracle  # bit for bit
    np.testing.assert_allclose(losses, ref_losses, **TOL)


def test_fixed_workload_needs_two_stages():
    with pytest.raises(ValueError, match="exactly 2 stages"):
        m2.run_stage_worker(0, 3, 1)


# -- three stages: the middle role ---------------------------------------------------

MODEL3 = ModelSpec(name="m3", num_layers=5, hidden_size=64,
                   sequence_length=16, vocab_size=128, num_heads=4)
ART3 = PlanArtifact(mesh_axes=(), mesh_shape=(), layer_partition=(0, 2, 3, 5),
                    strategies=({"dp": 1, "tp": 1},) * 3, gbs=4,
                    microbatches=2)
STEPS3 = 2


def _controllers(jobs: list[dict]) -> list:
    """Run one controller per job in threads of this process (one-device
    stages: no process group); the reports, or the exceptions raised."""
    out = [None] * len(jobs)

    def run(i):
        try:
            out[i] = m2.run_stage(jobs[i], ["cpu"])
        except Exception as e:  # noqa: BLE001 — the caller inspects it
            out[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return out


def _stage_jobs(cfg, init, steps=STEPS3, art=ART3, model=MODEL3, **extra):
    stages = stage_specs_from_plan(art.layer_partition, art.strategies, cfg)
    links = [("127.0.0.1", free_port()) for _ in range(len(stages) - 1)]
    return [dict(cfg=cfg, stages=stages, stage_id=i, links=links,
                 microbatches=art.microbatches, init=init, model=model,
                 gbs=art.gbs, steps=steps, plan=art.to_json(), **extra)
            for i in range(len(stages))]


def _train_batches(model, gbs, steps, skip=0):
    from metis_tpu_torch.data.pipeline import (
        make_input_pipeline,
        synthetic_run_dataset,
    )

    pipe = make_input_pipeline(
        synthetic_run_dataset(model.vocab_size, gbs, model.sequence_length),
        gbs, epochs=None, skip_batches=skip)
    try:
        return [tuple(torch.from_numpy(a) for a in next(pipe))
                for _ in range(steps)]
    finally:
        pipe.close()


def _single_controller(cfg, init, art=ART3, model=MODEL3, steps=STEPS3):
    world = art.num_devices
    ranks = tdist.spawn(run_plan_rank, world, "gloo", ["cpu"] * world,
                        art.to_json(), cfg, init,
                        _train_batches(model, art.gbs, steps))
    assert {r["kind"] for r in ranks} == {"hetero"}
    return ranks[0]["losses"]


@pytest.fixture(scope="module")
def reference_params():
    import jax
    import jax.numpy as jnp

    from metis_tpu.models import gpt as jgpt

    jcfg = jgpt.GPTConfig(vocab_size=128, seq_len=16, hidden=64, num_heads=4,
                          num_blocks=3, ffn_multiplier=4, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jgpt.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, params


def test_three_stages_fp32_equal_single_controller_and_reference(reference_params):
    import jax
    import jax.numpy as jnp

    from metis_tpu.execution.hetero import make_hetero_train_step_from_artifact
    from metis_tpu.execution.mesh import PlanArtifact as JPlanArtifact

    jcfg, params = reference_params
    cfg = config_for_model_spec(MODEL3, dtype=torch.float32)
    assert cfg.ffn_multiplier == jcfg.ffn_multiplier
    out = _controllers(_stage_jobs(cfg, params))
    assert [type(o) for o in out] == [dict] * 3, out
    assert out[0]["losses"] == out[1]["losses"] == []
    losses = out[2]["losses"]
    assert losses == _single_controller(cfg, params)

    init_fn, step_fn = make_hetero_train_step_from_artifact(
        jcfg, JPlanArtifact.from_json(ART3.to_json()),
        devices=jax.devices()[:3])
    state = init_fn(jax.random.PRNGKey(0))
    ref = []
    for toks, tgts in _train_batches(MODEL3, ART3.gbs, STEPS3):
        tok = jnp.asarray(toks.numpy()).reshape(ART3.microbatches, -1, 16)
        tgt = jnp.asarray(tgts.numpy()).reshape(ART3.microbatches, -1, 16)
        state, loss = step_fn(state, tok, tgt)
        ref.append(float(loss))
    np.testing.assert_allclose(losses, ref, **TOL)


def test_three_stage_artifact_worker_bf16_equals_single_controller():
    """``run_artifact_stage_worker`` (the model's bf16 activations cross
    the sockets) against the single-controller executor in bf16."""
    links = [("127.0.0.1", free_port()) for _ in range(2)]
    out = [None] * 3

    def run(i):
        out[i] = m2.run_artifact_stage_worker(ART3, MODEL3, i, links, STEPS3,
                                              ["cpu"])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert out[2]["losses"] == _single_controller(
        config_for_model_spec(MODEL3), 0)
    assert [o["stage"] for o in out] == [0, 1, 2]


# -- per-slice checkpoints ---------------------------------------------------------------

ART2 = PlanArtifact(mesh_axes=(), mesh_shape=(), layer_partition=(0, 2, 5),
                    strategies=({"dp": 1, "tp": 1},) * 2, gbs=4,
                    microbatches=2)


def _pair_run(ckpt: Path, steps: int, every: int = 0):
    cfg = config_for_model_spec(MODEL3, dtype=torch.float32)
    return _controllers(_stage_jobs(cfg, 0, steps=steps, art=ART2,
                                    checkpoint_dir=str(ckpt),
                                    checkpoint_every=every))


def test_checkpoint_resume_equals_straight_run(tmp_path):
    first = _pair_run(tmp_path / "c", 1)
    resumed = _pair_run(tmp_path / "c", 2)
    straight = _pair_run(tmp_path / "s", 3)
    assert [o["start_step"] for o in resumed] == [1, 1]
    assert first[1]["losses"] + resumed[1]["losses"] == straight[1]["losses"]
    for sid in (0, 1):
        assert (tmp_path / "c" / f"slice{sid}" / "meta.json").exists()


def _torn(tmp_path: Path, steps: int) -> Path:
    """slice0 at ``steps`` (with its ``.prev``), slice1 at step 1."""
    ckpt = tmp_path / "torn"
    _pair_run(ckpt, 1)
    import shutil

    shutil.copytree(ckpt / "slice1", tmp_path / "slice1_at_1")
    _pair_run(ckpt, steps - 1, every=1)
    shutil.rmtree(ckpt / "slice1")
    shutil.rmtree(ckpt / "slice1.prev", ignore_errors=True)
    shutil.copytree(tmp_path / "slice1_at_1", ckpt / "slice1")
    return ckpt


def test_slice_ahead_rolls_back_to_prev(tmp_path):
    """slice0 saved steps 1 and 2 (primary 2, ``.prev`` 1), slice1 only
    step 1: the chain agrees on 1, slice0 rolls back, and the next step's
    loss is the straight run's step 2."""
    ckpt = _torn(tmp_path, 2)
    out = _pair_run(ckpt, 1)
    assert [o["start_step"] for o in out] == [1, 1]
    straight = _pair_run(tmp_path / "s", 2)
    assert out[1]["losses"] == straight[1]["losses"][1:]


def test_torn_chain_is_refused_at_the_handshake(tmp_path):
    """slice0 at step 3 (``.prev`` at 2), slice1 at step 1: no generation
    of slice0 reaches the agreed step."""
    ckpt = _torn(tmp_path, 3)
    out = _pair_run(ckpt, 1)
    assert isinstance(out[0], RuntimeError)
    assert "out of sync" in str(out[0])


# -- refusals ----------------------------------------------------------------------------

def test_refusals_in_the_reference_words():
    links = [("127.0.0.1", 1)]
    moe = dataclasses.replace(MODEL3, num_experts=4)
    with pytest.raises(ValueError, match="dense plans only"):
        m2.run_artifact_stage_worker(ART2, moe, 0, links, 1, ["cpu"])
    for sched in ("1f1b", "interleaved"):
        with pytest.raises(ValueError, match="gpipe fill-drain"):
            m2.run_artifact_stage_worker(
                dataclasses.replace(ART2, schedule=sched), MODEL3, 0, links, 1,
                ["cpu"])
    one = PlanArtifact(mesh_axes=(), mesh_shape=(), layer_partition=(0, 5),
                       strategies=({"dp": 1, "tp": 1},), gbs=4, microbatches=2)
    with pytest.raises(ValueError, match=">= 2 stages"):
        m2.run_artifact_stage_worker(one, MODEL3, 0, [], 1, ["cpu"])
    with pytest.raises(ValueError, match="out of range"):
        m2.run_artifact_stage_worker(ART2, MODEL3, 2, links, 1, ["cpu"])
    with pytest.raises(ValueError, match="boundary links"):
        m2.run_artifact_stage_worker(ART2, MODEL3, 0, links * 2, 1, ["cpu"])
    with pytest.raises(RuntimeError, match="needs 2 devices"):
        cfg = GPTConfig(**m2.WORKLOAD, dtype=torch.float32)
        job = _stage_jobs(cfg, 0, art=PlanArtifact(
            mesh_axes=(), mesh_shape=(), layer_partition=(0, 2, 5),
            strategies=({"dp": 2, "tp": 1}, {"dp": 1, "tp": 1}), gbs=4,
            microbatches=2))[0]
        m2.run_stage(job, ["cpu"])


def test_cli_refuses_a_stage_of_two_device_types(tmp_path, capsys):
    """A plan whose first stage spans an A100 and a T4 (uneven
    data-balancer rows): ``train --slice-controller`` exits 2, as the
    reference's."""
    from metis_tpu.profiles import synthesize_profiles
    from metis_tpu_torch.cli import main

    from metis_tpu.core.config import ModelSpec as JModelSpec

    jmodel = JModelSpec(**dataclasses.asdict(MODEL3))
    synthesize_profiles(jmodel, ["A100", "T4"], tps=[1], bss=[1, 2, 4]
                        ).dump_to_dir(tmp_path / "profiles")
    (tmp_path / "hostfile").write_text("10.0.0.1 slots=1\n10.0.0.2 slots=2\n")
    (tmp_path / "cluster.json").write_text(json.dumps({
        "10.0.0.1": {"instance_type": "A100", "inter_bandwidth": 10,
                     "intra_bandwidth": 46, "memory": 80},
        "10.0.0.2": {"instance_type": "T4", "inter_bandwidth": 10,
                     "intra_bandwidth": 50, "memory": 15}}))
    # ranks A100, T4, T4: stage 0's two replicas are one of each
    art = PlanArtifact(mesh_axes=(), mesh_shape=(), layer_partition=(0, 2, 5),
                       strategies=({"dp": 2, "tp": 1}, {"dp": 1, "tp": 1}),
                       gbs=4, microbatches=2, node_sequence=("A100", "T4"),
                       device_groups=(2, 1))
    (tmp_path / "ckpt").mkdir()
    (tmp_path / "ckpt" / "plan.json").write_text(art.to_json())
    rc = main(["train", "--hostfile", str(tmp_path / "hostfile"),
               "--clusterfile", str(tmp_path / "cluster.json"),
               "--profile-dir", str(tmp_path / "profiles"),
               "--model-name", "m3", "--num-layers", "5", "--hidden-size",
               "64", "--seq-len", "16", "--vocab-size", "128", "--num-heads",
               "4", "--gbs", "4", "--device", "cpu", "--checkpoint-dir",
               str(tmp_path / "ckpt"), "--slice-controller", "0",
               "--peers", "127.0.0.1:1"])
    assert rc == 2
    assert "span multiple device types" in capsys.readouterr().err
