"""Multi-controller training (``metis_tpu_torch/execution/multihost.py``,
``train --coordinator``) against one launcher and against the reference.

- The fixed workload of the reference's ``tests/test_multihost.py`` at 4
  ranks: 2 launcher processes x 2 gloo CPU ranks, one process group over
  a TCP store, each rank feeding only its own rows of each batch
  (``global_batch_pipeline``), for a dp 2 x tp 2 gspmd plan and a pp 2 x
  dp 2 pipeline plan.  Their losses equal one launcher's 4 ranks bit for
  bit, and are within fp32 tolerance (1e-4 relative, 2e-5 absolute, as
  the port's other executor tests) of the reference's single-process
  GSPMD and pipeline routes on the 4 virtual CPU devices, on the same
  numpy parameters and tokens.
- ``train --coordinator`` end to end: two processes of two gloo ranks of
  a pinned dp 2 x tp 2 plan against one process of four ranks: the same
  losses and the same checkpoint digests.
- The flag rules of the reference CLI (``metis_tpu/planner/cli.py``
  ``_cmd_train``), their exit codes and words, and the port's own: a world
  the processes do not divide, a plan on the hetero route.

The coordinator's port comes from ``multihost.free_port``, never a fixed
one, and every subprocess has a timeout of its own."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from metis_tpu.execution import pipeline as jpipe
from metis_tpu.execution import train as jtrain
from metis_tpu.models import gpt as jgpt
from metis_tpu.planner.cli import main as ref_main
from metis_tpu_torch.cli import main
from metis_tpu_torch.core.errors import MetisError
from metis_tpu_torch.data.pipeline import _host_batches
from metis_tpu_torch.execution import multihost as mh
from metis_tpu_torch.execution.checkpoint import load_meta
from metis_tpu_torch.execution.mesh import PlanArtifact

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=2e-5)
SEED = 42


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """The reference's parameters (``PRNGKey(42)``) as an ``.npz`` the
    launchers read, and the batches of the workers' schedule."""
    jcfg = jgpt.GPTConfig(**mh.WORKLOAD, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jgpt.init_params(jax.random.PRNGKey(SEED), jcfg))
    path = tmp_path_factory.mktemp("multihost") / "params.npz"
    np.savez(path, **{f"{g}/{n}": a for g, sub in params.items()
                      for n, a in sub.items()})
    host = _host_batches(mh.workload_dataset(), mh.GBS, 0, None)
    batches = [next(host) for _ in range(mh.STEPS)]
    return jcfg, str(path), batches


def _reference_losses(mode, jcfg, batches) -> list[float]:
    if mode == "gspmd":
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
        state, _ = jtrain.build_train_state(jax.random.PRNGKey(SEED), jcfg, mesh)
        step = jtrain.make_train_step(jcfg, mesh)
        out = []
        for toks, tgts in batches:
            state, loss = step(state, toks, tgts)
            out.append(float(loss))
        return out
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2, 1), ("pp", "dp", "tp"))
    init_fn, step = jpipe.make_pipeline_train_step(jcfg, mesh, 2)
    params, opt_state = init_fn(jax.random.PRNGKey(SEED))
    out = []
    for toks, tgts in batches:
        params, opt_state, loss = step(
            params, opt_state, jpipe.microbatch_split(jnp.asarray(toks), 2),
            jpipe.microbatch_split(jnp.asarray(tgts), 2))
        out.append(float(loss))
    return out


@pytest.mark.parametrize("mode", sorted(mh.MODES))
def test_two_launchers_equal_one_and_the_reference(workload, mode):
    from concurrent.futures import ThreadPoolExecutor

    jcfg, params, batches = workload
    with ThreadPoolExecutor(2) as pool:
        two, one = pool.map(
            lambda n: mh.spawn_workers(mode, n, params=params, timeout_s=300),
            (2, 1))
    assert [o["process"] for o in two] == [0, 1]
    assert all(o["local_devices"] == 2 and o["global_devices"] == 4
               for o in two)
    # every rank of both launchers reports the global loss, one launcher's
    assert all(r == one[0]["losses"] for o in two for r in o["rank_losses"])
    # each rank gathered only its replica's rows, and together all of them
    art = mh.workload_artifact(mode)
    rows = [r for o in two for r in o["rows"]]
    assert rows == [mh.rank_rows(art, k).tolist() for k in range(mh.WORLD)]
    assert sorted(set(sum(rows, []))) == list(range(mh.GBS))
    assert all(len(r) < mh.GBS for r in rows)
    np.testing.assert_allclose(two[0]["losses"],
                               _reference_losses(mode, jcfg, batches), **TOL)


def test_global_batch_pipeline_gathers_only_the_rows():
    ds = mh.workload_dataset()
    full = _host_batches(ds, mh.GBS, 0, None, skip=1)
    part = mh.global_batch_pipeline(ds, mh.GBS, [1, 6], skip_batches=1)
    for _ in range(2):
        (ft, fg), (pt, pg) = next(full), next(part)
        np.testing.assert_array_equal(pt[[1, 6]], ft[[1, 6]])
        np.testing.assert_array_equal(pg[[1, 6]], fg[[1, 6]])
        assert not pt[[0, 2, 3, 4, 5, 7]].any()
    part.close()


def test_rank_rows_of_the_routes():
    gspmd = mh.workload_artifact("gspmd")  # (pp, dp, ep, sp, tp) = 1, 2, 1, 1, 2
    assert [mh.rank_rows(gspmd, r).tolist() for r in range(4)] == [
        [0, 1, 2, 3], [0, 1, 2, 3], [4, 5, 6, 7], [4, 5, 6, 7]]
    pipe = mh.workload_artifact("pipeline")  # (pp, dp, tp) = 2, 2, 1; M = 2
    assert [mh.rank_rows(pipe, r).tolist() for r in range(4)] == [
        [0, 1, 4, 5], [2, 3, 6, 7], [0, 1, 4, 5], [2, 3, 6, 7]]
    ep = PlanArtifact(mesh_axes=("pp", "dp", "ep", "sp", "tp"),
                      mesh_shape=(1, 2, 2, 1, 1), layer_partition=(),
                      strategies=({"dp": 4, "tp": 1, "ep": 2},), gbs=8,
                      microbatches=1)
    assert mh.rank_rows(ep, 3).tolist() == [6, 7]
    hetero = PlanArtifact(mesh_axes=(), mesh_shape=(), layer_partition=(0, 2, 4),
                          strategies=({"dp": 1, "tp": 1},) * 2, gbs=8,
                          microbatches=2)
    with pytest.raises(MetisError, match="rectangular"):
        mh.rank_rows(hetero, 0)


def test_initialize_multihost():
    info = mh.initialize_multihost("10.0.0.1:1234", 4, 3, 8)
    assert (info.process_index, info.process_count, info.global_device_count,
            info.local_device_count) == (3, 4, 8, 2)
    assert info.first_rank == 6 and info.init_method == "tcp://10.0.0.1:1234"
    with pytest.raises(MetisError, match="do not split over 3"):
        mh.initialize_multihost("h:1", 3, 0, 4)
    with pytest.raises(MetisError, match="not one of"):
        mh.initialize_multihost("h:1", 2, 2, 4)
    with pytest.raises(MetisError, match="host:port"):
        mh.initialize_multihost("nohost", 2, 0, 4)


# -- train --coordinator ----------------------------------------------------------------

MODEL_ARGS = [
    "--model-name", "cli-test", "--num-layers", "4", "--hidden-size", "32",
    "--seq-len", "16", "--vocab-size", "64", "--num-heads", "2",
]
DP2_TP2 = PlanArtifact(
    mesh_axes=("pp", "dp", "ep", "sp", "tp"), mesh_shape=(1, 2, 1, 1, 2),
    layer_partition=(0, 4),
    strategies=({"dp": 2, "tp": 2, "cp": 1, "ep": 1, "zero": 0, "sp": False},),
    gbs=8, microbatches=1)
HETERO = PlanArtifact(mesh_axes=(), mesh_shape=(), layer_partition=(0, 2, 4),
                      strategies=({"dp": 1, "tp": 1},) * 2, gbs=8,
                      microbatches=2)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    """Synthetic A100 profiles of the test model and a one-card cluster
    (as ``tests/test_torch_train_cli.py``)."""
    from metis_tpu.core.config import ModelSpec
    from metis_tpu.profiles import synthesize_profiles

    tmp = tmp_path_factory.mktemp("multihost_cli")
    model = ModelSpec(name="cli-test", num_layers=4, hidden_size=32,
                      sequence_length=16, vocab_size=64, num_heads=2)
    synthesize_profiles(model, ["A100"], tps=[1, 2],
                        bss=[1, 2, 4, 8]).dump_to_dir(tmp / "profiles")
    (tmp / "hostfile").write_text("10.0.0.1 slots=1\n")
    (tmp / "cluster.json").write_text(json.dumps({
        "10.0.0.1": {"instance_type": "A100", "inter_bandwidth": 10,
                     "intra_bandwidth": 46, "memory": 80}}))
    return tmp


def _base(fixture_dir, *extra):
    return ["train", "--hostfile", str(fixture_dir / "hostfile"),
            "--clusterfile", str(fixture_dir / "cluster.json"),
            "--profile-dir", str(fixture_dir / "profiles"),
            *MODEL_ARGS, "--gbs", "8", "--max-bs", "8", "--device", "cpu",
            *extra]


def _pinned(tmp_path, name, art) -> Path:
    d = tmp_path / name
    d.mkdir()
    (d / "plan.json").write_text(art.to_json())
    return d


def test_train_coordinator_equals_one_process(fixture_dir, tmp_path):
    multi, single = (_pinned(tmp_path, n, DP2_TP2) for n in ("multi", "single"))
    port = mh.free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "metis_tpu_torch",
         *_base(fixture_dir, "--steps", "3", "--checkpoint-dir", str(multi),
                "--devices", "cpu,cpu", "--coordinator", f"127.0.0.1:{port}",
                "--num-processes", "2", "--process-id", str(i),
                "--output", str(tmp_path / f"multi{i}.json"))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for i in range(2)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], errs
    assert "multihost: process 1/2, 4 global / 2 local devices" in errs[1]
    # one summary writer: process 0
    assert not (tmp_path / "multi1.json").exists()
    assert main(_base(fixture_dir, "--steps", "3", "--checkpoint-dir",
                      str(single), "--devices", "cpu,cpu,cpu,cpu", "--output",
                      str(tmp_path / "single.json"))) == 0
    got = json.loads((tmp_path / "multi0.json").read_text())
    want = json.loads((tmp_path / "single.json").read_text())
    assert got["executable"] == want["executable"] == "gspmd"
    assert (got["first_loss"], got["final_loss"]) == (
        want["first_loss"], want["final_loss"])
    assert load_meta(multi).step == 3
    assert load_meta(multi).digests == load_meta(single).digests


RULES = {
    # name: (extra flags, the reference's words)
    "slice_and_coordinator": (["--slice-controller", "0", "--peers", "h:1",
                               "--coordinator", "h:1", "--num-processes", "2",
                               "--process-id", "0"],
                              "different deployment shapes"),
    "slice_without_peers": (["--slice-controller", "0"], "requires --peers"),
    "num_processes_alone": (["--num-processes", "2"], "require --coordinator"),
    "process_id_alone": (["--process-id", "0"], "require --coordinator"),
    "coordinator_alone": (["--coordinator", "h:1"],
                          "requires --num-processes and --process-id"),
}


@pytest.mark.parametrize("name", RULES)
def test_flag_rules_exit_2_as_the_reference(fixture_dir, tmp_path, capsys, name):
    extra, said = RULES[name]
    rcs = []
    for cli in (ref_main, main):
        argv = _base(fixture_dir, "--steps", "1", "--checkpoint-dir",
                     str(tmp_path / "ckpt"), *extra)
        if cli is ref_main:  # the reference's backend pin
            argv[argv.index("--device")] = "--platform"
        rcs.append(cli(argv))
        assert said in capsys.readouterr().err
    assert rcs == [2, 2]
    assert not (tmp_path / "ckpt").exists()


@pytest.mark.parametrize("extra", [
    ["--coordinator", "h:1", "--num-processes", "2", "--process-id", "0"],
    ["--slice-controller", "1", "--peers", "h:1"]],
    ids=["coordinator", "slice_controller"])
def test_resilient_is_single_controller_only(fixture_dir, tmp_path, capsys,
                                              extra):
    assert main(_base(fixture_dir, "--steps", "1", "--resilient",
                      "--checkpoint-dir", str(tmp_path / "ckpt"), *extra)) == 2
    assert "--resilient is single-controller only" in capsys.readouterr().err


@pytest.mark.parametrize("case", ["world_not_divided", "hetero_plan"])
def test_coordinator_refusals(fixture_dir, tmp_path, capsys, case):
    """A world the processes do not divide (4 ranks over 3), and a plan on
    the hetero route (the reference's words): exit 2 before any rank
    starts."""
    art = DP2_TP2 if case == "world_not_divided" else HETERO
    ckpt = _pinned(tmp_path, "ckpt", art)
    n = "3" if case == "world_not_divided" else "2"
    rc = main(_base(fixture_dir, "--steps", "1", "--checkpoint-dir", str(ckpt),
                    "--devices", "cpu,cpu", "--coordinator",
                    f"127.0.0.1:{mh.free_port()}", "--num-processes", n,
                    "--process-id", "0"))
    assert rc == 2
    err = capsys.readouterr().err
    assert ("do not split over 3 processes" in err if case == "world_not_divided"
            else "--coordinator supports GSPMD (pp=1) and pipeline" in err)
