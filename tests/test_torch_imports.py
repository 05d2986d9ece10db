"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

# the suite runs in several workers at once; one intra-op thread keeps these
# tiny tensors from contending with the other workers' timing tests
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "metis_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "metis_tpu")


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        if parts[-1] == "__main__":
            continue  # runs the CLI when imported
        mods.append(".".join(parts))
    return mods


def test_every_module_imports_with_jax_blocked():
    blocked = ", ".join(repr(m) for m in FORBIDDEN)
    code = (
        "import sys\n"
        f"for name in ({blocked},):\n"
        "    sys.modules[name] = None  # any import of it raises ImportError\n"
        "import importlib\n"
        f"for mod in {_port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(mod)\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"({blocked},) and sys.modules[m] is not None)\n"
        "assert not leaked, leaked\n"
        "print('imported', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


# the plan daemon's modules: host Python over the planner, each scanned
# and imported with JAX blocked like every other module of the port
DAEMON_MODULES = ("metis_tpu_torch.obs.metrics", "metis_tpu_torch.sched",
                  "metis_tpu_torch.sched.fleet", "metis_tpu_torch.sched.tenant",
                  "metis_tpu_torch.serve", "metis_tpu_torch.serve.cache",
                  "metis_tpu_torch.serve.client", "metis_tpu_torch.serve.daemon",
                  "metis_tpu_torch.serve.persist", "metis_tpu_torch.serve.pool",
                  "metis_tpu_torch.serve.standby",
                  "metis_tpu_torch.inference.replay",
                  "metis_tpu_torch.profiles.synthetic", "metis_tpu_torch.native",
                  "metis_tpu_torch.fixtures", "metis_tpu_torch.obs.events_schema",
                  "metis_tpu_torch.obs.decisions_schema",
                  "metis_tpu_torch.resilience.fleet_drill")


def test_the_daemon_modules_are_covered():
    mods = set(_port_modules())
    assert set(DAEMON_MODULES) <= mods
    scanned = {str(p.relative_to(ROOT)) for p in PACKAGE.rglob("*.py")}
    for mod in DAEMON_MODULES:
        path = mod.replace(".", "/")
        assert f"{path}.py" in scanned or f"{path}/__init__.py" in scanned


def test_daemon_and_client_import_no_torch():
    """The plan daemon runs on the host and holds no card: a client
    (``plan --remote``, ``top``), the daemon with its search pool's worker
    modules, the fleet scheduler, the replay bench and the migration
    pricing a replan calls start without importing torch."""
    blocked = ", ".join(repr(m) for m in FORBIDDEN)
    code = (
        "import sys\n"
        f"for name in ({blocked},):\n"
        "    sys.modules[name] = None\n"
        "import metis_tpu_torch.serve.client, metis_tpu_torch.serve\n"
        "from metis_tpu_torch import cli\n"
        "assert 'torch' not in sys.modules, 'client imported torch'\n"
        "from metis_tpu_torch.serve import PlanService\n"
        "import metis_tpu_torch.serve.pool, metis_tpu_torch.serve.standby\n"
        "import metis_tpu_torch.sched, metis_tpu_torch.inference.replay\n"
        "import metis_tpu_torch.cost.migration\n"
        "from metis_tpu_torch.cluster.spec import ClusterSpec\n"
        "from metis_tpu_torch.profiles.store import ProfileStore\n"
        "PlanService(ClusterSpec.of(('A100', 1, 1)), ProfileStore({}, None))\n"
        "assert 'torch' not in sys.modules, 'the daemon imported torch'\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_profiles_native_fixtures_and_drills_import_no_torch(tmp_path):
    """The synthetic profiles, the native DP (built and called), the
    fixture writers and the fleet drill's fleet leg — the plan daemon's
    search pool runs the balancer, and the drill feeds the synthetic
    profiles to an in-thread daemon — start and run without torch.  (The
    tenant leg imports it: the fleet scheduler's switch decision builds a
    ``PlanArtifact``, ``sched/fleet.py``.)"""
    blocked = ", ".join(repr(m) for m in FORBIDDEN)
    code = (
        "import sys\n"
        f"for name in ({blocked},):\n"
        "    sys.modules[name] = None\n"
        "from pathlib import Path\n"
        "from metis_tpu_torch.profiles import synthesize_profiles, tiny_test_model\n"
        "from metis_tpu_torch import native\n"
        "from metis_tpu_torch.fixtures import write_parity_fixture\n"
        "from metis_tpu_torch.resilience.fleet_drill import run_fleet_drill\n"
        "import metis_tpu_torch.resilience.faults, metis_tpu_torch.resilience.retry\n"
        f"root = Path({str(tmp_path)!r})\n"
        "write_parity_fixture(root / 'parity')\n"
        "synthesize_profiles(tiny_test_model(), ['A100'], decode_context=64)\n"
        "import numpy as np\n"
        "if native.native_available():\n"
        "    assert native.minmax_partition_native(np.arange(5.0), [1.0, 1.0]) is not None\n"
        "run_fleet_drill(root / 'fleet', ticks=8, seed=7, spot_rate_per_hr=0.2)\n"
        "assert 'torch' not in sys.modules, 'imported torch'\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# the TPU slice planner: the torus model, its bandwidth model and plan_tpu
TPU_PLANNER_MODULES = ("metis_tpu_torch.cluster.tpu", "metis_tpu_torch.cost.ici",
                       "metis_tpu_torch.cost.torch_backend",
                       "metis_tpu_torch.ops.cost_tensor")


def test_the_tpu_planner_modules_are_covered():
    assert set(TPU_PLANNER_MODULES) <= set(_port_modules())
    assert (PACKAGE / "ops" / "csrc" / "cost_tensor.cu").exists()


def test_tpu_planner_and_numpy_cost_path_import_no_torch(tmp_path):
    """``cluster/tpu.py``, ``cost/ici.py`` and the planner on its numpy cost
    backend (``plan_hetero``, ``plan_tpu`` and the ``tpu`` command) import
    and run without torch; only ``cost_backend="torch"`` imports it, when
    the search builds its estimator."""
    blocked = ", ".join(repr(m) for m in FORBIDDEN)
    code = (
        "import sys\n"
        f"for name in ({blocked},):\n"
        "    sys.modules[name] = None\n"
        "from metis_tpu_torch.cluster.tpu import TpuClusterSpec, slice_from_name\n"
        "from metis_tpu_torch.cost.ici import IciDcnBandwidth\n"
        "from metis_tpu_torch.planner.api import plan_hetero, plan_tpu\n"
        "from metis_tpu_torch.core.config import SearchConfig\n"
        "from metis_tpu_torch.profiles import synthesize_profiles, tiny_test_model\n"
        "from metis_tpu_torch import cli\n"
        "model = tiny_test_model()\n"
        "profiles = synthesize_profiles(model, ['tpu_v5e'], tps=[1, 2], bss=[1, 2, 4])\n"
        "slices = TpuClusterSpec((slice_from_name('v5e-16'),))\n"
        "assert plan_tpu(slices, profiles, model, SearchConfig(gbs=8)).plans\n"
        f"profiles.dump_to_dir({str(tmp_path / 'p')!r})\n"
        "assert cli.main(['tpu', '--slices', 'v5e-16', '--profile-dir', "
        f"{str(tmp_path / 'p')!r}, '--gbs', '8', '--num-layers', '10', "
        "'--hidden-size', '4096', '--seq-len', '1024', '--vocab-size', '51200', "
        f"'--num-heads', '32', '--output', {str(tmp_path / 'o.json')!r}]) == 0\n"
        "assert 'torch' not in sys.modules, 'the numpy path imported torch'\n"
        "try:\n"
        "    plan_tpu(slices, profiles, model, SearchConfig(gbs=8, cost_backend='torch'),\n"
        "             cost_device='cpu')\n"
        "except Exception:\n"
        "    pass\n"
        "assert 'torch' in sys.modules, 'the torch backend did not import torch'\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", sorted(PACKAGE.rglob("*.py"))
    + [ROOT / "chip_smoke.py", ROOT / "tools" / "torch_step_profile.py",
       ROOT / "tools" / "torch_pipeline_cards.py",
       ROOT / "tools" / "torch_nccl_cards.py",
       ROOT / "tools" / "torch_calibration_probe.py",
       ROOT / "tools" / "torch_gloo_p2p_probe.py",
       ROOT / "tools" / "torch_fleet_drill.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def _entry_points():
    from metis_tpu_torch.core.config import ModelSpec
    from metis_tpu_torch.core.types import UniformPlan
    from metis_tpu_torch.data.pipeline import TokenDataset, batch_source
    from metis_tpu_torch.entry import entry
    from metis_tpu_torch.execution.builder import build_executable
    from metis_tpu_torch.execution.mesh import PlanArtifact
    from metis_tpu_torch.execution.train import build_train_state
    from metis_tpu_torch.models.convert import from_numpy_tree
    from metis_tpu_torch.models.gpt import GPTConfig
    from metis_tpu_torch.models.llama import LlamaConfig
    from metis_tpu_torch.models.moe import MoEConfig
    from metis_tpu_torch.profiles.profiler import (
        infer_device_type,
        measure_remat_fraction,
        profile_model,
    )
    from metis_tpu_torch import cli
    from metis_tpu_torch.execution.hetero import StageSpec, make_hetero_train_step
    from metis_tpu_torch.validation import (
        measure_ranked_plan,
        measure_ranked_plan_ms,
        measure_uniform_plan_ms,
        validate_hetero_choice,
        validate_planner_choice,
    )

    from metis_tpu_torch.resilience.fleet_drill import run_supervisor_spot_drill
    from metis_tpu_torch.resilience.supervisor import TrainingSupervisor
    from metis_tpu_torch.cost.calibration import (
        measure_dp_overlap,
        measure_pipeline_overlap,
        microbenchmark_chip,
        microbenchmark_collectives,
    )
    from metis_tpu_torch.cluster.spec import ClusterSpec
    from metis_tpu_torch.cluster.tpu import TpuClusterSpec, slice_from_name
    from metis_tpu_torch.core.config import SearchConfig
    from metis_tpu_torch.planner.api import plan_hetero, plan_tpu
    from metis_tpu_torch.profiles import synthesize_profiles, tiny_test_model

    spec = ModelSpec(name="t", num_layers=3, hidden_size=32,
                     sequence_length=16, vocab_size=64, num_heads=2)
    cfg = GPTConfig(vocab_size=64, seq_len=16, hidden=32, num_heads=2,
                    num_blocks=1)
    shape = dict(vocab_size=64, seq_len=16, hidden=32, num_heads=2, num_blocks=1)
    plan = UniformPlan(1, 1, 1, 1, 1)
    ds = TokenDataset.synthetic(64, 100, 16)
    tiny = tiny_test_model()
    torch_costs = SearchConfig(gbs=4, cost_backend="torch")
    return {
        "entry": lambda: entry(),
        "build_executable": lambda: build_executable(
            cfg, PlanArtifact.from_uniform_plan(plan)),
        "build_train_state": lambda: build_train_state(0, cfg),
        "build_executable_llama": lambda: build_executable(
            LlamaConfig(**shape, num_kv_heads=1), PlanArtifact.from_uniform_plan(plan)),
        "build_executable_moe": lambda: build_executable(
            MoEConfig(**shape, num_experts=2), PlanArtifact.from_uniform_plan(plan)),
        "profile_model_llama": lambda: profile_model(
            ModelSpec(name="t", num_layers=3, hidden_size=32, sequence_length=16,
                      vocab_size=64, num_heads=2, family="llama")),
        "profile_model_moe": lambda: profile_model(
            ModelSpec(name="t", num_layers=3, hidden_size=32, sequence_length=16,
                      vocab_size=64, num_heads=2, num_experts=2)),
        "profile_model": lambda: profile_model(spec),
        "profile_model_decode": lambda: profile_model(spec, decode=True),
        "measure_remat_fraction": lambda: measure_remat_fraction(spec),
        "profile_decode_cli": lambda: cli.main([
            "profile", "--model-size", "1.5B", "--decode", "--output-dir",
            "profiles"]),
        "infer_device_type": lambda: infer_device_type(),
        "measure_uniform_plan_ms": lambda: measure_uniform_plan_ms(plan, spec),
        "from_numpy_tree": lambda: from_numpy_tree({"a": {"b": [1.0]}}),
        "batch_source": lambda: batch_source(ds, 2, device="cuda"),
        "validate_planner_choice": lambda: validate_planner_choice([], spec),
        "make_hetero_train_step": lambda: make_hetero_train_step(
            cfg, [StageSpec((0, 1), True, True, dp=1, tp=1)]),
        "measure_ranked_plan_ms": lambda: measure_ranked_plan_ms(
            _one_stage_ranked(), spec),
        "measure_ranked_plan": lambda: measure_ranked_plan(
            _one_stage_ranked(), spec),
        "validate_hetero_choice": lambda: validate_hetero_choice([], spec),
        # the device is resolved before the files are read or a plan searched
        "validate_cli": lambda: cli.main([
            "validate", "--hostfile", "hosts", "--clusterfile", "c.json",
            "--profile-dir", "profiles", "--model-size", "1.5B",
            "--gbs", "4"]),
        "train_cli": lambda: cli.main([
            "train", "--hostfile", "hosts", "--clusterfile", "c.json",
            "--profile-dir", "profiles", "--model-size", "1.5B",
            "--gbs", "4"]),
        "train_resilient_cli": lambda: cli.main([
            "train", "--resilient", "--hostfile", "hosts", "--clusterfile",
            "c.json", "--profile-dir", "profiles", "--model-size", "1.5B",
            "--gbs", "4", "--checkpoint-dir", "ckpt"]),
        "chaos_cli": lambda: cli.main([
            "chaos", "--hostfile", "hosts", "--clusterfile", "c.json",
            "--profile-dir", "profiles", "--model-size", "1.5B", "--gbs", "4",
            "--checkpoint-dir", "ckpt", "--fault-script", "preempt@1"]),
        "TrainingSupervisor": lambda: TrainingSupervisor(
            None, None, spec, None, checkpoint_dir="ckpt", steps=1),
        # the device is resolved before any process group is read
        "microbenchmark_chip": lambda: microbenchmark_chip(),
        "microbenchmark_collectives": lambda: microbenchmark_collectives(),
        "measure_dp_overlap": lambda: measure_dp_overlap(),
        "measure_pipeline_overlap": lambda: measure_pipeline_overlap(),
        "calibrate_cli": lambda: cli.main(["calibrate", "--output", "cal.json"]),
        # the fleet drill's supervisor leg, alone and behind ``chaos --fleet``
        "run_supervisor_spot_drill": lambda: run_supervisor_spot_drill("spot"),
        "chaos_fleet_cli": lambda: cli.main(["chaos", "--fleet"]),
        # the cost kernel backend prices on the card unless asked otherwise
        "plan_hetero_torch_costs": lambda: plan_hetero(
            ClusterSpec.of(("A100", 1, 4)),
            synthesize_profiles(tiny, ["A100"], tps=[1], bss=[1, 2, 4]), tiny,
            torch_costs),
        "plan_tpu_torch_costs": lambda: plan_tpu(
            TpuClusterSpec((slice_from_name("v5e-4"),)),
            synthesize_profiles(tiny, ["tpu_v5e"], tps=[1], bss=[1, 2, 4]), tiny,
            torch_costs),
    }


def _one_stage_ranked():
    from metis_tpu_torch.core.types import (
        InterStagePlan,
        IntraStagePlan,
        PlanCost,
        RankedPlan,
        Strategy,
    )

    return RankedPlan(
        inter=InterStagePlan(("H100",), (1,), batches=1, gbs=1),
        intra=IntraStagePlan((Strategy(dp=1, tp=1),), (0, 3), (0.0,), 1),
        cost=PlanCost(total_ms=1.0))


ENTRY_POINTS = ["entry", "build_executable", "build_train_state",
                "profile_model", "infer_device_type", "measure_uniform_plan_ms",
                "from_numpy_tree", "batch_source", "validate_planner_choice",
                "validate_cli", "train_cli", "make_hetero_train_step",
                "measure_ranked_plan_ms", "measure_ranked_plan",
                "validate_hetero_choice",
                "build_executable_llama", "build_executable_moe",
                "profile_model_llama", "profile_model_moe",
                "train_resilient_cli", "chaos_cli", "TrainingSupervisor",
                "microbenchmark_chip", "microbenchmark_collectives",
                "measure_dp_overlap", "measure_pipeline_overlap", "calibrate_cli",
                "profile_model_decode", "measure_remat_fraction",
                "profile_decode_cli", "run_supervisor_spot_drill",
                "chaos_fleet_cli", "plan_hetero_torch_costs",
                "plan_tpu_torch_costs"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable")
    from metis_tpu_torch.core.errors import MetisError

    with pytest.raises(MetisError, match="CUDA is not available"):
        _entry_points()[name]()


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (ROOT, tmp_path):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
