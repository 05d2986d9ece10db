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
       ROOT / "tools" / "torch_gloo_p2p_probe.py"],
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
    from metis_tpu_torch.profiles.profiler import infer_device_type, profile_model
    from metis_tpu_torch import cli
    from metis_tpu_torch.execution.hetero import StageSpec, make_hetero_train_step
    from metis_tpu_torch.validation import (
        measure_ranked_plan,
        measure_ranked_plan_ms,
        measure_uniform_plan_ms,
        validate_hetero_choice,
        validate_planner_choice,
    )

    from metis_tpu_torch.resilience.supervisor import TrainingSupervisor
    from metis_tpu_torch.cost.calibration import (
        measure_dp_overlap,
        measure_pipeline_overlap,
        microbenchmark_chip,
        microbenchmark_collectives,
    )

    spec = ModelSpec(name="t", num_layers=3, hidden_size=32,
                     sequence_length=16, vocab_size=64, num_heads=2)
    cfg = GPTConfig(vocab_size=64, seq_len=16, hidden=32, num_heads=2,
                    num_blocks=1)
    shape = dict(vocab_size=64, seq_len=16, hidden=32, num_heads=2, num_blocks=1)
    plan = UniformPlan(1, 1, 1, 1, 1)
    ds = TokenDataset.synthetic(64, 100, 16)
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
                "measure_dp_overlap", "measure_pipeline_overlap", "calibrate_cli"]


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
