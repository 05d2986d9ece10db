"""The pipeline phase's gpipe 4 + 4 plan over NCCL, one rank per card.

    python3 tools/torch_pipeline_cards.py

Prints the card line (``nvidia-smi``) and ``torch.cuda.device_count()``.
With one card it stops there: NCCL refuses two ranks on one card, and
``chip_smoke.py`` runs the same plan on gloo ranks sharing it.  With two or
more cards it profiles the 1.5B flash GPT at bs 1 on card 0, prices the
pp 2 plan (dp 1, tp 1, mbs 1, gbs 4: 4 microbatches, 4 + 4 blocks) with
``plan_uniform`` on a one-node cluster of two such cards, and then, on
cards 0 and 1 over NCCL: 3 steps of the plan through ``build_executable``
(losses, launches and host time of each step, each rank's peak memory) and
``validate_uniform_plan`` (two-point queue timing, fenced by a barrier
after every rank's step) against the prediction.  The last line is one JSON
object with every reading.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_pipeline_cards: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    count = torch.cuda.device_count()
    print(f"cards: {count}\n{card}", flush=True)
    out: dict = {"device_count": count, "cards": card.splitlines()}
    if count < 2:
        print(json.dumps(out))
        return 0

    import chip_smoke
    from metis_tpu_torch.cluster.spec import ClusterSpec
    from metis_tpu_torch.core.config import ModelSpec, SearchConfig
    from metis_tpu_torch.core.types import UniformPlan
    from metis_tpu_torch.execution import dist as mdist
    from metis_tpu_torch.execution.mesh import PlanArtifact
    from metis_tpu_torch.models import config_for_model_spec
    from metis_tpu_torch.planner.api import plan_uniform
    from metis_tpu_torch.profiles.profiler import profile_model
    from metis_tpu_torch.testing import run_plan_rank
    from metis_tpu_torch.validation import validate_uniform_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    model = ModelSpec(name="gpt-1.5B", num_layers=10, hidden_size=4096,
                      sequence_length=1024, vocab_size=51200, num_heads=32,
                      attn="flash")
    plan = UniformPlan(dp=1, pp=2, tp=1, mbs=1, gbs=4)
    with tempfile.TemporaryDirectory() as tmp:
        work = pathlib.Path(tmp)
        store = profile_model(model, tps=(1,), bss=(1,), device="cuda")
        device_type = store.device_types[0]
        cluster = ClusterSpec.from_files(*chip_smoke.write_cluster_files(
            work, device_type, 1, 2))
    ranked = plan_uniform(cluster, store, model, SearchConfig(
        gbs=plan.gbs, max_profiled_tp=1, max_profiled_bs=1), include_oom=True)
    predicted = next(r for r in ranked.plans if r.plan == plan).cost.total_ms
    torch.cuda.empty_cache()

    cfg = config_for_model_spec(model)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (plan.gbs, cfg.seq_len), generator=gen)
    artifact = PlanArtifact.from_uniform_plan(plan).to_json()
    ranks = mdist.spawn(run_plan_rank, 2, "nccl", ["cuda:0", "cuda:1"], artifact,
                        cfg, 0, [(tokens, tokens.roll(-1, 1))] * 3)
    for rank, r in enumerate(ranks):
        print(f"rank {rank} ({r['kind']}, blocks {list(r['block_ids'])}): losses "
              f"{r['losses']}, step ms {r['step_ms']}, launches {r['launches']}, "
              f"peak {r['peak_memory_bytes'] / 1e9:.2f} GB", flush=True)
    report = validate_uniform_plan(plan, predicted, model, device="cuda",
                                   devices=["cuda:0", "cuda:1"])
    print(f"validate pp 2: measured {report.measured_ms:.3f} ms, predicted "
          f"{report.predicted_ms:.3f} ms, error_pct {report.error_pct:.2f}",
          flush=True)
    out.update(
        plan={"dp": 1, "pp": 2, "tp": 1, "mbs": 1, "gbs": 4},
        losses=ranks[0]["losses"], step_ms=[r["step_ms"] for r in ranks],
        launches=[r["launches"] for r in ranks],
        peak_memory_gb=[r["peak_memory_bytes"] / 1e9 for r in ranks],
        measured_ms=report.measured_ms, predicted_ms=report.predicted_ms,
        error_pct=report.error_pct)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
