"""Where one training step of the PyTorch port's 1.5B models spends its time
on the card.

    python3 tools/torch_step_profile.py [--family gpt|llama|moe] [--steps 3]
                                        [--trace PATH]

Builds the ``--model-size 1.5B`` model with ``attn="flash"`` (random weights
from a seed) through ``build_executable``: the GPT at full width and depth,
or its LLaMA configuration (``--family llama --num-kv-heads 8``, full width
and depth) or MoE configuration (``--num-layers 4 --num-experts 8
--expert-top-k 2``: 2 blocks, the depth one card holds) as chip_smoke.py
runs them, at the plan
dp = pp = tp = 1, mbs = gbs = 4.  After two warm-up steps it times
``--steps`` steps on the host clock, each closed by ``torch.cuda.synchronize``
(untraced), then traces the same number of steps with ``torch.profiler``
(CPU and CUDA activities).  It prints one JSON object: the card, the untraced
and traced wall time per step, the device's busy time per step (the union
of its kernel and copy intervals) and idle share, and device time per step
for each kernel group — the three flash-attention kernels by name, matrix
products, the optimizer, and the rest — and for the ten longest kernels.
``--trace`` also writes the Chrome trace.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

GROUPS = (
    ("fa_fwd (B1)", ("fa_fwd_kernel",)),
    ("fa_bwd_dq (B2)", ("fa_bwd_dq_kernel",)),
    ("fa_bwd_dkv (B3)", ("fa_bwd_dkv_kernel",)),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "sm90_")),
    ("optimizer", ("multi_tensor_apply", "fused_adam")),
    ("memcpy/memset", ("memcpy", "memset")),
)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# ModelSpec fields of each family's 1.5B configuration beyond the GPT preset
FAMILIES = {
    "gpt": {},
    "llama": {"family": "llama", "num_kv_heads": 8},
    "moe": {"num_layers": 4, "num_experts": 8, "expert_top_k": 2},
}


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def busy_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", choices=sorted(FAMILIES), default="gpt")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default=None, help="write the Chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2

    from metis_tpu_torch.core.config import ModelSpec
    from metis_tpu_torch.core.types import UniformPlan
    from metis_tpu_torch.execution.builder import build_executable
    from metis_tpu_torch.execution.mesh import PlanArtifact
    from metis_tpu_torch.models import config_for_model_spec

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    model = ModelSpec(**{**dict(
        name=f"{args.family}-1.5B", num_layers=10, hidden_size=4096,
        sequence_length=1024, vocab_size=51200, num_heads=32, attn="flash"),
        **FAMILIES[args.family]})
    plan = UniformPlan(dp=1, pp=1, tp=1, mbs=4, gbs=4)
    cfg = config_for_model_spec(model)
    exe = build_executable(cfg, PlanArtifact.from_uniform_plan(plan))
    state = exe.init(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (plan.gbs, cfg.seq_len),
                           generator=gen, device="cuda")
    targets = tokens.roll(-1, 1)

    def steps(n: int) -> float:
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = exe.step(state, tokens, targets)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    steps(2)
    wall_ms = steps(args.steps)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        traced_ms = steps(args.steps)
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(args.trace) if args.trace else Path(tmp) / "trace.json"
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]

    # device work only: kernels and copies (the trace also draws annotation
    # ranges such as "Optimizer.step" on the device rows, which overlap them)
    device_events = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not device_events:
        print("torch.profiler recorded no device events", file=sys.stderr)
        return 1
    by_group: dict[str, float] = {}
    by_kernel: dict[str, float] = {}
    for e in device_events:
        g = group_of(e["name"])
        by_group[g] = by_group.get(g, 0.0) + e["dur"]
        by_kernel[e["name"][:80]] = by_kernel.get(e["name"][:80], 0.0) + e["dur"]
    busy = busy_us([(e["ts"], e["ts"] + e["dur"]) for e in device_events])
    n = args.steps
    print(json.dumps({
        "card": card,
        "model": f"{model.name} flash, {cfg.num_blocks} blocks, bs 4, seq 1024",
        "steps": n,
        "wall_ms_per_step": wall_ms,
        "traced_wall_ms_per_step": traced_ms,
        "device_busy_ms_per_step": busy / 1e3 / n,
        "device_idle_share": 1.0 - (busy / 1e3 / n) / traced_ms,
        "device_ms_per_step_by_group": {
            g: by_group[g] / 1e3 / n for g in sorted(by_group, key=by_group.get,
                                                      reverse=True)},
        "top_kernels_ms_per_step": {
            k: by_kernel[k] / 1e3 / n
            for k in sorted(by_kernel, key=by_kernel.get, reverse=True)[:10]},
        "device_events": len(device_events),
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
