"""The cross-card legs of ROADMAP §A.1 over NCCL, one rank per card.

    python3 tools/torch_nccl_cards.py

Prints the card line (``nvidia-smi``) and ``torch.cuda.device_count()``;
with fewer than two cards it stops there (``chip_smoke.py`` runs these
plans on gloo ranks sharing one card).  With two or more:

1. NCCL bandwidth: ``all_reduce`` and ``all_gather`` of 256 MiB of fp32
   over 2 ranks (and 4 with four cards), 10 timed calls each after 3
   warm-up calls, as algorithm and bus GB/s (NCCL's own definitions);
2. the GPT at the 1.5B preset's widths, 2 blocks, gbs 4, 3 steps on fresh
   batches: one device on card 0, then in one spawn of 2 ranks tp 2, tp 2
   + sp, dp 2 at ZeRO 0, 1 and 3, cp 2 ring and cp 2 Ulysses (the
   ``RingTransfer``, sp, ZeRO and all-to-all branches over NCCL), and with
   four cards dp 2 x tp 2: each rank's losses against one device, its
   host step ms (each step synchronized by reading its loss) and peak;
3. tp 2 at full depth (8 blocks) against one device at full depth;
4. the MoE (``MOE_15B`` at 1 block, gbs 8) at ep 2: the expert
   all-to-all over NCCL, against one device;
5. ``profile --tps 1,2,4`` (``1,2`` with two cards) of the 2-block GPT at
   bs 4: the tp > 1 profiles, each layer's ms.

The last line is one JSON object with every reading.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

GBS = 4
STEPS = 3
PAYLOAD_BYTES = 256 * 2**20


def bandwidth_rank(rank: int, device: torch.device) -> dict:
    """Rank body: ms and GB/s of ``all_reduce`` and ``all_gather`` of
    ``PAYLOAD_BYTES`` of fp32 over the whole process group."""
    n = dist.get_world_size()
    x = torch.ones(PAYLOAD_BYTES // 4, device=device)
    mine = torch.ones(PAYLOAD_BYTES // 4 // n, device=device)
    parts = [torch.empty_like(mine) for _ in range(n)]
    out = {}
    for name, call, bus in (
            ("all_reduce", lambda: dist.all_reduce(x), 2 * (n - 1) / n),
            ("all_gather", lambda: dist.all_gather(parts, mine), (n - 1) / n)):
        for _ in range(3):
            call()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(10):
            call()
        torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) / 10 * 1e3
        size = PAYLOAD_BYTES if name == "all_reduce" else PAYLOAD_BYTES // n * n
        algbw = size / (ms / 1e3) / 1e9
        out[name] = {"ms": ms, "algbw_gb_s": algbw, "busbw_gb_s": algbw * bus}
    return out


def plan(dp=1, tp=1, cp=1, ep=1, sp=False, zero=0, mode="ring", blocks=2,
         gbs=GBS) -> str:
    from metis_tpu_torch.execution.mesh import PlanArtifact

    return PlanArtifact(
        mesh_axes=("pp", "dp", "ep", "sp", "tp"), mesh_shape=(1, dp, ep, cp, tp),
        layer_partition=(0, blocks + 2),
        strategies=({"dp": dp * ep, "tp": tp, "cp": cp, "ep": ep, "zero": zero,
                     "sp": sp, "cp_mode": mode},),
        gbs=gbs, microbatches=1).to_json()


def one_device(cfg, batches, device) -> dict:
    """The losses and host step ms of ``batches`` on one device."""
    from metis_tpu_torch.core.types import UniformPlan
    from metis_tpu_torch.execution.builder import build_executable
    from metis_tpu_torch.execution.mesh import PlanArtifact

    gbs = batches[0][0].shape[0]
    exe = build_executable(cfg, PlanArtifact.from_uniform_plan(
        UniformPlan(1, 1, 1, gbs, gbs)), device=device)
    state, out = exe.init(0), {"losses": [], "step_ms": []}
    for tok, tgt in batches:
        t0 = time.perf_counter()
        state, loss = exe.step(state, tok.to(device), tgt.to(device))
        out["losses"].append(loss.item())
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
    del state, exe
    torch.cuda.empty_cache() if torch.device(device).type == "cuda" else None
    return out


def legs(cfg, batches, jobs: dict, world: int, backend: str, devices) -> dict:
    """``jobs`` ({name: artifact JSON}) in one spawn of ``world`` ranks;
    per leg each rank's losses, step ms, launches and peak."""
    from metis_tpu_torch.execution import dist as mdist
    from metis_tpu_torch.testing import run_plans_rank

    ranks = mdist.spawn(run_plans_rank, world, backend, devices, [dict(
        artifact_json=art, cfg=cfg, init=0, batches=batches) for art in jobs.values()])
    out = {}
    for i, name in enumerate(jobs):
        leg = [r[i] for r in ranks]
        out[name] = {"kind": leg[0]["kind"], "losses": leg[0]["losses"],
                     "step_ms": [r["step_ms"] for r in leg],
                     "launches": [r["launches"][-1] for r in leg],
                     "peak_memory_gb": [r.get("peak_memory_bytes", 0) / 1e9
                                        for r in leg]}
    return out


def batches_for(cfg, gbs: int, seed: int = 1) -> list:
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(STEPS):
        t = torch.randint(0, cfg.vocab_size, (gbs, cfg.seq_len), generator=gen)
        out.append((t, t.roll(-1, 1)))
    return out


def report(label: str, got: dict, ref: dict) -> dict:
    gap = max(abs(a - b) for a, b in zip(got["losses"], ref["losses"]))
    warm = [sum(ms[1:]) / len(ms[1:]) for ms in got["step_ms"]]
    print(f"{label}: {got['kind']}, losses {[round(x, 5) for x in got['losses']]}, gap "
          f"to one device {gap:.3e}; warm step ms per rank {[round(x, 2) for x in warm]} "
          f"(one device {sum(ref['step_ms'][1:]) / len(ref['step_ms'][1:]):.2f}); peaks "
          f"{[round(x, 2) for x in got['peak_memory_gb']]} GB; launches {got['launches']}",
          flush=True)
    return {**got, "gap_to_one_device": gap, "warm_step_ms": warm}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_nccl_cards: CUDA is not available", file=sys.stderr)
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
    from metis_tpu_torch import cli
    from metis_tpu_torch.core.config import ModelSpec
    from metis_tpu_torch.execution import dist as mdist
    from metis_tpu_torch.models import config_for_model_spec
    from metis_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    fa.kernel_library()
    cards = [f"cuda:{i}" for i in range(count)]
    worlds = [2, 4] if count >= 4 else [2]

    t0 = time.perf_counter()
    out["bandwidth"] = {}
    for world in worlds:
        ranks = mdist.spawn(bandwidth_rank, world, "nccl", cards[:world])
        out["bandwidth"][world] = ranks[0]
        print(f"NCCL over {world} cards, 256 MiB fp32: {ranks[0]}", flush=True)
    print(f"  bandwidth {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    cfg = config_for_model_spec(ModelSpec(**dict(chip_smoke.GPT_15B, num_layers=4)))
    batches = batches_for(cfg, GBS)
    ref = one_device(cfg, batches, "cuda:0")
    print(f"one device, 2 blocks: losses {ref['losses']}, step ms {ref['step_ms']}",
          flush=True)
    two = {"tp2": plan(tp=2), "tp2_sp": plan(tp=2, sp=True), "dp2": plan(dp=2),
           "dp2_zero1": plan(dp=2, zero=1), "dp2_zero3": plan(dp=2, zero=3),
           "cp2_ring": plan(cp=2), "cp2_a2a": plan(cp=2, mode="a2a")}
    out["gpt_2_blocks"] = {"one_device": ref}
    for name, got in legs(cfg, batches, two, 2, "nccl", cards[:2]).items():
        out["gpt_2_blocks"][name] = report(name, got, ref)
    if 4 in worlds:
        got = legs(cfg, batches, {"dp2_tp2": plan(dp=2, tp=2)}, 4, "nccl", cards[:4])
        out["gpt_2_blocks"]["dp2_tp2"] = report("dp2_tp2", got["dp2_tp2"], ref)
    print(f"  2-block legs {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    full = config_for_model_spec(ModelSpec(**chip_smoke.GPT_15B))
    batches = batches_for(full, GBS)
    ref = one_device(full, batches, "cuda:0")
    got = legs(full, batches, {"tp2": plan(tp=2, blocks=full.num_blocks)}, 2, "nccl",
               cards[:2])
    out["gpt_full_tp2"] = report("tp2, 8 blocks", got["tp2"], ref)
    out["gpt_full_tp2"]["one_device"] = ref
    print(f"  full-depth tp 2 {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    moe = config_for_model_spec(ModelSpec(**dict(chip_smoke.MOE_15B, num_layers=3)))
    batches = batches_for(moe, 8)
    ref = one_device(moe, batches, "cuda:0")
    got = legs(moe, batches, {"ep2": plan(ep=2, blocks=1, gbs=8)}, 2, "nccl",
               cards[:2])
    out["moe_ep2"] = report("MoE ep 2, 1 block, gbs 8", got["ep2"], ref)
    print(f"  MoE ep 2 {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    tps = ",".join(str(w) for w in [1, *worlds])
    with tempfile.TemporaryDirectory() as tmp:
        prof = pathlib.Path(tmp) / "profiles"
        if cli.main(["profile", *chip_smoke.CLI_MODEL["gpt-1.5B"], "--model-name",
                     "gpt-1.5B", "--num-layers", "4", "--tps", tps, "--bss", "4",
                     "--output-dir", str(prof), "--device", "cuda"]) != 0:
            raise SystemExit("profile --tps failed")
        out["profiles"] = {}
        for path in sorted(prof.glob("*.json")):
            data = json.loads(path.read_text())
            out["profiles"][path.name] = {
                "layer_compute_total_ms": data["execution_time"]["layer_compute_total_ms"],
                "layer_memory_total_mb": data["execution_memory"]["layer_memory_total_mb"]}
            print(f"{path.name}: {out['profiles'][path.name]}", flush=True)
    print(f"  profile --tps {tps} {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
