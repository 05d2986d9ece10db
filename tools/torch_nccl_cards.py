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

    python3 tools/torch_nccl_cards.py --reshard

runs instead, on four cards, the bandwidth of 1. and a live reshard over
NCCL (``execution/reshard.py``, ``testing.live_reshard_rank``): the GPT at
the 1.5B preset's widths, 1 block, gbs 4, 2 steps at dp 4 + ZeRO 1,
resharded onto dp 2 x tp 2 and a step taken, bit-equal (loss and every
rank's state) to the same step after a checkpoint restore onto dp 2 x
tp 2;
its ``stall_ms`` beside ``price_migration_ms`` at the all-reduce bus
bandwidth just measured, and the checkpoint's save and restore ms.

    python3 tools/torch_nccl_cards.py --calibrate

runs instead the measured calibration over NCCL, one rank per card
(``cost/calibration.py``): ``python -m metis_tpu_torch calibrate`` on 2
cards (with ``--chip-roofline``: card 0's matmul TFLOP/s and streaming
GB/s) and on 4, each collective's fit; ``measure_dp_overlap`` at dp 4 (dp
2 with two cards); ``measure_pipeline_overlap`` at pp 2 x dp 2 (four
cards).

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


def reshard_leg(cards: list[str], bus_gb_s: float) -> dict:
    """dp 4 -> dp 2 x tp 2 live over NCCL against a checkpoint restore
    (module doc)."""
    import chip_smoke
    from metis_tpu_torch.core.config import ModelSpec
    from metis_tpu_torch.cost.volume import TransformerVolume
    from metis_tpu_torch.execution import dist as mdist
    from metis_tpu_torch.execution import reshard
    from metis_tpu_torch.execution.mesh import PlanArtifact
    from metis_tpu_torch.models import config_for_model_spec, family_ops
    from metis_tpu_torch.testing import live_reshard_rank

    # 1 block at ZeRO 1 keeps the four ranks' checkpoint near 15 GB
    spec = dict(chip_smoke.GPT_15B, num_layers=3)
    cfg = config_for_model_spec(ModelSpec(**spec))
    plans = [PlanArtifact.from_json(plan(dp=4, zero=1, blocks=1)),
             PlanArtifact.from_json(plan(dp=2, tp=2, blocks=1))]
    with tempfile.TemporaryDirectory() as tmp:
        ranks = mdist.spawn(live_reshard_rank, 4, "nccl", cards[:4], cfg,
                            batches_for(cfg, GBS), [p.to_json() for p in plans], tmp)
    leg = ranks[0]["legs"][0]
    rep = leg["report"]
    full = family_ops(cfg).init_params(None, cfg, device="meta")
    nbytes = {g: sum(t.numel() * t.element_size() for t in sub.values())
              for g, sub in full.items()}
    volume = TransformerVolume(ModelSpec(**spec), tuple(
        [nbytes["embed"]] + [nbytes["blocks"] // cfg.num_blocks] * cfg.num_blocks
        + [nbytes["head"]]))
    layouts = [reshard.stage_layout(p, cfg.num_profile_layers) for p in plans]
    price = reshard.price_migration_ms(*layouts, volume, bus_gb_s)
    equal = (leg["losses"][0] == leg["losses"][1]
             and all(r["legs"][0]["digests"][0] == r["legs"][0]["digests"][1]
                     for r in ranks))
    print(f"reshard dp 4 + ZeRO 1 -> dp 2 x tp 2 over NCCL, 1 block: {rep}; priced "
          f"{price:.3f} ms at {bus_gb_s:.1f} GB/s; checkpoint save "
          f"{max(r['legs'][0]['save_ms'] for r in ranks):.1f} + restore "
          f"{max(r['legs'][0]['restore_ms'] for r in ranks):.1f} ms; the step after "
          f"it {leg['losses'][0]!r}, after the restore {leg['losses'][1]!r}: "
          f"{'bit-equal' if equal else 'DIFFER'}; launches per rank "
          f"{[r['legs'][0]['launches'] for r in ranks]}", flush=True)
    if not rep.verified or not equal:
        raise SystemExit("the live reshard's step is not the restored one's")
    return {"report": rep.__dict__, "price_migration_ms": price, "bus_gb_s": bus_gb_s,
            "save_ms": [r["legs"][0]["save_ms"] for r in ranks],
            "restore_ms": [r["legs"][0]["restore_ms"] for r in ranks],
            "losses": leg["losses"], "bit_equal": equal,
            "launches": [r["legs"][0]["launches"] for r in ranks]}


def calibrate_leg(cards: list[str]) -> dict:
    """The measured calibration over NCCL (module doc, ``--calibrate``)."""
    from metis_tpu_torch import cli
    from metis_tpu_torch.execution import dist as mdist
    from metis_tpu_torch.cost.calibration import measure_rank

    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for world in (2, 4)[:len(cards) // 2]:
            target = pathlib.Path(tmp) / f"calibration_{world}.json"
            extra = ["--chip-roofline"] if world == 2 else []
            t0 = time.perf_counter()
            if cli.main(["calibrate", "--output", str(target), "--devices",
                         ",".join(cards[:world]), *extra]) != 0:
                raise SystemExit(f"calibrate over {world} cards failed")
            cal = json.loads(target.read_text())
            out[f"collectives_{world}"] = cal["fits"]
            for name, fit in cal["fits"].items():
                print(f"calibrate, {world} cards, {name}: latency "
                      f"{fit['latency_ms']:.4f} ms, {fit['effective_bw_gbps']:.3f} "
                      f"GB/s, r2 {fit['r2']:.4f}", flush=True)
            if extra:
                out["chip"] = json.loads(pathlib.Path(f"{target}.chip.json").read_text())
                print(f"chip roofline, card 0: {out['chip']}", flush=True)
            print(f"  calibrate {world} cards {time.perf_counter() - t0:.1f} s", flush=True)
    dp = 4 if len(cards) >= 4 else 2
    t0 = time.perf_counter()
    out[f"dp_overlap_dp{dp}"] = mdist.spawn(measure_rank, dp, "nccl", cards[:dp],
                                            "measure_dp_overlap", {})[0]["result"]
    print(f"measure_dp_overlap, dp {dp}: {out[f'dp_overlap_dp{dp}']} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if len(cards) >= 4:
        t0 = time.perf_counter()
        ranks = mdist.spawn(measure_rank, 4, "nccl", cards[:4],
                            "measure_pipeline_overlap", {})
        out["pipeline_overlap_pp2_dp2"] = dict(
            ranks[0]["result"], losses_equal=all(
                r["losses"]["overlapped"] == r["losses"]["lockstep"] for r in ranks))
        print(f"measure_pipeline_overlap, pp 2 x dp 2: {out['pipeline_overlap_pp2_dp2']} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return out


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
    cards = [f"cuda:{i}" for i in range(count)]
    if "--calibrate" in sys.argv[1:]:
        out["calibrate"] = calibrate_leg(cards)
        print(json.dumps(out, default=str))
        return 0
    fa.kernel_library()
    worlds = [2, 4] if count >= 4 else [2]
    if "--reshard" in sys.argv[1:]:
        if count < 4:
            raise SystemExit("--reshard needs four cards")
        worlds = [4]

    t0 = time.perf_counter()
    out["bandwidth"] = {}
    for world in worlds:
        ranks = mdist.spawn(bandwidth_rank, world, "nccl", cards[:world])
        out["bandwidth"][world] = ranks[0]
        print(f"NCCL over {world} cards, 256 MiB fp32: {ranks[0]}", flush=True)
    print(f"  bandwidth {time.perf_counter() - t0:.1f} s", flush=True)
    if "--reshard" in sys.argv[1:]:
        t0 = time.perf_counter()
        out["reshard"] = reshard_leg(cards, out["bandwidth"][4]["all_reduce"]["busbw_gb_s"])
        print(f"  reshard {time.perf_counter() - t0:.1f} s", flush=True)
        print(json.dumps(out, default=str))
        return 0

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
