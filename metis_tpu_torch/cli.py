"""Command line of the port: ``python -m metis_tpu_torch <command> ...``.

The port of ``metis_tpu/planner/cli.py``'s training loop commands, with the
reference's flags and output bytes:

  profile   measure per-layer profiles on the CUDA cards (tp > 1 as a job of
            tp ranks, one per card) and write the profile JSON dir the
            planner reads;
  hetero    heterogeneous-cluster plan search (``planner.api.plan_hetero``);
  uniform   uniform Megatron-grid sweep (``planner.api.plan_uniform``);
  validate  predicted-vs-measured step time of the top uniform plans,
            measured on the cards, a plan of several devices (dp x tp, or
            pp > 1 on the pipeline route with the plan's microbatch count)
            one rank per card (``--device cpu`` to run on the host).

The searches run on the host and take no device.  The reference's
``--platform`` (a JAX backend pin) becomes ``--device``.  ``train`` and the
serving, daemon and audit subcommands come with later slices.

  python -m metis_tpu_torch uniform --hostfile hosts --clusterfile c.json \\
      --profile-dir profiles/ --model-size 1.5B --attn flash --gbs 4
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from metis_tpu_torch.core.config import ModelSpec, SearchConfig
from metis_tpu_torch.core.events import NULL_LOG, EventLog

# --model-size presets (copied from metis_tpu/planner/cli.py): shape defaults
# a size name expands to; explicit shape flags always win.  "1.5B" is the
# reference launcher's shape.
MODEL_SIZE_PRESETS: dict[str, dict] = {
    "1.5B": dict(num_layers=10, hidden_size=4096, seq_len=1024,
                 vocab_size=51200, num_heads=32),
    "2.7B": dict(num_layers=34, hidden_size=2560, seq_len=2048,
                 vocab_size=51200, num_heads=32),
    "6.7B": dict(num_layers=34, hidden_size=4096, seq_len=2048,
                 vocab_size=51200, num_heads=32),
    "13B": dict(num_layers=42, hidden_size=5120, seq_len=2048,
                vocab_size=51200, num_heads=40),
    "175B": dict(num_layers=98, hidden_size=12288, seq_len=2048,
                 vocab_size=51200, num_heads=96),
}


def _add_model_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("model")
    g.add_argument("--model-name", default="gpt")
    g.add_argument("--model-size", choices=sorted(MODEL_SIZE_PRESETS),
                   default=None,
                   help="shape preset; explicit shape flags override preset "
                        "fields")
    g.add_argument("--num-layers", type=int, default=None,
                   help="profiled layers incl. embed + head pseudo-layers")
    g.add_argument("--hidden-size", type=int, default=None)
    g.add_argument("--seq-len", type=int, default=None)
    g.add_argument("--vocab-size", type=int, default=None)
    g.add_argument("--num-heads", type=int, default=None)
    g.add_argument("--num-experts", type=int, default=0,
                   help="MoE expert count (0 = dense model)")
    g.add_argument("--expert-top-k", type=int, default=1)
    g.add_argument("--family", choices=("gpt", "llama"), default="gpt")
    g.add_argument("--num-kv-heads", type=int, default=0,
                   help="GQA KV heads (llama family; 0 = num_heads)")
    g.add_argument("--attn", choices=("dense", "flash"), default="dense",
                   help="attention implementation the executors AND the "
                        "profiler use")


def _add_search_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("search")
    g.add_argument("--gbs", type=int, required=True)
    g.add_argument("--max-tp", type=int, default=4)
    g.add_argument("--max-bs", type=int, default=16)
    g.add_argument("--variance", type=float, default=1.0)
    g.add_argument("--max-permute-len", type=int, default=6)
    g.add_argument("--strict-compat", action="store_true",
                   help="reproduce reference cost-model quirks bit-for-bit")
    g.add_argument("--enable-cp", action="store_true",
                   help="search context-parallel plan families (ring "
                        "attention AND Ulysses all-to-all, ranked per stage)")
    g.add_argument("--max-cp", type=int, default=4,
                   help="largest context-parallel degree to search")
    g.add_argument("--enable-ep", action="store_true",
                   help="search expert-parallel (MoE) plan families")
    g.add_argument("--max-ep", type=int, default=8,
                   help="largest expert-parallel degree to search")
    g.add_argument("--enable-zero", action="store_true",
                   help="search ZeRO-1/2/3 sharded-state plan families")
    g.add_argument("--enable-sp", action="store_true",
                   help="search Megatron sequence-parallel plan families")
    g.add_argument("--enable-schedule-search", action="store_true",
                   help="search 1f1b/interleaved pipeline-schedule plan "
                        "families (gpipe is always searched)")
    g.add_argument("--no-overlap-model", action="store_true",
                   help="price every collective fully exposed instead of "
                        "charging only the share not hidden under compute "
                        "(SearchConfig.use_overlap_model; overlap pricing "
                        "is always inert under --strict-compat)")
    g.add_argument("--no-spot-model", action="store_true",
                   help="ignore spot-tier availability when ranking: drop "
                        "the expected_recovery cost term (preemption hazard "
                        "x time-to-recover over the plan's device set; "
                        "SearchConfig.use_spot_model; always inert under "
                        "--strict-compat)")
    g.add_argument("--spot-recover-s", type=float, default=30.0,
                   help="measured time-to-recover one preemption, seconds")
    g.add_argument("--dp-overlap", type=float, default=0.0,
                   help="measured fraction of the dp gradient all-reduce "
                        "hidden under backward compute; 0 = serial model")
    g.add_argument("--workers", type=int, default=1,
                   help="shard the search across N worker processes "
                        "(search/parallel.py); the merged ranking is "
                        "byte-identical to serial, and the planner falls "
                        "back to the serial loop when multiprocessing is "
                        "unavailable")
    g.add_argument("--backend", choices=("beam", "exact"), default="beam",
                   help="search backend: the default beam/prune walk, or "
                        "the branch-and-bound backend (search/exact.py) "
                        "that attaches an optimality certificate")
    g.add_argument("--exact-deadline-s", type=float, default=None,
                   help="anytime stop for --backend exact: return the "
                        "incumbent after this many seconds with an honest "
                        "certificate")
    g.add_argument("--mem-coef", type=float, default=None,
                   help="the layer balancer's memory coefficient: a stage "
                        "needs mem_coef x the sum of its layers' profiled "
                        "peaks (default: SearchConfig's 5.0, the reference "
                        "load balancer's factor).  A flag of the port only; "
                        "fit it to a measured step peak")
    g.add_argument("--top-k", type=int, default=20)
    g.add_argument("--output", default="-", help="output path ('-' = stdout)")
    g.add_argument("--events", default=None,
                   help="append structured JSONL search events to this file")


def _add_cluster_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("cluster")
    g.add_argument("--hostfile", required=True)
    g.add_argument("--clusterfile", required=True)


def _add_device_arg(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument("--device", default="cuda",
                   help=f"torch device to {what} (the CPU only when asked "
                        "for: --device cpu)")


def _model_from_args(args: argparse.Namespace) -> ModelSpec:
    preset = MODEL_SIZE_PRESETS.get(args.model_size or "", {})
    shape = {
        k: getattr(args, k) if getattr(args, k) is not None else preset.get(k)
        for k in ("num_layers", "hidden_size", "seq_len", "vocab_size",
                  "num_heads")
    }
    missing = [k for k, v in shape.items() if v is None]
    if missing:
        raise SystemExit(
            f"missing model shape flags {missing}: pass them explicitly or "
            f"pick a --model-size preset ({', '.join(sorted(MODEL_SIZE_PRESETS))})")
    return ModelSpec(
        name=args.model_name,
        num_layers=shape["num_layers"],
        hidden_size=shape["hidden_size"],
        sequence_length=shape["seq_len"],
        vocab_size=shape["vocab_size"],
        num_heads=shape["num_heads"],
        num_experts=args.num_experts,
        expert_top_k=args.expert_top_k,
        family=args.family,
        num_kv_heads=args.num_kv_heads,
        attn=args.attn,
    )


def _config_from_args(args: argparse.Namespace) -> SearchConfig:
    extra = {} if args.mem_coef is None else {"mem_coef": args.mem_coef}
    return SearchConfig(
        gbs=args.gbs,
        max_profiled_tp=args.max_tp,
        max_profiled_bs=args.max_bs,
        min_group_scale_variance=args.variance,
        max_permute_len=args.max_permute_len,
        strict_compat=args.strict_compat,
        enable_cp=args.enable_cp,
        max_cp_degree=args.max_cp,
        enable_ep=args.enable_ep,
        max_ep_degree=args.max_ep,
        enable_zero=args.enable_zero,
        enable_sp=args.enable_sp,
        enable_schedule_search=getattr(args, "enable_schedule_search", False),
        dp_overlap_fraction=getattr(args, "dp_overlap", 0.0),
        workers=getattr(args, "workers", 1),
        use_overlap_model=not getattr(args, "no_overlap_model", False),
        use_spot_model=not getattr(args, "no_spot_model", False),
        spot_recover_s=getattr(args, "spot_recover_s", 30.0),
        backend=getattr(args, "backend", "beam"),
        exact_deadline_s=getattr(args, "exact_deadline_s", None),
        **extra,
    )


def _emit(args: argparse.Namespace, payload: str) -> None:
    if args.output == "-":
        print(payload)
    else:
        with open(args.output, "w") as f:
            f.write(payload)


def _cmd_profile(args: argparse.Namespace) -> int:
    from metis_tpu_torch.profiles.profiler import ProfilerConfig, profile_model

    if args.decode or args.decode_context is not None:
        raise NotImplementedError(
            "decode-mode profiling comes with a later slice of the port")
    model = _model_from_args(args)
    events = EventLog(args.events) if args.events else NULL_LOG
    store = profile_model(
        model,
        tps=tuple(int(t) for t in args.tps.split(",")),
        bss=tuple(int(b) for b in args.bss.split(",")),
        device=args.device,
        config=ProfilerConfig(warmup=args.warmup, iters=args.iters),
        events=events)
    store.dump_to_dir(args.output_dir,
                      {"model_name": model.name, "attn": model.attn})
    print(f"profiled {model.name} -> {args.output_dir} "
          f"({', '.join(store.device_types)})", file=sys.stderr)
    return 0


def _cmd_validate(args: argparse.Namespace, profiles, model, config) -> int:
    from metis_tpu_torch.cluster.spec import ClusterSpec
    from metis_tpu_torch.planner.api import plan_uniform
    from metis_tpu_torch.validation import (
        affine_loo_calibrated,
        validate_planner_choice,
    )

    cluster = ClusterSpec.from_files(args.hostfile, args.clusterfile)
    result = plan_uniform(cluster, profiles, model, config,
                          include_oom=True, top_k=None)
    reports = validate_planner_choice(
        result.plans, model, device=args.device, top_k=args.validate_top_k,
        steps=args.steps, warmup=args.warmup)
    if args.ledger and reports:
        # every validated plan is one (predicted, measured) accuracy pair
        from metis_tpu_torch.obs.ledger import (
            AccuracyLedger,
            fingerprint_uniform_plan,
        )

        with AccuracyLedger(args.ledger) as ledger:
            for r in reports:
                fp = fingerprint_uniform_plan(r.plan)
                if fp not in ledger.predictions:
                    ledger.record_prediction(fp, r.predicted_ms,
                                             model=model.name)
                ledger.record_measurement(fp, r.measured_ms,
                                          source="validate")
    out = {"plans": [r.to_json_dict() for r in reports]}
    # leave-one-out affine calibration per executor family, gspmd (pp = 1)
    # and pipeline (pp > 1); every calibrated error is scored by a fit that
    # excluded that plan
    fams: dict = {}
    for r in reports:
        fams.setdefault("pipeline" if r.plan.pp > 1 else "gspmd",
                        []).append(r)
    if any(len(rs) >= 2 for rs in fams.values()):
        out["calibration"] = {}
        loo_all = []
        for famname, rs in fams.items():
            fit, loo = affine_loo_calibrated(rs)
            out["calibration"][famname] = fit
            loo_all.extend(loo)
        if loo_all:
            out["calibrated_plans"] = [r.to_json_dict() for r in loo_all]
            out["calibrated_mean_abs_error_pct"] = round(
                sum(r.abs_error_pct for r in loo_all) / len(loo_all), 1)
    _emit(args, json.dumps(out, indent=2))
    if reports:
        mean_err = sum(r.abs_error_pct for r in reports) / len(reports)
        extra = (f", calibrated {out['calibrated_mean_abs_error_pct']}%"
                 if "calibrated_mean_abs_error_pct" in out else "")
        print(f"validated {len(reports)} plans, mean abs error "
              f"{mean_err:.1f}%{extra}", file=sys.stderr)
    else:
        print(
            f"no executable plans to validate ({result.num_costed} costed, "
            f"{result.num_pruned} pruned — a fully-pruned search usually "
            "means the profile device types don't match the clusterfile)",
            file=sys.stderr)
    return 0


def _cmd_search(args: argparse.Namespace, profiles, model, config,
                events) -> int:
    """``hetero`` and ``uniform``: the same JSON as the reference's."""
    from metis_tpu_torch.cluster.spec import ClusterSpec
    from metis_tpu_torch.core.types import dump_ranked_plans
    from metis_tpu_torch.planner.api import plan_hetero, plan_uniform

    cluster = ClusterSpec.from_files(args.hostfile, args.clusterfile)
    if args.command == "hetero":
        result = plan_hetero(cluster, profiles, model, config,
                             top_k=args.top_k, events=events)
        _emit(args, dump_ranked_plans(result.plans))
    else:
        result = plan_uniform(cluster, profiles, model, config,
                              device_type=args.device_type,
                              include_oom=args.include_oom, top_k=args.top_k,
                              events=events)
        payload = json.dumps([
            {
                "rank": i + 1,
                "cost_ms": r.cost.total_ms,
                "cost_breakdown": dataclasses.asdict(r.cost),
                "plan": dataclasses.asdict(r.plan),
                "device_type": r.device_type,
            }
            for i, r in enumerate(result.plans)
        ], indent=2)
        _emit(args, payload)
    print(
        f"costed {result.num_costed} plans ({result.num_pruned} pruned) "
        f"in {result.search_seconds:.2f}s",
        file=sys.stderr)
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m metis_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    p_het = sub.add_parser("hetero", help="heterogeneous-cluster plan search")
    _add_cluster_args(p_het)
    p_het.add_argument("--profile-dir", required=True)
    _add_model_args(p_het)
    _add_search_args(p_het)

    p_uni = sub.add_parser("uniform", help="uniform Megatron-grid sweep")
    _add_cluster_args(p_uni)
    p_uni.add_argument("--profile-dir", required=True)
    p_uni.add_argument("--device-type", default=None)
    p_uni.add_argument("--include-oom", action="store_true")
    _add_model_args(p_uni)
    _add_search_args(p_uni)

    p_prof = sub.add_parser(
        "profile", help="measure per-layer profiles on the CUDA card and "
                        "write the profile JSON dir")
    _add_model_args(p_prof)
    p_prof.add_argument("--output-dir", required=True)
    p_prof.add_argument("--tps", default="1",
                        help="comma-separated tp degrees to profile")
    p_prof.add_argument("--bss", default="1,2,4",
                        help="comma-separated batch sizes to profile")
    p_prof.add_argument("--warmup", type=int, default=2)
    p_prof.add_argument("--iters", type=int, default=5)
    p_prof.add_argument("--decode", action="store_true",
                        help="decode-mode profiling (a later slice; raises)")
    p_prof.add_argument("--decode-context", type=int, default=None,
                        help="KV context of decode profiling (a later slice; raises)")
    p_prof.add_argument("--events", default=None,
                        help="append structured JSONL measurement events "
                             "(profile_measured per (tp, bs)) to this file")
    _add_device_arg(p_prof, "measure on")

    p_val = sub.add_parser(
        "validate", help="predicted-vs-measured step time of the top uniform "
                         "plans on the card")
    _add_cluster_args(p_val)
    p_val.add_argument("--profile-dir", required=True)
    _add_model_args(p_val)
    _add_search_args(p_val)
    p_val.add_argument("--validate-top-k", type=int, default=3)
    p_val.add_argument("--steps", type=int, default=5)
    p_val.add_argument("--warmup", type=int, default=2)
    p_val.add_argument("--ledger", default=None,
                       help="also record every (predicted, measured) pair "
                            "to this accuracy ledger JSONL (obs/ledger.py)")
    _add_device_arg(p_val, "execute the validated plans on")

    args = parser.parse_args(argv)
    if args.command == "profile":
        return _cmd_profile(args)
    if args.command == "validate":
        # a missing card fails before the search, not after it
        from metis_tpu_torch.core.device import resolve_device

        resolve_device(args.device)

    from metis_tpu_torch.profiles.store import ProfileStore

    profiles = ProfileStore.from_dir(args.profile_dir)
    model = _model_from_args(args)
    config = _config_from_args(args)
    if args.command == "validate":
        return _cmd_validate(args, profiles, model, config)
    events = EventLog(args.events) if args.events else NULL_LOG
    return _cmd_search(args, profiles, model, config, events)


if __name__ == "__main__":
    sys.exit(main())
