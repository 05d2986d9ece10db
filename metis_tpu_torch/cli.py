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
            one rank per card (``--device cpu`` to run on the host);
  train     plan and run: search the cluster (or resume on the plan a
            checkpoint pinned; with ``--replan-on-resume`` search the
            cluster as it is now and restore the checkpoint onto the new
            plan), build the plan's executable, stream batches through the
            input pipeline and train with checkpoints, a plan of several
            devices one rank per device; with ``--resilient`` under the
            fault-tolerant supervisor (``resilience/supervisor.py``), one
            rank per device of the cluster;
  chaos     the supervisor under a scripted fault sequence
            (``--fault-script``), its report as JSON;
  replan    diff two cluster descriptions, search the new one, report
            the delta and the cost movement (``planner/replan.py``);
  calibrate time the collectives over the devices, one rank per device,
            and write the fitted wire model's JSON (``cost/calibration.py``;
            exit 1 with one device), with ``--chip-roofline`` also the
            first device's matmul TFLOP/s and memory GB/s.

The searches run on the host and take no device.  The reference's
``--platform`` (a JAX backend pin) becomes ``--device``.  ``train``'s
multi-host flags parse and exit 2 naming their ROADMAP item, as does
``chaos --fleet``; the serving, daemon and audit subcommands come with
later slices.

  python -m metis_tpu_torch uniform --hostfile hosts --clusterfile c.json \\
      --profile-dir profiles/ --model-size 1.5B --attn flash --gbs 4
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from metis_tpu_torch.core.config import ModelSpec, SearchConfig
from metis_tpu_torch.core.errors import MetisError
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


def _cmd_calibrate(args: argparse.Namespace) -> int:
    """``calibrate``: the reference's files, stderr lines and exit codes."""
    from metis_tpu_torch.core.device import resolve_device
    from metis_tpu_torch.cost.calibration import measure_rank, microbenchmark_chip
    from metis_tpu_torch.execution import dist as mdist

    devices = ([d.strip() for d in args.devices.split(",")] if args.devices
               else mdist.default_devices(resolve_device(args.device)))
    wrote_output = False
    if len(devices) >= 2:
        backend = args.dist_backend or mdist.default_backend(devices)
        cal = mdist.spawn(
            measure_rank, len(devices), backend, devices,
            "microbenchmark_collectives",
            dict(payload_kb=tuple(int(k) for k in args.payload_kb.split(",")),
                 iters=args.iters))[0]["result"]
        cal.dump(args.output)
        wrote_output = True
        print(f"calibrated {len(cal.fits)} collectives over {len(devices)} "
              f"{cal.platform} devices -> {args.output}", file=sys.stderr)
    else:
        print("1 device visible: cannot calibrate collectives (needs >= 2); "
              f"{args.output} NOT written", file=sys.stderr)
    if args.chip_roofline:
        chip = microbenchmark_chip(devices[0])
        chip_path = args.output + ".chip.json"
        with open(chip_path, "w") as f:
            json.dump(chip, f, indent=1)
        print(f"chip roofline -> {chip_path}: {chip}", file=sys.stderr)
    # a downstream reader of args.output must not find a stale or missing
    # file after a silent success
    return 0 if wrote_output else 1


def _cmd_replan(args: argparse.Namespace, profiles, model, config,
                events) -> int:
    """``replan``: the reference's payload and stderr line."""
    from metis_tpu_torch.cluster.spec import ClusterSpec
    from metis_tpu_torch.core.types import dump_ranked_plans
    from metis_tpu_torch.planner.replan import replan

    old = ClusterSpec.from_files(args.hostfile, args.clusterfile)
    new = ClusterSpec.from_files(args.new_hostfile, args.new_clusterfile)
    report = replan(old, new, profiles, model, config,
                    search_old=not args.no_old_cost, events=events)
    payload = {
        "delta": {"added": report.delta.added,
                  "removed": report.delta.removed},
        "plan_changed": report.plan_changed,
        "old_best_cost_ms": report.old_best_cost_ms,
        "new_best_cost_ms": report.new_best_cost_ms,
        "cost_ratio": report.cost_ratio,
        "plans": json.loads(
            dump_ranked_plans(report.result.plans, limit=args.top_k)),
    }
    _emit(args, json.dumps(payload, indent=2))
    print(
        f"replan: delta +{report.delta.added or '{}'} "
        f"-{report.delta.removed or '{}'}; plan_changed="
        f"{report.plan_changed}; cost {report.old_best_cost_ms} -> "
        f"{report.new_best_cost_ms} ms", file=sys.stderr)
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


# train's flags of later ROADMAP items: (flag, dest, the item)
LATER_TRAIN_FLAGS = (
    ("--coordinator", "coordinator", "§A.7 (multi-host training)"),
    ("--num-processes", "num_processes", "§A.7 (multi-host training)"),
    ("--process-id", "process_id", "§A.7 (multi-host training)"),
    ("--slice-controller", "slice_controller", "§A.7 (multi-host training)"),
    ("--peers", "peers", "§A.7 (multi-host training)"),
)


def _add_train_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--profile-dir", required=True)
    p.add_argument("--steps", type=int, default=10,
                   help="training steps to run")
    p.add_argument("--schedule", choices=("gpipe", "1f1b", "interleaved"),
                   default=None,
                   help="pipeline schedule for rectangular pp>1 plans "
                        "(default: the schedule the plan was priced with)")
    p.add_argument("--virtual-stages", type=int, default=None,
                   help="model chunks per device for --schedule "
                        "interleaved (default: the plan's)")
    p.add_argument("--data", default=None,
                   help="flat token stream (.npy / raw int32 .bin, "
                        "memmapped); default: synthetic tokens")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save (and resume from) checkpoints here")
    p.add_argument("--replan-on-resume", action="store_true",
                   help="elastic recovery: ignore the checkpoint's pinned "
                        "plan, search the CURRENT cluster fresh, and restore "
                        "the training state onto the new plan (resharded "
                        "through the checkpoint's slice maps) — resume after "
                        "losing or gaining devices")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="also checkpoint every N steps (async on the gspmd "
                        "and pipeline routes); 0 = final only")
    p.add_argument("--log-every", type=int, default=1,
                   help="emit a train_step event every N steps")
    p.add_argument("--ledger", default=None,
                   help="cost-model accuracy ledger JSONL: record the chosen "
                        "plan's predicted breakdown and every measured step "
                        "(obs/ledger.py)")
    p.add_argument("--drift-band", type=float, default=20.0,
                   help="rolling MAPE %% that fires the drift alarm")
    _add_rank_args(p)
    g_res = p.add_argument_group(
        "resilience (resilience/supervisor.py — one rank per device of the "
        "cluster)")
    g_res.add_argument("--resilient", action="store_true",
                       help="run under the fault-tolerant training "
                            "supervisor: loss anomaly guards, retrying "
                            "checkpoints with .prev retention, SIGTERM "
                            "drain, replan-on-device-loss.  Requires "
                            "--checkpoint-dir")
    g_res.add_argument("--fault-script", default=None,
                       help="deterministic fault injection script, e.g. "
                            "'checkpoint_write@2x2,device_loss@5' "
                            "(resilience/faults.py syntax)")
    _add_retry_args(g_res)
    later = p.add_argument_group(
        "later items (parsed; each exits 2 naming its ROADMAP item)")
    for flag, dest, _ in LATER_TRAIN_FLAGS:
        later.add_argument(flag, dest=dest, default=None)
    _add_device_arg(p, "train on")


def _add_rank_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--devices", default=None,
                   help="comma-separated torch devices, one per rank of a "
                        "plan of several devices (default: every visible "
                        "card, or one CPU device with --device cpu); "
                        "'cuda:0,cuda:0' puts two ranks on one card")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="process-group backend of a plan of several devices "
                        "(default: nccl on CUDA, gloo on the CPU; gloo to "
                        "share a card)")


def _add_retry_args(p) -> None:
    p.add_argument("--retry-attempts", type=int, default=3,
                   help="transient-IO retry budget per checkpoint write")
    p.add_argument("--spike-factor", type=float, default=10.0,
                   help="loss > this x the rolling mean is flagged as a spike "
                        "anomaly")


def train_job(argv: list[str]) -> dict:
    """The job ``python -m metis_tpu_torch train`` with the arguments
    ``argv`` hands each rank (``train_rank``'s), after its search or the
    checkpoint's pinned plan: for a caller that launches the ranks
    itself."""
    args = _parser().parse_args(["train", *argv])
    job = _train_job(args, _model_from_args(args), _config_from_args(args),
                     EventLog(args.events) if args.events else NULL_LOG)
    if isinstance(job, int):
        raise SystemExit(job)
    return job


def _train_job(args: argparse.Namespace, model, config, events) -> dict | int:
    """Plan (or pin the checkpoint's plan): the job of every rank of
    ``train``, or the exit code of a refused run, or with ``--resilient``
    of the supervised run (``_run_supervisor``)."""
    for flag, dest, item in LATER_TRAIN_FLAGS:
        if getattr(args, dest) not in (None, False):
            print(f"train {flag} comes with ROADMAP {item}; this slice of "
                  "the port does not run it", file=sys.stderr)
            return 2
    if args.resilient:
        if args.checkpoint_dir is None:
            print("--resilient requires --checkpoint-dir (recovery restores "
                  "from the latest checkpoint)", file=sys.stderr)
            return 2
        return _run_supervisor(args, model, config, events)
    from metis_tpu_torch.cluster.spec import ClusterSpec
    from metis_tpu_torch.core.device import resolve_device
    from metis_tpu_torch.execution.checkpoint import load_plan
    from metis_tpu_torch.execution.mesh import PlanArtifact
    from metis_tpu_torch.planner.api import plan_hetero
    from metis_tpu_torch.profiles.store import ProfileStore

    resolve_device(args.device)  # a missing card fails before the search
    cluster = ClusterSpec.from_files(args.hostfile, args.clusterfile)
    profiles = ProfileStore.from_dir(args.profile_dir)
    # resume pins the checkpoint's plan: a fresh search could pick another
    # plan, whose state layout would not match the checkpoint
    art = plan_cost_ms = prediction = None
    replanned = False
    if args.checkpoint_dir is not None:
        art = load_plan(args.checkpoint_dir)
        if art is not None and args.replan_on_resume:
            # elastic recovery: the pinned plan may need devices that are
            # gone; search the cluster as it is and restore onto the new
            # plan through the checkpoint's slice maps
            print("--replan-on-resume: ignoring the pinned plan, searching "
                  "the current cluster", file=sys.stderr)
            art = None
            replanned = True
        elif art is not None:
            print(f"resuming with the plan pinned by {args.checkpoint_dir} "
                  "(search skipped)", file=sys.stderr)
    if art is None:
        result = plan_hetero(cluster, profiles, model, config, top_k=1,
                             events=events)
        if result.best is None:
            print(f"no feasible plan ({result.num_costed} costed, "
                  f"{result.num_pruned} pruned)", file=sys.stderr)
            return 1
        art = PlanArtifact.from_ranked_plan(result.best)
        plan_cost_ms = result.best.cost.total_ms
        bd = result.best.breakdown
        prediction = dict(components=bd.components if bd is not None else None,
                          stage_ms=bd.stage_execution_ms if bd is not None else ())
    return dict(artifact=art.to_json(), model=model, args=vars(args),
                plan_cost_ms=plan_cost_ms, prediction=prediction,
                replanned=replanned)


def _rank_devices(args: argparse.Namespace, need: int):
    """The devices of ``need`` ranks (``--devices``, else every visible
    card or the CPU) and the process group's backend; None (after saying
    why) when there are fewer."""
    from metis_tpu_torch.core.device import resolve_device
    from metis_tpu_torch.execution import dist as mdist

    devs = ([d.strip() for d in args.devices.split(",")] if args.devices
            else mdist.default_devices(resolve_device(args.device)))
    if len(devs) < need:
        print(f"the plan needs {need} devices, this run has {len(devs)} "
              f"({[str(d) for d in devs]}); pass --devices", file=sys.stderr)
        return None
    devs = devs[:need]
    return devs, args.dist_backend or mdist.default_backend(devs)


def _run_supervisor(args: argparse.Namespace, model, config, events) -> int:
    """What ``train --resilient`` and ``chaos`` share: the fault
    script and resilience knobs from flags, the supervisor on one rank per
    device of the cluster (``resilience.supervisor.supervised_rank``), its
    report as JSON.  Exit 0 for the two healthy outcomes (completed /
    cleanly preempted), 1 for a failed run.  A SIGTERM to this process
    reaches every rank, which drain together."""
    import multiprocessing
    import os
    import signal

    from metis_tpu_torch.cluster.spec import ClusterSpec
    from metis_tpu_torch.core.config import ResilienceConfig
    from metis_tpu_torch.core.device import resolve_device
    from metis_tpu_torch.execution import dist as mdist
    from metis_tpu_torch.resilience.supervisor import supervised_rank

    dev = resolve_device(args.device)  # a missing card fails first
    cluster = ClusterSpec.from_files(args.hostfile, args.clusterfile)
    job = dict(
        cluster=cluster, profile_dir=args.profile_dir, model=model,
        config=config, checkpoint_dir=args.checkpoint_dir, steps=args.steps,
        resilience=ResilienceConfig(
            checkpoint_every=getattr(args, "checkpoint_every", 0) or 1,
            retry_attempts=args.retry_attempts,
            spike_factor=args.spike_factor),
        fault_script=args.fault_script or "", seed=getattr(args, "seed", 0),
        events=args.events, data=getattr(args, "data", None),
        install_signal_handler=True)
    world = cluster.total_devices
    if world == 1:
        out = supervised_rank(0, dev, job, events=events)
    else:
        launch = _rank_devices(args, world)
        if launch is None:
            return 1

        def forward(signum, frame):  # pragma: no cover — a real SIGTERM
            for child in multiprocessing.active_children():
                os.kill(child.pid, signum)

        prev = signal.signal(signal.SIGTERM, forward)
        try:
            out = mdist.spawn(supervised_rank, world, launch[1], launch[0],
                              job)[0]
        finally:
            signal.signal(signal.SIGTERM, prev)
    report = out["report"]
    _emit(args, json.dumps(report, indent=2))
    if report["outcome"] == "failed":
        print(f"supervised run FAILED: {report['detail']}", file=sys.stderr)
        return 1
    print(f"supervised run {report['outcome']}: {report['steps_done']}/"
          f"{report['target_steps']} steps, {len(report['recoveries'])} "
          f"recoveries, {report['retries']} retries, {report['checkpoints']} "
          "checkpoints", file=sys.stderr)
    print("rank 0 checkpoint ms: " + json.dumps(
        {k: [round(ms, 1) for ms in out[k]] for k in ("save_ms", "restore_ms")}),
        file=sys.stderr)
    return 0


def _run_train(args: argparse.Namespace, job: dict) -> int:
    """``job`` on one rank per device of its plan (the one device in this
    process); rank 0's summary to ``--output``."""
    from metis_tpu_torch.core.device import resolve_device
    from metis_tpu_torch.execution import dist as mdist
    from metis_tpu_torch.execution.mesh import PlanArtifact

    dev = resolve_device(args.device)
    need = PlanArtifact.from_json(job["artifact"]).num_devices
    if need == 1:
        out = [train_rank(0, dev, job)]
    else:
        launch = _rank_devices(args, need)
        if launch is None:
            return 1
        out = mdist.spawn(train_rank, need, launch[1], launch[0], job)
    rc, summary = out[0]["rc"], out[0]["summary"]
    if rc == 0:
        _emit(args, json.dumps(summary, indent=2))
    return rc


def train_rank(rank: int, device, job: dict) -> dict:
    """One rank of ``train`` (``execution.dist.spawn``'s body, or the whole
    run on one device): build the plan's executable, resume from the
    checkpoint when there is one, stream batches, train and checkpoint.
    Returns ``{"rc", "summary"}``; rank 0 writes the events, the ledger
    and the summary."""
    import time

    import numpy as np

    from metis_tpu_torch.cluster.spec import ClusterSpec
    from metis_tpu_torch.data.pipeline import (
        TokenDataset,
        make_input_pipeline,
        synthetic_run_dataset,
    )
    from metis_tpu_torch.execution.builder import (
        build_executable,
        checkpoint_block_layout,
        exec_state_to_train_state,
        resolve_schedule,
        train_state_to_exec_state,
    )
    from metis_tpu_torch.execution.checkpoint import (
        AsyncCheckpointWriter,
        block_layouts_compatible,
        load_meta,
        restore_checkpoint,
        restore_hetero_checkpoint,
        save_checkpoint,
        save_hetero_checkpoint,
    )
    from metis_tpu_torch.execution.mesh import PlanArtifact
    from metis_tpu_torch.execution.train import StepTimer
    from metis_tpu_torch.models import config_for_model_spec
    from metis_tpu_torch.ops import flash_attention as fa
    from metis_tpu_torch.profiles.store import ProfileStore

    args = argparse.Namespace(**job["args"])
    art = PlanArtifact.from_json(job["artifact"])
    model, plan_cost_ms = job["model"], job["plan_cost_ms"]
    is_main = rank == 0
    events = EventLog(args.events) if args.events and is_main else NULL_LOG
    say = (lambda msg: print(msg, file=sys.stderr)) if is_main else (lambda msg: None)
    cluster = ClusterSpec.from_files(args.hostfile, args.clusterfile)
    profiles = ProfileStore.from_dir(args.profile_dir)
    cfg = config_for_model_spec(model)
    schedule, virtual_stages = resolve_schedule(art, args.schedule,
                                                args.virtual_stages)

    def build(sched):
        return build_executable(cfg, art, device, cluster=cluster,
                                profiles=profiles, schedule=sched,
                                virtual_stages=virtual_stages, events=events)

    try:
        exe = build(schedule)
    except ValueError as e:
        if schedule != "interleaved" or "interleaved" not in str(e):
            raise
        # the chosen plan's shape decides eligibility: degrade, don't die
        say(f"{e}; falling back to --schedule gpipe")
        schedule = "gpipe"
        exe = build(schedule)
    cost_txt = (f"cost {plan_cost_ms:.1f} ms" if plan_cost_ms is not None
                else "pinned")
    say(f"best plan ({cost_txt}) -> {exe.kind} executable; stages "
        f"{art.device_groups or '1'}, gbs {art.gbs} x {args.steps} steps")

    if args.data:
        tokens = (np.load(args.data, mmap_mode="r") if args.data.endswith(".npy")
                  else np.memmap(args.data, dtype=np.int32, mode="r"))
        dataset = TokenDataset(tokens, model.sequence_length)
    else:
        dataset = synthetic_run_dataset(model.vocab_size, art.gbs,
                                        model.sequence_length)
    can_ckpt = args.checkpoint_dir is not None
    hetero = exe.kind == "hetero"
    block_layout = checkpoint_block_layout(art, cfg, exe.kind, schedule,
                                           virtual_stages)
    state = exe.init(0)
    start_step = 0
    if can_ckpt:
        try:
            meta = load_meta(args.checkpoint_dir)
        except FileNotFoundError:
            meta = None
        if meta is not None:
            if not block_layouts_compatible(meta, block_layout):
                say(f"checkpoint {args.checkpoint_dir} was written with block "
                    f"layout '{meta.block_layout}' but this run uses "
                    f"'{block_layout}' (--schedule/--virtual-stages "
                    "changed?) — refusing to resume")
                return {"rc": 1, "summary": None}
            start_step = meta.step
            t0 = time.perf_counter()
            stats: dict = {}
            try:
                if hetero:
                    state = restore_hetero_checkpoint(args.checkpoint_dir,
                                                      state, exe.mesh, stats)
                else:
                    state = train_state_to_exec_state(exe.kind, restore_checkpoint(
                        args.checkpoint_dir,
                        exec_state_to_train_state(exe.kind, state, start_step),
                        mesh=art, stats=stats))
            except MetisError as e:
                if not job.get("replanned"):
                    raise
                # the slice maps reshard across meshes, not across state
                # structures (another route family, stage partition or
                # model): the reference refuses the same restores
                say("--replan-on-resume: the checkpoint's state structure "
                    f"does not fit the re-planned {exe.kind} executable (the "
                    "old plan likely routed to a different executor family) "
                    f"— {type(e).__name__}: {e}")
                return {"rc": 1, "summary": None}
            ms = (time.perf_counter() - t0) * 1e3
            events.emit("checkpoint_restore", step=start_step, ms=ms, **stats)
            say(f"resumed from {args.checkpoint_dir} at step {start_step} "
                f"({ms:.1f} ms)")

    # a resumed run continues through the data stream: one batch per
    # completed step, skipped arithmetically
    batches = make_input_pipeline(dataset, art.gbs, device=device, epochs=None,
                                  skip_batches=start_step)
    writer = AsyncCheckpointWriter() if can_ckpt and not hetero else None

    def save(state, step, final):
        t0 = time.perf_counter()
        if hetero:
            save_hetero_checkpoint(args.checkpoint_dir, state, step, exe.mesh,
                                   plan=art)
        elif final:
            save_checkpoint(args.checkpoint_dir,
                            exec_state_to_train_state(exe.kind, state, step),
                            art, plan=art, block_layout=block_layout)
        else:
            writer.save(args.checkpoint_dir,
                        exec_state_to_train_state(exe.kind, state, step),
                        art, plan=art, block_layout=block_layout)
        events.emit("checkpoint_save", step=step,
                    mode="async" if writer is not None and not final else "sync",
                    ms=(time.perf_counter() - t0) * 1e3)

    monitor = ledger = None
    if args.ledger and is_main:
        from metis_tpu_torch.obs.ledger import (
            AccuracyLedger,
            AccuracyMonitor,
            fingerprint_artifact,
        )

        ledger = AccuracyLedger(args.ledger)
        fp = fingerprint_artifact(art)
        if plan_cost_ms is not None and fp not in ledger.predictions:
            ledger.record_prediction(fp, plan_cost_ms, model=model.name,
                                     schedule=art.schedule,
                                     **(job["prediction"] or {}))
        elif fp not in ledger.predictions:
            say(f"--ledger: pinned plan {fp} has no recorded prediction; "
                "measurements will be unmatched until one is recorded")
        monitor = AccuracyMonitor(ledger, fp, events=events,
                                  band_pct=args.drift_band)

    timer = StepTimer(events, tokens_per_step=art.gbs * model.sequence_length,
                      start_step=start_step, monitor=monitor)
    losses: list[float] = []
    t0 = time.perf_counter()
    try:
        for i in range(args.steps):
            toks, tgts = next(batches)
            fa.reset_launch_counts()
            state, loss = exe.step(state, toks, tgts)
            log_this = (i == 0 or (i + 1) % args.log_every == 0
                        or i + 1 == args.steps)
            if log_this:
                loss = float(loss)  # the sync that makes the step time real
                losses.append(loss)
            launched = {k: v for k, v in fa.launch_counts.items() if v}
            timer.record(loss=loss if log_this else None, emit=log_this,
                         **({"kernel_launches": launched} if launched else {}))
            if (can_ckpt and args.checkpoint_every
                    and (i + 1) % args.checkpoint_every == 0):
                save(state, start_step + i + 1, final=False)
        # measured before the flush below, which is checkpoint IO
        elapsed = time.perf_counter() - t0
    finally:
        batches.close()
        if writer is not None:
            t1 = time.perf_counter()
            writer.close()
            events.emit("checkpoint_flush", ms=(time.perf_counter() - t1) * 1e3)
    final_already_saved = bool(args.steps and args.checkpoint_every
                               and args.steps % args.checkpoint_every == 0)
    if can_ckpt and not final_already_saved:
        save(state, start_step + args.steps, final=True)

    summary = {
        "executable": exe.kind,
        "plan_cost_ms": plan_cost_ms,
        "steps": args.steps,
        "first_loss": losses[0] if losses else None,
        "final_loss": losses[-1] if losses else None,
        "mean_step_ms": (round(elapsed / args.steps * 1e3, 2)
                         if args.steps else None),
        "tokens_per_s": (round(art.gbs * model.sequence_length * args.steps
                               / elapsed) if args.steps and elapsed > 0 else None),
        "checkpoint": args.checkpoint_dir if can_ckpt else None,
    }
    if monitor is not None:
        status = monitor.status()
        summary["accuracy"] = {
            "fingerprint": monitor.fingerprint,
            "ledger": args.ledger,
            "n": status.n,
            "rolling_mape_pct": (round(status.rolling_mape_pct, 2)
                                 if status.rolling_mape_pct is not None
                                 else None),
            "drift": status.in_drift,
            "drift_alarms": status.alarms,
        }
        if status.in_drift:
            say(f"cost-model drift: rolling MAPE {status.rolling_mape_pct:.1f}% "
                f"exceeds the {args.drift_band:.1f}% band — the plan was "
                "ranked on predictions the hardware no longer honors")
        ledger.close()
    events.close()
    return {"rc": 0, "summary": summary}


def _parser() -> argparse.ArgumentParser:
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

    p_rep = sub.add_parser(
        "replan", help="elastic re-plan on topology change: diff two cluster "
                       "descriptions, search the survivor topology, report "
                       "the delta and cost movement")
    p_rep.add_argument("--hostfile", required=True,
                       help="OLD topology hostfile")
    p_rep.add_argument("--clusterfile", required=True,
                       help="OLD topology clusterfile")
    p_rep.add_argument("--new-hostfile", required=True)
    p_rep.add_argument("--new-clusterfile", required=True)
    p_rep.add_argument("--profile-dir", required=True)
    p_rep.add_argument("--no-old-cost", action="store_true",
                       help="search ONLY the survivor topology (skip the "
                            "old-cluster search that supplies the cost "
                            "comparison) — the time-critical recovery path")
    _add_model_args(p_rep)
    _add_search_args(p_rep)

    p_cal = sub.add_parser(
        "calibrate", help="microbenchmark the collectives (+ single-device "
                          "roofline) and write a calibration JSON")
    p_cal.add_argument("--output", required=True)
    p_cal.add_argument("--payload-kb", default="64,256,1024,4096")
    p_cal.add_argument("--iters", type=int, default=8)
    p_cal.add_argument("--chip-roofline", action="store_true",
                       help="also measure matmul TFLOP/s + memory GB/s of the "
                            "first device (written next to --output as "
                            "*.chip.json)")
    _add_rank_args(p_cal)
    _add_device_arg(p_cal, "calibrate")

    p_train = sub.add_parser(
        "train", help="plan and run: search the cluster, build the plan's "
                      "executable, stream batches through the input "
                      "pipeline, train with checkpoints")
    _add_cluster_args(p_train)
    _add_model_args(p_train)
    _add_search_args(p_train)
    _add_train_args(p_train)

    p_chaos = sub.add_parser(
        "chaos", help="fault-injection drill: run the training supervisor "
                      "with a scripted fault sequence (checkpoint IO "
                      "failures, device loss, NaN loss, preemption) and "
                      "report what it survived")
    p_chaos.add_argument("--fleet", action="store_true",
                         help="the fleet-scale availability drill (comes "
                              "with ROADMAP §A.9; exits 2)")
    _add_cluster_args(p_chaos)
    p_chaos.add_argument("--profile-dir", required=True)
    _add_model_args(p_chaos)
    _add_search_args(p_chaos)
    p_chaos.add_argument("--steps", type=int, default=8,
                         help="training steps the drill must complete")
    p_chaos.add_argument("--fault-script", required=True,
                         help="e.g. 'checkpoint_write@2x2,device_loss@5' "
                              "(resilience/faults.py syntax)")
    p_chaos.add_argument("--checkpoint-dir", required=True)
    p_chaos.add_argument("--checkpoint-every", type=int, default=2)
    _add_retry_args(p_chaos)
    p_chaos.add_argument("--seed", type=int, default=0,
                         help="seed for probabilistic fault entries")
    _add_rank_args(p_chaos)
    _add_device_arg(p_chaos, "train on")
    return parser


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv[:1] == ["chaos"] and "--fleet" in argv:
        print("chaos --fleet (the fleet drill over the sched/ package, "
              "tools/fleet_drill.py) comes with ROADMAP §A.9; this slice of "
              "the port does not run it", file=sys.stderr)
        return 2
    args = _parser().parse_args(argv)
    if args.command == "profile":
        return _cmd_profile(args)
    if args.command == "calibrate":
        return _cmd_calibrate(args)
    if args.command == "validate":
        # a missing card fails before the search, not after it
        from metis_tpu_torch.core.device import resolve_device

        resolve_device(args.device)

    from metis_tpu_torch.profiles.store import ProfileStore

    model = _model_from_args(args)
    config = _config_from_args(args)
    events = EventLog(args.events) if args.events else NULL_LOG
    if args.command == "train":
        job = _train_job(args, model, config, events)
        return job if isinstance(job, int) else _run_train(args, job)
    if args.command == "chaos":
        return _run_supervisor(args, model, config, events)
    profiles = ProfileStore.from_dir(args.profile_dir)
    if args.command == "validate":
        return _cmd_validate(args, profiles, model, config)
    if args.command == "replan":
        return _cmd_replan(args, profiles, model, config, events)
    return _cmd_search(args, profiles, model, config, events)


if __name__ == "__main__":
    sys.exit(main())
