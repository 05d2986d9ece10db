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
            rank per device of the cluster; with ``--coordinator`` one of
            several processes, each starting its share of the ranks of one
            process group (``execution/multihost.py``); with
            ``--slice-controller N --peers ...`` stage N of a hetero plan
            alone, its boundaries over sockets
            (``execution/multihost2.py``);
  chaos     the supervisor under a scripted fault sequence
            (``--fault-script``), its report as JSON;
  replan    diff two cluster descriptions, search the new one, report
            the delta and the cost movement (``planner/replan.py``);
  calibrate time the collectives over the devices, one rank per device,
            and write the fitted wire model's JSON (``cost/calibration.py``;
            exit 1 with one device), with ``--chip-roofline`` also the
            first device's matmul TFLOP/s and memory GB/s;
  plan      a plan query in-process: the hetero search, or with
            ``--workload inference`` the prefill/decode-disaggregated
            serving search under p99 TTFT/TPOT SLOs
            (``inference/planner.py``), priced from the profile's measured
            decode table where it has one (``profile --decode``);
  explain   why plan #1 beat plan #2: the per-component cost delta table
            of the hetero search, or of the serving search's TTFT/TPOT;
  report    an event log (``--events``) as a span tree with self-times and
            counters (``core/trace.py``);
  accuracy  an accuracy ledger (``--ledger``): the error distribution,
            per-plan MAPE, worst samples and stages, drift status;
  why       a decision log's causal chain from a plan back to its root
            trigger, with the attributed cost diff at every hop
            (``obs/provenance.py``);
  diff      the attributed cost diff of two plans by fingerprint, from a
            decision log or plan dumps;
  serve     the plan daemon (``serve/daemon.py``): plan queries over local
            HTTP (TCP or a unix socket) from a plan cache, drift- and
            cluster-delta-driven replans, tenants, a durable state dir and
            a standby (``--standby-of``);
  top       a live dashboard over a daemon's ``GET /metrics``;
  replay    the traffic-replay bench (``inference/replay.py``): a diurnal
            arrival-rate sweep against a daemon (``--remote``, or one
            booted in-process).

``plan``, ``why`` and ``diff`` take ``--remote ADDRESS`` (``http://HOST:PORT``
or ``unix:/path``) to ask a running daemon instead.  The searches, readers
and the daemon run on the host and take no device.  The reference's
``--platform`` (a JAX backend pin) becomes ``--device``.  ``chaos
--fleet`` runs the fleet drill (``resilience/fleet_drill.py``) with its
own arguments.

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


def _add_inference_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("serving workload")
    g.add_argument("--workload", choices=("training", "inference"),
                   default="training",
                   help="planning target: training (min step-ms) or "
                        "inference (max throughput under p99 TTFT/TPOT "
                        "SLOs, prefill/decode disaggregated)")
    g.add_argument("--workload-spec", default=None,
                   help="JSON file with InferenceWorkload fields; explicit "
                        "flags below override its entries")
    g.add_argument("--arrival-rate", type=float, default=None,
                   help="offered request rate, requests/s")
    g.add_argument("--prompt-len", type=int, default=None,
                   help="mean prompt length, tokens")
    g.add_argument("--output-len", type=int, default=None,
                   help="mean generated length, tokens")
    g.add_argument("--slo-ttft", type=float, default=None,
                   help="p99 time-to-first-token SLO, ms")
    g.add_argument("--slo-tpot", type=float, default=None,
                   help="p99 time-per-output-token SLO, ms")
    g.add_argument("--prompt-len-p99", type=int, default=None,
                   help="p99 prompt length (0/omitted = deterministic)")
    g.add_argument("--output-len-p99", type=int, default=None,
                   help="p99 generated length (0/omitted = deterministic)")
    g.add_argument("--kv-dtype-bytes", type=int, default=None,
                   help="KV-cache element bytes (2 = bf16 default, 1 = int8)")
    g.add_argument("--prefix-share-frac", type=float, default=None,
                   help="fraction of requests sharing one common prompt "
                        "prefix whose KV pages are stored once per lane "
                        "(0 = no sharing, the exact pre-paging model)")
    g.add_argument("--prefix-len", type=int, default=None,
                   help="shared prompt-prefix length, tokens (clamped to "
                        "the tail prompt length)")
    g.add_argument("--page-tokens", type=int, default=None,
                   help="KV allocator page size, tokens per page per layer "
                        "(0/omitted = exact unpaged accounting)")


def _workload_from_args(args: argparse.Namespace,
                        default_arrival_rps: float | None = None):
    """InferenceWorkload from --workload-spec JSON + override flags, or
    None for a training query."""
    if getattr(args, "workload", "training") != "inference":
        return None
    from metis_tpu_torch.inference.workload import workload_from_dict

    spec: dict = {}
    if args.workload_spec:
        with open(args.workload_spec) as f:
            spec = json.load(f)
    overrides = {
        "arrival_rate_rps": args.arrival_rate,
        "prompt_len": args.prompt_len,
        "output_len": args.output_len,
        "slo_ttft_p99_ms": args.slo_ttft,
        "slo_tpot_p99_ms": args.slo_tpot,
        "prompt_len_p99": args.prompt_len_p99,
        "output_len_p99": args.output_len_p99,
        "kv_dtype_bytes": args.kv_dtype_bytes,
        "prefix_share_frac": args.prefix_share_frac,
        "prefix_len": args.prefix_len,
        "page_tokens": args.page_tokens,
    }
    for k, v in overrides.items():
        if v is not None:
            spec[k] = v
    if "arrival_rate_rps" not in spec and default_arrival_rps is not None:
        spec["arrival_rate_rps"] = default_arrival_rps
    try:
        return workload_from_dict(spec)
    except (TypeError, ValueError) as e:
        raise SystemExit(
            f"bad inference workload: {e} — pass --arrival-rate, "
            "--prompt-len, --output-len, --slo-ttft and --slo-tpot (or a "
            "--workload-spec JSON carrying them)")


def _emit(args: argparse.Namespace, payload: str) -> None:
    if args.output == "-":
        print(payload)
    else:
        with open(args.output, "w") as f:
            f.write(payload)


def _cmd_profile(args: argparse.Namespace) -> int:
    from metis_tpu_torch.profiles.profiler import ProfilerConfig, profile_model

    model = _model_from_args(args)
    events = EventLog(args.events) if args.events else NULL_LOG
    store = profile_model(
        model,
        tps=tuple(int(t) for t in args.tps.split(",")),
        bss=tuple(int(b) for b in args.bss.split(",")),
        device=args.device,
        config=ProfilerConfig(warmup=args.warmup, iters=args.iters),
        events=events,
        decode=args.decode,
        decode_context=args.decode_context)
    store.dump_to_dir(args.output_dir,
                      {"model_name": model.name, "attn": model.attn})
    decode_note = " (+decode tables)" if store.has_decode() else ""
    print(f"profiled {model.name} -> {args.output_dir} "
          f"({', '.join(store.device_types)}){decode_note}", file=sys.stderr)
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


def _cmd_plan(args: argparse.Namespace) -> int:
    """``plan``: a plan query, remote (a daemon round trip) or in-process;
    either way the printed ``plans`` JSON is the same dump for the same
    query, so the daemon's answer is byte-identical to the offline
    search."""
    model = _model_from_args(args)
    config = _config_from_args(args)
    workload = _workload_from_args(args)
    if args.remote:
        from metis_tpu_torch.serve.client import PlanServiceClient

        client = PlanServiceClient(args.remote)
        resp = client.plan(model, config, top_k=args.top_k,
                           workload=workload)
        _emit(args, resp["plans"])
        how = "cache hit" if resp.get("cached") else "cold search"
        print(
            f"{how} fingerprint={resp.get('fingerprint')} "
            f"costed {resp.get('num_costed')} plans "
            f"({resp.get('num_pruned')} pruned) in "
            f"{resp.get('search_seconds', 0):.2f}s "
            f"(served in {resp.get('serve_ms', 0):.1f}ms) "
            f"trace={resp.get('trace_id')}",
            file=sys.stderr)
        return 0

    from metis_tpu_torch.cluster.spec import ClusterSpec
    from metis_tpu_torch.core.types import dump_ranked_plans
    from metis_tpu_torch.planner.api import plan_hetero
    from metis_tpu_torch.profiles.store import ProfileStore

    if not (args.hostfile and args.clusterfile and args.profile_dir):
        print("in-process plan needs --hostfile, --clusterfile and "
              "--profile-dir (or point --remote at a daemon)",
              file=sys.stderr)
        return 2
    cluster = ClusterSpec.from_files(args.hostfile, args.clusterfile)
    profiles = ProfileStore.from_dir(args.profile_dir)
    events = EventLog(args.events) if args.events else NULL_LOG
    if workload is not None:
        from metis_tpu_torch.inference.planner import (
            dump_inference_plans,
            plan_inference,
        )

        result = plan_inference(cluster, profiles, model, config, workload,
                                top_k=args.top_k, events=events)
        _emit(args, dump_inference_plans(result, workload))
        print(f"costed {result.num_costed} pool candidates "
              f"({result.num_pruned} pruned) across {result.num_splits} "
              f"prefill/decode splits", file=sys.stderr)
    else:
        result = plan_hetero(cluster, profiles, model, config,
                             top_k=args.top_k, events=events)
        _emit(args, dump_ranked_plans(result.plans))
        print(f"costed {result.num_costed} plans ({result.num_pruned} "
              f"pruned) in {result.search_seconds:.2f}s", file=sys.stderr)
        cert = result.certificate
        if cert is not None:
            status = ("optimal" if cert.complete and cert.gap_frac == 0.0
                      else f"gap <= {cert.gap_frac:.2%}"
                      + ("" if cert.complete else " (deadline)"))
            print(f"certificate: {status} — best {cert.best_ms:.2f}ms, "
                  f"proven lower bound {cert.lower_bound_ms:.2f}ms, "
                  f"{cert.nodes_explored} nodes explored / "
                  f"{cert.nodes_bounded} bounded in {cert.wall_s:.2f}s",
                  file=sys.stderr)
    events.close()
    return 0


def _cmd_serve(args: argparse.Namespace) -> int:
    """Boot the plan daemon and serve until interrupted (or POST
    /shutdown).  Prints the bound address as one JSON line so wrappers
    can parse it even with --port 0."""
    from pathlib import Path

    from metis_tpu_torch.cluster.spec import ClusterSpec
    from metis_tpu_torch.obs.provenance import DecisionLog
    from metis_tpu_torch.profiles.store import ProfileStore
    from metis_tpu_torch.serve.daemon import PlanService, make_server, run_server

    cluster = ClusterSpec.from_files(args.hostfile, args.clusterfile)
    profiles = ProfileStore.from_dir(args.profile_dir)
    events = (EventLog(args.events, max_bytes=args.events_max_bytes)
              if args.events else NULL_LOG)
    decisions_path = args.decisions
    if decisions_path is None and args.state_dir:
        # the decision log is part of the durable control plane: default
        # it into the state dir so seq numbering survives restarts too
        decisions_path = str(Path(args.state_dir) / "decisions.jsonl")
    decisions = (DecisionLog(decisions_path, events=events)
                 if decisions_path else None)
    service = PlanService(
        cluster, profiles, cache_capacity=args.cache_size,
        cache_shards=args.cache_shards,
        state_capacity=args.state_cache_size, events=events,
        drift_band_pct=args.drift_band, decisions=decisions,
        state_dir=args.state_dir,
        snapshot_interval=args.snapshot_interval,
        search_pool=args.search_pool,
        read_only=args.standby_of is not None)
    tailer = None
    if args.standby_of is not None:
        from metis_tpu_torch.serve.standby import StandbyTailer

        tailer = StandbyTailer(service, args.standby_of)
        tailer.start()
    server = make_server(service, host=args.host, port=args.port,
                         socket_path=args.socket,
                         threads=args.serve_threads)
    boot = {
        "serving": server.address,
        "devices": cluster.total_devices,
        "device_types": list(cluster.device_types),
        "cache_capacity": args.cache_size,
        "cache_shards": args.cache_shards,
        "serve_threads": server.pool_threads,
    }
    if args.search_pool:
        boot["search_pool_workers"] = (
            service.search_pool.num_workers
            if service.search_pool is not None else 0)
    if args.state_dir:
        boot["state_dir"] = args.state_dir
        boot["restore_s"] = service.restore_s
        boot["restored_seq"] = service.stats()["note_seq"]
    if args.standby_of is not None:
        boot["standby_of"] = args.standby_of
    print(json.dumps(boot), flush=True)
    run_server(server)
    if tailer is not None:
        tailer.stop()
    service.close()
    events.close()
    return 0


def _cmd_replay(args: argparse.Namespace) -> int:
    """Traffic-replay bench (inference/replay.py): boot or dial a daemon,
    sweep the diurnal curve, print the ReplayReport JSON."""
    from metis_tpu_torch.cluster.spec import ClusterSpec
    from metis_tpu_torch.inference.replay import replay_traffic
    from metis_tpu_torch.serve.client import PlanServiceClient

    model = _model_from_args(args)
    config = _config_from_args(args)
    args.workload = "inference"  # replay is a serving bench by definition
    workload = _workload_from_args(args, default_arrival_rps=args.base_rps)
    cluster = ClusterSpec.from_files(args.hostfile, args.clusterfile)
    events = EventLog(args.events) if args.events else NULL_LOG

    server = None
    if args.remote:
        client = PlanServiceClient(args.remote)
    else:
        from metis_tpu_torch.profiles.store import ProfileStore
        from metis_tpu_torch.serve.daemon import PlanService, serve_in_thread

        profiles = ProfileStore.from_dir(args.profile_dir)
        service = PlanService(cluster, profiles, events=events)
        server, _thread, address = serve_in_thread(service)
        client = PlanServiceClient(address)
    try:
        report = replay_traffic(
            client, cluster, model, config, workload,
            base_rps=args.base_rps, peak_rps=args.peak_rps,
            ticks_per_cycle=args.ticks_per_cycle, cycles=args.cycles,
            tick_seconds=args.tick_seconds, min_nodes=args.min_nodes,
            top_k=args.top_k, policy=args.policy, events=events)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
    _emit(args, json.dumps(report.to_json_dict(), indent=2))
    print(f"[{report.policy}] slo attainment {report.slo_attainment:.3f} "
          f"over {report.cycles} cycle(s), devices "
          f"{min(report.device_trajectory, default=0)}-"
          f"{max(report.device_trajectory, default=0)} "
          f"({report.device_hours:.1f} device-hours), "
          f"{report.replan_pushes} replan push(es)", file=sys.stderr)
    events.close()
    return 0


def _top_frame(text: str, address: str) -> str:
    """One rendered dashboard frame from a /metrics exposition scrape.
    Pure text-in/text-out so tests drive it without a terminal."""
    from metis_tpu_torch.obs.metrics import (
        parse_exposition,
        quantile_from_buckets,
    )

    fams = parse_exposition(text)

    def gauge(name: str, **want) -> float | None:
        fam = fams.get(name)
        if fam is None:
            return None
        for n, lab, v in fam["samples"]:
            if n == name and all(lab.get(k) == w for k, w in want.items()):
                return v
        return None

    def labeled(name: str, label: str) -> dict[str, float]:
        fam = fams.get(name)
        if fam is None:
            return {}
        return {lab[label]: v for n, lab, v in fam["samples"]
                if n == name and label in lab}

    lines = [f"metis-tpu top — {address} — "
             f"up {gauge('metis_serve_uptime_seconds') or 0:.0f}s"]
    qps = gauge("metis_serve_qps") or 0.0
    hit = gauge("metis_serve_cache_hit_ratio")
    inflight = gauge("metis_serve_inflight_requests") or 0
    lines.append(
        f"qps {qps:7.1f}   in-flight {inflight:3.0f}   cache hit "
        + (f"{hit:6.1%}" if hit is not None else "   n/a")
        + f"   entries {gauge('metis_serve_cache_entries') or 0:.0f}"
          f"/{gauge('metis_serve_cache_capacity') or 0:.0f}")
    lat = fams.get("metis_serve_request_latency_ms")
    if lat is not None:
        # per-endpoint cumulative buckets -> p50/p99 via the same
        # nearest-rank rule the registry uses
        per_ep: dict[str, list[tuple[float, float]]] = {}
        counts: dict[str, float] = {}
        for n, lab, v in lat["samples"]:
            ep = lab.get("endpoint", "")
            if n.endswith("_bucket"):
                le = lab.get("le", "")
                bound = float("inf") if le == "+Inf" else float(le)
                per_ep.setdefault(ep, []).append((bound, v))
            elif n.endswith("_count"):
                counts[ep] = v
        lines.append(f"{'endpoint':<16}{'reqs':>8}{'p50 ms':>10}"
                     f"{'p99 ms':>10}")
        for ep in sorted(per_ep):
            p50 = quantile_from_buckets(per_ep[ep], 0.5)
            p99 = quantile_from_buckets(per_ep[ep], 0.99)
            lines.append(
                f"{ep:<16}{counts.get(ep, 0):>8.0f}"
                + (f"{p50:>10.2f}" if p50 is not None else f"{'-':>10}")
                + (f"{p99:>10.2f}" if p99 is not None else f"{'-':>10}"))
    util = gauge("metis_fleet_utilization_frac")
    if util is not None:
        lines.append(f"fleet utilization {util:6.1%}   objective "
                     f"{gauge('metis_fleet_objective') or 0:.3f}")
        devices = labeled("metis_fleet_tenant_devices", "tenant")
        tenant_util = labeled("metis_fleet_tenant_utilization_frac",
                              "tenant")
        for tname in sorted(devices):
            lines.append(f"  tenant {tname:<14}{devices[tname]:>5.0f} dev"
                         f"   util {tenant_util.get(tname, 0.0):6.1%}")
    slo = labeled("metis_replay_slo_attainment", "policy")
    for policy in sorted(slo):
        lines.append(f"replay[{policy}] slo attainment {slo[policy]:6.1%}")
    return "\n".join(lines)


def _cmd_top(args: argparse.Namespace) -> int:
    """Live dashboard: poll GET /metrics and render qps / latency
    quantiles / cache / fleet / SLO until Ctrl-C (or --iterations)."""
    import time

    from metis_tpu_torch.serve.client import PlanServiceClient, ServeClientError

    client = PlanServiceClient(args.address,
                               timeout=max(args.interval, 5.0))
    n = 0
    try:
        while True:
            try:
                text = client.metrics(timeout=max(args.interval, 5.0))
                frame = _top_frame(text, args.address)
            except ServeClientError as e:
                frame = f"metis-tpu top — {args.address} — {e}"
            if args.no_clear:
                print(frame, flush=True)
            else:
                # ANSI clear + home: plain escapes, no curses dependency
                print(f"\x1b[2J\x1b[H{frame}", flush=True)
            n += 1
            if args.iterations and n >= args.iterations:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def _parse_ranks(args: argparse.Namespace) -> list[int] | None:
    try:
        ranks = sorted({int(r) for r in args.ranks.split(",")})
    except ValueError:
        print(f"--ranks must be comma-separated 1-based integers, got "
              f"{args.ranks!r}", file=sys.stderr)
        return None
    if not ranks or ranks[0] < 1 or len(ranks) > 2:
        print("--ranks takes one or two 1-based ranks (e.g. 1,2)",
              file=sys.stderr)
        return None
    return ranks


def _table(header: list[str], rows: list[list[str]]) -> list[str]:
    """Left-justified columns under a rule, trailing blanks stripped."""
    widths = [max(len(header[i]), *(len(r[i]) for r in rows))
              for i in range(len(header))]
    lines = ["  ".join(h.ljust(widths[i]) for i, h in enumerate(header)),
             "  ".join("-" * w for w in widths)]
    return lines + ["  ".join(c.ljust(widths[i])
                              for i, c in enumerate(row)).rstrip()
                    for row in rows]


def _cmd_explain(args: argparse.Namespace, profiles, model, config,
                 events) -> int:
    """``explain``: the per-component delta table of two ranked hetero
    plans (the cost term that decided the ranking), or with ``--workload
    inference`` of two serving plans — the reference's bytes."""
    from metis_tpu_torch.cluster.spec import ClusterSpec
    from metis_tpu_torch.core.types import COST_COMPONENTS
    from metis_tpu_torch.obs.ledger import fingerprint_ranked_plan
    from metis_tpu_torch.planner.api import plan_hetero

    if getattr(args, "workload", "training") == "inference":
        return _cmd_explain_inference(args, profiles, model, config, events)
    ranks = _parse_ranks(args)
    if ranks is None:
        return 2
    cluster = ClusterSpec.from_files(args.hostfile, args.clusterfile)
    result = plan_hetero(cluster, profiles, model, config,
                         top_k=max(args.top_k, ranks[-1]), events=events)
    if len(result.plans) < ranks[-1]:
        print(f"search found only {len(result.plans)} plans "
              f"({result.num_pruned} pruned); cannot explain rank "
              f"{ranks[-1]}", file=sys.stderr)
        return 1
    chosen = [result.plans[r - 1] for r in ranks]
    if any(p.breakdown is None for p in chosen):
        print("breakdown unavailable for a requested rank (profile miss "
              "during re-pricing)", file=sys.stderr)
        return 1
    fps = [fingerprint_ranked_plan(p) for p in chosen]

    if args.as_json:
        payload: dict = {"plans": [
            {"rank": r, "fingerprint": fp, **p.to_json_dict()}
            for r, fp, p in zip(ranks, fps, chosen)]}
        if len(chosen) == 2:
            payload["delta"] = {
                k: round(v, 4)
                for k, v in chosen[0].breakdown.delta(
                    chosen[1].breakdown).items()}
            name, d = chosen[0].breakdown.decisive_component(
                chosen[1].breakdown)
            payload["decisive"] = {"component": name, "delta_ms": round(d, 4)}
        if result.certificate is not None:
            payload["certificate"] = result.certificate.to_json_dict()
        _emit(args, json.dumps(payload, indent=2))
        return 0

    bds = [p.breakdown for p in chosen]
    keys = [k for k in COST_COMPONENTS
            if any(abs(b.components.get(k, 0.0)) > 1e-12 for b in bds)]
    header = ["component"] + [f"#{r} ({fp})" for r, fp in zip(ranks, fps)]
    rows: list[list[str]] = []
    if len(bds) == 2:
        header.append(f"delta (#{ranks[1]}-#{ranks[0]})")
        delta = bds[0].delta(bds[1])
    for k in keys:
        row = [k] + [f"{b.components.get(k, 0.0):.3f}" for b in bds]
        if len(bds) == 2:
            row.append(f"{delta[k]:+.3f}")
        rows.append(row)
    # overlap-hidden comm shares: informational, not part of total_ms —
    # exposed + hidden reconstructs the serial collective cost
    hidden_keys = sorted({k for b in bds
                          for k, v in b.hidden.items() if abs(v) > 1e-12})
    for k in hidden_keys:
        row = ([f"{k} (hidden)"]
               + [f"{b.hidden.get(k, 0.0):.3f}" for b in bds])
        if len(bds) == 2:
            row.append(f"{bds[1].hidden.get(k, 0.0) - bds[0].hidden.get(k, 0.0):+.3f}")
        rows.append(row)
    total_row = ["total"] + [f"{b.total_ms:.3f}" for b in bds]
    if len(bds) == 2:
        total_row.append(f"{bds[1].total_ms - bds[0].total_ms:+.3f}")
    rows.append(total_row)
    lines = _table(header, rows)
    for r, p, b in zip(ranks, chosen, bds):
        lines.append("")
        lines.append(
            f"#{r}: stages {list(p.inter.device_groups)} x "
            f"{[(s.dp, s.tp) for s in p.intra.strategies]}, "
            f"batches {p.inter.batches}, schedule {b.schedule}; "
            f"per-stage ms {[round(x, 2) for x in b.stage_execution_ms]}")
    if len(bds) == 2:
        name, d = bds[0].decisive_component(bds[1])
        gap = bds[1].total_ms - bds[0].total_ms
        lines.append("")
        if abs(gap) < 1e-3 and abs(d) < 1e-3:
            lines.append(
                f"decisive: none — the plans tie at {bds[0].total_ms:.3f} ms "
                "on every component (ranking broke the tie by order)")
        elif d > 0:
            lines.append(
                f"decisive: {name} ({d:+.3f} ms of the {gap:+.3f} ms gap) — "
                f"#{ranks[1]} loses mostly on {name}")
        else:
            lines.append(
                f"decisive: {name} ({d:+.3f} ms against a {gap:+.3f} ms gap) "
                f"— #{ranks[1]} wins {name} but loses elsewhere")
    cert = result.certificate
    if cert is not None:
        status = ("proven optimal" if cert.complete and cert.gap_frac == 0.0
                  else f"gap <= {cert.gap_frac:.2%}"
                  + ("" if cert.complete else ", deadline stop"))
        lines.append("")
        lines.append(
            f"certificate: #1 is {status} over this config's plan space "
            f"(lower bound {cert.lower_bound_ms:.3f} ms; "
            f"{cert.nodes_explored} nodes explored, "
            f"{cert.nodes_bounded} bounded, {cert.wall_s:.2f}s)")
    _emit(args, "\n".join(lines))
    print(f"costed {result.num_costed} plans ({result.num_pruned} pruned) "
          f"in {result.search_seconds:.2f}s", file=sys.stderr)
    return 0


def _kv_sharing_summary(model, workload) -> dict:
    """Per-sequence decode-pool KV with and without paged prefix sharing
    (full model depth, tp=1 — the hardware-independent contribution)."""
    from metis_tpu_torch.cost.estimator import kv_stage_bytes, paged_kv_seq_bytes

    ctx = workload.max_context_len
    full = kv_stage_bytes(model, 1, ctx, 0, model.num_layers,
                          workload.kv_dtype_bytes, 1)
    eff = paged_kv_seq_bytes(
        model, ctx, 0, model.num_layers, workload.kv_dtype_bytes, 1,
        page_tokens=workload.page_tokens,
        prefix_len=workload.shared_prefix_len,
        prefix_share_frac=workload.prefix_share_frac)
    return {
        "prefix_share_frac": workload.prefix_share_frac,
        "shared_prefix_len": workload.shared_prefix_len,
        "page_tokens": workload.page_tokens,
        "kv_bytes_per_seq_full": round(full),
        "kv_bytes_per_seq_effective": round(eff),
        "kv_reduction_frac": (round(1.0 - eff / full, 4) if full else 0.0),
    }


def _cmd_explain_inference(args: argparse.Namespace, profiles, model,
                           config, events) -> int:
    """Serving counterpart of ``explain``: the per-component TTFT/TPOT
    delta table over ``InferenceCostBreakdown`` (components sum to the two
    p99 latencies the SLO check judged)."""
    from metis_tpu_torch.cluster.spec import ClusterSpec
    from metis_tpu_torch.core.types import TPOT_COMPONENTS, TTFT_COMPONENTS
    from metis_tpu_torch.inference.planner import (
        fingerprint_inference_plan,
        plan_inference,
    )

    ranks = _parse_ranks(args)
    if ranks is None:
        return 2
    workload = _workload_from_args(args)
    cluster = ClusterSpec.from_files(args.hostfile, args.clusterfile)
    result = plan_inference(cluster, profiles, model, config, workload,
                            top_k=max(args.top_k, ranks[-1]), events=events)
    if len(result.plans) < ranks[-1]:
        print(f"search ranked only {len(result.plans)} serving plans "
              f"({result.num_pruned} pruned) across {result.num_splits} "
              f"splits; cannot explain rank {ranks[-1]}", file=sys.stderr)
        return 1
    chosen = [result.plans[r - 1] for r in ranks]
    fps = [fingerprint_inference_plan(p) for p in chosen]
    bds = [p.cost for p in chosen]

    if args.as_json:
        payload: dict = {
            "workload": workload.to_json_dict(),
            "plans": [{"rank": r, "fingerprint": fp, **p.to_json_dict()}
                      for r, fp, p in zip(ranks, fps, chosen)]}
        if len(chosen) == 2:
            payload["delta"] = {k: round(v, 4)
                                for k, v in bds[0].delta(bds[1]).items()}
            name, d = bds[0].decisive_component(bds[1])
            payload["decisive"] = {"component": name,
                                   "delta_ms": round(d, 4)}
        if workload.prefix_share_frac > 0.0:
            payload["kv_sharing"] = _kv_sharing_summary(model, workload)
        _emit(args, json.dumps(payload, indent=2))
        return 0

    header = ["component"] + [f"#{r} ({fp})" for r, fp in zip(ranks, fps)]
    rows: list[list[str]] = []
    if len(bds) == 2:
        header.append(f"delta (#{ranks[1]}-#{ranks[0]})")
        delta = bds[0].delta(bds[1])
    # grouped so each block visibly sums to its p99 latency
    for title, keys, total in (
            ("ttft_p99", TTFT_COMPONENTS,
             [b.ttft_p99_ms for b in bds]),
            ("tpot_p99", TPOT_COMPONENTS,
             [b.tpot_p99_ms for b in bds])):
        for k in keys:
            if all(abs(b.components.get(k, 0.0)) <= 1e-12 for b in bds):
                continue
            row = [k] + [f"{b.components.get(k, 0.0):.3f}" for b in bds]
            if len(bds) == 2:
                row.append(f"{delta[k]:+.3f}")
            rows.append(row)
        trow = [title] + [f"{t:.3f}" for t in total]
        if len(bds) == 2:
            trow.append(f"{total[1] - total[0]:+.3f}")
        rows.append(trow)
    tput_row = (["throughput_rps"]
                + [f"{b.throughput_rps:.2f}" for b in bds])
    if len(bds) == 2:
        tput_row.append(
            f"{bds[1].throughput_rps - bds[0].throughput_rps:+.2f}")
    rows.append(tput_row)
    lines = _table(header, rows)
    for r, p in zip(ranks, chosen):
        pf, dc = p.prefill, p.decode
        lines.append("")
        lines.append(
            f"#{r}: prefill {dict(sorted(pf.node_counts.items()))} "
            f"dp={pf.dp} tp={list(pf.tp_per_stage)} "
            f"(max {pf.max_rps:.1f} rps) | decode "
            f"{dict(sorted(dc.node_counts.items()))} dp={dc.dp} "
            f"tp={list(dc.tp_per_stage)} batch/lane={dc.batch_per_lane} "
            f"(max {dc.max_rps:.1f} rps, "
            f"tpot {dc.decode_source or 'derived'}); "
            f"slo {'ok' if p.cost.slo_ok else 'VIOLATED'}")
    if workload.prefix_share_frac > 0.0:
        ks = _kv_sharing_summary(model, workload)
        lines.append("")
        lines.append(
            f"prefix sharing: f={ks['prefix_share_frac']} over "
            f"{ks['shared_prefix_len']} shared tokens (page="
            f"{ks['page_tokens'] or 1}) — per-seq decode KV "
            f"{ks['kv_bytes_per_seq_effective'] / 1e6:.1f} MB vs "
            f"{ks['kv_bytes_per_seq_full'] / 1e6:.1f} MB unshared "
            f"({ks['kv_reduction_frac']:.1%} smaller)")
    if len(bds) == 2:
        name, d = bds[0].decisive_component(bds[1])
        lines.append("")
        lines.append(
            f"decisive: {name} ({d:+.3f} ms) — the latency term that most "
            f"separates #{ranks[1]} from #{ranks[0]} (ranking is by "
            "SLO-feasibility, then throughput)")
    _emit(args, "\n".join(lines))
    print(f"costed {result.num_costed} pool candidates "
          f"({result.num_pruned} pruned) across {result.num_splits} "
          f"prefill/decode splits", file=sys.stderr)
    return 0


def _cmd_report(args: argparse.Namespace) -> int:
    """Span-tree/counters report over an event JSONL (``core/trace.py``)."""
    from metis_tpu_torch.core.events import read_events_rotated
    from metis_tpu_torch.core.trace import (
        build_span_tree,
        filter_top_spans,
        render_span_table,
        span_tree_json,
    )

    try:
        # a log rolled to <name>.1 (EventLog max_bytes) is read roll
        # first, so spans that straddle the rotation still pair up
        events = read_events_rotated(args.events_file)
    except OSError as e:
        print(f"cannot read {args.events_file}: {e}", file=sys.stderr)
        return 1
    if args.trace is not None:
        total = len(events)
        events = [e for e in events if e.get("trace_id") == args.trace]
        print(f"trace {args.trace}: {len(events)} of {total} events",
              file=sys.stderr)
        if not events:
            return 1
    roots, counters = build_span_tree(events)
    if not roots and not counters:
        print(f"{args.events_file}: no span/counter events "
              f"({len(events)} events total)", file=sys.stderr)
    if args.top is not None:
        roots = filter_top_spans(roots, args.top)
    if args.as_json:
        payload = json.dumps(span_tree_json(roots, counters), indent=2)
    else:
        payload = render_span_table(roots, counters)
    _emit(args, payload)
    return 0


def _cmd_accuracy(args: argparse.Namespace) -> int:
    """Ledger summary: cost-model error distribution + drift status."""
    from pathlib import Path

    from metis_tpu_torch.obs.ledger import AccuracyLedger, DriftDetector

    if not Path(args.ledger).exists():
        print(f"no such ledger: {args.ledger}", file=sys.stderr)
        return 1
    ledger = AccuracyLedger(args.ledger)
    summary = ledger.summary(fingerprint=args.fingerprint, worst_k=args.top)
    # drift status: the matched samples replayed (in recorded order)
    # through a detector at the requested band — the train loop's
    # hysteresis, so `accuracy` and the drift_alarm agree
    detector = DriftDetector(band_pct=args.band)
    for s in ledger.samples:
        if args.fingerprint and s.fingerprint != args.fingerprint:
            continue
        if s.error_pct is not None:
            detector.observe(s.error_pct)
    status = detector.status()

    residuals = None
    if args.components or args.by_device:
        residuals = ledger.component_residuals(
            fingerprint=args.fingerprint, by_device=args.by_device)

    if args.as_json:
        payload = summary.to_json_dict()
        payload["drift"] = {
            "in_drift": status.in_drift,
            "rolling_mape_pct": (round(status.rolling_mape_pct, 3)
                                 if status.rolling_mape_pct is not None
                                 else None),
            "band_pct": status.band_pct,
            "alarms": status.alarms,
        }
        if residuals is not None:
            payload["component_residuals"] = residuals
        _emit(args, json.dumps(payload, indent=2))
        return 0

    lines = [f"accuracy ledger {args.ledger}: {summary.n_samples} samples "
             f"({summary.n_matched} matched) over {summary.n_plans} plan(s)"]
    if summary.mape_pct is not None:
        lines.append(
            f"error: MAPE {summary.mape_pct:.1f}%  signed bias "
            f"{summary.signed_error_pct:+.1f}%  p50 {summary.p50_abs_pct:.1f}%"
            f"  p90 {summary.p90_abs_pct:.1f}%  max {summary.max_abs_pct:.1f}%")
        mape_txt = (f"{status.rolling_mape_pct:.1f}%"
                    if status.rolling_mape_pct is not None else "n/a")
        lines.append(
            f"drift: {'ALARM' if status.in_drift else 'ok'} "
            f"(rolling MAPE {mape_txt} vs band {status.band_pct:.1f}%, "
            f"{status.alarms} alarm(s) over the replay)")
    else:
        lines.append("no samples carry a matching prediction — record one "
                     "with `metis-tpu train --ledger` or `validate --ledger`")
    if summary.by_plan:
        lines.append("")
        lines.append("per plan:")
        for fp, d in summary.by_plan.items():
            mape = (f"{d['mape_pct']:.1f}%" if d["mape_pct"] is not None
                    else "n/a")
            pred = (f"{d['predicted_ms']:.2f} ms"
                    if d.get("predicted_ms") is not None else "unpredicted")
            lines.append(f"  {fp}: n={d['n']} mape={mape} predicted={pred}")
    if summary.worst:
        lines.append("")
        lines.append("worst samples:")
        for w in summary.worst:
            lines.append(
                f"  {w['fingerprint']} step={w['step']} src={w['source']}: "
                f"predicted {w['predicted_ms']:.2f} vs measured "
                f"{w['measured_ms']:.2f} ms ({w['error_pct']:+.1f}%)")
    if summary.stage_residuals:
        lines.append("")
        lines.append("per-stage residuals (worst first):")
        for sr in sorted(summary.stage_residuals,
                         key=lambda d: -d["mape_pct"]):
            lines.append(
                f"  stage {sr['stage']}: signed "
                f"{sr['signed_error_pct']:+.1f}% mape {sr['mape_pct']:.1f}% "
                f"(n={sr['n']})")
    if residuals is not None:
        lines.append("")
        if not residuals:
            lines.append("component residuals: none (no sample carries a "
                         "component-attributed prediction)")
        elif args.by_device:
            lines.append("component residuals by device (|residual| ms):")
            for dev, comps in residuals.items():
                lines.append(f"  {dev or '(unlabeled)'}:")
                for comp, st in comps.items():
                    lines.append(
                        f"    {comp}: n={st['n']} mean "
                        f"{st['mean_ms']:+.3f} p50 {st['p50_abs_ms']:.3f} "
                        f"p95 {st['p95_abs_ms']:.3f}")
        else:
            lines.append("component residuals (|residual| ms):")
            for comp, st in residuals.items():
                lines.append(
                    f"  {comp}: n={st['n']} mean {st['mean_ms']:+.3f} "
                    f"p50 {st['p50_abs_ms']:.3f} p95 {st['p95_abs_ms']:.3f}")
    _emit(args, "\n".join(lines))
    return 0


def _load_decision_records(args: argparse.Namespace):
    """DecisionRecords from ``--decisions FILE`` or a ``--remote`` daemon
    (None + stderr message when neither source yields records)."""
    from pathlib import Path

    from metis_tpu_torch.obs.provenance import DecisionRecord

    if args.remote:
        from metis_tpu_torch.serve.client import PlanServiceClient

        dicts = PlanServiceClient(args.remote).decisions()
        return [DecisionRecord.from_json_dict(d) for d in dicts]
    if not args.decisions:
        print("need a decision source: --decisions FILE (metis-tpu serve "
              "--decisions) or --remote ADDRESS", file=sys.stderr)
        return None
    path = Path(args.decisions)
    if not path.exists():
        print(f"no such decision log: {args.decisions}", file=sys.stderr)
        return None
    records = []
    for line in path.read_text().splitlines():
        if not line.strip():
            continue
        try:
            records.append(DecisionRecord.from_json_dict(json.loads(line)))
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            continue  # check_decisions_schema.py reports corruption
    return records


def _cmd_why(args: argparse.Namespace) -> int:
    """Causal-chain reconstruction: find the leaf decision (by plan
    fingerprint, tenant, or seq), walk parent_seq edges to the root
    trigger, render each hop with its attributed diff."""
    from metis_tpu_torch.obs.provenance import (
        causal_chain,
        chain_json,
        render_chain,
    )

    if args.fingerprint is None and args.tenant is None and args.seq is None:
        print("give a plan fingerprint, --tenant NAME, or --seq N",
              file=sys.stderr)
        return 2
    records = _load_decision_records(args)
    if records is None:
        return 1
    leaf = None
    if args.seq is not None:
        leaf = next((r for r in records if r.seq == args.seq), None)
    else:
        # the latest record wins ("why is this plan/tenant running now");
        # a fingerprint matches the plan or the query fingerprint
        for rec in reversed(records):
            if args.fingerprint is not None \
                    and args.fingerprint not in (rec.plan_fingerprint,
                                                 rec.query_fingerprint):
                continue
            if args.tenant is not None and rec.tenant != args.tenant:
                continue
            leaf = rec
            break
    if leaf is None:
        want = (f"seq {args.seq}" if args.seq is not None
                else f"tenant {args.tenant!r}" if args.tenant is not None
                else f"plan {args.fingerprint}")
        print(f"no decision matching {want} among {len(records)} records",
              file=sys.stderr)
        return 1
    chain = causal_chain(records, leaf)
    if args.as_json:
        _emit(args, json.dumps(chain_json(chain), indent=2))
    else:
        _emit(args, render_chain(chain))
    return 0


def _cmd_diff(args: argparse.Namespace) -> int:
    """Attributed plan diff by fingerprint: resolve each fingerprint from
    plan dumps (structural axes + breakdown) and/or decision records
    (breakdown only), then render ``diff_plans``' attribution."""
    from pathlib import Path

    from metis_tpu_torch.obs.provenance import diff_plans, fingerprint_plan_dict

    by_fp: dict[str, object] = {}
    # decision records first, so a plan dump carrying the same
    # fingerprint overrides with its richer structural axes
    if args.decisions or args.remote:
        records = _load_decision_records(args)
        if records is None:
            return 1
        for rec in records:  # later (newer) records win
            if rec.plan_fingerprint and rec.breakdown is not None:
                by_fp[rec.plan_fingerprint] = rec
    for plans_file in args.plans:
        try:
            payload = json.loads(Path(plans_file).read_text())
        except (OSError, json.JSONDecodeError) as e:
            print(f"cannot read plan dump {plans_file}: {e}",
                  file=sys.stderr)
            return 1
        entries = (payload.get("plans", [])
                   if isinstance(payload, dict) else payload)
        for entry in entries:
            fp = fingerprint_plan_dict(entry)
            if fp:
                by_fp[fp] = entry
    if not by_fp:
        print("no plans to diff: give --plans FILE, --decisions FILE, "
              "or --remote ADDRESS", file=sys.stderr)
        return 2
    missing = [fp for fp in (args.fp_a, args.fp_b) if fp not in by_fp]
    if missing:
        known = ", ".join(sorted(by_fp)) or "(none)"
        print(f"fingerprint(s) not found: {', '.join(missing)} — "
              f"known: {known}", file=sys.stderr)
        return 1
    diff = diff_plans(by_fp[args.fp_a], by_fp[args.fp_b])
    if args.as_json:
        _emit(args, json.dumps(diff.to_json_dict(), indent=2))
    else:
        header = (f"plan {args.fp_a} -> {args.fp_b}"
                  + (f": {diff.total_a_ms:.3f} -> {diff.total_b_ms:.3f} ms"
                     f" ({diff.total_delta_ms:+.3f})"
                     if diff.total_delta_ms is not None else ""))
        _emit(args, header + "\n\n" + diff.render())
    return 0


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
    g_mh = p.add_argument_group(
        "multi-host (run the same command on every host, varying only "
        "--process-id; execution/multihost.py: each process starts world / "
        "--num-processes ranks of one process group)")
    g_mh.add_argument("--coordinator", default=None,
                      help="host:port of process 0 — enables "
                           "multi-controller training (gspmd and pipeline "
                           "plans); the ranks meet at its TCP store")
    g_mh.add_argument("--num-processes", type=int, default=None)
    g_mh.add_argument("--process-id", type=int, default=None)
    g_sc = p.add_argument_group(
        "per-slice controller (one controller per stage group, each with "
        "its own process group; run the same command per slice varying "
        "only --slice-controller)")
    g_sc.add_argument("--slice-controller", type=int, default=None,
                      metavar="STAGE",
                      help="run only this stage of the chosen/pinned hetero "
                           "plan as an independent controller; boundary "
                           "activations/cotangents flow over --peers "
                           "sockets (execution/multihost2.py)")
    g_sc.add_argument("--peers", default=None,
                      help="comma-separated host:port boundary links, one "
                           "per stage boundary: link i is listened on by "
                           "stage i and dialed by stage i+1")
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


def _deployment_refusal(args: argparse.Namespace) -> str | None:
    """The reference's rules for the multi-controller flags, in its words:
    what is wrong with this combination, or None."""
    multihost = args.coordinator is not None
    if args.slice_controller is not None:
        if multihost:
            return ("--slice-controller and --coordinator are different "
                    "deployment shapes (one controller per stage group vs "
                    "one process group over every rank) — pick one")
        if args.peers is None:
            return ("--slice-controller requires --peers (one host:port "
                    "boundary link per stage boundary)")
    if not multihost and (args.num_processes is not None
                          or args.process_id is not None):
        return ("--num-processes/--process-id require --coordinator (without "
                "it every host would silently train an independent copy)")
    if multihost and (args.num_processes is None or args.process_id is None):
        return "--coordinator requires --num-processes and --process-id"
    if args.resilient and (multihost or args.slice_controller is not None):
        return ("--resilient is single-controller only (the supervisor "
                "rebuilds the executable on recovery, which a "
                "multi-controller run cannot do mid-flight)")
    return None


def _train_job(args: argparse.Namespace, model, config, events) -> dict | int:
    """Plan (or pin the checkpoint's plan): the job of every rank of
    ``train``, or the exit code of a refused run, or with ``--resilient``
    of the supervised run (``_run_supervisor``)."""
    refusal = _deployment_refusal(args)
    if refusal is not None:
        print(refusal, file=sys.stderr)
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


def _say_launches(who: str, launches: list[dict] | None) -> None:
    """A multi-controller rank's flash-attention kernel launches, one dict
    per step, on stderr (its process writes no events)."""
    if launches and any(launches):
        print(f"{who} kernel launches per step: {json.dumps(launches)}",
              file=sys.stderr)


def _run_multihost(args: argparse.Namespace, job: dict) -> int:
    """``train --coordinator``: this process's share of the plan's ranks
    (``execution/multihost.py``), global ranks ``I * L ..`` of one process
    group that meets at the coordinator; process 0's summary to
    ``--output``.  A plan on the hetero route is refused, as the
    reference refuses it."""
    from metis_tpu_torch.execution import dist as mdist
    from metis_tpu_torch.execution.builder import plan_route, resolve_schedule
    from metis_tpu_torch.execution.mesh import PlanArtifact
    from metis_tpu_torch.execution.multihost import initialize_multihost
    from metis_tpu_torch.models import config_for_model_spec

    art = PlanArtifact.from_json(job["artifact"])
    schedule, vs = resolve_schedule(art, args.schedule, args.virtual_stages)
    kind = plan_route(config_for_model_spec(job["model"]), art, schedule, vs)
    if kind == "hetero":
        print(f"--coordinator supports GSPMD (pp=1) and pipeline (pp>1 "
              f"rectangular) plans; the chosen plan routes to the {kind} "
              "executable.  The multi-mesh hetero executor runs one "
              "controller per stage group on real deployments "
              "(execution/multihost2.py realizes that slice: train "
              "--slice-controller).", file=sys.stderr)
        return 2
    try:
        info = initialize_multihost(args.coordinator, args.num_processes,
                                    args.process_id, art.num_devices)
    except MetisError as e:
        print(e, file=sys.stderr)
        return 2
    print(f"multihost: process {info.process_index}/{info.process_count}, "
          f"{info.global_device_count} global / {info.local_device_count} "
          "local devices", file=sys.stderr)
    launch = _rank_devices(args, info.local_device_count)
    if launch is None:
        return 1
    with mdist.RankPool(info.local_device_count, launch[1], launch[0],
                        init_method=info.init_method,
                        first_rank=info.first_rank,
                        world_size=info.global_device_count) as pool:
        out = pool.run(train_rank, {**job, "multihost": True})
    for r, rank_out in enumerate(out):
        _say_launches(f"rank {info.first_rank + r}", rank_out.get("launches"))
    rc, summary = out[0]["rc"], out[0]["summary"]
    if rc == 0 and info.process_index == 0:
        _emit(args, json.dumps(summary, indent=2))
    return rc


def _run_slice_controller(args: argparse.Namespace, job: dict) -> int:
    """``train --slice-controller N --peers ...``: this process runs stage
    N of the chosen/pinned plan as an independent controller
    (``execution/multihost2.py``), its ranks on ``--devices`` in a process
    group of their own, boundary tensors over the ``--peers`` sockets.
    With ``--checkpoint-dir`` each controller checkpoints and resumes its
    own stage under ``<dir>/slice{N}/``; the plan is pinned at the top
    level, where a resume reads it."""
    from pathlib import Path

    from metis_tpu_torch.cluster.spec import ClusterSpec
    from metis_tpu_torch.core.device import resolve_device
    from metis_tpu_torch.execution import dist as mdist
    from metis_tpu_torch.execution.builder import resolve_schedule
    from metis_tpu_torch.execution.mesh import PlanArtifact
    from metis_tpu_torch.execution.multihost2 import (
        parse_link_addrs,
        run_artifact_stage_worker,
    )

    art = PlanArtifact.from_json(job["artifact"])
    # the single-controller path's rule: the plan's priced schedule unless
    # --schedule / --virtual-stages say otherwise
    sched, vs = resolve_schedule(art, args.schedule, args.virtual_stages)
    art = dataclasses.replace(art, schedule=sched, virtual_stages=vs)
    if art.node_sequence:
        # a mixed-type stage gets uneven data-balancer rows / per-type
        # groups in the single-controller executor, which one controller
        # per slice cannot realize: refuse rather than diverge
        from metis_tpu_torch.core.types import InterStagePlan, Strategy
        from metis_tpu_torch.execution.hetero import plan_replica_rows
        from metis_tpu_torch.profiles.store import ProfileStore

        inter = InterStagePlan(
            node_sequence=tuple(art.node_sequence),
            device_groups=tuple(art.device_groups),
            batches=art.microbatches, gbs=art.gbs)
        strats = [Strategy(dp=s["dp"], tp=s["tp"]) for s in art.strategies]
        rows = plan_replica_rows(
            inter, strats, ClusterSpec.from_files(args.hostfile,
                                                  args.clusterfile),
            ProfileStore.from_dir(args.profile_dir))
        mixed = [i for i, r in enumerate(rows) if r is not None]
        if mixed:
            print(f"stages {mixed} span multiple device types (uneven "
                  "data-balancer rows) — a slice controller owns one "
                  "process group of one device type and cannot realize a "
                  "mixed-type stage; re-plan with per-slice stage groups or "
                  "run single-controller", file=sys.stderr)
            return 2
    if args.checkpoint_dir is not None:
        pin = Path(args.checkpoint_dir) / "plan.json"
        if not pin.exists():
            pin.parent.mkdir(parents=True, exist_ok=True)
            pin.write_text(art.to_json())
    links = parse_link_addrs(args.peers)
    print(f"slice controller: stage {args.slice_controller} of "
          f"{len(art.strategies)}, links {links}", file=sys.stderr)
    # the stage's ranks: --devices, else every visible card (or the CPU)
    devs = ([d.strip() for d in args.devices.split(",")] if args.devices
            else mdist.default_devices(resolve_device(args.device)))
    report = run_artifact_stage_worker(
        art, job["model"], args.slice_controller, links, args.steps, devs,
        backend=args.dist_backend, data_path=args.data,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every)
    _say_launches(f"stage {report['stage']} rank 0", report["launches"])
    print(f"stage {report['stage']} rank 0 step ms: "
          f"{json.dumps([round(ms, 3) for ms in report['step_ms']])}",
          file=sys.stderr)
    summary = {
        "executable": "slice-controller",
        "stage": report["stage"],
        "stages": report["stages"],
        "local_devices": report["local_devices"],
        "steps": report["steps"],
        "start_step": report["start_step"],
        "first_loss": report["losses"][0] if report["losses"] else None,
        "final_loss": report["losses"][-1] if report["losses"] else None,
        "losses": report["losses"],
    }
    _emit(args, json.dumps(summary, indent=2))
    return 0


def _run_train(args: argparse.Namespace, job: dict) -> int:
    """``job`` on one rank per device of its plan (the one device in this
    process); rank 0's summary to ``--output``.  ``--coordinator`` and
    ``--slice-controller`` run their multi-controller shapes."""
    from metis_tpu_torch.core.device import resolve_device
    from metis_tpu_torch.execution import dist as mdist
    from metis_tpu_torch.execution.mesh import PlanArtifact

    if args.slice_controller is not None:
        return _run_slice_controller(args, job)
    dev = resolve_device(args.device)
    if args.coordinator is not None:
        return _run_multihost(args, job)
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
    Returns ``{"rc", "summary", "launches"}`` (the kernel launches of each
    step on this rank); rank 0 writes the events, the ledger
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
    if job.get("multihost"):
        # per-rank feeding: the schedule of every rank, only this rank's
        # rows gathered (execution/multihost.py)
        from metis_tpu_torch.execution.multihost import (
            global_batch_pipeline,
            rank_rows,
        )

        batches = global_batch_pipeline(dataset, art.gbs, rank_rows(art, rank),
                                        device=device, skip_batches=start_step)
    else:
        batches = make_input_pipeline(dataset, art.gbs, device=device,
                                      epochs=None, skip_batches=start_step)
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
    launches: list[dict] = []
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
            launches.append(launched)
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
    return {"rc": 0, "summary": summary, "launches": launches}


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
                        help="also measure KV-cache-resident single-token "
                             "decode steps per (tp, bs) — the measured TPOT "
                             "table serving search prefers over the "
                             "forward-share derivation")
    p_prof.add_argument("--decode-context", type=int, default=None,
                        help="resident KV tokens during decode profiling "
                             "(default: the model's sequence length)")
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

    p_srv = sub.add_parser(
        "serve", help="long-lived planner daemon (serve/daemon.py): answer "
                      "plan queries over local HTTP (TCP or unix socket) "
                      "from an LRU plan cache keyed by query fingerprint, "
                      "with warm search state and drift-driven replanning")
    p_srv.add_argument("--hostfile", required=True)
    p_srv.add_argument("--clusterfile", required=True)
    p_srv.add_argument("--profile-dir", required=True)
    p_srv.add_argument("--host", default="127.0.0.1")
    p_srv.add_argument("--port", type=int, default=0,
                       help="TCP port (0 = ephemeral; the bound address is "
                            "printed as JSON at boot)")
    p_srv.add_argument("--socket", default=None,
                       help="serve on this unix socket path instead of TCP")
    p_srv.add_argument("--cache-size", type=int, default=128,
                       help="plan cache capacity (LRU entries)")
    p_srv.add_argument("--cache-shards", type=int, default=4,
                       help="plan-cache lock shards (serve/cache.py): "
                            "concurrent requests on distinct fingerprints "
                            "never contend; capacity stays a single "
                            "global LRU bound")
    p_srv.add_argument("--serve-threads", type=int, default=None,
                       metavar="N",
                       help="handler worker-pool size (default 64); when "
                            "pool and backlog are both full, new "
                            "connections get 503 + Retry-After instead "
                            "of unbounded thread growth")
    p_srv.add_argument("--search-pool", type=int, default=0, metavar="N",
                       help="resident cold-search worker processes "
                            "(serve/pool.py): N index-stride shards per "
                            "search, warm evaluators per query shape, "
                            "byte-identical ranking; 0 = serial in-"
                            "process search (default)")
    p_srv.add_argument("--state-cache-size", type=int, default=8,
                       help="warm search states retained (one per query "
                            "shape; each holds estimator + memo tables)")
    p_srv.add_argument("--drift-band", type=float, default=20.0,
                       help="rolling MAPE %% band posted accuracy samples "
                            "must stay inside before a replan fires")
    p_srv.add_argument("--events", default=None,
                       help="append structured JSONL daemon events here")
    p_srv.add_argument("--events-max-bytes", type=int, default=None,
                       metavar="N",
                       help="rotate the events file to <name>.1 when it "
                            "would exceed N bytes (core/events.EventLog "
                            "max_bytes) — bounds a long-lived daemon's "
                            "log; default: never rotate")
    p_srv.add_argument("--decisions", default=None, metavar="FILE",
                       help="append the decision log (plan provenance: "
                            "obs/provenance.DecisionLog) here; reopening "
                            "resumes the seq so restarts never reset the "
                            "audit trail. Default: in-memory only "
                            "(with --state-dir, defaults to "
                            "STATE_DIR/decisions.jsonl)")
    p_srv.add_argument("--state-dir", default=None, metavar="DIR",
                       help="durable control plane (serve/persist.py): "
                            "atomic digest-verified state snapshots plus "
                            "an append-only oplog in DIR; a restarted "
                            "daemon restores its plan cache, tenants and "
                            "cursors from them (restart ≈ warm). "
                            "Default: memory-only")
    p_srv.add_argument("--snapshot-interval", type=float, default=30.0,
                       metavar="S",
                       help="seconds between periodic state snapshots "
                            "when --state-dir is set (mutating endpoints "
                            "also snapshot synchronously; 0 disables the "
                            "periodic loop)")
    p_srv.add_argument("--standby-of", default=None, metavar="ADDR",
                       help="boot as a read-only standby replicating "
                            "ADDR's oplog (serve/standby.py): serves "
                            "reads, answers mutations 503, and promotes "
                            "itself to primary when ADDR stops answering")

    p_top = sub.add_parser(
        "top", help="live terminal dashboard over a running daemon's "
                    "GET /metrics: qps, per-endpoint p50/p99 latency, "
                    "cache hit rate, fleet utilization, per-tenant SLO "
                    "(plain ANSI poll loop, Ctrl-C to exit)")
    p_top.add_argument("address",
                       help="daemon address: http://HOST:PORT or "
                            "unix:/path/to.sock")
    p_top.add_argument("--interval", type=float, default=2.0,
                       help="seconds between /metrics polls")
    p_top.add_argument("--iterations", type=int, default=0, metavar="N",
                       help="render N frames then exit (0 = run until "
                            "Ctrl-C; >0 is the scriptable/test mode)")
    p_top.add_argument("--no-clear", action="store_true",
                       help="append frames instead of clearing the "
                            "screen (for logs/pipes)")

    p_rpl = sub.add_parser(
        "replay", help="traffic-replay bench: sweep a diurnal arrival-rate "
                       "curve against the plan daemon, scale the fleet "
                       "up/down through cluster deltas (replan pushes), "
                       "and report SLO attainment + device trajectory")
    p_rpl.add_argument("--remote", default=None,
                       help="existing daemon address (default: boot one "
                            "in-process for the bench)")
    _add_cluster_args(p_rpl)
    p_rpl.add_argument("--profile-dir", required=True)
    _add_model_args(p_rpl)
    _add_search_args(p_rpl)
    _add_inference_args(p_rpl)
    g_rpl = p_rpl.add_argument_group("replay")
    g_rpl.add_argument("--base-rps", type=float, required=True,
                       help="trough arrival rate, requests/s")
    g_rpl.add_argument("--peak-rps", type=float, required=True,
                       help="peak arrival rate, requests/s")
    g_rpl.add_argument("--ticks-per-cycle", type=int, default=24,
                       help="ticks per diurnal cycle (default hourly)")
    g_rpl.add_argument("--cycles", type=int, default=1)
    g_rpl.add_argument("--tick-seconds", type=float, default=3600.0,
                       help="simulated seconds per tick (no wall sleeps)")
    g_rpl.add_argument("--min-nodes", type=int, default=2,
                       help="scale-down floor, nodes")
    g_rpl.add_argument("--policy", choices=("hysteresis", "predictive"),
                       default="hysteresis",
                       help="elastic policy: reactive hysteresis (scale "
                            "after a tick shows stress) or predictive "
                            "(forecast the arrival trend and scale BEFORE "
                            "the rate crosses the feasible ceiling)")

    p_plan = sub.add_parser(
        "plan", help="plan query: against a running daemon (--remote) or "
                     "in-process (--hostfile/--clusterfile/--profile-dir); "
                     "--workload inference ranks prefill/decode-"
                     "disaggregated serving plans by throughput under p99 "
                     "TTFT/TPOT SLOs (output byte-identical either way)")
    p_plan.add_argument("--remote", default=None,
                        help="daemon address: http://HOST:PORT or "
                             "unix:/path/to.sock (omit to search "
                             "in-process)")
    p_plan.add_argument("--hostfile", default=None,
                        help="MPI-style hostfile (in-process path)")
    p_plan.add_argument("--clusterfile", default=None,
                        help="device-type JSON (in-process path)")
    p_plan.add_argument("--profile-dir", default=None,
                        help="profile store (in-process path)")
    _add_model_args(p_plan)
    _add_search_args(p_plan)
    _add_inference_args(p_plan)

    p_exp = sub.add_parser(
        "explain", help="why plan #1 beat plan #2: run a hetero (or "
                        "--workload inference) search and render the top "
                        "plans' per-component cost delta table")
    _add_cluster_args(p_exp)
    p_exp.add_argument("--profile-dir", required=True)
    _add_model_args(p_exp)
    _add_search_args(p_exp)
    _add_inference_args(p_exp)
    p_exp.add_argument("--ranks", default="1,2",
                       help="1-based ranks to compare, e.g. 1,3 "
                            "(default: the top two)")
    p_exp.add_argument("--json", action="store_true", dest="as_json",
                       help="emit breakdowns + delta as JSON")

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
                         help="run the fleet-scale availability drill "
                              "instead (resilience/fleet_drill.py): a "
                              "simulated 256-device mixed v5e/v6e spot fleet "
                              "under seeded Poisson preemptions/returns, "
                              "replanning through the plan daemon; ignores "
                              "the flags below — see `python -m "
                              "metis_tpu_torch chaos --fleet --help`")
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

    p_report = sub.add_parser(
        "report", help="render a trace/event JSONL (--events, core/trace "
                       "spans) as a span tree with self-times, "
                       "percentages, and counters — table or JSON")
    p_report.add_argument("events_file",
                          help="JSONL file written via --events")
    p_report.add_argument("--json", action="store_true", dest="as_json",
                          help="emit the tree as JSON instead of a table")
    p_report.add_argument("--top", type=int, default=None, metavar="N",
                          help="keep only the N most expensive spans by "
                               "self-time (ancestors kept for context, "
                               "crashed-open spans always shown)")
    p_report.add_argument("--trace", default=None, metavar="ID",
                          help="keep only events stamped with this "
                               "trace_id — one request's span tree out of "
                               "a shared event log")
    p_report.add_argument("--output", default="-",
                          help="output path ('-' = stdout)")

    p_acc = sub.add_parser(
        "accuracy", help="cost-model accuracy from a ledger JSONL "
                         "(train/validate --ledger): error distribution, "
                         "per-plan MAPE, worst samples/stages, drift status")
    p_acc.add_argument("ledger", help="accuracy ledger JSONL")
    p_acc.add_argument("--band", type=float, default=20.0,
                       help="drift band (MAPE %%) the status is judged "
                            "against")
    p_acc.add_argument("--fingerprint", default=None,
                       help="restrict to one plan fingerprint")
    p_acc.add_argument("--top", type=int, default=5,
                       help="worst samples to list")
    p_acc.add_argument("--components", action="store_true",
                       help="per-component residual distributions (n, "
                            "mean, p50/p95 |residual| ms) — the "
                            "model-confidence stats decision records "
                            "carry")
    p_acc.add_argument("--by-device", action="store_true",
                       help="split --components stats per device type")
    p_acc.add_argument("--json", action="store_true", dest="as_json")
    p_acc.add_argument("--output", default="-",
                       help="output path ('-' = stdout)")

    p_why = sub.add_parser(
        "why", help="why is this plan running: walk the decision log's "
                    "causal parent chain from a plan (or a tenant's latest "
                    "decision) back to its root trigger, with the "
                    "attributed cost diff at every hop")
    p_why.add_argument("fingerprint", nargs="?", default=None,
                       help="plan fingerprint to explain (a query "
                            "fingerprint also matches; omit with --tenant "
                            "or --seq)")
    p_why.add_argument("--tenant", default=None,
                       help="explain this tenant's latest decision "
                            "instead of a plan fingerprint")
    p_why.add_argument("--seq", type=int, default=None,
                       help="explain the decision with this exact seq")
    p_why.add_argument("--decisions", default=None, metavar="FILE",
                       help="decision JSONL (obs/provenance.DecisionLog)")
    p_why.add_argument("--remote", default=None,
                       help="fetch decisions from a running daemon "
                            "(http://HOST:PORT or unix:/path) instead "
                            "of a file")
    p_why.add_argument("--json", action="store_true", dest="as_json",
                       help="emit the chain + per-hop diffs as JSON")
    p_why.add_argument("--output", default="-",
                       help="output path ('-' = stdout)")

    p_diff = sub.add_parser(
        "diff", help="attributed diff between two plans by fingerprint: "
                     "per-component cost deltas (summing exactly to the "
                     "total delta) plus every decision axis that moved")
    p_diff.add_argument("fp_a", help="plan fingerprint A (the baseline)")
    p_diff.add_argument("fp_b", help="plan fingerprint B")
    p_diff.add_argument("--decisions", default=None, metavar="FILE",
                        help="decision JSONL to resolve fingerprints from")
    p_diff.add_argument("--remote", default=None,
                        help="resolve fingerprints from a running "
                             "daemon's decision log")
    p_diff.add_argument("--plans", action="append", default=[],
                        metavar="FILE",
                        help="plan-dump JSON (hetero output) to resolve "
                             "fingerprints from; repeatable, carries the "
                             "structural axes decision records lack")
    p_diff.add_argument("--json", action="store_true", dest="as_json",
                        help="emit the diff as JSON")
    p_diff.add_argument("--output", default="-",
                        help="output path ('-' = stdout)")
    return parser


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv[:1] == ["chaos"] and "--fleet" in argv:
        # fleet-scale availability drill: its own arg surface (no hostfile/
        # profiles — the drill synthesizes the mixed v5e/v6e spot fleet and
        # drives the plan daemon itself)
        from metis_tpu_torch.resilience.fleet_drill import main as fleet_main

        return fleet_main([a for a in argv[1:] if a != "--fleet"])
    args = _parser().parse_args(argv)
    reader = {"report": _cmd_report, "accuracy": _cmd_accuracy,
              "why": _cmd_why, "diff": _cmd_diff, "serve": _cmd_serve,
              "top": _cmd_top, "replay": _cmd_replay}.get(args.command)
    if reader is not None:
        return reader(args)
    if args.command == "profile":
        return _cmd_profile(args)
    if args.command == "calibrate":
        return _cmd_calibrate(args)
    if args.command == "plan":
        return _cmd_plan(args)
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
    if args.command == "explain":
        return _cmd_explain(args, profiles, model, config, events)
    return _cmd_search(args, profiles, model, config, events)


if __name__ == "__main__":
    sys.exit(main())
