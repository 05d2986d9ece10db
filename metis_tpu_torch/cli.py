"""Command line of the port: ``python -m metis_tpu_torch profile ...``.

The ``profile`` subcommand takes the same flags as the JAX package's
(``metis_tpu/planner/cli.py``) and writes the same profile JSON, measured on
the CUDA card.  The ``uniform``, ``validate`` and ``train`` subcommands plan
first, so they come with the slice that ports the planner.
"""
from __future__ import annotations

import argparse
import sys

from metis_tpu_torch.core.config import ModelSpec
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


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m metis_tpu_torch",
                                     description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)
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
    p_prof.add_argument("--device", default="cuda",
                        help="torch device to measure on (the CPU only when "
                             "asked for: --device cpu)")
    args = parser.parse_args(argv)
    return _cmd_profile(args)


if __name__ == "__main__":
    sys.exit(main())
