"""Time the flash-attention kernels of one source tree at the main-path shape.

    python3 tools/torch_kernel_ab.py --root DIR

Imports ``metis_tpu_torch`` from the checkout DIR (this one, or a
``git archive`` of another commit unpacked somewhere), builds that tree's
kernels, and times its B1, B2 and B3 at ``chip_smoke.py``'s main-path shape
(b 4, h 32, s 1024, d 128, causal, bf16), and B2 then B3 back to back (the
whole backward), with this checkout's timer (``chip_smoke.timed_runs``:
CUDA events around back-to-back calls, three repetitions), on inputs made
from the same seed.  Prints one JSON line: the card and its power limit, the
tree, and each kernel's (and the pair's) median and runs.  To compare two
trees on one card, run it on each in turns (old, new, new, old) within one
command.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="checkout whose kernels to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    smoke = load_chip_smoke()
    sys.path.insert(0, str(root))
    from metis_tpu_torch.ops import flash_attention as fa
    if not Path(fa.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {fa.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    fa.kernel_library()

    case = smoke.MAIN
    b, h, s, d = case["b"], case["hq"], case["s"], case["d"]
    heads = dict(q_heads=h, kv_heads=case["hkv"], causal=case["causal"])
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    q, k, v, do = (torch.randn(b * h, s, d, generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    o, m, l = fa.fa_fwd_plain(q, k, v, **heads)
    lse, delta = fa.logsumexp_of(m, l), (do.float() * o.float()).sum(-1)
    del o, m, l
    torch.cuda.empty_cache()
    result = {
        "card": smoke.card_line(),
        "root": str(root),
        "fa_fwd": smoke.timed_runs(lambda: fa.fa_fwd(q, k, v, **heads)),
        "fa_bwd_dq": smoke.timed_runs(lambda: fa.fa_bwd_dq(q, k, v, do, lse, delta, **heads)),
        "fa_bwd_dkv": smoke.timed_runs(lambda: fa.fa_bwd_dkv(q, k, v, do, lse, delta, **heads)),
        # the whole backward, B2 then B3 back to back
        "bwd_pair": smoke.timed_runs(lambda: (fa.fa_bwd_dq(q, k, v, do, lse, delta, **heads),
                                              fa.fa_bwd_dkv(q, k, v, do, lse, delta, **heads))),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
