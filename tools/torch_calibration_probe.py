"""The calibration phase's calls on one card, alone.

    python3 tools/torch_calibration_probe.py

Prints the card line (``nvidia-smi``) and the versions, runs ``python -m
metis_tpu_torch calibrate --chip-roofline`` on the one card (exit 1, no
collective file) and again on two gloo ranks of it (exit 0), then on rank
pools of 2 and 4 gloo ranks sharing the card ``microbenchmark_collectives``
(each pool), ``measure_dp_overlap`` (2 ranks) and
``measure_pipeline_overlap`` (4 ranks, pp 2 x dp 2), each with its
seconds.  ``chip_smoke.py``'s calibration phase runs the same calls with
its gates; this drives them without the script's earlier phases.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    from metis_tpu_torch.cost.calibration import measure_rank
    from metis_tpu_torch.execution import dist as mdist

    if not torch.cuda.is_available():
        print("torch_calibration_probe: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "cal.json"
        for extra in ([], ["--devices", "cuda:0,cuda:0", "--dist-backend", "gloo"]):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "metis_tpu_torch", "calibrate", "--output",
                 str(out), "--chip-roofline", *extra],
                capture_output=True, text=True, cwd=ROOT)
            print(f"calibrate {extra}: rc {proc.returncode}, {out.name} written "
                  f"{out.exists()}: {proc.stderr[-2000:]} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    pools = {w: mdist.RankPool(w, "gloo", ["cuda:0"] * w) for w in (2, 4)}
    try:
        for world in (2, 4):
            t0 = time.perf_counter()
            cal = pools[world].run(measure_rank, "microbenchmark_collectives",
                                   dict(payload_kb=(64, 256, 1024, 4096), iters=8))
            print(world, json.dumps(cal[0]["result"].to_json_dict()["fits"]),
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        t0 = time.perf_counter()
        dp = pools[2].run(measure_rank, "measure_dp_overlap", {})
        print("dp", dp[0]["result"], f"({time.perf_counter() - t0:.1f} s)", flush=True)
        t0 = time.perf_counter()
        pipe = pools[4].run(measure_rank, "measure_pipeline_overlap", {})
        print("pipeline", pipe[0]["result"], pipe[0]["losses"], pipe[0]["events"],
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    finally:
        for pool in pools.values():
            pool.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
