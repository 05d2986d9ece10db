"""Whether gloo's point-to-point operations take CUDA tensors.

    python3 tools/torch_gloo_p2p_probe.py

Two gloo ranks on ``cuda:0`` exchange bf16 CUDA tensors of 7, 2^20 and
3 * 2^22 elements, once with ``batch_isend_irecv`` and once with plain
``isend`` / ``recv``, and print per rank, per size and per form either
whether the received tensor equals the sent one or the error raised.  On
the card machine every form raises (gloo's ``writev`` fails with "Bad
address": it reads the device pointer as host memory), which is why
``metis_tpu_torch/execution/stages.py`` stages boundary tensors through the
host on the gloo backend.
"""
from __future__ import annotations

import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SIZES = (7, 1 << 20, 3 << 22)


def _exchange(rank: int, n: int, batched: bool):
    peer = 1 - rank
    sent = (torch.arange(n, device="cuda", dtype=torch.float32)
            + 1000 * rank).to(torch.bfloat16)
    want = (torch.arange(n, device="cuda", dtype=torch.float32)
            + 1000 * peer).to(torch.bfloat16)
    got = torch.zeros(n, device="cuda", dtype=torch.bfloat16)
    try:
        if batched:
            ops = [dist.P2POp(dist.isend, sent, peer),
                   dist.P2POp(dist.irecv, got, peer)]
            for w in dist.batch_isend_irecv(ops if rank == 0 else ops[::-1]):
                w.wait()
        elif rank == 0:
            w = dist.isend(sent, 1)
            dist.recv(got, 1)
            w.wait()
        else:
            dist.recv(got, 0)
            dist.send(sent, 0)
        torch.cuda.synchronize()
        return bool(torch.equal(got, want))
    except RuntimeError as e:
        return f"raised {type(e).__name__}: {str(e)[:200]}"


def _rank(rank: int, store: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=2)
    for n in SIZES:
        for batched in (True, False):
            form = "batch_isend_irecv" if batched else "isend/recv"
            print(f"rank {rank} n {n} {form}: {_exchange(rank, n, batched)}",
                  flush=True)
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gloo_p2p_probe: CUDA is not available", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(os.path.join(tmp, "store"),), nprocs=2,
                           start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
