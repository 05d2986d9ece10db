"""Device timing under asynchronous launch — the port of
``metis_tpu/core/timing.py``.

CUDA work is queued on a stream and runs in FIFO order, so the two-point
queue form still holds: queue n invocations, fence once, repeat with 2n, and
take the difference — ``t = (T(2n) - T(n)) / n`` — which cancels the fixed
launch and fence overhead.  The fence is ``torch.cuda.synchronize()``; CPU
tensors compute synchronously and need no fence.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import torch


def _first_tensor(out: Any) -> torch.Tensor | None:
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for item in out:
            found = _first_tensor(item)
            if found is not None:
                return found
    return None


def forced_scalar(leaf: Any) -> float:
    """Materialize one element of the first tensor in ``leaf`` on the host —
    the full fence (a device-to-host copy waits for the stream)."""
    t = _first_tensor(leaf)
    if t is None:
        raise TypeError(f"no tensor to fence on in {type(leaf).__name__}")
    return float(t.reshape(-1)[:1].float().sum().item())


def two_point_queue_ms(
    enqueue_n: Callable[[int], Any],
    iters: int,
    sync: Callable[[Any], None] | None = None,
    repeats: int = 2,
) -> float:
    """Per-iteration wall time (ms) of ``enqueue_n`` via the two-point form.

    ``enqueue_n(n)`` must queue n invocations and return something ``sync``
    can fence on; ``sync`` defaults to ``forced_scalar``.  Both queue
    lengths are warmed once, then timed ``repeats`` times taking minima.
    """
    if sync is None:
        sync = forced_scalar

    def run(n: int) -> float:
        t0 = time.perf_counter()
        sync(enqueue_n(n))
        return time.perf_counter() - t0

    run(iters), run(2 * iters)  # warm both queue lengths
    t1 = min(run(iters) for _ in range(repeats))
    t2 = min(run(2 * iters) for _ in range(repeats))
    return max(t2 - t1, 1e-9) / iters * 1e3
