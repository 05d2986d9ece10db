"""Collective microbenchmarks and calibration fits — the port of
``metis_tpu/cost/calibration.py``.

The fits are host arithmetic, copied from the reference:

- ``fit_samples`` fits each collective to the two-parameter wire model
  ``time_ms = latency_ms + nbytes * ms_per_byte`` by least squares, and
  ``CollectiveCalibration`` is its JSON artifact, byte for byte the
  reference's;
- ``fit_ledger_correction`` refits the prediction level from accuracy-ledger
  pairs, ``fit_recovery_seconds`` the planner's ``spot_recover_s`` from the
  supervisor's recoveries;
- ``fit_transfer_scale`` and ``transfer_profiles`` scale a profiled device
  type's profiles onto an unprofiled one by two roofline numbers.

The measurements run one rank per device over ``torch.distributed`` (the
reference runs one program over a device mesh): every rank of the process
group calls ``microbenchmark_collectives``, ``measure_dp_overlap`` or
``measure_pipeline_overlap`` with its own device, times the port's own
collectives and executors on it, and returns rank 0's result.
``microbenchmark_chip`` times one device alone.  On gloo ranks sharing one
card the collectives cross through the host, so their fits describe that
transport, not the card's links.  The measurements import torch when they
run: the planner imports this module, and a process that only plans (the
plan daemon, its search workers) starts without torch.
"""
from __future__ import annotations

import json
import math
import statistics
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Sequence


COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
               "ppermute")


class CalibrationError(ValueError):
    """A calibration/transfer fit cannot be computed from the given
    samples (empty ledger, degenerate probe measurements, ...).

    Subclasses ValueError so pre-existing ``except ValueError`` /
    ``pytest.raises(ValueError)`` call sites keep working; new callers
    can catch the typed error and degrade (e.g. to an identity fit)."""


@dataclass(frozen=True)
class CollectiveSample:
    """One timed collective: ``nbytes`` is the logical payload the analytic
    formula charges (the full gradient/buffer size, not the wire volume)."""

    collective: str
    group_size: int
    nbytes: int
    time_ms: float


@dataclass(frozen=True)
class LinearFit:
    """``time_ms = latency_ms + nbytes * ms_per_byte`` (alpha-beta model)."""

    latency_ms: float
    ms_per_byte: float
    r2: float
    n_samples: int

    def predict_ms(self, nbytes: float) -> float:
        return self.latency_ms + nbytes * self.ms_per_byte

    @property
    def effective_bw_gbps(self) -> float:
        """Asymptotic (large-payload) bandwidth in GB/s (1 GB/s = 1e6 B/ms)."""
        if self.ms_per_byte <= 0:
            return float("inf")
        return 1.0 / (self.ms_per_byte * 1e6)


@dataclass(frozen=True)
class CollectiveCalibration:
    """Fitted wire model per collective for one (platform, group size)."""

    platform: str
    device_kind: str
    group_size: int
    fits: dict[str, LinearFit]
    samples: tuple[CollectiveSample, ...] = field(default=(), repr=False)

    # -- persistence -------------------------------------------------------
    def to_json_dict(self) -> dict:
        return {
            "platform": self.platform,
            "device_kind": self.device_kind,
            "group_size": self.group_size,
            "fits": {
                name: {"latency_ms": f.latency_ms,
                       "ms_per_byte": f.ms_per_byte,
                       "r2": f.r2, "n_samples": f.n_samples,
                       "effective_bw_gbps": f.effective_bw_gbps}
                for name, f in self.fits.items()
            },
            "samples": [
                {"collective": s.collective, "group_size": s.group_size,
                 "nbytes": s.nbytes, "time_ms": s.time_ms}
                for s in self.samples
            ],
        }

    def dump(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_json_dict(), indent=1))

    @classmethod
    def from_json_dict(cls, d: dict) -> "CollectiveCalibration":
        fits = {
            name: LinearFit(f["latency_ms"], f["ms_per_byte"], f["r2"],
                            f["n_samples"])
            for name, f in d["fits"].items()
        }
        samples = tuple(
            CollectiveSample(s["collective"], s["group_size"], s["nbytes"],
                             s["time_ms"])
            for s in d.get("samples", ()))
        return cls(d["platform"], d["device_kind"], d["group_size"], fits,
                   samples)

    @classmethod
    def load(cls, path: str | Path) -> "CollectiveCalibration":
        return cls.from_json_dict(json.loads(Path(path).read_text()))

    # -- application -------------------------------------------------------
    def bw_gbps(self, collective: str) -> float | None:
        fit = self.fits.get(collective)
        return None if fit is None else fit.effective_bw_gbps

    def latency_ms(self, collective: str) -> float:
        fit = self.fits.get(collective)
        return 0.0 if fit is None else max(fit.latency_ms, 0.0)

    def with_correction(self, scale: float) -> "CollectiveCalibration":
        """A new calibration with every fit's ``predict_ms`` scaled by a
        ledger-derived correction factor (``fit_ledger_correction``):
        latency and per-byte slope scale together, so the alpha/beta shape
        is preserved while the absolute prediction tracks what the
        accuracy ledger measured."""
        if scale <= 0:
            raise ValueError(f"correction scale must be > 0, got {scale}")
        fits = {
            name: LinearFit(f.latency_ms * scale, f.ms_per_byte * scale,
                            f.r2, f.n_samples)
            for name, f in self.fits.items()
        }
        return CollectiveCalibration(
            platform=self.platform, device_kind=self.device_kind,
            group_size=self.group_size, fits=fits, samples=self.samples)


def fit_samples(samples: Sequence[CollectiveSample]) -> dict[str, LinearFit]:
    """Least-squares alpha-beta fit per collective (clamped to latency >= 0:
    a tiny negative intercept is measurement noise, not physics)."""
    import numpy as np

    by_name: dict[str, list[CollectiveSample]] = {}
    for s in samples:
        by_name.setdefault(s.collective, []).append(s)

    fits = {}
    for name, group in by_name.items():
        x = np.array([s.nbytes for s in group], dtype=np.float64)
        y = np.array([s.time_ms for s in group], dtype=np.float64)
        if len(group) >= 2 and np.ptp(x) > 0:
            slope, intercept = np.polyfit(x, y, 1)
            slope = max(float(slope), 0.0)
            intercept = max(float(intercept), 0.0)
            pred = intercept + slope * x
            ss_res = float(((y - pred) ** 2).sum())
            ss_tot = float(((y - y.mean()) ** 2).sum())
            r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
        else:
            slope, intercept, r2 = 0.0, float(y.mean()), 1.0
        fits[name] = LinearFit(intercept, slope, r2, len(group))
    return fits


# ---------------------------------------------------------------------------
# measurements over torch.distributed
# ---------------------------------------------------------------------------


def _device_names(device: torch.device) -> tuple[str, str]:
    """(platform, device_kind): the torch device type and the device's name."""
    import torch

    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    return device.type, kind


def _fence(device: torch.device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rank0(value):
    """Rank 0's ``value`` on every rank of the process group."""
    import torch.distributed as dist

    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _collective_fns(group, n: int) -> dict:
    """name -> (local_fn, logical_payload_fn(local_bytes, n)): the port's
    own collectives (``models/parallel.py``) over ``group`` on a local
    ``[rows, cols]`` buffer.  The payload reported is the quantity the
    analytic formulas charge:

    - all_reduce: the full reduced buffer (every rank ends with it);
    - all_gather: the full gathered result;
    - reduce_scatter: the full pre-reduction buffer;
    - all_to_all: each rank's full send buffer;
    - ppermute: the block one neighbor sends (a one-step ring of
      send/recv).
    """
    import torch.distributed as dist

    from metis_tpu_torch.models import parallel

    def all_reduce(x):
        dist.all_reduce(x, group=group)
        return x

    return {
        "all_reduce": (all_reduce, lambda local, n: local),
        "all_gather": (lambda x: parallel.all_gather_dim(x, group, 0),
                       lambda local, n: local * n),
        "reduce_scatter": (lambda x: parallel.reduce_scatter_dim(x, group, 0),
                           lambda local, n: local),
        "all_to_all": (lambda x: parallel.all_to_all(x, group),
                       lambda local, n: local),
        "ppermute": (lambda x: parallel.RingTransfer([x], group).wait()[0],
                     lambda local, n: local),
    }


def microbenchmark_collectives(
    device: str | torch.device | None = None,
    payload_kb: Sequence[int] = (64, 256, 1024, 4096),
    iters: int = 10,
    warmup: int = 2,
    collectives: Sequence[str] = COLLECTIVES,
) -> CollectiveCalibration:
    """Time the port's collectives over the process group (every rank calls
    this with its own ``device``) and fit the wire model; every rank returns
    rank 0's calibration.  ``payload_kb`` are *local* buffer sizes; logical
    payloads are derived per collective (see ``_collective_fns``).  Each
    timing is ``iters`` back-to-back calls between two device fences."""
    import torch
    import torch.distributed as dist

    from metis_tpu_torch.core.device import resolve_device

    dev = resolve_device(device if device is not None else "cuda")
    group = dist.group.WORLD
    n = dist.get_world_size(group)
    if n < 2:
        raise ValueError("collective microbenchmark needs >= 2 devices")
    fns = _collective_fns(group, n)

    samples: list[CollectiveSample] = []
    # local rows: a multiple of n (the even all-to-all and reduce-scatter
    # split dim 0 into n blocks) that is also >= 8
    rows = n * max(8 // n, 1)
    for kb in payload_kb:
        cols = max(kb * 1024 // 4 // rows, 8)  # fp32
        local_bytes = rows * cols * 4
        x = torch.zeros((rows, cols), dtype=torch.float32, device=dev)
        for name in collectives:
            fn, payload = fns[name][0], fns[name][1](local_bytes, n)
            try:
                for _ in range(warmup):
                    fn(x)
                _fence(dev)
                dist.barrier(group=group)
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn(x)
                _fence(dev)
                ms = (time.perf_counter() - t0) / iters * 1e3
            except (RuntimeError, NotImplementedError) as e:  # backend-specific
                warnings.warn(
                    f"collective microbenchmark skipped {name} at "
                    f"{kb} KB: {type(e).__name__}: {e}", stacklevel=2)
                continue
            samples.append(CollectiveSample(name, n, payload, ms))

    platform, kind = _device_names(dev)
    return _rank0(CollectiveCalibration(
        platform=platform, device_kind=kind, group_size=n,
        fits=fit_samples(samples), samples=tuple(samples)))


# ---------------------------------------------------------------------------
# accuracy-ledger residual refit
# ---------------------------------------------------------------------------


def fit_ledger_correction(samples) -> dict:
    """Fit a multiplicative ``predict_ms`` correction from accuracy-ledger
    residuals (``obs/ledger.py``): the closing of the drift loop — once the
    ledger shows the estimator systematically off, its residuals refit the
    prediction instead of being merely alarmed about.

    ``samples``: an iterable of ``(predicted_ms, measured_ms)`` pairs OR
    ledger ``AccuracySample`` objects (matched ones; unpredicted samples
    are skipped).  The scale is the least-squares through-origin fit
    ``measured ≈ scale * predicted`` — a single factor, because a ranking
    model only needs its *level* corrected (a uniform scale preserves every
    plan ordering while fixing the absolute step-time estimate the drift
    band is judged against).

    Returns ``{"scale", "n", "mape_before_pct", "mape_after_pct"}``; apply
    with ``CollectiveCalibration.with_correction(scale)`` or by scaling any
    ``predict_ms`` output directly.

    Degrades gracefully on thin ledgers: an empty/unmatched sample set
    raises the typed :class:`CalibrationError` (a ValueError subclass —
    existing handlers keep working); a single matched sample fits the
    exact one-point scale; non-finite (NaN/inf) pairs are skipped like
    unmatched ones rather than poisoning the fit.
    """
    pairs: list[tuple[float, float]] = []
    for s in samples:
        if hasattr(s, "predicted_ms"):
            p, m = s.predicted_ms, s.measured_ms
        else:
            p, m = s
        if p is None or m is None:
            continue
        p, m = float(p), float(m)
        if not math.isfinite(p) or not math.isfinite(m) or m <= 0:
            continue
        pairs.append((p, m))
    if not pairs:
        raise CalibrationError(
            "no matched (predicted, measured) samples to fit")
    sxx = sum(p * p for p, _ in pairs)
    sxy = sum(p * m for p, m in pairs)
    scale = sxy / sxx if sxx > 0 else 1.0

    def mape(factor: float) -> float:
        return sum(abs(p * factor - m) / m for p, m in pairs) / len(pairs) * 100

    return {
        "scale": round(scale, 6),
        "n": len(pairs),
        "mape_before_pct": round(mape(1.0), 3),
        "mape_after_pct": round(mape(scale), 3),
    }


def fit_recovery_seconds(samples, kinds: Sequence[str] | None = None) -> dict:
    """Refit ``SearchConfig.spot_recover_s`` from measured recoveries.

    The spot-availability cost term charges ``hazard_per_hr x
    spot_recover_s`` of expected recovery time per plan
    (``cost/estimator.py``); the seed value comes from the bench
    ``resilience`` headline, and THIS closes the loop from production:
    ``samples`` is an iterable of recovery durations in seconds — floats,
    ``(kind, recover_s)`` pairs, supervisor ``RecoveryRecord`` objects, or
    their ``to_json_dict`` rows.  ``kinds`` (default: the replan-bearing
    ones — ``device_loss``/``spot_preemption``/``spot_return``) filters
    records that carry a kind; anomaly rollbacks rebuild nothing and would
    drag the estimate down.

    Returns ``{"spot_recover_s", "n", "mean_s", "p50_s", "p90_s"}`` —
    ``spot_recover_s`` is the MEDIAN (one straggler recovery must not
    dominate the prior every future plan is ranked with)."""
    if kinds is None:
        kinds = ("device_loss", "spot_preemption", "spot_return")
    vals: list[float] = []
    for s in samples:
        kind = None
        if hasattr(s, "recover_s"):
            kind, sec = getattr(s, "kind", None), s.recover_s
        elif isinstance(s, dict):
            kind, sec = s.get("kind"), s.get("recover_s")
        elif isinstance(s, tuple):
            kind, sec = s
        else:
            sec = s
        if sec is None or float(sec) <= 0:
            continue
        if kind is not None and kind not in kinds:
            continue
        vals.append(float(sec))
    if not vals:
        raise ValueError("no usable recovery samples to fit")
    vals.sort()
    n = len(vals)
    p50 = vals[(n - 1) // 2]
    p90 = vals[min(int(n * 0.9), n - 1)]
    return {
        "spot_recover_s": round(p50, 4),
        "n": n,
        "mean_s": round(sum(vals) / n, 4),
        "p50_s": round(p50, 4),
        "p90_s": round(p90, 4),
    }


# ---------------------------------------------------------------------------
# dp gradient-sync overlap calibration
# ---------------------------------------------------------------------------


def _timed(fn: Callable[[], object], device: torch.device, iters: int,
           warmup: int) -> tuple[float, float]:
    """(median_ms, spread_ms) of ``iters`` calls of ``fn``, each fenced on
    the device — spread is the interquartile range, the caller's noise
    yardstick for rejecting implausible fits."""
    for _ in range(warmup):
        fn()
    _fence(device)
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _fence(device)
        samples.append((time.perf_counter() - t0) * 1e3)
    srt = sorted(samples)
    return (statistics.median(samples),
            srt[(3 * len(srt)) // 4] - srt[len(srt) // 4])


def measure_dp_overlap(
    device: str | torch.device | None = None,
    hidden: int = 512,
    layers: int = 8,
    batch_per_device: int = 32,
    iters: int = 8,
    warmup: int = 2,
) -> dict:
    """Measure how much of the dp gradient all-reduce the port's executor
    hides under backward compute on THIS backend (every rank of the dp
    process group calls this with its own ``device``).

    Three timed variants of a layered matmul train-ish step, each rank on
    its own batch: (a) the backward, then the gradients' dp mean the way
    the gspmd executor reduces a dense leaf (``execution/train.py``,
    ``make_train_step``'s ``reduce_grads``: one blocking all-reduce per
    leaf after the whole backward, then the division), (b) the same without
    any gradient reduction, (c) a bare all-reduce of the same total
    gradient payload.  Then

        exposed_ms          = (a) - (b)     — comm actually on the critical path
        overlap_fraction    = 1 - exposed_ms / (c), clamped to [0, 1]

    The fraction feeds ``EstimatorOptions.dp_overlap_fraction`` (native cost
    mode only; strict_compat stays serial like the reference).  Every rank
    returns rank 0's measurement."""
    import torch
    import torch.distributed as dist

    from metis_tpu_torch.core.device import resolve_device

    dev = resolve_device(device if device is not None else "cuda")
    group = dist.group.WORLD
    n = dist.get_world_size(group)
    if n < 2:
        raise ValueError("dp overlap calibration needs >= 2 devices")
    params = [torch.full((hidden, hidden), 0.01, dtype=torch.float32,
                         device=dev, requires_grad=True) for _ in range(layers)]
    x = torch.ones((batch_per_device, hidden), dtype=torch.float32, device=dev)

    def loss_fn(ps, xb):
        for w in ps:
            xb = torch.tanh(xb @ w)
        return (xb * xb).mean()

    def make_step(reduce_grads: bool):
        def step():
            loss = loss_fn(params, x)
            grads = torch.autograd.grad(loss, params)
            if reduce_grads:
                for g in grads:
                    dist.all_reduce(g, group=group)
                    g.div_(n)
            # consume every gradient, as the step's optimizer would
            return loss + sum(g.sum() for g in grads) * 1e-9
        return step

    grad_bytes = layers * hidden * hidden * 4
    # each rank's buffer holds the FULL gradient payload: the gradient mean
    # above all-reduces grad_bytes per rank (params are replicated)
    buf = torch.ones((max(grad_bytes // 4 // hidden, 1), hidden),
                     dtype=torch.float32, device=dev)

    def bare_allreduce():
        dist.all_reduce(buf, group=group)

    dist.barrier(group=group)
    with_ms, with_iqr = _timed(make_step(True), dev, iters, warmup)
    dist.barrier(group=group)
    without_ms, without_iqr = _timed(make_step(False), dev, iters, warmup)
    dist.barrier(group=group)
    bare_ms, _ = _timed(bare_allreduce, dev, iters, warmup)

    exposed_ms = max(with_ms - without_ms, 0.0)
    overlap = 1.0 - exposed_ms / bare_ms if bare_ms > 0 else 0.0
    # Noise guard: on a loaded host with_ms <= without_ms happens from
    # jitter alone, which would read as overlap 1.0 (perfect hiding) and
    # zero out the dp comm term in native cost mode — a noise artifact
    # presented as measurement.  When the measured exposure doesn't stand
    # above the run-to-run spread, cap the fraction so some comm cost
    # always survives, and flag the fit so callers can reject it.
    noise_ms = max(with_iqr, without_iqr)
    noise_limited = bool(noise_ms > 0.0 and exposed_ms <= noise_ms)
    if noise_limited:
        overlap = min(overlap, 0.9)
    platform, kind = _device_names(dev)
    return _rank0({
        "platform": platform,
        "device_kind": kind,
        "group_size": n,
        "grad_bytes": grad_bytes,
        "with_reduce_ms": round(with_ms, 4),
        "without_reduce_ms": round(without_ms, 4),
        "with_reduce_iqr_ms": round(with_iqr, 4),
        "without_reduce_iqr_ms": round(without_iqr, 4),
        "exposed_comm_ms": round(exposed_ms, 4),
        "bare_allreduce_ms": round(bare_ms, 4),
        "noise_limited": noise_limited,
        "overlap_fraction": round(min(max(overlap, 0.0), 1.0), 4),
    })


def measure_pipeline_overlap(
    device: str | torch.device | None = None,
    pp: int = 2,
    dp: int = 2,
    microbatches: int = 4,
    hidden: int = 64,
    blocks: int = 4,
    seq: int = 32,
    vocab: int = 256,
    schedule: str = "1f1b",
    iters: int = 5,
    warmup: int = 2,
    events=None,
    losses: dict | None = None,
) -> dict:
    """Measure what the overlap schedule actually buys on THIS backend:
    the SAME pipeline train step built lockstep vs overlapped
    (``execution.pipeline.make_pipeline_train_step(overlap=...)``) on a
    (pp, dp) grid of the process group's first ``pp * dp`` ranks (every
    rank calls this with its own ``device``), plus a bare ring of the
    boundary activation (one send/recv step around each pp ring per
    schedule send, ``2 * ticks`` of them) as the comm yardstick —

        saved_ms            = lockstep_ms - overlapped_ms
        overlap_hidden_frac = clamp(saved_ms / bare_comm_ms, 0, 1)

    the measured analogue of the cost model's exposed-vs-hidden split
    (``SearchConfig.use_overlap_model``).  Rank 0 emits one
    ``overlap_measured`` event to ``events``.  Same noise discipline as
    :func:`measure_dp_overlap`: when the saving doesn't stand above the
    run-to-run spread the result is flagged ``noise_limited`` — ranks on
    one host route the "transfer" through memcpy, so a near-zero (even
    negative-before-clamp) saving there is expected, not a failed
    measurement.  ``losses``, when given, receives each mode's step losses
    (``"lockstep"``, ``"overlapped"``): both modes take the same steps from
    the same initial state.  Every rank returns rank 0's measurement."""
    import torch
    import torch.distributed as dist

    from metis_tpu_torch.core.device import resolve_device
    from metis_tpu_torch.core.events import NULL_LOG
    from metis_tpu_torch.execution.mesh import DP, PP, TP, _grid
    from metis_tpu_torch.execution.pipeline import (
        make_pipeline_train_step,
        microbatch_split,
    )
    from metis_tpu_torch.models.gpt import GPTConfig
    from metis_tpu_torch.models.parallel import RingTransfer

    events = events if events is not None else NULL_LOG
    dev = resolve_device(device if device is not None else "cuda")
    if dist.get_world_size() < pp * dp:
        raise ValueError(
            f"pipeline overlap calibration needs >= {pp * dp} devices, "
            f"have {dist.get_world_size()}")
    mesh = _grid((pp, dp, 1), (PP, DP, TP))
    cfg = GPTConfig(vocab_size=vocab, seq_len=seq, hidden=hidden,
                    num_heads=max(hidden // 16, 1), num_blocks=blocks,
                    ffn_multiplier=2, dtype=torch.float32)
    batch = microbatches * dp
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, vocab, (batch, seq), generator=gen).to(dev)
    tok_mbs = microbatch_split(tokens, microbatches)
    got: dict = {}

    def step_ms(overlap: bool) -> tuple[float, float]:
        if mesh is None:  # a rank past the grid: nothing to time
            return 0.0, 0.0
        init_fn, step = make_pipeline_train_step(
            cfg, mesh, microbatches, device=dev, schedule=schedule,
            overlap=overlap)
        state = [init_fn(1)]
        mode = got.setdefault("overlapped" if overlap else "lockstep", [])

        def run():
            state[0], loss = step(state[0], tok_mbs, tok_mbs)
            mode.append(loss.item())

        return _timed(run, dev, iters, warmup)

    dist.barrier()
    lockstep_ms, lockstep_iqr = step_ms(False)
    dist.barrier()
    overlapped_ms, overlapped_iqr = step_ms(True)

    # comm yardstick: the boundary activation around the pp ring for every
    # tick's forward+backward send (what the schedule tries to hide)
    ticks = microbatches + pp - 1
    mbs_local = batch // microbatches // dp
    buf = torch.ones((mbs_local, seq, hidden), dtype=torch.float32, device=dev)

    def bare():
        b = buf
        for _ in range(2 * ticks):
            b = RingTransfer([b], mesh.group(PP)).wait()[0]
        return b

    dist.barrier()
    bare_ms, _ = (_timed(bare, dev, iters, warmup) if mesh is not None
                  else (0.0, 0.0))

    saved_ms = lockstep_ms - overlapped_ms
    frac = saved_ms / bare_ms if bare_ms > 0 else 0.0
    frac = min(max(frac, 0.0), 1.0)
    noise_ms = max(lockstep_iqr, overlapped_iqr)
    noise_limited = bool(noise_ms > 0.0 and abs(saved_ms) <= noise_ms)
    platform, kind = _device_names(dev)
    out = {
        "platform": platform,
        "device_kind": kind,
        "pp": pp,
        "dp": dp,
        "microbatches": microbatches,
        "schedule": schedule,
        "lockstep_ms": round(lockstep_ms, 4),
        "overlapped_ms": round(overlapped_ms, 4),
        "lockstep_iqr_ms": round(lockstep_iqr, 4),
        "overlapped_iqr_ms": round(overlapped_iqr, 4),
        "bare_comm_ms": round(bare_ms, 4),
        "saved_ms": round(saved_ms, 4),
        "noise_limited": noise_limited,
        "overlap_hidden_frac": round(frac, 4),
    }
    if dist.get_rank() == 0:
        events.emit("overlap_measured", lockstep_ms=out["lockstep_ms"],
                    overlapped_ms=out["overlapped_ms"],
                    overlap_hidden_frac=out["overlap_hidden_frac"],
                    noise_limited=noise_limited, schedule=schedule)
    if losses is not None:
        losses.update(got)
    return _rank0(out)


def measure_rank(rank: int, device: torch.device, name: str, kwargs: dict) -> dict:
    """Rank body (``execution.dist``) of the measurements over a process
    group: ``name`` (``microbenchmark_collectives``, ``measure_dp_overlap``
    or ``measure_pipeline_overlap``) on this rank's device with
    ``kwargs``.  Returns ``{"result": rank 0's result}``; for the pipeline
    overlap also rank 0's ``events`` (the ``overlap_measured`` event) and
    this rank's step ``losses`` of each mode."""
    if name != "measure_pipeline_overlap":
        return {"result": globals()[name](device, **kwargs)}
    import io

    from metis_tpu_torch.core.events import EventLog

    stream, losses = io.StringIO(), {}
    result = measure_pipeline_overlap(device, events=EventLog(stream=stream),
                                      losses=losses, **kwargs)
    return {"result": result, "losses": losses,
            "events": [json.loads(line) for line in stream.getvalue().splitlines()]}


# ---------------------------------------------------------------------------
# single-device roofline calibration (compute side)
# ---------------------------------------------------------------------------


def matmul_chain(n: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``n`` dependent products: each feeds ``x @ b``, scaled by ``1/k``
    back to ~1, into the next (``microbenchmark_chip``'s compute chain)."""
    import torch

    k = b.shape[0]
    x = a
    for _ in range(n):
        x = torch.matmul(x, b).mul_(1.0 / k)
    return x


def stream_chain(n: int, v: torch.Tensor) -> torch.Tensor:
    """``n`` dependent ``v * 1.0000001`` passes over a buffer: each reads
    and writes it whole (``microbenchmark_chip``'s memory chain)."""
    for _ in range(n):
        v = v * 1.0000001
    return v


def microbenchmark_chip(device: str | torch.device | None = None,
                        iters: int = 10) -> dict:
    """Measure one device's achievable bf16 matmul TFLOP/s and its memory
    streaming bandwidth — the two roofline constants the synthetic profile
    generator (``profiles/synthetic.py``) and MFU accounting key on.  Both
    chains are timed with the two-point fence (``core/timing.py``), which
    cancels the fixed launch and fence overhead.  Returns a plain dict
    artifact (written next to the collective calibration)."""
    import torch

    from metis_tpu_torch.core.device import resolve_device
    from metis_tpu_torch.core.timing import two_point_queue_ms

    dev = resolve_device(device if device is not None else "cuda")
    platform, kind = _device_names(dev)
    out: dict = {"platform": platform, "device_kind": kind}

    # matmul peak: bf16 k^3 keeps the tensor cores busy ~ms per iteration
    k = 2048 if dev.type == "cpu" else 8192
    a = torch.ones((k, k), dtype=torch.bfloat16, device=dev)
    b = torch.ones((k, k), dtype=torch.bfloat16, device=dev)
    dt = two_point_queue_ms(lambda n: matmul_chain(n, a, b), iters) / 1e3
    out["matmul_tflops"] = round(2 * k**3 / dt / 1e12, 1)

    # streaming bandwidth: each iteration reads + writes the buffer (2x
    # volume), dependent on the previous iteration's output
    m = (64 if dev.type == "cpu" else 256) * 1024 * 1024 // 4
    big = torch.ones((m,), dtype=torch.float32, device=dev)
    dt = two_point_queue_ms(lambda n: stream_chain(n, big), iters) / 1e3
    out["hbm_stream_gbps"] = round(2 * m * 4 / dt / 1e9, 1)
    return out


# ---------------------------------------------------------------------------
# cross-device profile transfer (AMP-style roofline scaling)
# ---------------------------------------------------------------------------


# Default compute share of a transformer layer's step time for the
# roofline mix: large-matmul transformer layers are mostly compute-bound,
# the remainder streams activations/weights from memory.
TRANSFER_COMPUTE_MIX = 0.7


def fit_transfer_scale(source_bench: dict, target_bench: dict,
                       compute_mix: float = TRANSFER_COMPUTE_MIX) -> dict:
    """Fit roofline scale factors between a profiled and an unprofiled
    chip from two ``microbenchmark_chip`` artifacts.

    AMP-style cross-type generalization (arXiv 2210.07297): a layer's
    step time splits into a compute-bound share (scales with achievable
    matmul TFLOP/s) and a memory-bound share (scales with memory stream
    bandwidth), so

    ``time_target = time_source * (mix / compute_scale
                                   + (1 - mix) / mem_scale)``

    where ``compute_scale = target_tflops / source_tflops`` and
    ``mem_scale = target_gbps / source_gbps``.  Returns ``{"compute_scale",
    "mem_scale", "time_scale", "compute_mix", "source_kind",
    "target_kind"}``; raises :class:`CalibrationError` when either probe
    artifact is missing or degenerate (non-positive roofline numbers)."""
    if not 0.0 <= compute_mix <= 1.0:
        raise CalibrationError(
            f"compute_mix must be in [0, 1], got {compute_mix!r}")
    vals = {}
    for name, bench in (("source", source_bench), ("target", target_bench)):
        try:
            tflops = float(bench["matmul_tflops"])
            gbps = float(bench["hbm_stream_gbps"])
        except (KeyError, TypeError, ValueError) as e:
            raise CalibrationError(
                f"{name} probe artifact lacks roofline numbers: {e}") from None
        if tflops <= 0 or gbps <= 0:
            raise CalibrationError(
                f"{name} probe artifact has non-positive roofline numbers")
        vals[name] = (tflops, gbps)
    compute_scale = vals["target"][0] / vals["source"][0]
    mem_scale = vals["target"][1] / vals["source"][1]
    time_scale = compute_mix / compute_scale + (1.0 - compute_mix) / mem_scale
    return {
        "compute_scale": round(compute_scale, 6),
        "mem_scale": round(mem_scale, 6),
        "time_scale": round(time_scale, 6),
        "compute_mix": compute_mix,
        "source_kind": source_bench.get("device_kind", ""),
        "target_kind": target_bench.get("device_kind", ""),
    }


def transfer_profiles(store, source_type: str, target_type: str,
                      scales: dict, events=None) -> "object":
    """Synthesize profiles for an unprofiled device type by roofline-
    scaling a profiled one (:func:`fit_transfer_scale` output).

    Every (``source_type``, tp, bs) entry is copied to ``target_type``
    with layer/decode times and fb_sync multiplied by
    ``scales["time_scale"]`` (memory rows are model- not chip-shaped and
    pass through); the per-type optimizer/batch-generator metas scale
    the same way.  The returned merged store carries the provenance tag
    ``store.transferred[target_type] = {"source": ..., **scales,
    "transferred": True}`` — planner decision records pick it up so a
    plan built on transferred profiles is auditable as such.  Emits one
    ``transfer_fit`` event when an event log is passed."""
    from metis_tpu_torch.profiles.store import (
        DeviceTypeMeta,
        LayerProfile,
        ProfileStore,
    )

    src_keys = store.configs(source_type)
    if not src_keys:
        raise CalibrationError(
            f"no profiled entries for source type {source_type!r}")
    if store.configs(target_type):
        raise CalibrationError(
            f"target type {target_type!r} is already profiled")
    ts = float(scales["time_scale"])
    if not ts > 0:
        raise CalibrationError(f"time_scale must be > 0, got {ts!r}")
    entries = {}
    for (t, tp, bs) in src_keys:
        prof = store.get(t, tp, bs)
        entries[(target_type, tp, bs)] = LayerProfile(
            layer_times_ms=tuple(x * ts for x in prof.layer_times_ms),
            layer_memory_mb=prof.layer_memory_mb,
            fb_sync_ms=prof.fb_sync_ms * ts,
            decode_layer_times_ms=(
                tuple(x * ts for x in prof.decode_layer_times_ms)
                if prof.decode_layer_times_ms is not None else None),
            decode_context_len=prof.decode_context_len,
        )
    src_meta = store.type_meta[source_type]
    extra = ProfileStore(
        entries, store.model,
        {target_type: DeviceTypeMeta(
            optimizer_time_ms=src_meta.optimizer_time_ms * ts,
            batch_generator_ms=src_meta.batch_generator_ms * ts)})
    extra.attn = store.attn
    merged = store.merged_with(extra)
    merged.transferred = dict(getattr(store, "transferred", {}) or {})
    merged.transferred[target_type] = {
        "source": source_type, "transferred": True, **scales}
    if events is not None:
        events.emit("transfer_fit", source_type=source_type,
                    target_type=target_type,
                    time_scale=scales.get("time_scale"),
                    compute_scale=scales.get("compute_scale"),
                    mem_scale=scales.get("mem_scale"),
                    n_entries=len(entries))
    return merged
