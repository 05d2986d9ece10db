"""Traffic-replay bench: a diurnal arrival-rate sweep against the serve
daemon, driving elastic scale-up/down through ``POST /cluster_delta`` —
the port of ``metis_tpu/inference/replay.py``.

The generator models one day of serving load as a raised-cosine between a
base and a peak rate.  Each tick queries the daemon for the best plan at
the CURRENT rate and topology (the workload's arrival rate is part of the
query fingerprint, so every rate level is its own cache entry — repeat
cycles hit the cache), records whether the SLOs hold, and applies one of
two elastic policies:

- ``hysteresis`` (the baseline): REACTIVE — when the offered rate
  falls below ``scale_down_frac`` of the plan's sustainable throughput, the
  last node is released (a ``ClusterDelta`` the daemon answers with replan
  + ``replan_push``); when it climbs above ``scale_up_frac``, the most
  recently released node is restored.  Scaling happens AFTER the tick is
  scored, so a spike's first over-ceiling tick always records a miss.
- ``predictive``: PROACTIVE — a least-squares arrival-rate trend over a
  sliding window of observed ticks issues capacity deltas BEFORE the tick
  is scored.  Scale-up fires when the one-tick-ahead forecast crosses the
  pool's estimated feasible ceiling (the breach hysteresis would score as
  a miss); scale-down sheds as many nodes as the ``forecast_horizon``-tick
  forecasted peak leaves fitting the shrunken pool with margin, instead of
  waiting for the rate to fall below half the ceiling — same attainment,
  fewer device-hours.

Simulated time only — ticks never sleep, so a full diurnal cycle completes
in seconds of wall clock.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

from metis_tpu_torch.cluster.spec import ClusterSpec, NodeSpec
from metis_tpu_torch.core.config import ModelSpec, SearchConfig
from metis_tpu_torch.core.events import EventLog, NULL_LOG
from metis_tpu_torch.inference.workload import InferenceWorkload


def diurnal_rate(tick: int, ticks_per_cycle: int, base_rps: float,
                 peak_rps: float) -> float:
    """Raised-cosine day curve: base at tick 0, peak mid-cycle."""
    phase = 2.0 * math.pi * (tick % ticks_per_cycle) / ticks_per_cycle
    return base_rps + (peak_rps - base_rps) * 0.5 * (1.0 - math.cos(phase))


@dataclass(frozen=True)
class ReplayTick:
    """One simulated tick's outcome."""

    t_s: float
    arrival_rps: float
    devices: int
    slo_ok: bool
    throughput_rps: float | None
    scaled: str  # "", "down", "up"

    def to_json_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass
class ReplayReport:
    """Whole-replay outcome: the SLO-attainment headline plus the device
    trajectory the elastic policy traced."""

    ticks: list[ReplayTick] = field(default_factory=list)
    replan_pushes: int = 0
    cycles: int = 0
    policy: str = "hysteresis"
    tick_seconds: float = 3600.0

    @property
    def slo_attainment(self) -> float:
        """Request-weighted fraction of offered traffic served inside the
        SLOs (a miss at peak hurts more than a miss at 3am)."""
        offered = sum(t.arrival_rps for t in self.ticks)
        if not offered:
            return 1.0
        met = sum(t.arrival_rps for t in self.ticks if t.slo_ok)
        return met / offered

    @property
    def device_trajectory(self) -> list[int]:
        return [t.devices for t in self.ticks]

    @property
    def device_hours(self) -> float:
        """Total provisioned capacity over the replay — the cost side of the
        policy comparison (attainment is the quality side)."""
        return sum(self.device_trajectory) * self.tick_seconds / 3600.0

    def to_json_dict(self) -> dict:
        return {
            "slo_attainment": self.slo_attainment,
            "policy": self.policy,
            "cycles": self.cycles,
            "replan_pushes": self.replan_pushes,
            "min_devices": min(self.device_trajectory, default=0),
            "max_devices": max(self.device_trajectory, default=0),
            "device_hours": self.device_hours,
            "ticks": [t.to_json_dict() for t in self.ticks],
        }


def forecast_rate(history: list[float], window: int = 4,
                  horizon: int = 2) -> float:
    """Forecasted PEAK arrival rate over the next ``horizon`` ticks: a
    least-squares linear trend over the last ``window`` observations,
    extrapolated and floored at 0.  With fewer than two observations the
    last rate is returned (no trend to fit yet)."""
    tail = history[-window:]
    n = len(tail)
    if n < 2:
        return tail[-1] if tail else 0.0
    xs = range(n)
    sx = sum(xs)
    sy = sum(tail)
    sxx = sum(x * x for x in xs)
    sxy = sum(x * y for x, y in zip(xs, tail))
    slope = (n * sxy - sx * sy) / (n * sxx - sx * sx)
    intercept = (sy - slope * sx) / n
    return max(max(intercept + slope * (n - 1 + h)
                   for h in range(1, horizon + 1)), 0.0)


def replay_traffic(
    client,
    cluster: ClusterSpec,
    model: ModelSpec,
    config: SearchConfig,
    workload: InferenceWorkload,
    *,
    base_rps: float,
    peak_rps: float,
    ticks_per_cycle: int = 24,
    cycles: int = 1,
    tick_seconds: float = 3600.0,
    scale_down_frac: float = 0.5,
    scale_up_frac: float = 0.9,
    min_nodes: int = 2,
    top_k: int = 5,
    policy: str = "hysteresis",
    forecast_window: int = 4,
    forecast_horizon: int = 2,
    events: EventLog = NULL_LOG,
    metrics=None,
) -> ReplayReport:
    """Run ``cycles`` diurnal cycles against a live daemon (``client`` is a
    ``serve.client.PlanServiceClient``; ``cluster`` mirrors the daemon's
    boot topology so the bench knows node widths for whole-node deltas).

    ``policy`` selects the elastic strategy (module docstring): reactive
    ``"hysteresis"`` or proactive ``"predictive"``.  Every elastic action
    goes through ``client.cluster_delta(..., replan=True)`` so the daemon
    re-searches and pushes ``replan_push`` notifications, which the report
    counts.

    ``metrics`` (an ``obs.metrics.MetricsRegistry``) gets per-tick
    telemetry labeled by ``policy``: the running request-weighted SLO
    attainment gauge, a device-hours counter (fractional — counters are
    float-valued), and a tick counter — so a dashboard watching /metrics
    follows a live replay without waiting for the final report."""
    if policy not in ("hysteresis", "predictive"):
        raise ValueError(f"unknown replay policy: {policy!r}")
    # local mirror of the daemon's node list: deltas remove from the END
    # (shrink_cluster's convention) and restore in LIFO order
    live_nodes = list(cluster.nodes)
    released: list[dict[str, int]] = []
    report = ReplayReport(cycles=cycles, policy=policy,
                          tick_seconds=tick_seconds)
    note_seq = 0
    total_ticks = ticks_per_cycle * cycles
    history: list[float] = []
    prev_throughput: float | None = None

    def add_node() -> None:
        delta = released.pop()
        # cause labels the delta's decision-log root "autoscale": the
        # daemon records it as an autoscale_delta, distinguishing elastic
        # policy actions from operator deltas in `metis-tpu why`
        client.cluster_delta(added=delta, replan=True, cause="autoscale")
        t = next(iter(delta))
        live_nodes.append(NodeSpec(t, delta[t]))

    def shed_node() -> None:
        node = live_nodes.pop()
        delta = {node.device_type: node.num_devices}
        client.cluster_delta(removed=delta, replan=True,
                             cause="autoscale")
        released.append(delta)

    for tick in range(total_ticks):
        rate = diurnal_rate(tick, ticks_per_cycle, base_rps, peak_rps)
        t_s = tick * tick_seconds
        scaled = ""

        if policy == "predictive":
            # act BEFORE scoring the tick.  Scale-up watches the NEAR-TERM
            # forecast (one tick ahead — the breach the reactive policy
            # would score as a miss); scale-down requires the full
            # ``forecast_horizon``-tick peak to fit the shrunken pool with
            # margin.  The asymmetry keeps the linear trend's overshoot
            # around a demand peak from buying capacity it never needs.
            history.append(rate)
            fc = forecast_rate(history, forecast_window, forecast_horizon)
            near = forecast_rate(history, forecast_window, 1)
            demand = max(rate, fc)
            if prev_throughput is not None:
                devs = sum(n.num_devices for n in live_nodes)
                ceiling = prev_throughput
                while max(rate, near) > ceiling and released:
                    width = sum(released[-1].values())
                    add_node()
                    ceiling *= (devs + width) / devs
                    devs += width
                    scaled = "up"
                while scaled != "up" and len(live_nodes) > min_nodes:
                    width = live_nodes[-1].num_devices
                    shrunk = ceiling * (devs - width) / devs
                    if demand > scale_up_frac * shrunk:
                        break
                    shed_node()
                    ceiling = shrunk
                    devs -= width
                    scaled = "down"
            events.emit("autoscale_forecast", t_s=t_s, forecast_rps=fc,
                        ceiling_rps=(prev_throughput
                                     if prev_throughput is not None else 0.0),
                        action=scaled)

        wl = dataclasses.replace(workload, arrival_rate_rps=rate)
        resp = client.plan(model, config, top_k=top_k, workload=wl)
        throughput = resp.get("best_max_rps")
        slo_ok = bool(resp.get("slo_ok")) and throughput is not None
        devices = sum(n.num_devices for n in live_nodes)
        prev_throughput = throughput

        if policy == "hysteresis":
            if (throughput is None or rate > scale_up_frac * throughput) \
                    and released:
                add_node()
                scaled = "up"
            elif (throughput is not None
                  and rate < scale_down_frac * throughput
                  and len(live_nodes) > min_nodes):
                shed_node()
                scaled = "down"

        report.ticks.append(ReplayTick(
            t_s=t_s, arrival_rps=rate, devices=devices, slo_ok=slo_ok,
            throughput_rps=throughput, scaled=scaled))
        if metrics is not None:
            metrics.gauge("metis_replay_slo_attainment",
                          policy=policy).set(report.slo_attainment)
            metrics.counter("metis_replay_device_hours_total",
                            policy=policy).inc(
                devices * tick_seconds / 3600.0)
            metrics.counter("metis_replay_ticks_total", policy=policy).inc()
        events.emit("replay_tick", t_s=t_s, arrival_rps=rate,
                    devices=devices, slo_ok=slo_ok)
        if not slo_ok:
            events.emit("slo_violation", metric="throughput_rps",
                        value=throughput if throughput is not None else 0.0,
                        slo=rate)
        notes = client.notifications(since=note_seq)
        if notes:
            note_seq = max(n["seq"] for n in notes)
            report.replan_pushes += sum(
                1 for n in notes if n.get("kind") == "replan_push")

    return report
